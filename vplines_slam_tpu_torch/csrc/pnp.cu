// K18 pnp: the hypotheses of PnP-RANSAC -- a six-point DLT pose from each
// sample and its reprojection inliers over all points.
//
// Replaces: vplines_slam_tpu/ops/mvg.py:241 ransac_pnp, the vmapped hyp
//   (pnp_dlt :180 on each sample's mask) and score.  On the TPU each of the
//   256 hypotheses built a [2N, 12] A over all N points (zero rows outside
//   the sample), a batched 12x12 eigh and a 3x3 SVD, then a vmapped
//   reprojection of all N points.
// Bound on the H100: operations, serial ones.  256 hypotheses x (a 12x12
//   Jacobi eigensolve, ~7 sweeps of 66 rotations, + N reprojections) is
//   ~30 MFLOP of f64, a microsecond of the card's f64 rate; what sets the
//   time is the latency of each eigensolve's 11 dependent steps a sweep
//   (each the rotation, then the column and the row shuffles).
// Design: a warp per hypothesis, kWarps hypotheses a CTA, no shared memory
//   and no __syncwarp.  Lane k < S holds draw k; a repeated draw counts once
//   (as .at[sample].set(True) does: a 6x6 compare by shuffles) and a masked
//   point not at all.  Lane r < 12 holds row r of A^T A (built from the
//   sample's rows r0 = [X 1 0 -uX -u], r1 = [0 X 1 -vX -v] only) and row r of
//   the eigenvectors V, in registers.  The eigensolve is a parallel-ordered
//   Jacobi: round-robin pairing (the circle method: 12 indices, 11 steps a
//   sweep, every pair once), six disjoint rotations a step -- the pair's
//   smaller lane forms (c, s) from two rsqrt (no division, no sqrt), the
//   columns rotate in every lane's registers, the rows by one shuffle of
//   the partner lane's row -- until the off-diagonal mass is 1e-32 of the
//   diagonal's or, below 1e-20 of it, a sweep no longer halves it.  The
//   smallest diagonal's
//   column of V is P (3x4); its sign makes the sample's summed depth
//   positive (a lane a sample point, a warp sum); R is the orthogonal polar
//   factor of M = P[:, :3] by scaled Newton steps X <- (g X + X^-T / g) / 2
//   (each lane the same few 3x3 steps), times sign(det); the scale is
//   trace(R^T M) / 3, the mean singular value, and t = P[:, 3] / scale.  The
//   lanes then score the N points (z > 0.05, reprojection error <
//   threshold, mask) and a ballot counts the inliers.  All of it is f64
//   whatever the input type: A^T A spans ~1e4 against a near-zero smallest
//   eigenvalue.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 2;  // hypotheses a CTA
constexpr int kN = 12;     // unknowns of the DLT
constexpr int kMaxSweeps = 30;
constexpr int kPolarSteps = 16;

__device__ __forceinline__ double sgn(double v) { return (v > 0.0) - (v < 0.0); }

// the partner of index i in step s of the round-robin (circle method): index
// 11 stays, the others pair as (s + k, s - k) mod 11
__host__ __device__ constexpr int partner(int s, int i) {
  return i == kN - 1 ? s : (i == s ? kN - 1 : (2 * s - i + 2 * (kN - 1)) % (kN - 1));
}

// a[i] for an index i that differs between lanes: a chain of selects, so that
// a stays in registers
template <int n>
__device__ __forceinline__ double pick(const double (&a)[n], int i) {
  double v = a[0];
#pragma unroll
  for (int c = 1; c < n; ++c) v = i == c ? a[c] : v;
  return v;
}

__device__ __forceinline__ double warp_sum64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += VP_SHFL_XOR(v, o);
  return v;
}

// one step of the parallel-ordered Jacobi: the six rotations of round s.
// Lane r holds row r of A (a) and of V (v).
template <int s>
__device__ __forceinline__ void jacobi_step(double (&a)[kN], double (&v)[kN], int r) {
  const int pr = partner(s, r);
  const double d = pick(a, r), apq = pick(a, pr);
  const double d_pr = VP_SHFL_IDX(d, pr);
  const bool lo = r < pr;
  // the pair's smaller lane forms the rotation zeroing A[p][q] (p < q):
  // with h = |(aqq - app, 2 apq)|, cos 2phi = |aqq - app| / h,
  // c = sqrt((1 + cos 2phi) / 2), s = sin 2phi / (2 c), |phi| <= pi / 4
  double c = 1.0, sn = 0.0;
  if (apq != 0.0) {
    const double app = lo ? d : d_pr, aqq = lo ? d_pr : d;
    const double dd = aqq - app, e = 2.0 * apq;
    const double rh = rsqrt(dd * dd + e * e);
    const double w = 0.5 + 0.5 * (fabs(dd) * rh);
    const double ic = rsqrt(w);
    c = w * ic;
    sn = (dd >= 0.0 ? 0.5 : -0.5) * (e * rh) * ic;
  }
  // columns: A <- A J, V <- V J, every pair in registers, each pair's
  // rotation from its smaller lane
#pragma unroll
  for (int p = 0; p < kN; ++p) {
    const int q = partner(s, p);
    if (p < q) {
      const double cp = VP_SHFL_IDX(c, p), sp = VP_SHFL_IDX(sn, p);
      const double ap = a[p], aq = a[q], vp = v[p], vq = v[q];
      a[p] = cp * ap - sp * aq;
      a[q] = sp * ap + cp * aq;
      v[p] = cp * vp - sp * vq;
      v[q] = sp * vp + cp * vq;
    }
  }
  // rows: A <- J^T A, the partner's row by shuffles
  const int p_of_r = lo ? r : pr;
  const double cr = VP_SHFL_IDX(c, p_of_r), sr = VP_SHFL_IDX(sn, p_of_r);
  const double ss = lo ? -sr : sr;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const double b = VP_SHFL_IDX(a[k], pr);
    a[k] = ss * b + cr * a[k];
  }
}

template <int s>
__device__ __forceinline__ void jacobi_steps(double (&a)[kN], double (&v)[kN], int r) {
  jacobi_step<s>(a, v, r);
  if constexpr (s + 1 < kN - 1) jacobi_steps<s + 1>(a, v, r);
}

// 3x3 cofactor matrix of X (row-major): X^-T = cof / det
__device__ __forceinline__ void cofactor3(const double (&X)[9], double (&C)[9]) {
  C[0] = X[4] * X[8] - X[5] * X[7];
  C[1] = X[5] * X[6] - X[3] * X[8];
  C[2] = X[3] * X[7] - X[4] * X[6];
  C[3] = X[2] * X[7] - X[1] * X[8];
  C[4] = X[0] * X[8] - X[2] * X[6];
  C[5] = X[1] * X[6] - X[0] * X[7];
  C[6] = X[1] * X[5] - X[2] * X[4];
  C[7] = X[2] * X[3] - X[0] * X[5];
  C[8] = X[0] * X[4] - X[1] * X[3];
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
pnp_kernel(const T* __restrict__ X, const T* __restrict__ x,
           const unsigned char* __restrict__ mask, const long long* __restrict__ idx, int n_hyp,
           int N, int S, double thr, double* __restrict__ Rs, double* __restrict__ ts,
           int* __restrict__ counts, unsigned char* __restrict__ inl) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (h >= n_hyp) return;  // the whole warp
  // the sample: lane k < S holds draw k; a repeated draw and a masked point
  // contribute no rows
  const long long id = lane < S ? idx[(size_t)h * S + lane] : -1;
  double px = 0.0, py = 0.0, pz = 0.0, pu = 0.0, pv = 0.0;
  bool live = false;
  if (lane < S) {
    px = (double)X[3 * id];
    py = (double)X[3 * id + 1];
    pz = (double)X[3 * id + 2];
    pu = (double)x[2 * id];
    pv = (double)x[2 * id + 1];
    live = mask[id] != 0;
  }
  for (int k = 0; k < S; ++k) {
    const long long o = VP_SHFL_IDX(id, k);
    live = live && !(k < lane && o == id);
  }
  // row r of A^T A over the live sample rows
  const int r = lane < kN ? lane : kN - 1;
  double a[kN], v[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    a[c] = 0.0;
    v[c] = c == r ? 1.0 : 0.0;
  }
  for (int k = 0; k < S; ++k) {
    if (!VP_SHFL_IDX((int)live, k)) continue;  // the same k for the whole warp
    const double xh[4] = {VP_SHFL_IDX(px, k), VP_SHFL_IDX(py, k), VP_SHFL_IDX(pz, k), 1.0};
    const double u = VP_SHFL_IDX(pu, k), w = VP_SHFL_IDX(pv, k);
    const double r0[kN] = {xh[0], xh[1], xh[2], xh[3], 0.0, 0.0, 0.0, 0.0,
                           -u * xh[0], -u * xh[1], -u * xh[2], -u * xh[3]};
    const double r1[kN] = {0.0, 0.0, 0.0, 0.0, xh[0], xh[1], xh[2], xh[3],
                           -w * xh[0], -w * xh[1], -w * xh[2], -w * xh[3]};
    const double c0 = pick(r0, r), c1 = pick(r1, r);
#pragma unroll
    for (int c = 0; c < kN; ++c) a[c] += c0 * r0[c] + c1 * r1[c];
  }
  // the eigensolve
  const bool row_lane = lane < kN;
  double prev = INFINITY;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int c = 0; c < kN; ++c) off += c == r ? 0.0 : a[c] * a[c];
    const double dr = pick(a, r);
    off = warp_sum64(row_lane ? off : 0.0);
    const double diag = warp_sum64(row_lane ? dr * dr : 0.0);
    // converged, or near the rounding floor where a sweep no longer halves it
    if (off <= 1e-32 * diag || off == 0.0 || (off <= 1e-20 * diag && off >= 0.5 * prev)) break;
    prev = off;
    jacobi_steps<0>(a, v, r);
  }
  // the smallest eigenvalue's column (the lowest index on a tie)
  double best = row_lane ? pick(a, r) : INFINITY;
  int kmin = r;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double ob = VP_SHFL_XOR(best, o);
    const int ok = VP_SHFL_XOR(kmin, o);
    if (ob < best || (ob == best && ok < kmin)) {
      best = ob;
      kmin = ok;
    }
  }
  const double pe = pick(v, kmin);  // P[r / 4][r % 4] in lane r < 12
  double P[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) P[c] = VP_SHFL_IDX(pe, c);
  // sign: the summed depths of the sample points positive
  const double dep = live ? P[8] * px + P[9] * py + P[10] * pz + P[11] : 0.0;
  const double sign = sgn(warp_sum64(dep) + 1e-30);
#pragma unroll
  for (int c = 0; c < kN; ++c) P[c] *= sign;
  // R: the orthogonal polar factor of M = P[:, :3] by scaled Newton steps
  double M[9], Q[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[3 * i + j] = Q[3 * i + j] = P[4 * i + j];
  for (int it = 0; it < kPolarSteps; ++it) {
    double C[9];
    cofactor3(Q, C);
    const double det = Q[0] * C[0] + Q[1] * C[1] + Q[2] * C[2];
    if (!(fabs(det) > 1e-300)) break;  // a rank-deficient M stays as it is
    double nq = 0.0, nc = 0.0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      nq += Q[k] * Q[k];
      nc += C[k] * C[k];
    }
    // g = sqrt(|X^-1|_F / |X|_F), |X^-1|_F = |C|_F / |det|
    const double g = sqrt(sqrt(nc / nq) / fabs(det));
    double change = 0.0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const double q = 0.5 * (g * Q[k] + C[k] / (g * det));
      change += (q - Q[k]) * (q - Q[k]);
      Q[k] = q;
    }
    if (change <= 1e-28 * nq) break;
  }
  const double detq = Q[0] * (Q[4] * Q[8] - Q[5] * Q[7]) - Q[1] * (Q[3] * Q[8] - Q[5] * Q[6]) +
                      Q[2] * (Q[3] * Q[7] - Q[4] * Q[6]);
  const double sd = sgn(detq);
  double tr = 0.0;
#pragma unroll
  for (int k = 0; k < 9; ++k) tr += Q[k] * M[k];
  const double scale = tr / 3.0;
  double R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = Q[k] * sd;
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = P[4 * i + 3] / scale;
  if (lane < 9) Rs[(size_t)h * 9 + lane] = pick(R, lane);
  if (lane < 3) ts[(size_t)h * 3 + lane] = pick(t, lane);
  // the inliers over all points, a lane a point
  int count = 0;
  for (int n0 = 0; n0 < N; n0 += 32) {
    const int n = n0 + lane;
    bool in = false;
    if (n < N) {
      const double X0 = (double)X[3 * n], X1 = (double)X[3 * n + 1], X2 = (double)X[3 * n + 2];
      const double zc = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2];
      const double xc = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0];
      const double yc = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1];
      const bool good_z = zc > 0.05;
      const double z = good_z ? zc : 1.0;
      const double dx = xc / z - (double)x[2 * n], dy = yc / z - (double)x[2 * n + 1];
      in = (sqrt(dx * dx + dy * dy) < thr) && mask[n] && good_z;
      inl[(size_t)h * N + n] = in;
    }
    count += __popc(VP_BALLOT(in));
  }
  if (lane == 0) counts[h] = count;
}

}  // namespace

// X [N, 3], x [N, 2] (float, or double when is_double), mask [N], idx
// [n_hyp, S] int64 sample indices into [0, N), S <= 32.  Rs [n_hyp, 3, 3],
// ts [n_hyp, 3] f64; counts [n_hyp]; inl [n_hyp, N].
extern "C" int vp_pnp_hypotheses(const void* X, const void* x, const unsigned char* mask,
                                 const long long* idx, int n_hyp, int N, int S, double thr,
                                 int is_double, double* Rs, double* ts, int* counts,
                                 unsigned char* inl, cudaStream_t stream) {
  if (S > 32) return (int)cudaErrorInvalidValue;
  if (n_hyp <= 0) return (int)cudaSuccess;
  const int grid = (n_hyp + kWarps - 1) / kWarps;
  if (is_double)
    VP_LAUNCH(pnp_kernel<double>, grid, kWarps * 32, 0, stream, (const double*)X,
              (const double*)x, mask, idx, n_hyp, N, S, thr, Rs, ts, counts, inl);
  else
    VP_LAUNCH(pnp_kernel<float>, grid, kWarps * 32, 0, stream, (const float*)X,
              (const float*)x, mask, idx, n_hyp, N, S, thr, Rs, ts, counts, inl);
  return (int)cudaGetLastError();
}
