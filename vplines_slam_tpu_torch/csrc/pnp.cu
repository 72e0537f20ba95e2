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
//   Jacobi (vp::jacobi_eig in common.cuh, shared with K4's refit):
//   round-robin pairing (the circle method: 12 indices, 11 steps a sweep,
//   every pair once), six disjoint rotations a step -- the pair's
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
constexpr int kPolarSteps = 16;

__device__ __forceinline__ double sgn(double v) { return (v > 0.0) - (v < 0.0); }

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
    const double c0 = vp::pick(r0, r), c1 = vp::pick(r1, r);
#pragma unroll
    for (int c = 0; c < kN; ++c) a[c] += c0 * r0[c] + c1 * r1[c];
  }
  // the eigensolve
  vp::jacobi_eig<kN>(a, v, r, lane);
  // the smallest eigenvalue's column (the lowest index on a tie)
  const int kmin = vp::jacobi_min_index<kN>(a, r, lane, kN);
  const double pe = vp::pick(v, kmin);  // P[r / 4][r % 4] in lane r < 12
  double P[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) P[c] = VP_SHFL_IDX(pe, c);
  // sign: the summed depths of the sample points positive
  const double dep = live ? P[8] * px + P[9] * py + P[10] * pz + P[11] : 0.0;
  const double sign = sgn(vp::warp_sum64(dep) + 1e-30);
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
  if (lane < 9) Rs[(size_t)h * 9 + lane] = vp::pick(R, lane);
  if (lane < 3) ts[(size_t)h * 3 + lane] = vp::pick(t, lane);
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
