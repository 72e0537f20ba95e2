// K4 ransac_essential: the whole fixed-trial essential-matrix RANSAC of one
// frame pair in one launch -- the sample masks, the n_hyp eight-point fits
// and their rank-2 projections, the Sampson scores of every hypothesis over
// all N tracks, the first-max pick, the least-squares refit on the winner's
// inliers and its score, and the choice between the two; with min_valid,
// the tracker's gate (fewer valid tracks: the mask itself comes back).
//
// Replaces: vplines_slam_tpu/ops/mvg.py:278 ransac_essential (the vmapped
//   hyp over eight_point_essential :159, score :307 vmapped at :317, the
//   argmax, the refit :323-325 and the wheres :326-328) and the lax.cond
//   around it in vplines_slam_tpu/models/feature_tracker.py:116.  On the
//   TPU: a batched 9x9 eigh and 3x3 SVD for the hypotheses and again for
//   the refit, vmapped matmuls for the scores.
// Bound on the H100: latency.  The work is ~0.1 MFLOP of f64 and ~0.1 MFLOP
//   of f32 over a few KB, nanoseconds at either rate or at the memory's;
//   the time is the chain of dependent steps: the fits, a barrier, the
//   scores, a barrier, the refit's sums, its 9x9 eigensolve, its score.
// Design: one CTA of 512 threads, no atomics, every sum in a fixed order
//   (two calls agree to the bit).
//   Stage 0: a ballot scan of the mask gives the stable valid-first order
//     and n_valid; below min_valid the CTA writes inl = mask, E = 0, n =
//     n_valid and returns.
//   Stage 1: eight lanes a hypothesis (64 groups).  Lane j takes draw j,
//     remapped as the reference does (the (draw mod max(n_valid, 8))-th
//     valid entry, none past n_valid; a repeated entry once), and holds its
//     row kron(h2, h1) of A in f64 whatever the input type: column j of the
//     9x8 A^T.  A Householder QR of A^T (step k: lane k's column reflected,
//     its vector broadcast by shuffles within the group, the later columns
//     updated in their own lanes), then the eight reflections applied
//     backwards to e_9, give Q's last column: a unit null vector of A, the
//     smallest eigenvector of A^T A.  A sample of fewer than 8 distinct
//     valid rows leaves zero columns (identity reflections) and gets one
//     vector of its null space, as eigh gets one of its own.  The rank-2
//     projection: the 3x3 eigenproblem of E^T E by cyclic Jacobi, v_1, v_2
//     of its two largest eigenvalues, u_i = E v_i / |E v_i|, E' = u_1 v_1^T
//     + u_2 v_2^T = U diag(1, 1, 0) V^T whatever the SVD's signs; E' is
//     rounded to the input type.
//   Stage 2: a warp scores up to four hypotheses, a lane a track, in the
//     input type, every operation rounded on its own in sampson_score_plain's
//     order; ballots give 32-bit inlier words and popc the counts.
//   Stage 3: every warp takes the first maximum of the counts (redux.sync
//     of count << 8 | 255 - h); 45 x 8 threads sum the entries of the
//     refit's A^T A over eighths of the winner's inliers in f64, 45 threads
//     add the eighths in order; warp 0 solves the 9x9 eigenproblem
//     (vp::jacobi_eig, padded to 10; the smallest eigenvalue's vector),
//     projects and rounds E_ref; all warps score it; better = n_ref >=
//     counts[best] picks E and the inliers, n = max(n_ref, counts[best]).
//   With Es_hyp set (the checks), each hypothesis's E, count and inliers
//   and the refit's E are written too.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                   // lanes a hypothesis's fit
constexpr int kMaxHyp = kThreads / kGroup;  // 64
constexpr int kMaxN = 1024;
constexpr int kMaxWords = kMaxN / 32;
constexpr int kEntries = 45;  // of a symmetric 9x9 matrix
constexpr int kChunks = 8;    // the refit's sums: an eighth of the tracks a thread

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// sampson_score_plain's test for one track: E h1 and E^T h2 (rows), the
// residual h2 . E h1, then num^2 / (|(E h1)_01|^2 + |(E^T h2)_01|^2 + 1e-18)
// < thr^2, every operation rounded on its own in that order
template <typename T>
__device__ __forceinline__ bool sampson_inlier(const T* E, T u1, T v1, T u2, T v2, T thr2) {
  const T e0 = add_rn(add_rn(mul_rn(E[0], u1), mul_rn(E[1], v1)), E[2]);
  const T e1 = add_rn(add_rn(mul_rn(E[3], u1), mul_rn(E[4], v1)), E[5]);
  const T e2 = add_rn(add_rn(mul_rn(E[6], u1), mul_rn(E[7], v1)), E[8]);
  const T f0 = add_rn(add_rn(mul_rn(E[0], u2), mul_rn(E[3], v2)), E[6]);
  const T f1 = add_rn(add_rn(mul_rn(E[1], u2), mul_rn(E[4], v2)), E[7]);
  const T num = add_rn(add_rn(mul_rn(u2, e0), mul_rn(v2, e1)), e2);
  const T den = add_rn(add_rn(add_rn(add_rn(mul_rn(e0, e0), mul_rn(e1, e1)), mul_rn(f0, f0)),
                              mul_rn(f1, f1)),
                       (T)1e-18);
  return div_rn(mul_rn(num, num), den) < thr2;
}

// one Jacobi rotation of the symmetric 3x3 A zeroing A[p][q] (the rotation
// of vp::jacobi_step), V <- V J
template <int p, int q>
__device__ __forceinline__ void rot3(double (&A)[3][3], double (&V)[3][3]) {
  const double apq = A[p][q];
  if (apq == 0.0) return;
  const double dd = A[q][q] - A[p][p], e = 2.0 * apq;
  const double rh = rsqrt(dd * dd + e * e);
  const double w = 0.5 + 0.5 * (fabs(dd) * rh);
  const double ic = rsqrt(w);
  const double c = w * ic, s = (dd >= 0.0 ? 0.5 : -0.5) * (e * rh) * ic;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double ap = A[i][p], aq = A[i][q], vp = V[i][p], vq = V[i][q];
    A[i][p] = c * ap - s * aq;
    A[i][q] = s * ap + c * aq;
    V[i][p] = c * vp - s * vq;
    V[i][q] = s * vp + c * vq;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double ap = A[p][i], aq = A[q][i];
    A[p][i] = c * ap - s * aq;
    A[q][i] = s * ap + c * aq;
  }
}

__device__ __forceinline__ double col3(const double (&V)[3][3], int r, int i) {
  return i == 0 ? V[r][0] : (i == 1 ? V[r][1] : V[r][2]);
}

// E (row-major, unit) -> U diag(1, 1, 0) V^T in T
template <typename T>
__device__ __forceinline__ void project_rank2(const double (&E)[9], T (&out)[9]) {
  double A[3][3], V[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      A[a][b] = fma(E[6 + a], E[6 + b], fma(E[3 + a], E[3 + b], E[a] * E[b]));
      V[a][b] = a == b ? 1.0 : 0.0;
    }
  double prev = INFINITY;
  for (int sweep = 0; sweep < vp::kJacobiMaxSweeps; ++sweep) {
    const double off = A[0][1] * A[0][1] + A[0][2] * A[0][2] + A[1][2] * A[1][2];
    const double diag = A[0][0] * A[0][0] + A[1][1] * A[1][1] + A[2][2] * A[2][2];
    if (off <= 1e-32 * diag || off == 0.0 || (off <= 1e-20 * diag && off >= 0.5 * prev)) break;
    prev = off;
    rot3<0, 1>(A, V);
    rot3<0, 2>(A, V);
    rot3<1, 2>(A, V);
  }
  // the two largest eigenvalues (the lower index first on a tie)
  const double l0 = A[0][0], l1 = A[1][1], l2 = A[2][2];
  const int i1 = l1 > l0 ? (l2 > l1 ? 2 : 1) : (l2 > l0 ? 2 : 0);
  const int ja = i1 == 0 ? 1 : 0, jb = i1 == 2 ? 1 : 2;
  const double la = ja == 0 ? l0 : l1, lb = jb == 1 ? l1 : l2;
  const int i2 = lb > la ? jb : ja;
  double v1[3], v2[3], u1[3], u2[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    v1[r] = col3(V, r, i1);
    v2[r] = col3(V, r, i2);
  }
  double n1 = 0.0, n2 = 0.0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u1[r] = fma(E[3 * r + 2], v1[2], fma(E[3 * r + 1], v1[1], E[3 * r] * v1[0]));
    u2[r] = fma(E[3 * r + 2], v2[2], fma(E[3 * r + 1], v2[1], E[3 * r] * v2[0]));
    n1 = fma(u1[r], u1[r], n1);
    n2 = fma(u2[r], u2[r], n2);
  }
  const double s1 = n1 > 0.0 ? 1.0 / sqrt(n1) : 0.0, s2 = n2 > 0.0 ? 1.0 / sqrt(n2) : 0.0;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * r + c] = (T)fma(u2[r] * s2, v2[c], (u1[r] * s1) * v1[c]);
}

// which of (u, v, 1) entry i of a homogeneous point is
__device__ __forceinline__ double hom(int i, double u, double v) {
  return i == 0 ? u : (i == 1 ? v : 1.0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ransac_kernel(const T* __restrict__ x1, int s1, const T* __restrict__ x2, int s2,
              const unsigned char* __restrict__ mask, const long long* __restrict__ idx,
              int n_hyp, int N, T thr2, int min_valid, T* __restrict__ E_out,
              unsigned char* __restrict__ inl_out, int* __restrict__ n_out,
              T* __restrict__ Es_hyp, int* __restrict__ counts_hyp,
              unsigned char* __restrict__ inl_hyp, T* __restrict__ Eref_hyp) {
  __shared__ int s_order[kMaxN];  // the valid entries in index order
  __shared__ int s_warp[kWarps];
  __shared__ unsigned s_words[kMaxHyp][kMaxWords];  // each hypothesis's inlier bits
  __shared__ int s_count[kMaxHyp];
  __shared__ T s_E[kMaxHyp][9];
  __shared__ double s_part[kEntries][kChunks];
  __shared__ double s_AtA[kEntries];
  __shared__ T s_Eref[9];
  __shared__ unsigned s_refwords[kMaxWords];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_words = (N + 31) >> 5;

  // ---- stage 0: the stable valid-first order and n_valid
  int n_valid = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int t = base + tid;
    const bool valid = t < N && mask[t] != 0;
    const unsigned b = VP_BALLOT(valid);
    if (lane == 0) s_warp[warp] = __popc(b);
    __syncthreads();
    int before = n_valid, total = n_valid;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (valid) s_order[before + __popc(b & ((1u << lane) - 1u))] = t;
    n_valid = total;
    __syncthreads();
  }
  if (n_valid < min_valid) {  // the tracker's gate (the reference's lax.cond)
    for (int t = tid; t < N; t += kThreads) inl_out[t] = mask[t] != 0;
    if (tid < 9) E_out[tid] = (T)0;
    if (tid == 0) *n_out = n_valid;
    if (Es_hyp != nullptr) {
      for (int t = tid; t < n_hyp * 9; t += kThreads) Es_hyp[t] = (T)0;
      for (int t = tid; t < n_hyp; t += kThreads) counts_hyp[t] = 0;
      for (int t = tid; t < n_hyp * N; t += kThreads) inl_hyp[t] = 0;
      if (tid < 9) Eref_hyp[tid] = (T)0;
    }
    return;
  }

  // ---- stage 1: the eight-point fits, eight lanes a hypothesis
  const int group = tid / kGroup, gl = tid % kGroup, gbase = lane & ~(kGroup - 1);
  if (warp * (32 / kGroup) < n_hyp) {  // a group past n_hyp repeats the last, unwritten
    const int h = min(group, n_hyp - 1);
    const long long m = max(n_valid, 8);
    long long k = idx[(size_t)h * 8 + gl] % m;
    if (k < 0) k += m;
    const int id = k < n_valid ? s_order[k] : -1;
    bool live = id >= 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int o = VP_SHFL_IDX(id, gbase + j);
      live = live && !(j < gl && o == id);
    }
    // column gl of A^T: the draw's row kron(h2, h1), zero if not live
    double col[9];
    {
      double u1 = 0.0, v1 = 0.0, u2 = 0.0, v2 = 0.0, one = 0.0;
      if (live) {
        u1 = (double)x1[(size_t)id * s1];
        v1 = (double)x1[(size_t)id * s1 + 1];
        u2 = (double)x2[(size_t)id * s2];
        v2 = (double)x2[(size_t)id * s2 + 1];
        one = 1.0;
      }
      const double h1[3] = {u1, v1, one}, h2[3] = {u2, v2, one};
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) col[3 * a + b] = h2[a] * h1[b];
    }
    // Householder QR of A^T: after step k lane k holds its reflection
    // vector (entries k..8) and beta_own = 2 / |v|^2
    double beta_own = 0.0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      double nrm2 = 0.0;
#pragma unroll
      for (int i = k; i < 9; ++i) nrm2 = fma(col[i], col[i], nrm2);
      const double alpha = col[k] >= 0.0 ? -sqrt(nrm2) : sqrt(nrm2);
      const double beta = nrm2 > 0.0 ? 1.0 / (nrm2 - alpha * col[k]) : 0.0;
      const int src = gbase + k;
      const double b = VP_SHFL_IDX(beta, src);
      double v[9];
#pragma unroll
      for (int i = k; i < 9; ++i) v[i] = VP_SHFL_IDX(i == k ? col[k] - alpha : col[i], src);
      if (gl > k) {
        double w = 0.0;
#pragma unroll
        for (int i = k; i < 9; ++i) w = fma(v[i], col[i], w);
        const double sw = b * w;
#pragma unroll
        for (int i = k; i < 9; ++i) col[i] = fma(-sw, v[i], col[i]);
      } else if (gl == k) {
#pragma unroll
        for (int i = k; i < 9; ++i) col[i] = v[i];
        beta_own = b;
      }
    }
    // Q e_9 = H_0 H_1 ... H_7 e_9, the same in every lane of the group
    double y[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) y[i] = i == 8 ? 1.0 : 0.0;
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      const int src = gbase + k;
      const double b = VP_SHFL_IDX(beta_own, src);
      double v[9], w = 0.0;
#pragma unroll
      for (int i = k; i < 9; ++i) {
        v[i] = VP_SHFL_IDX(col[i], src);
        w = fma(v[i], y[i], w);
      }
      const double sw = b * w;
#pragma unroll
      for (int i = k; i < 9; ++i) y[i] = fma(-sw, v[i], y[i]);
    }
    T Eh[9];
    project_rank2(y, Eh);
    if (group < n_hyp && gl == 0) {
#pragma unroll
      for (int c = 0; c < 9; ++c) s_E[group][c] = Eh[c];
      if (Es_hyp != nullptr) {
#pragma unroll
        for (int c = 0; c < 9; ++c) Es_hyp[(size_t)group * 9 + c] = Eh[c];
      }
    }
  }
  __syncthreads();

  // ---- stage 2: the scores, a warp up to four hypotheses, a lane a track
  int cnt[4] = {0, 0, 0, 0};
  for (int t0 = 0; t0 < N; t0 += 32) {
    const int n = t0 + lane;
    T u1 = 0, v1 = 0, u2 = 0, v2 = 0;
    bool valid = false;
    if (n < N) {
      u1 = x1[(size_t)n * s1];
      v1 = x1[(size_t)n * s1 + 1];
      u2 = x2[(size_t)n * s2];
      v2 = x2[(size_t)n * s2 + 1];
      valid = mask[n] != 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = warp + kWarps * j;
      if (h < n_hyp) {
        const bool in = valid && sampson_inlier(s_E[h], u1, v1, u2, v2, thr2);
        const unsigned b = VP_BALLOT(in);
        if (lane == 0) s_words[h][t0 >> 5] = b;
        cnt[j] += __popc(b);
        if (inl_hyp != nullptr && n < N) inl_hyp[(size_t)h * N + n] = in;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = warp + kWarps * j;
      if (h < n_hyp) {
        s_count[h] = cnt[j];
        if (counts_hyp != nullptr) counts_hyp[h] = cnt[j];
      }
    }
  }
  __syncthreads();

  // ---- stage 3: the first maximum (in every warp), the refit, the choice
  unsigned key = 0u;
  if (lane < n_hyp) key = ((unsigned)s_count[lane] << 8) | (255u - lane);
  if (lane + 32 < n_hyp)
    key = max(key, ((unsigned)s_count[lane + 32] << 8) | (255u - (lane + 32)));
  key = VP_REDUX_MAX(key);
  const int best = 255 - (int)(key & 255u), n_best = (int)(key >> 8);
  if (tid < kEntries * kChunks) {
    const int e = tid / kChunks, c = tid % kChunks;
    int a = 0, rest = e;
    while (rest >= 9 - a) rest -= 9 - a++;
    const int b = a + rest;
    const int len = (N + kChunks - 1) / kChunks, n0 = c * len, n1 = min(N, n0 + len);
    double sum = 0.0;
    for (int n = n0; n < n1; ++n) {
      if ((s_words[best][n >> 5] >> (n & 31)) & 1u) {
        const double u1 = (double)x1[(size_t)n * s1], v1 = (double)x1[(size_t)n * s1 + 1];
        const double u2 = (double)x2[(size_t)n * s2], v2 = (double)x2[(size_t)n * s2 + 1];
        const double ra = hom(a / 3, u2, v2) * hom(a % 3, u1, v1);
        const double rb = hom(b / 3, u2, v2) * hom(b % 3, u1, v1);
        sum = fma(ra, rb, sum);
      }
    }
    s_part[e][c] = sum;
  }
  __syncthreads();
  if (tid < kEntries) {
    double s = 0.0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) s += s_part[tid][c];
    s_AtA[tid] = s;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kN = 10;  // the 9 unknowns and a zero row
    const int r = lane < kN ? lane : kN - 1;
    double a[kN], v[kN];
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      const int lo = min(r, c), hi = max(r, c);
      a[c] = hi < 9 ? s_AtA[lo * 9 - lo * (lo - 1) / 2 + hi - lo] : 0.0;
      v[c] = c == r ? 1.0 : 0.0;
    }
    vp::jacobi_eig<kN>(a, v, r, lane);
    const int kmin = vp::jacobi_min_index<kN>(a, r, lane, 9);
    const double ve = vp::pick(v, kmin);  // entry r of the eigenvector in lane r
    double e[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) e[c] = VP_SHFL_IDX(ve, c);
    T Er[9];
    project_rank2(e, Er);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 9; ++c) s_Eref[c] = Er[c];
    }
  }
  __syncthreads();
  if (Eref_hyp != nullptr && tid < 9) Eref_hyp[tid] = s_Eref[tid];
  for (int w0 = warp; w0 < n_words; w0 += kWarps) {
    const int n = w0 * 32 + lane;
    bool in = false;
    if (n < N && mask[n] != 0)
      in = sampson_inlier(s_Eref, x1[(size_t)n * s1], x1[(size_t)n * s1 + 1], x2[(size_t)n * s2],
                          x2[(size_t)n * s2 + 1], thr2);
    const unsigned b = VP_BALLOT(in);
    if (lane == 0) s_refwords[w0] = b;
  }
  __syncthreads();
  int n_ref = 0;
  for (int w0 = 0; w0 < n_words; ++w0) n_ref += __popc(s_refwords[w0]);
  const bool better = n_ref >= n_best;
  for (int t = tid; t < N; t += kThreads)
    inl_out[t] = ((better ? s_refwords[t >> 5] : s_words[best][t >> 5]) >> (t & 31)) & 1u;
  if (tid < 9) E_out[tid] = better ? s_Eref[tid] : s_E[best][tid];
  if (tid == 0) *n_out = max(n_ref, n_best);
}

}  // namespace

// x1, x2 [N, 2] (float, or double when is_double) with row strides s1, s2
// (elements; the two entries of a row adjacent), mask [N], idx [n_hyp, 8]
// int64 draws, n_hyp <= 64, 1 <= N <= 1024.  E_out [3, 3], inl_out [N]
// (0/1 bytes), n_out [1]; Es_hyp [n_hyp, 3, 3], counts_hyp [n_hyp],
// inl_hyp [n_hyp, N] and Eref_hyp [3, 3] (the refit's E) are written when
// Es_hyp is not null.
extern "C" int vp_ransac_essential(const void* x1, int s1, const void* x2, int s2,
                                   const unsigned char* mask, const long long* idx, int n_hyp,
                                   int N, double thr, int min_valid, int is_double, void* E_out,
                                   unsigned char* inl_out, int* n_out, void* Es_hyp,
                                   int* counts_hyp, unsigned char* inl_hyp, void* Eref_hyp,
                                   cudaStream_t stream) {
  if (n_hyp < 1 || n_hyp > kMaxHyp || N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  const double thr2 = thr * thr;
  if (is_double)
    VP_LAUNCH(ransac_kernel<double>, 1, kThreads, 0, stream, (const double*)x1, s1,
              (const double*)x2, s2, mask, idx, n_hyp, N, thr2, min_valid, (double*)E_out,
              inl_out, n_out, (double*)Es_hyp, counts_hyp, inl_hyp, (double*)Eref_hyp);
  else
    VP_LAUNCH(ransac_kernel<float>, 1, kThreads, 0, stream, (const float*)x1, s1,
              (const float*)x2, s2, mask, idx, n_hyp, N, (float)thr2, min_valid, (float*)E_out,
              inl_out, n_out, (float*)Es_hyp, counts_hyp, inl_hyp, (float*)Eref_hyp);
  return (int)cudaGetLastError();
}
