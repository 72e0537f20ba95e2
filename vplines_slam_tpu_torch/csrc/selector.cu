// K20 selector: the attention feature selector's information matrices and
// its greedy log-det pass, f64 throughout.
//
// Replaces: vplines_slam_tpu/models/selector.py:135 feature_information
//   (a vmap over candidates of a vmap over the 5 horizon states, then an
//   einsum and 25 block writes into a dense [45, 45] per candidate) and
//   :210 select_features (a lax.scan of max_features rounds, each a batched
//   45x45 slogdet of every candidate's Omega + Omega_f[i] + 1e-9 I, a masked
//   argmax and the update).
// Bound on the H100: selector_info by bytes, its [N, 45, 45] f64 output
//   (2.4 MB at N = 150); selector_greedy by operations, ~n^3 / 3 f64 FLOP
//   per LU (30 kFLOP at n = 45) for N + 1 matrices a round, but each LU is
//   a chain of 45 dependent pivot steps, so the latency of one block's
//   elimination sets a round's time.
// Design:
//   - selector_info: one block per candidate.  A thread per horizon state
//     builds its bearing factor C_k = B^T B (B = [u]x R_cw) and visibility,
//     thread 0 the landmark's W = (sum C + 1e-9 I)^-1 by the adjugate, a
//     thread per state C_k W, then the block writes the 45x45 entries:
//     C_i - C_i W C_i^T, -C_i W C_j^T on the position blocks, 0 elsewhere
//     and for a candidate seen by fewer than 2 states.  Each product and
//     sum is rounded on its own (__dmul_rn / __dadd_rn) in the order of the
//     plain twin, feature_information_plain.
//   - selector_greedy: one C entry runs every round on the stream, no host
//     sync: per round one block per candidate and one for the base factor a
//     matrix in shared memory (45^2 f64 = 16 KB) by the twin's LU (unblocked,
//     partial pivoting with the first largest |pivot|, multipliers times the
//     pivot's reciprocal), then one block takes the masked argmax (the first
//     on ties), and when the gain is positive and the round is inside the
//     device-scalar budget adds Omega_f[best] and marks it.  A round that
//     selects nothing leaves every later round identical, so it clears a
//     device flag and the later rounds' blocks return at once; candidates
//     off the mask or selected already are not factored (their gains are
//     -inf whatever their log-det).  That is 2 max_features + 1 launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxStates = 8;
constexpr int kInfoThreads = 64;
constexpr int kLuThreads = 128;
constexpr int kUpdThreads = 256;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// torch.linalg.cross
__device__ __forceinline__ void cross3(const double* a, const double* b, double* c) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}
// utils/geometry.quat_rotate: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ void qrot(const double* q, const double* v, double* out) {
  double uv[3], c[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, c);
  for (int i = 0; i < 3; ++i) out[i] = add(v[i], mul(2.0, add(mul(q[0], uv[i]), c[i])));
}
// quat_mul (Hamilton), summed left to right
__device__ __forceinline__ void qmul4(const double* q, const double* p, double* o) {
  o[0] = sub(sub(sub(mul(q[0], p[0]), mul(q[1], p[1])), mul(q[2], p[2])), mul(q[3], p[3]));
  o[1] = sub(add(add(mul(q[0], p[1]), mul(q[1], p[0])), mul(q[2], p[3])), mul(q[3], p[2]));
  o[2] = add(add(sub(mul(q[0], p[2]), mul(q[1], p[3])), mul(q[2], p[0])), mul(q[3], p[1]));
  o[3] = add(sub(add(mul(q[0], p[3]), mul(q[1], p[2])), mul(q[2], p[1])), mul(q[3], p[0]));
}
// quat_to_rot
__device__ __forceinline__ void q2r(const double* q, double* R) {
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = sub(1.0, mul(2.0, add(mul(y, y), mul(z, z))));
  R[1] = mul(2.0, sub(mul(x, y), mul(w, z)));
  R[2] = mul(2.0, add(mul(x, z), mul(w, y)));
  R[3] = mul(2.0, add(mul(x, y), mul(w, z)));
  R[4] = sub(1.0, mul(2.0, add(mul(x, x), mul(z, z))));
  R[5] = mul(2.0, sub(mul(y, z), mul(w, x)));
  R[6] = mul(2.0, sub(mul(x, z), mul(w, y)));
  R[7] = mul(2.0, add(mul(y, z), mul(w, x)));
  R[8] = sub(1.0, mul(2.0, add(mul(x, x), mul(y, y))));
}
// selector._mm3: C = A @ B, each entry ((0 + 1) + 2)
__device__ __forceinline__ void mm3(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = add(add(mul(A[3 * i], B[j]), mul(A[3 * i + 1], B[3 + j])),
                         mul(A[3 * i + 2], B[6 + j]));
}

__global__ void __launch_bounds__(kInfoThreads)
selector_info_kernel(const double* __restrict__ rays, const double* __restrict__ depths,
                     const uint8_t* __restrict__ valid, const double* __restrict__ ps,
                     const double* __restrict__ qs, const double* __restrict__ q_ic,
                     const double* __restrict__ p_ic, int nh, int o, double fov,
                     double* __restrict__ out) {
  __shared__ double s_C[kMaxStates][9], s_CW[kMaxStates][9], s_W[9];
  __shared__ int s_vis[kMaxStates], s_nvis;
  const int f = blockIdx.x, n = 9 * nh;
  for (int k = threadIdx.x; k < nh; k += blockDim.x) {
    // the landmark in the world from the observation state's pose
    double rd[3], a[3], b[3], Xw[3];
    for (int i = 0; i < 3; ++i) rd[i] = mul(rays[3 * f + i], depths[f]);
    qrot(q_ic, rd, a);
    for (int i = 0; i < 3; ++i) a[i] = add(a[i], p_ic[i]);
    qrot(qs + 4 * o, a, b);
    for (int i = 0; i < 3; ++i) Xw[i] = add(b[i], ps[3 * o + i]);
    // camera pose of state k: (q_cw, p_cw) = inverse(q_k (x) q_ic, p_k + R_k p_ic)
    double qwc[4], pwc[3], qcw[4], t[3], pcw[3], Xc[3];
    qmul4(qs + 4 * k, q_ic, qwc);
    qrot(qs + 4 * k, p_ic, t);
    for (int i = 0; i < 3; ++i) pwc[i] = add(t[i], ps[3 * k + i]);
    qcw[0] = qwc[0];
    for (int i = 1; i < 4; ++i) qcw[i] = -qwc[i];
    qrot(qcw, pwc, t);
    for (int i = 0; i < 3; ++i) pcw[i] = -t[i];
    qrot(qcw, Xw, t);
    for (int i = 0; i < 3; ++i) Xc[i] = add(t[i], pcw[i]);
    const double z = Xc[2];
    const bool vis = (k >= o) && (z > 0.2) && (fabs(Xc[0] / z) < fov) && (fabs(Xc[1] / z) < fov);
    double nrm = sqrt(add(add(mul(Xc[0], Xc[0]), mul(Xc[1], Xc[1])), mul(Xc[2], Xc[2])));
    nrm = nrm < 1e-9 ? 1e-9 : nrm;
    double u[3], S[9], R[9], B[9], Bt[9], C[9];
    for (int i = 0; i < 3; ++i) u[i] = Xc[i] / nrm;
    S[0] = 0.0, S[1] = -u[2], S[2] = u[1];
    S[3] = u[2], S[4] = 0.0, S[5] = -u[0];
    S[6] = -u[1], S[7] = u[0], S[8] = 0.0;
    q2r(qcw, R);
    mm3(S, R, B);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Bt[3 * i + j] = B[3 * j + i];
    mm3(Bt, B, C);
    const double w = (vis && valid[f]) ? 1.0 : 0.0;
    for (int e = 0; e < 9; ++e) s_C[k][e] = mul(C[e], w);
    s_vis[k] = vis;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nv = 0;
    double E[9];
    for (int e = 0; e < 9; ++e) E[e] = s_C[0][e];
    for (int k = 0; k < nh; ++k) nv += s_vis[k];
    for (int k = 1; k < nh; ++k)
      for (int e = 0; e < 9; ++e) E[e] = add(E[e], s_C[k][e]);
    for (int i = 0; i < 3; ++i) E[4 * i] = add(E[4 * i], 1e-9);
    // selector._inv3: the adjugate over the first-row expansion
    const double a = E[0], b = E[1], c = E[2], d = E[3], e = E[4], f6 = E[5], g = E[6],
                 h = E[7], i = E[8];
    const double c00 = sub(mul(e, i), mul(f6, h)), c01 = sub(mul(c, h), mul(b, i)),
                 c02 = sub(mul(b, f6), mul(c, e));
    const double c10 = sub(mul(f6, g), mul(d, i)), c11 = sub(mul(a, i), mul(c, g)),
                 c12 = sub(mul(c, d), mul(a, f6));
    const double c20 = sub(mul(d, h), mul(e, g)), c21 = sub(mul(b, g), mul(a, h)),
                 c22 = sub(mul(a, e), mul(b, d));
    const double det = add(add(mul(a, c00), mul(b, c10)), mul(c, c20));
    const double adj[9] = {c00, c01, c02, c10, c11, c12, c20, c21, c22};
    for (int k = 0; k < 9; ++k) s_W[k] = adj[k] / det;
    s_nvis = nv;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nh; k += blockDim.x) mm3(s_C[k], s_W, s_CW[k]);
  __syncthreads();
  const bool keep = s_nvis >= 2;
  double* o_f = out + (size_t)f * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int r = idx / n, c = idx % n;
    const int si = r / 9, a = r % 9, sj = c / 9, b = c % 9;
    double v = 0.0;
    if (keep && a < 3 && b < 3) {
      const double* cw = s_CW[si] + 3 * a;
      const double* cj = s_C[sj] + 3 * b;  // row b of C_j = column b of C_j^T
      const double d = add(add(mul(cw[0], cj[0]), mul(cw[1], cj[1])), mul(cw[2], cj[2]));
      v = sub(si == sj ? s_C[si][3 * a + b] : 0.0, d);
    }
    o_f[idx] = v;
  }
}

__global__ void greedy_init_kernel(const double* __restrict__ prior, double* __restrict__ omega,
                                   uint8_t* __restrict__ selected, int* __restrict__ active,
                                   int N, int dim) {
  for (int e = threadIdx.x; e < dim * dim; e += blockDim.x) omega[e] = prior[e];
  for (int i = threadIdx.x; i < N; i += blockDim.x) selected[i] = 0;
  if (threadIdx.x == 0) *active = 1;
}

// log|det| of Omega (+ Omega_f[i]) + 1e-9 I by selector.logdet_plain's LU:
// block 0 the base, block 1 + i candidate i
__global__ void __launch_bounds__(kLuThreads)
greedy_logdet_kernel(const double* __restrict__ omega, const double* __restrict__ feats,
                     const uint8_t* __restrict__ mask, const uint8_t* __restrict__ selected,
                     const int* __restrict__ active, int round, int dim,
                     double* __restrict__ logdets) {
  VP_DYN_SMEM(double, A);
  __shared__ double s_pv[32];
  __shared__ int s_pi[32], s_p;
  __shared__ double s_ld, s_rcp;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  if (round > 0 && !*active) return;
  if (b > 0 && (!mask[b - 1] || selected[b - 1])) return;
  const double* F = b > 0 ? feats + (size_t)(b - 1) * dim * dim : nullptr;
  for (int e = tid; e < dim * dim; e += nt) {
    double m = omega[e];
    if (F) m = add(m, F[e]);
    if (e / dim == e % dim) m = add(m, 1e-9);
    A[e] = m;
  }
  if (tid == 0) s_ld = 0.0;
  __syncthreads();
  const int np = nt < 32 ? nt : 32;  // threads of the pivot search
  for (int k = 0; k < dim; ++k) {
    // the first largest |A[i][k]|, i >= k (a NaN counts as the largest)
    if (tid < np) {
      double best = -1.0;
      int bi = -1;
      for (int i = k + tid; i < dim; i += np) {
        const double v = fabs(A[i * dim + k]);
        if (bi < 0 || (isnan(v) && !isnan(best)) || v > best) best = v, bi = i;
      }
      s_pv[tid] = best;
      s_pi[tid] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      double best = s_pv[0];
      int bi = s_pi[0];
      for (int l = 1; l < np; ++l) {
        const int i = s_pi[l];
        if (i < 0) continue;
        const double v = s_pv[l];
        const bool better = (isnan(v) && !isnan(best)) || v > best ||
                            ((v == best || (isnan(v) && isnan(best))) && i < bi);
        if (bi < 0 || better) best = v, bi = i;
      }
      s_p = bi;
    }
    __syncthreads();
    const int p = s_p;
    if (p != k)
      for (int j = k + tid; j < dim; j += nt) {
        const double t = A[k * dim + j];
        A[k * dim + j] = A[p * dim + j];
        A[p * dim + j] = t;
      }
    __syncthreads();
    const double piv = A[k * dim + k];
    if (tid == 0) {
      s_ld = add(s_ld, log(fabs(piv)));
      s_rcp = 1.0 / piv;
    }
    __syncthreads();
    for (int i = k + 1 + tid; i < dim; i += nt)
      if (piv != 0.0) A[i * dim + k] = mul(A[i * dim + k], s_rcp);
    __syncthreads();
    const int m = dim - k - 1;
    for (int e = tid; e < m * m; e += nt) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      A[i * dim + j] = sub(A[i * dim + j], mul(A[i * dim + k], A[k * dim + j]));
    }
    __syncthreads();
  }
  if (tid == 0) logdets[b] = s_ld;
}

// one round's masked argmax and update; round 0 also writes the gains
__global__ void __launch_bounds__(kUpdThreads)
greedy_update_kernel(const double* __restrict__ logdets, const uint8_t* __restrict__ mask,
                     uint8_t* __restrict__ selected, const int64_t* __restrict__ budget,
                     int round, int rounds, const double* __restrict__ feats,
                     double* __restrict__ omega, double* __restrict__ gains,
                     int* __restrict__ active, int N, int dim) {
  __shared__ double s_v[kUpdThreads];
  __shared__ int s_i[kUpdThreads];
  __shared__ int s_best, s_improved;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (round > 0 && !*active) return;
  const double base = logdets[0];
  double best = 0.0;
  int bi = -1;
  for (int i = tid; i < N; i += nt) {
    const bool cand = mask[i] && !selected[i];
    if (round == 0) gains[i] = mask[i] ? sub(logdets[1 + i], base) : 0.0;
    const double g = cand ? sub(logdets[1 + i], base) : -INFINITY;
    if (bi < 0 || (isnan(g) && !isnan(best)) || g > best) best = g, bi = i;
  }
  s_v[tid] = best;
  s_i[tid] = bi;
  __syncthreads();
  if (tid == 0) {
    best = s_v[0];
    bi = s_i[0];
    for (int l = 1; l < nt && l < N; ++l) {
      const double v = s_v[l];
      const int i = s_i[l];
      const bool better = (isnan(v) && !isnan(best)) || v > best ||
                          ((v == best || (isnan(v) && isnan(best))) && i < bi);
      if (better) best = v, bi = i;
    }
    const int improved = round < rounds && best > 0.0 && (int64_t)round < *budget;
    s_best = bi;
    s_improved = improved;
    if (improved) selected[bi] = 1;
    else *active = 0;
  }
  __syncthreads();
  if (s_improved) {
    const double* F = feats + (size_t)s_best * dim * dim;
    for (int e = tid; e < dim * dim; e += nt) omega[e] = add(omega[e], F[e]);
  }
}

}  // namespace

// rays [N, 3], depths [N], valid [N], ps [nh, 3], qs [nh, 4], q_ic [4],
// p_ic [3], all f64; out [N, 9 nh, 9 nh] f64.
extern "C" int vp_selector_info(const double* rays, const double* depths, const uint8_t* valid,
                                const double* ps, const double* qs, const double* q_ic,
                                const double* p_ic, int N, int nh, int obs_frame, double fov,
                                double* out, cudaStream_t stream) {
  if (nh > kMaxStates) return (int)cudaErrorInvalidValue;
  VP_LAUNCH(selector_info_kernel, N, kInfoThreads, 0, stream, rays, depths, valid, ps, qs, q_ic,
            p_ic, nh, obs_frame, fov, out);
  return (int)cudaGetLastError();
}

// prior [dim, dim], feats [N, dim, dim] f64, mask [N], budget [1] int64 (a
// device scalar); out selected [N] (0/1), gains [N] f64 (the first round's,
// 0 off the mask); scratch omega [dim, dim], logdets [N + 1], active [1].
extern "C" int vp_selector_greedy(const double* prior, const double* feats, const uint8_t* mask,
                                  const int64_t* budget, int N, int dim, int rounds,
                                  uint8_t* selected, double* gains, double* omega,
                                  double* logdets, int* active, cudaStream_t stream) {
  const size_t smem = (size_t)dim * dim * sizeof(double);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  VP_LAUNCH(greedy_init_kernel, 1, kUpdThreads, 0, stream, prior, omega, selected, active, N,
            dim);
  int err = (int)cudaGetLastError();
  const int n_rounds = rounds > 0 ? rounds : 1;  // round 0 gives the gains
  for (int r = 0; r < n_rounds && err == 0; ++r) {
    VP_LAUNCH(greedy_logdet_kernel, N + 1, kLuThreads, smem, stream, omega, feats, mask,
              selected, active, r, dim, logdets);
    VP_LAUNCH(greedy_update_kernel, 1, kUpdThreads, 0, stream, logdets, mask, selected, budget,
              r, rounds, feats, omega, gains, active, N, dim);
    err = (int)cudaGetLastError();
  }
  return err;
}
