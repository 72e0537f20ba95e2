// K21 pnp_refine: Gauss-Newton refinement of a batch of PnP poses, all
// iterations in one launch, f64 inside.
//
// Replaces: vplines_slam_tpu/ops/mvg.py:213 pnp_refine, a fori_loop of
//   `iters` steps, each jacfwd of the whole [2N] reprojection residual in
//   (w, t) with R = exp(w) R0, the 6x6 normal equations and a solve; the
//   initializer vmaps it over the window's frames.  In plain PyTorch every
//   step is ~350 launches, 1,700 per loop verification.
// Bound on the H100: operations, and latency: per problem and step ~N x 600
//   f64 FLOP of jets and sums (N <= 128), then a 6x6 solve whose result the
//   next step needs, so a problem is a chain of `iters` dependent reductions.
// Design: one warp per problem (a block of 32 threads).  Each lane builds
//   R = exp(w) R0 and t as jets in the 6 parameters (forward mode, Jet<double,
//   6> of common.cuh, the so3_exp_quat formula with its small-angle branch:
//   w is not reset between steps, so from the second step on the Jacobian is
//   taken at w != 0), then strides over the points: r = (proj(R X + t) - x)
//   times the mask (a masked point's NaN stays the twin's NaN), its 2x6
//   Jacobian from the tangents, and the lane's share of J^T J (upper 21) and
//   J^T r.  A butterfly of shuffles sums the 27 values in a fixed order;
//   lane 0's totals go to every lane, which solve (J^T J + 1e-8 I) d = J^T r
//   by Gaussian elimination with partial pivoting (a singular system gives
//   non-finite values, as the twin's solve_ex) and step the parameters.
//   Inputs are f32 or f64; the arithmetic is f64 and the pose is written in
//   the input type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kP = 6;          // parameters: w (3), t (3)
constexpr int kSums = 21 + 6;  // upper J^T J, then J^T r
using J6 = Jet<double, kP>;

__device__ __forceinline__ void solve6(double (&A)[kP][kP], double (&b)[kP], double (&x)[kP]) {
  for (int k = 0; k < kP; ++k) {
    int p = k;
    for (int i = k + 1; i < kP; ++i)
      if (fabs(A[i][k]) > fabs(A[p][k])) p = i;
    if (p != k) {
      for (int j = 0; j < kP; ++j) {
        const double t = A[k][j];
        A[k][j] = A[p][j];
        A[p][j] = t;
      }
      const double t = b[k];
      b[k] = b[p];
      b[p] = t;
    }
    for (int i = k + 1; i < kP; ++i) {
      const double l = A[i][k] / A[k][k];
      for (int j = k; j < kP; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
  for (int k = kP - 1; k >= 0; --k) {
    double s = b[k];
    for (int j = k + 1; j < kP; ++j) s -= A[k][j] * x[j];
    x[k] = s / A[k][k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pnp_refine_kernel(const T* __restrict__ R0, const T* __restrict__ t0, const T* __restrict__ X,
                  long long x_batch_stride, const T* __restrict__ x,
                  const uint8_t* __restrict__ mask, int N, int iters, T* __restrict__ R_out,
                  T* __restrict__ t_out) {
  const int b = blockIdx.x, lane = threadIdx.x, nl = blockDim.x;
  double r0[9];
  for (int e = 0; e < 9; ++e) r0[e] = (double)R0[9 * b + e];
  double prm[kP] = {0.0, 0.0, 0.0, (double)t0[3 * b], (double)t0[3 * b + 1],
                    (double)t0[3 * b + 2]};
  const T* Xb = X + (size_t)b * x_batch_stride;
  const T* xb = x + (size_t)b * N * 2;
  const uint8_t* mb = mask + (size_t)b * N;
  for (int it = 0; it < iters; ++it) {
    const V3<double, kP> w = {seed<double, kP>(prm[0], 0), seed<double, kP>(prm[1], 1),
                              seed<double, kP>(prm[2], 2)};
    J6 Rw[3][3], R[3][3];
    qtorot(so3_exp(w), Rw);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        R[i][j] = Rw[i][0] * r0[j] + Rw[i][1] * r0[3 + j] + Rw[i][2] * r0[6 + j];
    const J6 t[3] = {seed<double, kP>(prm[3], 3), seed<double, kP>(prm[4], 4),
                     seed<double, kP>(prm[5], 5)};
    double acc[kSums];
    for (int s = 0; s < kSums; ++s) acc[s] = 0.0;
    for (int n = lane; n < N; n += nl) {
      const double X0 = (double)Xb[3 * n], X1 = (double)Xb[3 * n + 1], X2 = (double)Xb[3 * n + 2];
      J6 Xc[3];
      for (int i = 0; i < 3; ++i) Xc[i] = R[i][0] * X0 + R[i][1] * X1 + R[i][2] * X2 + t[i];
      const double m = mb[n] ? 1.0 : 0.0;
      const J6 e0 = (Xc[0] / Xc[2] - (double)xb[2 * n]) * m;
      const J6 e1 = (Xc[1] / Xc[2] - (double)xb[2 * n + 1]) * m;
      int s = 0;
      for (int a = 0; a < kP; ++a)
        for (int c = a; c < kP; ++c) acc[s++] += e0.v[a] * e0.v[c] + e1.v[a] * e1.v[c];
      for (int a = 0; a < kP; ++a) acc[s++] += e0.v[a] * e0.a + e1.v[a] * e1.a;
    }
    for (int s = 0; s < kSums; ++s) {
      double v = acc[s];
      for (int o = 16; o > 0; o >>= 1) v += VP_SHFL_XOR(v, o);
      acc[s] = VP_SHFL_IDX(v, 0);
    }
    double H[kP][kP], g[kP], d[kP];
    int s = 0;
    for (int a = 0; a < kP; ++a)
      for (int c = a; c < kP; ++c, ++s) H[a][c] = H[c][a] = acc[s];
    for (int a = 0; a < kP; ++a) {
      g[a] = acc[s++];
      H[a][a] += 1e-8;
    }
    solve6(H, g, d);
    for (int a = 0; a < kP; ++a) prm[a] -= d[a];
  }
  if (lane == 0) {
    const V3<double, 0> w = {cst<double, 0>(prm[0]), cst<double, 0>(prm[1]),
                             cst<double, 0>(prm[2])};
    Jet<double, 0> Rw[3][3];
    qtorot(so3_exp(w), Rw);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        R_out[9 * b + 3 * i + j] =
            (T)(Rw[i][0].a * r0[j] + Rw[i][1].a * r0[3 + j] + Rw[i][2].a * r0[6 + j]);
      t_out[3 * b + i] = (T)prm[3 + i];
    }
  }
}

}  // namespace

// R0 [B, 3, 3], t0 [B, 3], X [N, 3] (x_batched = 0) or [B, N, 3], x [B, N, 2]
// (float, or double when is_double), mask [B, N]; R_out [B, 3, 3], t_out
// [B, 3] in the input type.
extern "C" int vp_pnp_refine(const void* R0, const void* t0, const void* X, int x_batched,
                             const void* x, const uint8_t* mask, int B, int N, int iters,
                             int is_double, void* R_out, void* t_out, cudaStream_t stream) {
  const long long stride = x_batched ? 3LL * N : 0LL;
  if (is_double)
    VP_LAUNCH(pnp_refine_kernel<double>, B, kThreads, 0, stream, (const double*)R0,
              (const double*)t0, (const double*)X, stride, (const double*)x, mask, N, iters,
              (double*)R_out, (double*)t_out);
  else
    VP_LAUNCH(pnp_refine_kernel<float>, B, kThreads, 0, stream, (const float*)R0,
              (const float*)t0, (const float*)X, stride, (const float*)x, mask, N, iters,
              (float*)R_out, (float*)t_out);
  return (int)cudaGetLastError();
}
