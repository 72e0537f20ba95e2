// K21 pnp_refine: Gauss-Newton refinement of a batch of PnP poses, all
// iterations in one launch, f64 inside.
//
// Replaces: vplines_slam_tpu/ops/mvg.py:213 pnp_refine, a fori_loop of
//   `iters` steps, each jacfwd of the whole [2N] reprojection residual in
//   (w, t) with R = exp(w) R0, the 6x6 normal equations and a solve; the
//   initializer vmaps it over the window's frames.  In plain PyTorch every
//   step is ~350 launches, 1,700 per loop verification.
// Bound on the H100: latency.  Per problem and step ~N x 100 f64 FLOP of
//   Jacobians and sums (N <= 128), then a 6x6 solve whose result the next
//   step needs, so a problem is a chain of `iters` dependent reductions.
// Design: one warp per problem (a block of 32 threads).  Each step:
//   - every lane forms R = exp(w) R0 (the so3_exp_quat formula with its
//     small-angle branch, as the reference; w is not reset between steps)
//     and SO(3)'s left Jacobian J_l(w) = I + A [w]x + B [w]x^2 in plain f64
//     from the same half-angle sine and cosine: A = 2 k^2, B = (1 - 2 k qw) /
//     |w|^2 (1/6 in the small-angle branch), k = sin(|w|/2) / |w|;
//   - strides over the points with each point's Jacobian in closed form:
//     p = R X, Xc = p + t, a_i = d proj_i / d Xc = (1/z, 0, -u/z) or
//     (0, 1/z, -v/z), J_t = a_i and J_w = (p x a_i)^T J_l(w), which is
//     a_i^T (-[p]x J_l(w)), since exp(w + e) = exp(J_l(w) e) exp(w) to first
//     order: in exact arithmetic jacfwd of the reference's residual.  A
//     masked point's residual and Jacobian are multiplied by 0 (a padded
//     point's NaN stays the twin's NaN);
//   - sums its share of the upper 21 of J^T J and the 6 of J^T r, then a
//     reduce-scatter butterfly (each of 5 rounds halves the values a lane
//     carries: 31 shuffles) leaves sum s in lane s, in a fixed order;
//   - gathers the 27 sums into every lane (27 shuffles) and solves
//     (J^T J + 1e-8 I) d = J^T r there by Gaussian elimination with partial
//     pivoting: the pivot is the first of the largest |a| (LAPACK's rule;
//     NaN counts as the largest), rows swapped by selects so that the system
//     stays in registers, the rows below scaled by one reciprocal of the
//     pivot (__drcp_rn), reused by the back substitution.  A singular system
//     gives non-finite values, as the twin's solve_ex.  (A row a lane, the
//     pivot found by shuffles, measured slower: by clock64() stamps on the
//     H100 a step took 4,940 cycles against 4,150, its elimination and back
//     substitution 2,430 against 1,550.)
//   Inputs are f32 or f64; the arithmetic is f64 and the pose is written in
//   the input type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kP = 6;          // parameters: w (3), t (3)
constexpr int kSums = 21 + 6;  // upper J^T J, then J^T r: one lane each
static_assert(kSums <= 32, "a sum a lane");

// R = exp(w) (so3_exp_quat then quat_to_rot, as utils/geometry) and the
// left Jacobian J_l(w), in plain f64
__device__ __forceinline__ void exp_and_jacobian(const double (&w)[3], double (&Rw)[3][3],
                                                 double (&Jl)[3][3]) {
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < 1e-12;
  double k, qw, B;
  if (small) {
    k = 0.5 - th2 / 48.0;
    qw = 1.0 - th2 / 8.0;
    B = 1.0 / 6.0;
  } else {
    const double th = sqrt(th2);
    double s, c;
    sincos(th * 0.5, &s, &c);
    k = s / th;
    qw = c;
    B = (1.0 - 2.0 * k * qw) / th2;
  }
  const Q4<double, 0> q = {cst<double, 0>(qw), cst<double, 0>(k * w[0]),
                           cst<double, 0>(k * w[1]), cst<double, 0>(k * w[2])};
  Jet<double, 0> R[3][3];
  qtorot(q, R);
  const double A = 2.0 * k * k;
  // [w]x and [w]x^2 = w w^T - |w|^2 I
  const double W[3][3] = {{0.0, -w[2], w[1]}, {w[2], 0.0, -w[0]}, {-w[1], w[0], 0.0}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Rw[i][j] = R[i][j].a;
      Jl[i][j] = (i == j ? 1.0 : 0.0) + A * W[i][j] + B * (w[i] * w[j] - (i == j ? th2 : 0.0));
    }
}

// |a| with NaN above every number (the pivot order's key)
__device__ __forceinline__ double magnitude(double a) {
  const double m = fabs(a);
  return m != m ? INFINITY : m;
}

// one round of the reduce-scatter butterfly: a lane keeps the half of its
// 2H values that its bit H selects and adds its partner's copy of that half
// (H a template argument, so every index is a constant and v stays in
// registers)
template <int H>
__device__ __forceinline__ void scatter_round(double (&v)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const double send = up ? v[k] : v[k + H];
    const double keep = up ? v[k + H] : v[k];
    v[k] = keep + VP_SHFL_XOR(send, H);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pnp_refine_kernel(const T* __restrict__ R0, const T* __restrict__ t0, const T* __restrict__ X,
                  long long x_batch_stride, const T* __restrict__ x,
                  const uint8_t* __restrict__ mask, int N, int iters, T* __restrict__ R_out,
                  T* __restrict__ t_out) {
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  double r0[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) r0[e] = (double)R0[9 * b + e];
  double prm[kP] = {0.0, 0.0, 0.0, (double)t0[3 * b], (double)t0[3 * b + 1],
                    (double)t0[3 * b + 2]};
  const T* Xb = X + (size_t)b * x_batch_stride;
  const T* xb = x + (size_t)b * N * 2;
  const uint8_t* mb = mask + (size_t)b * N;
  for (int it = 0; it < iters; ++it) {
    const double w[3] = {prm[0], prm[1], prm[2]};
    double Rw[3][3], Jl[3][3], R[3][3];
    exp_and_jacobian(w, Rw, Jl);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R[i][j] = Rw[i][0] * r0[j] + Rw[i][1] * r0[3 + j] + Rw[i][2] * r0[6 + j];
    double v[32];
#pragma unroll
    for (int s = 0; s < 32; ++s) v[s] = 0.0;
    for (int n = lane; n < N; n += 32) {
      const double X0 = (double)Xb[3 * n], X1 = (double)Xb[3 * n + 1], X2 = (double)Xb[3 * n + 2];
      const double m = mb[n] ? 1.0 : 0.0;
      double p[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) p[i] = R[i][0] * X0 + R[i][1] * X1 + R[i][2] * X2;
      const double xc = p[0] + prm[3], yc = p[1] + prm[4], z = p[2] + prm[5];
      const double iz = 1.0 / z, u = xc * iz, vv = yc * iz;
      const double e[2] = {(u - (double)xb[2 * n]) * m, (vv - (double)xb[2 * n + 1]) * m};
      double J[2][kP];
      const double a[2][3] = {{iz * m, 0.0, -u * iz * m}, {0.0, iz * m, -vv * iz * m}};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // (p x a)^T J_l
        const double c[3] = {p[1] * a[r][2] - p[2] * a[r][1], p[2] * a[r][0] - p[0] * a[r][2],
                             p[0] * a[r][1] - p[1] * a[r][0]};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          J[r][j] = c[0] * Jl[0][j] + c[1] * Jl[1][j] + c[2] * Jl[2][j];
          J[r][3 + j] = a[r][j];
        }
      }
      int s = 0;
#pragma unroll
      for (int i = 0; i < kP; ++i)
#pragma unroll
        for (int j = i; j < kP; ++j) v[s++] += J[0][i] * J[0][j] + J[1][i] * J[1][j];
#pragma unroll
      for (int i = 0; i < kP; ++i) v[s++] += J[0][i] * e[0] + J[1][i] * e[1];
    }
    // reduce-scatter: lane s ends with sum s
    scatter_round<16>(v, lane);
    scatter_round<8>(v, lane);
    scatter_round<4>(v, lane);
    scatter_round<2>(v, lane);
    scatter_round<1>(v, lane);
    const double tot = v[0];
    // the system in every lane, then its elimination
    double A[kP][kP], g[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
#pragma unroll
      for (int j = i; j < kP; ++j) {
        A[i][j] = VP_SHFL_IDX(tot, 6 * i - i * (i - 1) / 2 + j - i);
        A[j][i] = A[i][j];
      }
      A[i][i] += 1e-8;
      g[i] = VP_SHFL_IDX(tot, 21 + i);
    }
    double rinv[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      int p = k;
      double best = magnitude(A[k][k]);
#pragma unroll
      for (int i = k + 1; i < kP; ++i) {
        const double m = magnitude(A[i][k]);
        if (m > best) {
          best = m;
          p = i;
        }
      }
#pragma unroll
      for (int j = k; j < kP; ++j) {
        const double ak = A[k][j];
        double ap = ak;
#pragma unroll
        for (int i = k + 1; i < kP; ++i) ap = p == i ? A[i][j] : ap;
        A[k][j] = ap;
#pragma unroll
        for (int i = k + 1; i < kP; ++i) A[i][j] = p == i ? ak : A[i][j];
      }
      {
        const double gk = g[k];
        double gp = gk;
#pragma unroll
        for (int i = k + 1; i < kP; ++i) gp = p == i ? g[i] : gp;
        g[k] = gp;
#pragma unroll
        for (int i = k + 1; i < kP; ++i) g[i] = p == i ? gk : g[i];
      }
      rinv[k] = __drcp_rn(A[k][k]);
#pragma unroll
      for (int i = k + 1; i < kP; ++i) {
        const double l = A[i][k] * rinv[k];
#pragma unroll
        for (int j = k + 1; j < kP; ++j) A[i][j] -= l * A[k][j];
        g[i] -= l * g[k];
      }
    }
    double xs[kP];  // back substitution
#pragma unroll
    for (int k = kP - 1; k >= 0; --k) {
      double r = g[k];
#pragma unroll
      for (int j = k + 1; j < kP; ++j) r -= A[k][j] * xs[j];
      xs[k] = r * rinv[k];
    }
#pragma unroll
    for (int k = 0; k < kP; ++k) prm[k] -= xs[k];
  }
  if (lane == 0) {
    const double w[3] = {prm[0], prm[1], prm[2]};
    double Rw[3][3], Jl[3][3];
    exp_and_jacobian(w, Rw, Jl);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        R_out[9 * b + 3 * i + j] =
            (T)(Rw[i][0] * r0[j] + Rw[i][1] * r0[3 + j] + Rw[i][2] * r0[6 + j]);
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
