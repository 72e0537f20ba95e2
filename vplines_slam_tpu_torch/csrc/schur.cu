// K13 schur: the damped, Jacobi-scaled Schur solve of the window's block
// normal equations, in f64.
//
// Replaces: vplines_slam_tpu/solver/lm.py:302 schur_solve_blocks (the port's
//   plain twin: solver/lm.schur_solve_blocks_plain).  Scalar point blocks
//   (wp = 1 / h_p, scaled and damped) and 4x4 line blocks (their inverse,
//   written out by Gauss-Jordan) are eliminated onto the dense block:
//   S = H_dd - Hdp diag(wp) Hdpᵀ - sum_l Hdl_l W_l Hdl_lᵀ, then a Cholesky
//   of S, forward and back substitution and the landmark back-substitution.
//   A non-positive (or NaN) pivot makes the whole delta NaN, as the twin's
//   _cholesky_solve_or_nan, so the LM rejects the step.  lam is read on the
//   device: no host sync.
// Two launches: (1) a grid over 16x16 tiles of S's lower triangle, each CTA
//   first forming every line's W_l and every point's wp in shared memory,
//   then summing its entries' slots in a fixed order (CTA (0, 0) also keeps
//   the scales and inverses for launch 2); (2) one CTA: S as a packed lower
//   triangle in shared memory (nd = 177: 15,753 doubles, 126 KB), a
//   right-looking Cholesky, the two substitutions and the landmarks.  No
//   atomics: a run repeats to the last bit.
// Bound on the H100: f64 operations, ~10 MFLOP at nd = 177, P = 128, L = 32
//   (the Schur sums ~7, the Cholesky ~2): a fraction of a microsecond at
//   67 TFLOP/s; launch 2 is one CTA on one SM and serial in its 177 pivots,
//   so the kernel is latency-bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

struct VpSchurArgs {
  const double *H_dd, *g_d, *H_dp, *h_p, *g_p, *H_dl, *Hll, *g_l, *lam;
  // scratch: S [nd, nd] (lower triangle used), rhs [nd], aux [3 P + 24 L + nd]
  double *S, *rhs, *aux;
  void* out;  // delta [nd + P + 4 L]
  int nd, P, L, out_double;
  double diag_floor;
};

namespace {

constexpr int TILE = 16;

__device__ __forceinline__ double jacobi(double d) { return d > 1e-30 ? sqrt(d) : 1.0; }

// landmark terms: c_p [P] | wp [P] | gp_s [P] | c_l [4L] | gl_s [4L] | W [16L]
// (3 P + 24 L doubles; aux adds c_d [nd] after them)
struct Aux {
  double *c_p, *wp, *gp_s, *c_l, *gl_s, *W, *c_d;
  __device__ Aux(double* base, int P, int L) {
    c_p = base, wp = c_p + P, gp_s = wp + P, c_l = gp_s + P, gl_s = c_l + 4 * L,
    W = gl_s + 4 * L, c_d = W + 16 * L;
  }
};

// inverse of a 4x4 matrix by Gauss-Jordan with partial pivoting
__device__ void inv4(const double (&M)[4][4], double* out) {
  double A[4][8];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 8; ++c) A[r][c] = c < 4 ? M[r][c] : (c - 4 == r ? 1.0 : 0.0);
  for (int k = 0; k < 4; ++k) {
    int piv = k;
    for (int r = k + 1; r < 4; ++r)
      if (fabs(A[r][k]) > fabs(A[piv][k])) piv = r;
    if (piv != k)
      for (int c = 0; c < 8; ++c) {
        const double t = A[k][c];
        A[k][c] = A[piv][c], A[piv][c] = t;
      }
    const double d = A[k][k];
    for (int c = 0; c < 8; ++c) A[k][c] /= d;
    for (int r = 0; r < 4; ++r) {
      if (r == k) continue;
      const double f = A[r][k];
      for (int c = 0; c < 8; ++c) A[r][c] -= f * A[k][c];
    }
  }
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) out[r * 4 + c] = A[r][4 + c];
}

// the scales, wp and the line inverses, into X (shared memory or aux)
__device__ void landmark_terms(const VpSchurArgs& A, const Aux& X) {
  const double lam = A.lam[0], fl = A.diag_floor;
  for (int p = threadIdx.x; p < A.P; p += blockDim.x) {
    const double c = jacobi(A.h_p[p]);
    const double s = A.h_p[p] / (c * c);
    X.c_p[p] = c;
    X.wp[p] = 1.0 / (s + lam * s + fl);
    X.gp_s[p] = A.g_p[p] / c;
  }
  for (int l = threadIdx.x; l < A.L; l += blockDim.x) {
    const double* B = A.Hll + 16 * l;
    double c[4], M[4][4];
    for (int k = 0; k < 4; ++k) c[k] = jacobi(B[5 * k]);
    for (int r = 0; r < 4; ++r)
      for (int k = 0; k < 4; ++k) M[r][k] = B[4 * r + k] / (c[r] * c[k]);
    for (int k = 0; k < 4; ++k) {
      const double s = B[5 * k] / (c[k] * c[k]);
      M[k][k] = M[k][k] + (lam * s + fl);
      X.c_l[4 * l + k] = c[k];
      X.gl_s[4 * l + k] = A.g_l[4 * l + k] / c[k];
    }
    inv4(M, X.W + 16 * l);
  }
}

// launch 1: the Schur complement S (lower tiles) and its rhs
__global__ void schur_tiles_kernel(VpSchurArgs A) {
  const int nd = A.nd, P = A.P, L = A.L;
  VP_DYN_SMEM(double, sm);
  const Aux X(sm, P, L);  // c_d is not kept in shared memory
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;
  landmark_terms(A, X);
  __syncthreads();
  if (bi == 0 && bj == 0) {  // keep them for launch 2
    const Aux G(A.aux, P, L);
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      G.c_p[p] = X.c_p[p], G.wp[p] = X.wp[p], G.gp_s[p] = X.gp_s[p];
    for (int e = threadIdx.x; e < 4 * L; e += blockDim.x)
      G.c_l[e] = X.c_l[e], G.gl_s[e] = X.gl_s[e];
    for (int e = threadIdx.x; e < 16 * L; e += blockDim.x) G.W[e] = X.W[e];
    for (int d = threadIdx.x; d < nd; d += blockDim.x) G.c_d[d] = jacobi(A.H_dd[d * nd + d]);
  }
  __syncthreads();
  const double lam = A.lam[0];
  for (int e = threadIdx.x; e < TILE * TILE; e += blockDim.x) {
    const int i = bi * TILE + e / TILE, j = bj * TILE + e % TILE;
    if (i >= nd || j > i) continue;
    const double ci = jacobi(A.H_dd[i * nd + i]), cj = jacobi(A.H_dd[j * nd + j]);
    double s = A.H_dd[i * nd + j] / (ci * cj);
    if (i == j) s = s + (lam * (A.H_dd[i * nd + i] / (ci * ci)) + A.diag_floor);
    double acc = 0.0;
    for (int p = 0; p < P; ++p) {
      const double hi = A.H_dp[i * P + p] / (ci * X.c_p[p]);
      const double hj = A.H_dp[j * P + p] / (cj * X.c_p[p]);
      acc += (hi * X.wp[p]) * hj;
    }
    s = s - acc;
    acc = 0.0;
    for (int l = 0; l < L; ++l) {
      double hi[4], hj[4];
      for (int k = 0; k < 4; ++k) {
        hi[k] = A.H_dl[(i * L + l) * 4 + k] / (ci * X.c_l[4 * l + k]);
        hj[k] = A.H_dl[(j * L + l) * 4 + k] / (cj * X.c_l[4 * l + k]);
      }
      const double* W = X.W + 16 * l;
      for (int k = 0; k < 4; ++k)
        for (int m = 0; m < 4; ++m) acc += hi[k] * W[4 * k + m] * hj[m];
    }
    s = s - acc;
    A.S[i * nd + j] = s;
    if (j == 0) {  // the rhs of row i
      double r = A.g_d[i] / ci, ap = 0.0, al = 0.0;
      for (int p = 0; p < P; ++p)
        ap += (A.H_dp[i * P + p] / (ci * X.c_p[p])) * (X.wp[p] * X.gp_s[p]);
      r = r - ap;
      for (int l = 0; l < L; ++l) {
        const double* W = X.W + 16 * l;
        for (int k = 0; k < 4; ++k) {
          const double hi = A.H_dl[(i * L + l) * 4 + k] / (ci * X.c_l[4 * l + k]);
          for (int m = 0; m < 4; ++m) al += hi * W[4 * k + m] * X.gl_s[4 * l + m];
        }
      }
      A.rhs[i] = r - al;
    }
  }
}

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// launch 2: one CTA, Cholesky of S, substitutions, landmarks
template <typename TO>
__global__ void schur_chol_kernel(VpSchurArgs A) {
  const int nd = A.nd, P = A.P, L = A.L;
  VP_DYN_SMEM(double, sm);
  double* Ls = sm;                       // packed lower triangle
  double* b = Ls + nd * (nd + 1) / 2;    // rhs -> y -> x
  double* flag = b + nd;                 // 1: a pivot failed
  const Aux G(A.aux, P, L);
  TO* out = (TO*)A.out;
  const int tid = threadIdx.x, bd = blockDim.x;
  for (int i = tid; i < nd; i += bd) {
    for (int j = 0; j <= i; ++j) Ls[tri(i, j)] = A.S[i * nd + j];
    b[i] = A.rhs[i];
  }
  if (tid == 0) flag[0] = 0.0;
  __syncthreads();
  for (int k = 0; k < nd; ++k) {
    if (tid == 0) {
      const double d = Ls[tri(k, k)];
      if (!(d > 0.0)) flag[0] = 1.0;
      Ls[tri(k, k)] = sqrt(d);
    }
    __syncthreads();
    const double lkk = Ls[tri(k, k)];
    for (int i = k + 1 + tid; i < nd; i += bd) Ls[tri(i, k)] = Ls[tri(i, k)] / lkk;
    __syncthreads();
    const int m = nd - k - 1;
    for (int e = tid; e < m * m; e += bd) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      if (j <= i) Ls[tri(i, j)] = Ls[tri(i, j)] - Ls[tri(i, k)] * Ls[tri(j, k)];
    }
    __syncthreads();
  }
  // L y = rhs
  for (int k = 0; k < nd; ++k) {
    if (tid == 0) b[k] = b[k] / Ls[tri(k, k)];
    __syncthreads();
    for (int i = k + 1 + tid; i < nd; i += bd) b[i] = b[i] - Ls[tri(i, k)] * b[k];
    __syncthreads();
  }
  // Lᵀ x = y
  for (int k = nd - 1; k >= 0; --k) {
    if (tid == 0) b[k] = b[k] / Ls[tri(k, k)];
    __syncthreads();
    for (int i = tid; i < k; i += bd) b[i] = b[i] - Ls[tri(k, i)] * b[k];
    __syncthreads();
  }
  if (flag[0] != 0.0) {
    for (int i = tid; i < nd; i += bd) b[i] = __longlong_as_double(0x7ff8000000000000LL);
    __syncthreads();
  }
  for (int i = tid; i < nd; i += bd) out[i] = (TO)(b[i] / G.c_d[i]);
  for (int p = tid; p < P; p += bd) {
    double acc = 0.0;
    for (int d = 0; d < nd; ++d) acc += (A.H_dp[d * P + p] / (G.c_d[d] * G.c_p[p])) * b[d];
    out[nd + p] = (TO)(G.wp[p] * (G.gp_s[p] - acc) / G.c_p[p]);
  }
  for (int l = tid; l < L; l += bd) {
    double t[4];
    for (int k = 0; k < 4; ++k) {
      double acc = 0.0;
      for (int d = 0; d < nd; ++d)
        acc += (A.H_dl[(d * L + l) * 4 + k] / (G.c_d[d] * G.c_l[4 * l + k])) * b[d];
      t[k] = G.gl_s[4 * l + k] - acc;
    }
    const double* W = G.W + 16 * l;
    for (int k = 0; k < 4; ++k) {
      const double dl = W[4 * k] * t[0] + W[4 * k + 1] * t[1] + W[4 * k + 2] * t[2] +
                        W[4 * k + 3] * t[3];
      out[nd + P + 4 * l + k] = (TO)(dl / G.c_l[4 * l + k]);
    }
  }
}

// ---- launch ----

template <typename TO>
int launch(const VpSchurArgs& A, cudaStream_t stream) {
  const int nt = (A.nd + TILE - 1) / TILE;
  const size_t sm1 = sizeof(double) * (3 * A.P + 24 * A.L) + 16;
  const size_t sm2 = sizeof(double) * (A.nd * (A.nd + 1) / 2 + A.nd + 1);
  auto* k_tiles = &schur_tiles_kernel;
  auto* k_chol = &schur_chol_kernel<TO>;
  cudaFuncSetAttribute(k_chol, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm2);
  VP_LAUNCH(k_tiles, dim3(nt, nt), 256, sm1, stream, A);
  VP_LAUNCH(k_chol, 1, 1024, sm2, stream, A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vp_schur_solve(const VpSchurArgs* A, cudaStream_t stream) {
  return A->out_double ? launch<double>(*A, stream) : launch<float>(*A, stream);
}
