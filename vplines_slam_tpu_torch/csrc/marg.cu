// K14 marg: stage 1 of the window's marginalization, from the block normal
// equations: column scaling, then the point and line landmarks eliminated
// onto the dense block with clipped inverses.
//
// Replaces: vplines_slam_tpu/solver/marginalization.py:152 marginalize_window
//   (stage 1; stages 2-3, eigh of the dropped 15x15 block and of the kept
//   block, stay torch.linalg.eigh in solver/marginalization.py, as the
//   reference calls jnp.linalg.eigh there).  The reference forms the dense
//   Jacobian J [R, N] and H = (J/c)ᵀ(J/c); here H comes as K12's blocks
//   (points never couple to each other, lines neither), with
//   c = sqrt(diag H) (1 where <= 1e-30), b = Jᵀr = -g.
// Points: a scalar block each, kept where its scaled diagonal passes the
//   relative clip gate against the largest one (_clip_gate, :61).  Lines: the
//   clipped pseudo-inverse of each scaled 4x4 block from a cyclic Jacobi
//   eigen-decomposition, one thread per line (the clipped inverse does not
//   depend on the eigenbasis, so it agrees with the reference's eigh to
//   rounding).  Outputs: H1 = H_dd - sum Cp dpi Cpᵀ - sum Cl Dl Clᵀ [nd, nd],
//   b1 [nd] and the dense column scales c_d [nd], all f64.
// Two launches: (1) one CTA: scales, the point gate, the line inverses; (2) a
//   grid over 16x16 tiles of H1, each entry one thread's sum over the slots in
//   a fixed order (no atomics).
// Bound on the H100: f64 operations, ~9 MFLOP at nd = 177, P = 128, L = 32:
//   a fraction of a microsecond at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

struct VpMargArgs {
  const double *H_dd, *g_d, *H_dp, *h_p, *g_p, *H_dl, *Hll, *g_l;
  double *H1, *b1, *c_d;
  double* aux;  // c_p [P] | dpi [P] | bp [P] | c_l [4L] | bl [4L] | D [16L]
  int nd, P, L;
  double eps;
};

namespace {

constexpr int TILE = 16;

__device__ __forceinline__ double col_scale(double d) { return d > 1e-30 ? sqrt(d) : 1.0; }

struct Aux {
  double *c_p, *dpi, *bp, *c_l, *bl, *D;
  __device__ Aux(double* base, int P, int L) {
    c_p = base, dpi = c_p + P, bp = dpi + P, c_l = bp + P, bl = c_l + 4 * L, D = bl + 4 * L;
  }
};

// eigen-decomposition of a symmetric 4x4 by cyclic Jacobi: A -> diag(w),
// V's columns the eigenvectors
__device__ void jacobi_eig4(double (&A)[4][4], double (&V)[4][4]) {
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) V[r][c] = r == c ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = 0.0, tot = 0.0;
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        tot += A[r][c] * A[r][c];
        if (r != c) off += A[r][c] * A[r][c];
      }
    if (!(off > 1e-32 * tot)) break;
    for (int p = 0; p < 3; ++p)
      for (int q = p + 1; q < 4; ++q) {
        const double apq = A[p][q];
        if (apq == 0.0) continue;
        const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
        const double at = fabs(theta);
        double t = at > 1e150 ? 0.5 / at : 1.0 / (at + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 4; ++k) {  // A <- A G (columns p, q)
          const double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 4; ++k) {  // A <- Gᵀ A (rows p, q)
          const double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
        A[p][q] = A[q][p] = 0.0;
        for (int k = 0; k < 4; ++k) {
          const double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
  }
}

// launch 1: one CTA
__global__ void marg_prep_kernel(VpMargArgs A) {
  const int nd = A.nd, P = A.P, L = A.L;
  const Aux X(A.aux, P, L);
  __shared__ double wmax_s;
  for (int d = threadIdx.x; d < nd; d += blockDim.x) A.c_d[d] = col_scale(A.H_dd[d * nd + d]);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const double c = col_scale(A.h_p[p]);
    X.c_p[p] = c;
    X.dpi[p] = A.h_p[p] / (c * c);  // the scaled diagonal, gated below
    X.bp[p] = -A.g_p[p] / c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double m = 0.0;
    for (int p = 0; p < P; ++p) m = fmax(m, fabs(X.dpi[p]));
    wmax_s = m;
  }
  __syncthreads();
  const double thr_p = fmax(A.eps * wmax_s, 1e-30);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const double w = X.dpi[p];
    X.dpi[p] = w > thr_p ? 1.0 / fmax(w, 1e-30) : 0.0;
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const double* B = A.Hll + 16 * l;
    double c[4], M[4][4], V[4][4], wi[4];
    for (int k = 0; k < 4; ++k) {
      c[k] = col_scale(B[5 * k]);
      X.c_l[4 * l + k] = c[k];
      X.bl[4 * l + k] = -A.g_l[4 * l + k] / c[k];
    }
    for (int r = 0; r < 4; ++r)
      for (int k = 0; k < 4; ++k) M[r][k] = B[4 * r + k] / (c[r] * c[k]);
    jacobi_eig4(M, V);
    double wm = 0.0;
    for (int k = 0; k < 4; ++k) wm = fmax(wm, fabs(M[k][k]));
    const double thr = fmax(A.eps * wm, 1e-30);
    for (int k = 0; k < 4; ++k) wi[k] = M[k][k] > thr ? 1.0 / fmax(M[k][k], 1e-30) : 0.0;
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < 4; ++b) {
        double s = 0.0;
        for (int k = 0; k < 4; ++k) s += (V[a][k] * V[b][k]) * wi[k];
        X.D[16 * l + 4 * a + b] = s;
      }
  }
}

// launch 2: tiles of H1 (and b1 from the first tile column)
__global__ void marg_reduce_kernel(VpMargArgs A) {
  const int nd = A.nd, P = A.P, L = A.L;
  const Aux X(A.aux, P, L);
  const int bi = blockIdx.y, bj = blockIdx.x;
  for (int e = threadIdx.x; e < TILE * TILE; e += blockDim.x) {
    const int i = bi * TILE + e / TILE, j = bj * TILE + e % TILE;
    if (i >= nd || j >= nd) continue;
    const double ci = A.c_d[i], cj = A.c_d[j];
    double h = A.H_dd[i * nd + j] / (ci * cj);
    double acc = 0.0;
    for (int p = 0; p < P; ++p) {
      const double hi = A.H_dp[i * P + p] / (ci * X.c_p[p]);
      const double hj = A.H_dp[j * P + p] / (cj * X.c_p[p]);
      acc += (hi * X.dpi[p]) * hj;
    }
    h = h - acc;
    acc = 0.0;
    for (int l = 0; l < L; ++l) {
      double hi[4], hj[4];
      for (int k = 0; k < 4; ++k) {
        hi[k] = A.H_dl[(i * L + l) * 4 + k] / (ci * X.c_l[4 * l + k]);
        hj[k] = A.H_dl[(j * L + l) * 4 + k] / (cj * X.c_l[4 * l + k]);
      }
      const double* D = X.D + 16 * l;
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) acc += hi[a] * D[4 * a + b] * hj[b];
    }
    A.H1[i * nd + j] = h - acc;
    if (j == 0) {
      double b = -A.g_d[i] / ci, ap = 0.0, al = 0.0;
      for (int p = 0; p < P; ++p)
        ap += (A.H_dp[i * P + p] / (ci * X.c_p[p])) * (X.dpi[p] * X.bp[p]);
      b = b - ap;
      for (int l = 0; l < L; ++l) {
        const double* D = X.D + 16 * l;
        for (int a = 0; a < 4; ++a) {
          const double hi = A.H_dl[(i * L + l) * 4 + a] / (ci * X.c_l[4 * l + a]);
          for (int c = 0; c < 4; ++c) al += hi * D[4 * a + c] * X.bl[4 * l + c];
        }
      }
      A.b1[i] = b - al;
    }
  }
}

// ---- launch ----

int launch(const VpMargArgs& A, cudaStream_t stream) {
  const int nt = (A.nd + TILE - 1) / TILE;
  auto* k_prep = &marg_prep_kernel;
  auto* k_reduce = &marg_reduce_kernel;
  VP_LAUNCH(k_prep, 1, 256, 0, stream, A);
  VP_LAUNCH(k_reduce, dim3(nt, nt), 256, 0, stream, A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vp_marg_window(const VpMargArgs* A, cudaStream_t stream) {
  return launch(*A, stream);
}
