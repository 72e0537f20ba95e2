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
//   clipped pseudo-inverse D_l of each scaled 4x4 block from a cyclic Jacobi
//   eigen-decomposition (the clipped inverse does not depend on the
//   eigenbasis, so it agrees with the reference's eigh to rounding).  With
//   the scaled landmark columns C = [Cp | Cl] [nd, K] (K = P + 4 L) and
//   their weighted partners Y = [Cp diag(dpi) | Cl blockdiag(D_l)]:
//     H1 = H_dd / (c cᵀ) - Y Cᵀ,  b1 = -g_d / c - Y bv,
//   bv = [-g_p / c_p | -g_l / c_l].  Outputs H1 [nd, nd] (symmetric to the
//   bit), b1 [nd] and the dense column scales c_d [nd], all f64.
// Two launches: (1) prep: a grid over 32 columns x 16 rows of C and Y; each
//   CTA forms its columns' landmark terms once (the point gate's max over all
//   P by a block reduction, a thread per line column its line's Jacobi) and
//   writes Cᵀ, Yᵀ [Kp, ndp] (Kp = K rounded up to 4, ndp = nd rounded up to
//   16, zero padded) and bv to scratch (L2-resident); (2) product: a CTA per
//   16x16 tile of H1's lower triangle, a warp per 8x8 quadrant summing k in
//   one order on the f64 tensor cores (mma.sync m8n8k4), each entry i >= j
//   written to (i, j) and (j, i); the first tile column's left warps also
//   form Y bv on the same MMA.  No atomics: a run repeats to the last bit.
// Bound on the H100: f64 operations, ~16 MFLOP at nd = 177, P = 128, L = 32
//   (the product over the whole [177, 256] x [256, 177]): a fraction of a
//   microsecond at 67 TFLOP/s.  The prep's line Jacobi (a chain of
//   dependent rotations in one thread) and the product's chain of MMAs per
//   warp bound it in latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

struct VpMargArgs {
  const double *H_dd, *g_d, *H_dp, *h_p, *g_p, *H_dl, *Hll, *g_l;
  double *H1, *b1, *c_d;
  double* aux;  // scratch (marginalization.marg_scratch): bv [Kp] | Ct [Kp, ndp] | Yt [Kp, ndp]
  int nd, P, L;
  double eps;
};

namespace {

constexpr int TB = 16;   // tile edge (H1's tiles, the prep's rows)
constexpr int CH = 32;   // prep: columns a CTA
constexpr int NT_PREP = CH * TB;
constexpr int KU = 16;   // product: MMA k-steps whose loads are in flight together

struct Plan {
  int ndp, nb, tiles, K, Kp;
};

__host__ __device__ Plan plan(int nd, int P, int L) {
  Plan p;
  p.ndp = (nd + TB - 1) / TB * TB;
  p.nb = p.ndp / TB;
  p.tiles = p.nb * (p.nb + 1) / 2;
  p.K = P + 4 * L;
  p.Kp = (p.K + 3) / 4 * 4;
  return p;
}

struct Aux {
  double *bv, *Ct, *Yt;
  __device__ Aux(double* base, int ndp, int Kp) {
    bv = base, Ct = bv + Kp, Yt = Ct + (size_t)Kp * ndp;
  }
};

__device__ __forceinline__ double col_scale(double d) { return d > 1e-30 ? sqrt(d) : 1.0; }

// eigen-decomposition of a symmetric 4x4 by cyclic Jacobi: A -> diag(w),
// V's columns the eigenvectors
__device__ void jacobi_eig4(double (&A)[4][4], double (&V)[4][4]) {
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) V[r][c] = r == c ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = 0.0, tot = 0.0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tot += A[r][c] * A[r][c];
        if (r != c) off += A[r][c] * A[r][c];
      }
    if (!(off > 1e-32 * tot)) break;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = p + 1; q < 4; ++q) {
        const double apq = A[p][q];
        if (apq == 0.0) continue;
        const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
        const double at = fabs(theta);
        double t = at > 1e150 ? 0.5 / at : 1.0 / (at + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // A <- A G (columns p, q)
          const double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // A <- Gᵀ A (rows p, q)
          const double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
        A[p][q] = A[q][p] = 0.0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
  }
}

// ---- launch 1: the landmark terms, Cᵀ, Yᵀ and bv ----

__global__ void __launch_bounds__(NT_PREP) marg_prep_kernel(VpMargArgs A) {
  const int nd = A.nd, P = A.P, L = A.L;
  const Plan pl = plan(nd, P, L);
  const int ndp = pl.ndp, K = pl.K, Kp = pl.Kp;
  const Aux X(A.aux, ndp, Kp);
  // the CTA's columns: 1/(c_p) and dpi (point), or the line's c_l and
  // column m of its D; its rows' c_d
  __shared__ double s_c[CH], s_w[CH], s_cd[TB], s_max[NT_PREP / 32];
  __shared__ double s_D[CH][4], s_cl[CH][4];
  const int tid = threadIdx.x, k0 = blockIdx.x * CH, d0 = blockIdx.y * TB;
  const bool top = blockIdx.y == 0;  // one CTA row writes the column terms
  // the point gate: max |dp| over all P (every CTA with point columns)
  double thr_p = 0.0;
  if (k0 < P) {
    double m = 0.0;
    for (int p = tid; p < P; p += NT_PREP) {
      const double c = col_scale(A.h_p[p]);
      m = fmax(m, fabs(A.h_p[p] / (c * c)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmax(m, VP_SHFL_XOR(m, o));
    if ((tid & 31) == 0) s_max[tid >> 5] = m;
    __syncthreads();
    m = s_max[0];
    for (int w = 1; w < NT_PREP / 32; ++w) m = fmax(m, s_max[w]);
    thr_p = fmax(A.eps * m, 1e-30);
  }
  if (tid < CH && k0 + tid < Kp) {
    const int k = k0 + tid;
    if (k < P) {
      const double c = col_scale(A.h_p[k]);
      const double w = A.h_p[k] / (c * c);
      s_c[tid] = c;
      s_w[tid] = w > thr_p ? 1.0 / fmax(w, 1e-30) : 0.0;
      if (top) X.bv[k] = -A.g_p[k] / c;
    } else if (k < K) {
      const int l = (k - P) / 4, m = (k - P) % 4;
      const double* B = A.Hll + 16 * l;
      double c[4], M[4][4], V[4][4], wi[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = col_scale(B[5 * r]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) M[r][q] = B[4 * r + q] / (c[r] * c[q]);
      jacobi_eig4(M, V);
      double wm = 0.0;
#pragma unroll
      for (int q = 0; q < 4; ++q) wm = fmax(wm, fabs(M[q][q]));
      const double thr = fmax(A.eps * wm, 1e-30);
#pragma unroll
      for (int q = 0; q < 4; ++q) wi[q] = M[q][q] > thr ? 1.0 / fmax(M[q][q], 1e-30) : 0.0;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < 4; ++q) s += (V[a][q] * V[m][q]) * wi[q];
        s_D[tid][a] = s;  // D[a][m]
        s_cl[tid][a] = c[a];
      }
      if (top) X.bv[k] = -A.g_l[k - P] / c[m];
    } else if (top) {
      X.bv[k] = 0.0;
    }
  } else if (tid >= CH && tid < CH + TB) {
    const int d = d0 + tid - CH;
    const double c = d < nd ? col_scale(A.H_dd[(size_t)d * nd + d]) : 1.0;
    s_cd[tid - CH] = c;
    if (blockIdx.x == 0 && d < nd) A.c_d[d] = c;
  }
  __syncthreads();
  if (Kp == 0) return;
  // a thread per (column, row): rows fastest, so the stores coalesce
  const int kl = tid / TB, dl = tid % TB, k = k0 + kl, d = d0 + dl;
  if (k >= Kp || d >= ndp) return;
  double v = 0.0, u = 0.0;
  if (d < nd && k < P) {
    v = A.H_dp[(size_t)d * P + k] / (s_cd[dl] * s_c[kl]);
    u = v * s_w[kl];
  } else if (d < nd && k < K) {
    const int l = (k - P) / 4, m = (k - P) % 4;
    const double* h = A.H_dl + ((size_t)d * L + l) * 4;
    double hv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) hv[r] = h[r];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const double vr = hv[r] / (s_cd[dl] * s_cl[kl][r]);
      if (r == m) v = vr;
      u += vr * s_D[kl][r];
    }
  }
  X.Ct[(size_t)k * ndp + d] = v;
  X.Yt[(size_t)k * ndp + d] = u;
}

// ---- launch 2: H1's lower tiles (mirrored) and b1 ----

__global__ void __launch_bounds__(128) marg_product_kernel(VpMargArgs A) {
  const int nd = A.nd;
  const Plan pl = plan(nd, A.P, A.L);
  const int ndp = pl.ndp, Kp = pl.Kp;
  const Aux X(A.aux, ndp, Kp);
  const int b = blockIdx.x;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= b) ++I;
  const int J = b - I * (I + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = I * TB + (warp >> 1) * 8, col0 = J * TB + (warp & 1) * 8;
  // a diagonal tile's upper-right quadrant holds only entries i < j
  if (I == J && (warp >> 1) == 0 && (warp & 1) == 1) return;
  // (Y Cᵀ)[row0 + g][col0 + 2 t + {0, 1}]: two chains (even and odd k-steps
  // of 4), added at the end; the first tile column's left warps also run
  // Y bv as a third chain (B's column 0 is bv, the rest 0)
  const bool with_b = J == 0 && (warp & 1) == 0;
  double c0[2] = {0.0, 0.0}, c1[2] = {0.0, 0.0}, cr[2] = {0.0, 0.0};
  for (int k = 0; k < Kp; k += 4 * KU) {
    double a[KU], bb[KU], br[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int kk = k + 4 * u + t;
      a[u] = kk < Kp ? X.Yt[(size_t)kk * ndp + row0 + g] : 0.0;
      bb[u] = kk < Kp ? X.Ct[(size_t)kk * ndp + col0 + g] : 0.0;
      br[u] = with_b && g == 0 && kk < Kp ? X.bv[kk] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < KU; u += 2) {
      VP_MMA_F64(c0[0], c0[1], a[u], bb[u]);
      VP_MMA_F64(c1[0], c1[1], a[u + 1], bb[u + 1]);
    }
    if (with_b) {
#pragma unroll
      for (int u = 0; u < KU; ++u) VP_MMA_F64(cr[0], cr[1], a[u], br[u]);
    }
  }
  const double d0 = c0[0] + c1[0], d1 = c0[1] + c1[1];
  const int i = row0 + g;
  if (i < nd) {
    const double ci = col_scale(A.H_dd[(size_t)i * nd + i]);
    for (int e = 0; e < 2; ++e) {
      const int j = col0 + 2 * t + e;
      if (j > i) continue;
      const double cj = col_scale(A.H_dd[(size_t)j * nd + j]);
      const double h = A.H_dd[(size_t)i * nd + j] / (ci * cj) - (e ? d1 : d0);
      A.H1[(size_t)i * nd + j] = h;
      A.H1[(size_t)j * nd + i] = h;
    }
    if (with_b && t == 0) A.b1[i] = -A.g_d[i] / ci - cr[0];
  }
}

// ---- launch ----

int launch(const VpMargArgs& A, cudaStream_t stream) {
  const Plan pl = plan(A.nd, A.P, A.L);
  const int gx = pl.Kp > 0 ? (pl.Kp + CH - 1) / CH : 1;
  auto* k_prep = &marg_prep_kernel;
  auto* k_prod = &marg_product_kernel;
  VP_LAUNCH(k_prep, dim3(gx, pl.nb), NT_PREP, 0, stream, A);
  VP_LAUNCH(k_prod, pl.tiles, 128, 0, stream, A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vp_marg_window(const VpMargArgs* A, cudaStream_t stream) {
  return launch(*A, stream);
}
