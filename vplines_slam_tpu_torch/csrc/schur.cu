// K13 schur: the damped, Jacobi-scaled Schur solve of the window's block
// normal equations, in f64.
//
// Replaces: vplines_slam_tpu/solver/lm.py:302 schur_solve_blocks (the port's
//   plain twin: solver/lm.schur_solve_blocks_plain).  Scalar point blocks
//   (wp = 1 / h_p, scaled and damped) and 4x4 line blocks (their inverse,
//   written out by Gauss-Jordan) are eliminated onto the dense block:
//     S = H_dd + diag - U V^T,  V = [Hdp | Hdl],  U = [Hdp diag(wp) | Hdl blockdiag(W_l)]
//   (all Jacobi-scaled, K = P + 4 L columns), then a Cholesky of S, forward
//   and back substitution and the landmark back-substitution
//   t = g_s - V^T dd, dp = wp t_p / c_p, dl = W_l t_l / c_l.  A non-positive
//   (or NaN) pivot makes the whole delta NaN, as the twin's
//   _cholesky_solve_or_nan, so the LM rejects the step.  lam is read on the
//   device: no host sync.
// Three launches:
//   (1) prep: a grid over 32 columns x 32 rows of U and V.  Each CTA forms
//       its columns' landmark terms (scales, wp, the 4x4 inverses) once and
//       writes U^T, V^T [Kp, ndp] (Kp = K rounded up to 4, ndp = nd rounded
//       up to 16, zero padded) and the scales to scratch (L2-resident).
//   (2) product: a CTA per 16x16 tile of S's lower triangle, a warp per 8x8
//       quadrant summing k in one order on the f64 tensor cores
//       (mma.sync m8n8k4); the padding is the identity.  The first tile
//       column's CTAs also form the rhs g_d - U g_s on the same MMA.
//   (3) factor: one CTA holds S's lower tiles in shared memory (nd = 177:
//       78 tiles, 156 KB) and runs a right-looking blocked Cholesky: per
//       block step one warp factors the diagonal tile in registers with
//       shuffles and solves the rhs block, all threads solve the panel
//       below it, and all warps apply the trailing update with the same MMA
//       (and the rhs update).  Then the back substitution by 16-row blocks
//       and the landmarks from V^T, a warp per column with a fixed
//       shuffle tree.
//   No atomics: every sum has one order, so a run repeats to the last bit.
// Bound on the H100: f64 operations, ~10 MFLOP at nd = 177, P = 128, L = 32
//   (U V^T ~8, the Cholesky ~2): a fraction of a microsecond at 67 TFLOP/s.
//   Launch 3 is one CTA on one SM and serial in its 12 block steps, so the
//   kernel is latency-bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

struct VpSchurArgs {
  const double *H_dd, *g_d, *H_dp, *h_p, *g_p, *H_dl, *Hll, *g_l, *lam;
  // scratch, sized by solver/lm.schur_plan (the Plan below):
  //   S: the lower 16x16 tiles of S, row-major each [tiles, 16, 16]; rhs [ndp];
  //   aux: c_d [ndp] | g_s [Kp] | wp [P] | c_p [P] | c_l [4L] | W [16L] |
  //        U^T [Kp, ndp] | V^T [Kp, ndp]
  double *S, *rhs, *aux;
  void* out;  // delta [nd + P + 4 L]
  int nd, P, L, out_double;
  double diag_floor;
};

namespace {

constexpr int TB = 16;        // tile edge
constexpr int TT = TB * TB;   // doubles a tile
constexpr int CH = 32;        // prep: columns a CTA
constexpr int RH = 16;        // prep: rows a CTA
constexpr int NT_PREP = CH * RH;
constexpr int NT_FACTOR = 512;
constexpr int KU = 16;        // product: MMA k-steps whose loads are in flight together
constexpr size_t SMEM_LIMIT = 232448;  // a CTA's shared memory on the H100
constexpr int MAX_ND = 224;             // the largest ndp whose tiles fit SMEM_LIMIT

struct Plan {
  int ndp, nb, tiles, K, Kp;
  size_t smem;  // launch 3's dynamic shared memory
};

__host__ __device__ Plan plan(int nd, int P, int L) {
  Plan p;
  p.ndp = (nd + TB - 1) / TB * TB;
  p.nb = p.ndp / TB;
  p.tiles = p.nb * (p.nb + 1) / 2;
  p.K = P + 4 * L;
  p.Kp = (p.K + 3) / 4 * 4;
  p.smem = sizeof(double) * ((size_t)p.tiles * TT + 2 * p.ndp + p.Kp + 1);
  return p;
}

struct Aux {
  double *c_d, *g_s, *wp, *c_p, *c_l, *W, *Ut, *Vt;
  __device__ Aux(double* base, int ndp, int Kp, int P, int L) {
    c_d = base, g_s = c_d + ndp, wp = g_s + Kp, c_p = wp + P, c_l = c_p + P, W = c_l + 4 * L,
    Ut = W + 16 * L, Vt = Ut + (size_t)Kp * ndp;
  }
};

__device__ __forceinline__ double jacobi(double d) { return d > 1e-30 ? sqrt(d) : 1.0; }
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }
// a tile's entry (r, c) in shared memory: the column xor-swizzled by the row,
// so a warp's MMA fragments (8 rows x 4 columns) hit distinct banks
__device__ __forceinline__ int sw(int r, int c) { return r * TB + (c ^ ((r & 3) << 2)); }

// inverse of a 4x4 matrix by Gauss-Jordan with partial pivoting
__device__ void inv4(const double (&M)[4][4], double (&out)[4][4]) {
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
    const double rd = 1.0 / A[k][k];
    for (int c = 0; c < 8; ++c) A[k][c] *= rd;
    for (int r = 0; r < 4; ++r) {
      if (r == k) continue;
      const double f = A[r][k];
      for (int c = 0; c < 8; ++c) A[r][c] -= f * A[k][c];
    }
  }
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) out[r][c] = A[r][4 + c];
}

// ---- launch 1: landmark terms, U^T and V^T ----

__global__ void __launch_bounds__(NT_PREP) schur_prep_kernel(VpSchurArgs A) {
  const int nd = A.nd, P = A.P, L = A.L;
  const Plan pl = plan(nd, P, L);
  const int ndp = pl.ndp, K = pl.K, Kp = pl.Kp;
  const Aux X(A.aux, ndp, Kp, P, L);
  // the CTA's columns: 1 / c (point) with wp, or the line's 1 / c_l and
  // column m of its W; its rows' 1 / c_d
  __shared__ double s_rc[CH], s_w[CH], s_rcd[RH];
  __shared__ double s_Wc[CH][4], s_rcl[CH][4];
  const int tid = threadIdx.x, k0 = blockIdx.x * CH, d0 = blockIdx.y * RH;
  const double lam = A.lam[0], fl = A.diag_floor;
  if (tid < CH && k0 + tid < Kp) {
    const int k = k0 + tid;
    const bool top = blockIdx.y == 0;  // one CTA row writes the terms
    if (k < P) {
      const double c = jacobi(A.h_p[k]);
      const double s = A.h_p[k] / (c * c);
      const double wp = 1.0 / (s + lam * s + fl);
      s_rc[tid] = 1.0 / c, s_w[tid] = wp;
      if (top) X.c_p[k] = c, X.wp[k] = wp, X.g_s[k] = A.g_p[k] / c;
    } else if (k < K) {
      const int l = (k - P) / 4, m = (k - P) % 4;
      const double* B = A.Hll + 16 * l;
      double c[4], M[4][4], Wl[4][4];
      for (int r = 0; r < 4; ++r) c[r] = jacobi(B[5 * r]);
      for (int r = 0; r < 4; ++r)
        for (int q = 0; q < 4; ++q) M[r][q] = B[4 * r + q] / (c[r] * c[q]);
      for (int r = 0; r < 4; ++r) {
        const double s = B[5 * r] / (c[r] * c[r]);
        M[r][r] = M[r][r] + (lam * s + fl);
      }
      inv4(M, Wl);
      for (int r = 0; r < 4; ++r) s_Wc[tid][r] = Wl[r][m], s_rcl[tid][r] = 1.0 / c[r];
      if (top) {
        X.c_l[k - P] = c[m];
        X.g_s[k] = A.g_l[k - P] / c[m];
        for (int q = 0; q < 4; ++q) X.W[16 * l + 4 * m + q] = Wl[m][q];
      }
    } else if (top) {
      X.g_s[k] = 0.0;
    }
  } else if (tid >= CH && tid < CH + RH && d0 + tid - CH < ndp) {
    const int d = d0 + tid - CH;
    const double c = d < nd ? jacobi(A.H_dd[(size_t)d * nd + d]) : 1.0;
    s_rcd[tid - CH] = 1.0 / c;
    if (blockIdx.x == 0) X.c_d[d] = c;
  }
  __syncthreads();
  // a thread per (column, row): rows fastest, so the stores coalesce
  const int kl = tid / RH, dl = tid % RH, k = k0 + kl, d = d0 + dl;
  if (k >= Kp || d >= ndp) return;
  double v = 0.0, u = 0.0;
  if (d < nd && k < P) {
    v = A.H_dp[(size_t)d * P + k] * s_rcd[dl] * s_rc[kl];
    u = v * s_w[kl];
  } else if (d < nd && k < K) {
    const int l = (k - P) / 4, m = (k - P) % 4;
    const double* h = A.H_dl + ((size_t)d * L + l) * 4;
    double hv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) hv[r] = h[r];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const double vr = hv[r] * s_rcd[dl] * s_rcl[kl][r];
      if (r == m) v = vr;
      u += vr * s_Wc[kl][r];
    }
  }
  X.Vt[(size_t)k * ndp + d] = v;
  X.Ut[(size_t)k * ndp + d] = u;
}

// ---- launch 2: S's lower tiles and the rhs ----

__global__ void __launch_bounds__(128) schur_product_kernel(VpSchurArgs A) {
  const int nd = A.nd;
  const Plan pl = plan(nd, A.P, A.L);
  const int ndp = pl.ndp, Kp = pl.Kp;
  const Aux X(A.aux, ndp, Kp, A.P, A.L);
  const int b = blockIdx.x;
  int I = 0;
  while (tri(I + 1, 0) <= b) ++I;
  const int J = b - tri(I, 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = I * TB + (warp >> 1) * 8, col0 = J * TB + (warp & 1) * 8;
  // (U V^T)[row0 + g][col0 + 2 t + {0, 1}]: two chains (even and odd
  // k-steps of 4), added at the end; KU steps' loads in flight at a time.
  // The first tile column's left warps also run U g_s as a third chain (B's
  // column 0 is g_s, the rest 0): the rhs of row row0 + g lands in lane 4 g.
  const bool with_rhs = J == 0 && (warp & 1) == 0;
  double c0[2] = {0.0, 0.0}, c1[2] = {0.0, 0.0}, cr[2] = {0.0, 0.0};
  for (int k = 0; k < Kp; k += 4 * KU) {
    double a[KU], bb[KU], br[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int kk = k + 4 * u + t;
      a[u] = kk < Kp ? X.Ut[(size_t)kk * ndp + row0 + g] : 0.0;
      bb[u] = kk < Kp ? X.Vt[(size_t)kk * ndp + col0 + g] : 0.0;
      br[u] = with_rhs && g == 0 && kk < Kp ? X.g_s[kk] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < KU; u += 2) {
      VP_MMA_F64(c0[0], c0[1], a[u], bb[u]);
      VP_MMA_F64(c1[0], c1[1], a[u + 1], bb[u + 1]);
    }
    if (with_rhs) {
#pragma unroll
      for (int u = 0; u < KU; ++u) VP_MMA_F64(cr[0], cr[1], a[u], br[u]);
    }
  }
  const double d0 = c0[0] + c1[0], d1 = c0[1] + c1[1];
  const double lam = A.lam[0];
  const int i = row0 + g;
  for (int e = 0; e < 2; ++e) {
    const int j = col0 + 2 * t + e;
    double s;
    if (i >= nd || j >= nd) {
      s = i == j ? 1.0 : 0.0;
    } else {
      const double ci = X.c_d[i], cj = X.c_d[j];
      s = A.H_dd[(size_t)i * nd + j] / (ci * cj);
      if (i == j) s = s + (lam * (A.H_dd[(size_t)i * nd + i] / (ci * ci)) + A.diag_floor);
      s = s - (e ? d1 : d0);
    }
    A.S[(size_t)b * TT + (i - I * TB) * TB + (j - J * TB)] = s;
  }
  if (with_rhs && t == 0) A.rhs[i] = i < nd ? A.g_d[i] / X.c_d[i] - cr[0] : 0.0;
}

// ---- launch 3: one CTA, blocked Cholesky, substitutions, landmarks ----

// C (16x16) -= A B^T for three tiles in shared memory, by one warp: four
// 8x8 quadrants, k in steps of 4 on the MMA
__device__ __forceinline__ void tile_update(double* C, const double* Am, const double* Bm,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  double acc[2][2][2];
#pragma unroll
  for (int qi = 0; qi < 2; ++qi)
#pragma unroll
    for (int qj = 0; qj < 2; ++qj)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[qi][qj][e] = C[sw(qi * 8 + g, qj * 8 + 2 * t + e)];
#pragma unroll
  for (int kk = 0; kk < TB; kk += 4) {
    double a[2], b[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      a[q] = -Am[sw(q * 8 + g, kk + t)];
      b[q] = Bm[sw(q * 8 + g, kk + t)];
    }
#pragma unroll
    for (int qi = 0; qi < 2; ++qi)
#pragma unroll
      for (int qj = 0; qj < 2; ++qj) VP_MMA_F64(acc[qi][qj][0], acc[qi][qj][1], a[qi], b[qj]);
  }
#pragma unroll
  for (int qi = 0; qi < 2; ++qi)
#pragma unroll
    for (int qj = 0; qj < 2; ++qj)
#pragma unroll
      for (int e = 0; e < 2; ++e) C[sw(qi * 8 + g, qj * 8 + 2 * t + e)] = acc[qi][qj][e];
}

// One warp: factor the diagonal tile D in registers (lane r, and its mirror
// r + 16, holds row r) and solve L y = y in the same pivot loop; 1 / L[r][r]
// goes to rinv.  Returns true when a pivot is not positive (or NaN).
__device__ __forceinline__ bool factor_diag(double* D, double* y_blk, double* rinv_blk,
                                            int lane) {
  const int r = lane & 15;
  double a[TB];
#pragma unroll
  for (int c = 0; c < TB; ++c) a[c] = c <= r ? D[sw(r, c)] : 0.0;
  double y = y_blk[r], rl = 0.0;
  bool bad = false;
#pragma unroll
  for (int p = 0; p < TB; ++p) {
    const double dpp = VP_SHFL_IDX(a[p], p);
    if (!(dpp > 0.0)) bad = true;
    const double rp = rsqrt(dpp);  // 1 / L[p][p]
    if (r == p) a[p] = dpp * rp, rl = rp, y = y * rp;
    else if (r > p) a[p] = a[p] * rp;
    const double yp = VP_SHFL_IDX(y, p);
    if (r > p) y = y - a[p] * yp;
#pragma unroll
    for (int j = p + 1; j < TB; ++j) {
      const double ljp = VP_SHFL_IDX(a[p], j);
      if (r >= j) a[j] = a[j] - a[p] * ljp;
    }
  }
  if (lane < TB) {
#pragma unroll
    for (int c = 0; c < TB; ++c)
      if (c <= r) D[sw(r, c)] = a[c];
    rinv_blk[r] = rl;
    y_blk[r] = y;
  }
  return bad;
}

template <typename TO>
__global__ void __launch_bounds__(NT_FACTOR) schur_factor_kernel(VpSchurArgs A) {
  const int nd = A.nd, P = A.P, L = A.L;
  const Plan pl = plan(nd, P, L);
  const int ndp = pl.ndp, nb = pl.nb, K = pl.K, Kp = pl.Kp;
  const Aux X(A.aux, ndp, Kp, P, L);
  VP_DYN_SMEM(double, sm);
  double* T = sm;                          // the lower tiles, swizzled
  double* b = T + (size_t)pl.tiles * TT;   // rhs -> y -> x
  double* rinv = b + ndp;                  // 1 / L[i][i]
  double* ts = rinv + ndp;                 // the landmark columns' t
  int* flag = reinterpret_cast<int*>(ts + Kp);  // 1: a pivot failed
  TO* out = (TO*)A.out;
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31, warp = tid >> 5,
            nwarps = bd >> 5;
  {  // S and the rhs into shared memory, 8 loads in flight a thread
    const int n = pl.tiles * TT;
    for (int e0 = tid; e0 < n; e0 += 8 * bd) {
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = e0 + u * bd < n ? A.S[e0 + u * bd] : 0.0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * bd, rc = e % TT;
        if (e < n) T[e - rc + sw(rc / TB, rc % TB)] = v[u];
      }
    }
  }
  for (int i = tid; i < ndp; i += bd) b[i] = A.rhs[i];
  if (tid == 0) flag[0] = 0;
  __syncthreads();
  if (warp == 0 && factor_diag(T, b, rinv, lane) && lane == 0) flag[0] = 1;
  __syncthreads();
  // right-looking, one block step ahead: after step k's panel, warp 0
  // updates and factors the next diagonal tile while the other warps update
  // the rest of the trailing triangle
  for (int k = 0; k + 1 < nb; ++k) {
    const double* D = T + tri(k, k) * TT;
    // the panel: X L_kk^T = A for the tiles below, a thread per row
    const int nrow = (nb - k - 1) * TB;
    for (int e = tid; e < nrow; e += bd) {
      double* Pm = T + tri(k + 1 + e / TB, k) * TT;
      const int pr = e % TB;
      double x[TB];
#pragma unroll
      for (int c = 0; c < TB; ++c) x[c] = Pm[sw(pr, c)];
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        x[j] = x[j] * rinv[k * TB + j];
#pragma unroll
        for (int m = j + 1; m < TB; ++m) x[m] = x[m] - x[j] * D[sw(m, j)];
      }
#pragma unroll
      for (int c = 0; c < TB; ++c) Pm[sw(pr, c)] = x[c];
    }
    __syncthreads();
    const int k1 = k + 1;
    if (warp == 0) {
      double* D1 = T + tri(k1, k1) * TT;
      const double* P1 = T + tri(k1, k) * TT;
      tile_update(D1, P1, P1, lane);
      if (lane < TB) {
        double acc = b[k1 * TB + lane];
        for (int c = 0; c < TB; ++c) acc = acc - P1[sw(lane, c)] * b[k * TB + c];
        b[k1 * TB + lane] = acc;
      }
      __syncwarp();
      if (factor_diag(D1, b + k1 * TB, rinv + k1 * TB, lane) && lane == 0) flag[0] = 1;
    } else {
      // the rhs rows below block k + 1, then the trailing tiles but (k+1, k+1)
      for (int e = TB + tid - 32; e < nrow; e += bd - 32) {
        const double* Pm = T + tri(k1 + e / TB, k) * TT;
        const int pr = e % TB;
        double acc = b[k1 * TB + e];
        for (int c = 0; c < TB; ++c) acc = acc - Pm[sw(pr, c)] * b[k * TB + c];
        b[k1 * TB + e] = acc;
      }
      const int m = nb - k1;
      for (int q = warp; q < m * (m + 1) / 2; q += nwarps - 1) {
        int ii = 0;
        while (tri(ii + 1, 0) <= q) ++ii;
        const int I = k1 + ii, J = k1 + (q - tri(ii, 0));
        tile_update(T + tri(I, J) * TT, T + tri(I, k) * TT, T + tri(J, k) * TT, lane);
      }
    }
    __syncthreads();
  }
  // L^T x = y, by blocks from the last, one barrier a step: warp 0 applies
  // x_{k+1} to block k and solves x_k while the other warps apply x_{k+1}
  // to the blocks above k
  for (int k = nb - 1; k >= 0; --k) {
    if (warp == 0) {
      const double* D = T + tri(k, k) * TT;
      const int r = lane & 15;
      double a[TB];  // column r of L_kk
#pragma unroll
      for (int j = 0; j < TB; ++j) a[j] = j >= r ? D[sw(j, r)] : 0.0;
      double x = b[k * TB + r];
      if (k + 1 < nb) {
        const double* Pm = T + tri(k + 1, k) * TT;
        for (int q = 0; q < TB; ++q) x = x - Pm[sw(q, r)] * b[(k + 1) * TB + q];
      }
      const double rl = rinv[k * TB + r];
#pragma unroll
      for (int p = TB - 1; p >= 0; --p) {
        if (r == p) x = x * rl;
        const double xp = VP_SHFL_IDX(x, p);
        if (r < p) x = x - a[p] * xp;
      }
      if (lane < TB) b[k * TB + r] = x;
    } else if (k + 1 < nb) {
      for (int i = tid - 32; i < k * TB; i += bd - 32) {
        const double* Pm = T + tri(k + 1, i / TB) * TT;
        const int c = i % TB;
        double acc = b[i];
        for (int q = 0; q < TB; ++q) acc = acc - Pm[sw(q, c)] * b[(k + 1) * TB + q];
        b[i] = acc;
      }
    }
    __syncthreads();
  }
  if (flag[0] != 0) {
    for (int i = tid; i < ndp; i += bd) b[i] = __longlong_as_double(0x7ff8000000000000LL);
    __syncthreads();
  }
  for (int i = tid; i < nd; i += bd) out[i] = (TO)(b[i] / X.c_d[i]);
  // t = g_s - V^T dd: a warp per column, 4 columns at a time with all their
  // loads in flight, lanes over d, a fixed tree
  constexpr int NC = 4, ND32 = MAX_ND / 32;
  for (int k0 = NC * warp; k0 < K; k0 += NC * nwarps) {
    double vv[NC][ND32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int u = 0; u < ND32; ++u) {
        const int d = lane + 32 * u;
        vv[c][u] = k0 + c < K && d < nd ? X.Vt[(size_t)(k0 + c) * ndp + d] : 0.0;
      }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      double acc = 0.0;
#pragma unroll
      for (int u = 0; u < ND32; ++u) {
        const int d = lane + 32 * u;
        if (d < nd) acc += vv[c][u] * b[d];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += VP_SHFL_XOR(acc, o);
      acc = VP_SHFL_IDX(acc, 0);
      if (lane == 0 && k0 + c < K) ts[k0 + c] = X.g_s[k0 + c] - acc;
    }
  }
  __syncthreads();
  for (int p = tid; p < P; p += bd) out[nd + p] = (TO)(X.wp[p] * ts[p] / X.c_p[p]);
  for (int e = tid; e < 4 * L; e += bd) {
    const int l = e / 4;
    const double* W = X.W + 16 * l + 4 * (e % 4);
    const double* t = ts + P + 4 * l;
    const double dl = W[0] * t[0] + W[1] * t[1] + W[2] * t[2] + W[3] * t[3];
    out[nd + P + e] = (TO)(dl / X.c_l[e]);
  }
}

// ---- launch ----

template <typename TO>
int launch(const VpSchurArgs& A, cudaStream_t stream) {
  const Plan pl = plan(A.nd, A.P, A.L);
  if (pl.smem > SMEM_LIMIT || pl.ndp > MAX_ND) return (int)cudaErrorInvalidValue;
  auto* k_prep = &schur_prep_kernel;
  auto* k_prod = &schur_product_kernel;
  auto* k_fact = &schur_factor_kernel<TO>;
  const cudaError_t e =
      cudaFuncSetAttribute(k_fact, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  const int gx = pl.Kp > 0 ? (pl.Kp + CH - 1) / CH : 1;
  VP_LAUNCH(k_prep, dim3(gx, (pl.ndp + RH - 1) / RH), NT_PREP, 0, stream, A);
  VP_LAUNCH(k_prod, pl.tiles, 128, 0, stream, A);
  VP_LAUNCH(k_fact, 1, NT_FACTOR, pl.smem, stream, A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vp_schur_solve(const VpSchurArgs* A, cudaStream_t stream) {
  return A->out_double ? launch<double>(*A, stream) : launch<float>(*A, stream);
}
