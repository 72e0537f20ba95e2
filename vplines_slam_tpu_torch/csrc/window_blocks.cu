// K12 window_blocks: the block normal equations of the window from K11's
// per-observation Jacobian blocks.
//
// Replaces: vplines_slam_tpu/solver/lm.py:243 _assemble_blocks (JᵀJ of the
//   dense [R, nd] Jacobian, the per-slot point and line reductions).
// Outputs (all f64): H_dd [nd, nd], g_d [nd], H_dp [nd, P], h_p [P],
//   g_p [P] and, with lines, H_dl [nd, L, 4], Hll_b [L, 4, 4], g_l [L, 4];
//   g = -Jᵀr.
// Accumulates in f64 and emits f64, where the reference sums in f32: the LM
//   solves in f64 and the whitened information spans ~7 decades.  Every sum
//   has one order and there are no atomics, so a run repeats to the last
//   bit; every entry of H_dd is computed once and written to (u, v) and
//   (v, u), so it is symmetric to the bit.
// Structure: H_dd = J_priorᵀ J_prior + the IMU intervals' 30-wide blocks +
//   the observations' part, which touches only the 6 pose dims of each frame,
//   the extrinsic and the relo pose: a reduced [6 nf + 12]² matrix.
// Two launches:
//   (1) one grid of three roles, each CTA staging what it reads once (a
//       thread per row, all of the row's loads in flight), widened to f64 in
//       shared memory:
//       - prior: a CTA per pair of 16-column bands of J_prior, their 16x16
//         block (and J_priorᵀ r on the diagonal) on the f64 tensor cores
//         (mma.sync m8n8k4), plus the IMU intervals' terms; an entry off the
//         observations' dims is final here, the others go to scratch;
//       - point chunks (SP slots) and line chunks (SL slots): the slots' rows
//         staged densely over column blocks of 8 (a node's 6 dims, then the
//         slots' landmark columns and r), whose Gram on the f64 MMA gives the
//         chunk's partial of the reduced matrix and gradient and, in the
//         landmark columns, the slots' final H_dp, h_p, g_p (H_dl, Hll_b,
//         g_l).  Each k-step (4 rows) carries the mask of the blocks its rows
//         touch (built from pt_start on the device: no host sync), and a tile
//         multiplies only the steps that touch both of its blocks, so the
//         work follows the rows that touch a tile.  The chunks split the heavy
//         tiles (extrinsic, relo, an anchor's blocks, or all of them when
//         every point is anchored at one frame) over slots;
//   (2) finalize: each reduced entry of H_dd and g_d adds the chunks'
//       partials in chunk order (FG threads an entry and a fixed shuffle
//       tree) to the prior and IMU terms.
// Bound on the H100: bytes (the blocks are read once and the outputs written
//   once: ~0.4 MB at the EuRoC window), a few tenths of a microsecond.  What
//   sets the time: a warp issues f64 MMAs far below the card's peak rate and
//   waits out each one's latency, so a chunk's Gram spreads its tiles over
//   the warps, TU chains a warp; and the two dependent launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"


struct VpBlkArgs {
  // inputs: r [R], J_prior [nd, nd], J_imu [nf-1, 15, 30], J_pt [P, nf, 2, 19],
  // J_relo [P, 2, 19], J_ln / J_vp [L, nf, 2, 16], pt_start [P]
  const void *r, *J_prior, *J_imu, *J_pt, *J_relo, *J_ln, *J_vp;
  const int64_t* pt_start;
  // outputs
  double *H_dd, *g_d, *H_dp, *h_p, *g_p, *H_dl, *Hll, *g_l;
  // scratch of BlkPlan::scratch doubles (launch 1 -> launch 2)
  double* scratch;
  int nf, P, L, has_relo, has_lines, has_vps;
  int off_imu, off_pt, off_ln, off_vp, off_relo, is_double;
};

namespace {

constexpr int NT = 512;      // threads a CTA, both launches
constexpr int WARPS = NT / 32;
constexpr int PB = 16;       // prior: columns of a band
constexpr int SP = 4;        // point slots a chunk
constexpr int SL = 2;        // line slots a chunk
constexpr int PAD = 4;       // doubles past a staged row's width (rows off one bank)
constexpr int FG = 8;        // finalize: threads summing one reduced entry's partials

struct BlkPlan {
  int nd, NR, kp, ndp, nbands, nb_prior, n_pc, n_lc, grid1, grid2;
  int kpt, kln;  // rows of a point / line chunk's block
  // scratch offsets, in doubles
  size_t o_prior, o_gprior, o_part, scratch;
  size_t smem;
};

__host__ __device__ inline BlkPlan blk_plan(int nf, int P, int L, int lines, int vps) {
  BlkPlan p;
  p.nd = 15 * nf + 12;
  p.NR = 6 * nf + 12;
  p.kp = (p.nd + 3) / 4 * 4;  // the prior MMA's k, zero padded
  p.ndp = (p.nd + PB - 1) / PB * PB;
  p.nbands = p.ndp / PB;
  p.nb_prior = p.nbands * (p.nbands + 1) / 2;
  p.n_pc = (P + SP - 1) / SP;
  p.n_lc = lines ? (L + SL - 1) / SL : 0;
  p.grid1 = p.nb_prior + p.n_pc + p.n_lc;
  const int n_fin = (p.NR * (p.NR + 1) / 2 * FG + 31) / 32 * 32 + p.NR * FG;  // its two ranges
  p.grid2 = (n_fin + NT - 1) / NT;
  p.kpt = SP * (2 * nf + 2);
  p.kln = (SL * (vps ? 2 : 1) * 2 * nf + 3) / 4 * 4;
  const size_t C = (size_t)p.n_pc + p.n_lc;
  p.o_prior = 0;  // [ndp, ndp], both triangles
  p.o_gprior = p.o_prior + (size_t)p.ndp * p.ndp;
  p.o_part = p.o_gprior + p.ndp;  // [C, NR (NR + 1)]: each chunk's partial, then its gradient
  p.scratch = p.o_part + C * p.NR * (p.NR + 1);
  const size_t s_prior = sizeof(double) * ((size_t)(2 * PB + 1) * p.kp + PB * PB + PB);
  const size_t ws = 8 * (nf + 3) + PAD;  // both chunks' blocks: 8 (nf + 3) columns
  const size_t s_pt = sizeof(double) * p.kpt * ws + sizeof(int) * (SP + p.kpt / 4);
  const size_t s_ln = lines ? sizeof(double) * p.kln * ws + sizeof(int) * (p.kln / 4) : 0;
  p.smem = s_prior;
  if (s_pt > p.smem) p.smem = s_pt;
  if (s_ln > p.smem) p.smem = s_ln;
  return p;
}

// node of dense dim d (frame k: 15 dims at 15k; the extrinsic: 6 at 15 nf;
// the relo pose: 6 at 15 nf + 6) and its offset there
__device__ __forceinline__ void node_of(int d, int nf, int& n, int& o) {
  if (d < 15 * nf) {
    n = d / 15, o = d % 15;
  } else if (d < 15 * nf + 6) {
    n = nf, o = d - 15 * nf;
  } else {
    n = nf + 1, o = d - 15 * nf - 6;
  }
}
// the reduced index of (n, o) (the observations' columns: a frame's 6 pose
// dims, the extrinsic, the relo pose), -1 off it
__device__ __forceinline__ int reduced(int n, int o, int nf) {
  if (n < nf) return o < 6 ? 6 * n + o : -1;
  return 6 * nf + 6 * (n - nf) + o;
}
// the dense dim of reduced index u
__device__ __forceinline__ int dense_of(int u, int nf) {
  return u < 6 * nf ? 15 * (u / 6) + u % 6 : 15 * nf + (u - 6 * nf);
}
// pair (a <= b) number t of the upper triangle of n
__device__ __forceinline__ void tri_pair(int t, int n, int& a, int& b) {
  a = 0;
  while (t >= n - a) t -= n - a, ++a;
  b = a + t;
}

// n consecutive values of src, all loads issued before the first use (a
// thread stages a whole row, so no load waits for another)
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, T (&v)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = src[c];
}

// D (an 8x8 tile, D[m][2 kq + {0, 1}] in each lane) = sum over k < K (a
// multiple of 4) of X[k][cx + m] Y[k][cy + n], X and Y row-major in shared
// memory with strides sx, sy.  The MMA's latency, not its rate, bounds a
// chain of k-steps, so k-step q goes to chain q % 4; the chains are added in
// one order at the end.
__device__ __forceinline__ void gram_tile(const double* X, int sx, int cx, const double* Y, int sy,
                                          int cy, int K, double& d0, double& d1) {
  const int lane = threadIdx.x & 31, m = lane >> 2, kq = lane & 3;
  double c[4][2] = {};
  const int steps = K / 4;
  for (int q0 = 0; q0 < steps; q0 += 4) {
    double a[4], b[4];
#pragma unroll
    for (int z = 0; z < 4; ++z) {
      const int k = 4 * (q0 + z) + kq;
      a[z] = q0 + z < steps ? X[k * sx + cx + m] : 0.0;
      b[z] = q0 + z < steps ? Y[k * sy + cy + m] : 0.0;
    }
#pragma unroll
    for (int z = 0; z < 4; ++z) VP_MMA_F64(c[z][0], c[z][1], a[z], b[z]);
  }
  d0 = (c[0][0] + c[1][0]) + (c[2][0] + c[3][0]);
  d1 = (c[0][1] + c[1][1]) + (c[2][1] + c[3][1]);
}

// ---- launch 1, role prior: a 16x16 block of J_priorᵀ J_prior (and
// J_priorᵀ r) on the f64 MMA, plus the IMU intervals' terms ----

// x [m] y over an IMU interval's 15 rows (global, the engine dtype), even and
// odd rows apart
template <typename T>
__device__ __forceinline__ double dot15(const T* x, int sx, const T* y, int sy) {
  double h0 = 0.0, h1 = 0.0;
#pragma unroll
  for (int m = 0; m < 14; m += 2) {
    h0 += (double)x[m * sx] * (double)y[m * sy];
    h1 += (double)x[(m + 1) * sx] * (double)y[(m + 1) * sy];
  }
  return (h0 + (double)x[14 * sx] * (double)y[14 * sy]) + h1;
}

// The IMU intervals' term of H_dd[u][v] (frames' dims only): interval k's
// block J_imu[k] is 15 rows over frame k's 15 dims, then frame k + 1's
template <typename T>
__device__ __forceinline__ double imu_term(const T* Ji, int nf, int u, int v) {
  int nu, ou, nv, ov;
  node_of(u, nf, nu, ou);
  node_of(v, nf, nv, ov);
  if (nu >= nf || nv >= nf) return 0.0;
  if (nu == nv) {  // interval f-1's second half, then interval f's first
    double h = nu > 0 ? dot15(Ji + (nu - 1) * 450 + 15 + ou, 30, Ji + (nu - 1) * 450 + 15 + ov, 30)
                      : 0.0;
    if (nu < nf - 1) h += dot15(Ji + nu * 450 + ou, 30, Ji + nu * 450 + ov, 30);
    return h;
  }
  if (nv == nu + 1) return dot15(Ji + nu * 450 + ou, 30, Ji + nu * 450 + 15 + ov, 30);
  if (nu == nv + 1) return dot15(Ji + nv * 450 + ov, 30, Ji + nv * 450 + 15 + ou, 30);
  return 0.0;
}

// the IMU intervals' term of g (J_imuᵀ r) at dense dim u
template <typename T>
__device__ __forceinline__ double imu_grad(const T* Ji, const T* ri, int nf, int u) {
  int n, o;
  node_of(u, nf, n, o);
  if (n >= nf) return 0.0;
  double h = n > 0 ? dot15(Ji + (n - 1) * 450 + 15 + o, 30, ri + (n - 1) * 15, 1) : 0.0;
  if (n < nf - 1) h += dot15(Ji + n * 450 + o, 30, ri + n * 15, 1);
  return h;
}

// Band pair b (ba >= bb): the block of H_dd at rows PB ba.., columns PB bb..
// (and its mirror).  An entry off the reduced pairs is final here (prior +
// IMU); a reduced pair's goes to scratch for launch 2 to add the
// observations.  On the diagonal pairs, g likewise.
template <typename T>
__device__ void prior_role(const VpBlkArgs& A, const BlkPlan& pl, int b, double* sm) {
  const int nd = pl.nd, nf = A.nf, kp = pl.kp, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int ba, bb;  // bands, ba >= bb
  tri_pair(b, pl.nbands, bb, ba);
  const T* J = (const T*)A.J_prior;
  double* sA = sm;  // [kp, PB]: columns PB ba.. of J_prior
  double* sB = ba == bb ? sA : sm + kp * PB;
  double* sr = sm + 2 * kp * PB;  // [kp]
  double* blk = sr + kp;          // [PB, PB] the block, then [PB] g
  // a thread per row k of a band (its 16 columns, zero past nd), and on the
  // diagonal r[k]
  const int nband = ba == bb ? 1 : 2;
  for (int e = threadIdx.x; e < nband * kp; e += NT) {
    const int band = e / kp, k = e % kp, c0 = PB * (band == 0 ? ba : bb);
    double* dst = (band == 0 ? sA : sB) + k * PB;
    if (k < nd && c0 + PB <= nd) {
      T v[PB];
      load_row(J + (size_t)k * nd + c0, v);
#pragma unroll
      for (int c = 0; c < PB; ++c) dst[c] = (double)v[c];
    } else {
      for (int c = 0; c < PB; ++c)
        dst[c] = k < nd && c0 + c < nd ? (double)J[(size_t)k * nd + c0 + c] : 0.0;
    }
  }
  if (ba == bb)
    for (int k = threadIdx.x; k < kp; k += NT) sr[k] = k < nd ? (double)((const T*)A.r)[k] : 0.0;
  __syncthreads();
  // warps 0-3: the 8x8 tiles (ta, tb) of the block (the upper one of a
  // diagonal block is its lower one's mirror); warps 4-5 of a diagonal block:
  // J_priorᵀ r of its 8-row halves (r as every column of B: column 0 of D)
  const bool grad = w >= 4;
  const int ta = grad ? w - 4 : w >> 1, tb = grad ? 0 : w & 1, m = lane >> 2, kq = lane & 3;
  if (w < 6 && !(grad && ba != bb) && !(!grad && ba == bb && ta < tb)) {
    double d0, d1;
    if (grad) {
      gram_tile(sA, PB, 8 * ta, sr, 1, -m, kp, d0, d1);
      if (kq == 0) blk[PB * PB + 8 * ta + m] = d0;
    } else {
      gram_tile(sA, PB, 8 * ta, sB, PB, 8 * tb, kp, d0, d1);
      const int r = 8 * ta + m, c = 8 * tb + 2 * kq;
      blk[r * PB + c] = d0;
      blk[r * PB + c + 1] = d1;
    }
  }
  __syncthreads();
  // the outputs: prior + IMU, a thread per entry of the block (on a diagonal
  // block, its lower triangle), then per g entry
  const T* Ji = (const T*)A.J_imu;
  const T* ri = (const T*)A.r + A.off_imu;
  double* S = A.scratch;
  for (int e = threadIdx.x; e < PB * PB + (ba == bb ? PB : 0); e += NT) {
    if (e < PB * PB) {
      const int r = e / PB, c = e % PB, u = PB * ba + r, v = PB * bb + c;
      if (u >= nd || v >= nd || (ba == bb && c > r)) continue;
      const double h = blk[e] + (nf > 1 ? imu_term(Ji, nf, u, v) : 0.0);
      int nu, ou, nv, ov;
      node_of(u, nf, nu, ou);
      node_of(v, nf, nv, ov);
      if (reduced(nu, ou, nf) >= 0 && reduced(nv, ov, nf) >= 0) {
        S[pl.o_prior + (size_t)v * pl.ndp + u] = h;  // (v <= u) launch 2 adds the observations
      } else {
        A.H_dd[(size_t)u * nd + v] = h;
        A.H_dd[(size_t)v * nd + u] = h;
      }
    } else {
      const int u = PB * ba + e - PB * PB;
      if (u >= nd) continue;
      const double g = blk[e] + (nf > 1 ? imu_grad(Ji, ri, nf, u) : 0.0);
      int n, o;
      node_of(u, nf, n, o);
      if (reduced(n, o, nf) >= 0)
        S[pl.o_gprior + u] = g;
      else
        A.g_d[u] = -g;
    }
  }
}

// ---- launch 1, roles point chunk and line chunk ----
//
// A chunk stages its rows densely over columns in blocks of 8: node n's 6
// dims at 8 n (the frames, the extrinsic nf, the relo pose nf + 1), then
// extra blocks for the slots' landmark columns and r.  The Gram of the block
// on the f64 MMA, a warp per pair of column blocks, gives the chunk's partial
// of the reduced matrix and gradient and, in the extra columns, the slots'
// final H_dp, h_p, g_p (H_dl, Hll_b, g_l).  Each k-step (4 rows) carries the
// mask of the blocks its rows touch, and a pair multiplies only the k-steps
// that touch both of its blocks: a point row touches 3 of the 14.

// zero a chunk's block
__device__ __forceinline__ void zero_block(double* sm, int n) {
  for (int e = threadIdx.x; e < n; e += NT) sm[e] = 0.0;
}

constexpr int TU = 4;  // tiles of one block column a warp accumulates at once

// Unit u of a chunk's Gram: TU tiles (bx0 .. bx0 + TU - 1, by) of block
// column by, bx0 >= by; a block column of n - by tiles makes
// ceil((n - by) / TU) units.  A warp issues its MMAs one at a time and a
// chain waits for its last, so the units spread a column's tiles over the
// warps (a warp per column left the worst chunk's anchor column, 14 tiles
// over every k-step, on one warp) and a unit keeps TU chains in flight.
__device__ __forceinline__ int gram_units(int nb) {
  int n = 0;
  for (int by = 0; by < nb; ++by) n += (nb - by + TU - 1) / TU;
  return n;
}
__device__ __forceinline__ void gram_unit(int u, int nb, int& by, int& bx0) {
  for (by = 0;; ++by) {
    const int n = (nb - by + TU - 1) / TU;
    if (u < n) break;
    u -= n;
  }
  bx0 = by + TU * u;
}

// Tiles (bx0 + x, by), x < TU, of a chunk's Gram over the k-steps whose
// rows touch block by (a ballot of the steps' masks finds them), each tile
// only where the step's rows touch its block bx too (the others' products
// are zero).  D[x] holds tile (bx0 + x, by) on return.
__device__ __forceinline__ void gram_unit_tiles(const double* X, int ws, int bx0, int by, int nb,
                                                const unsigned* mask, int steps,
                                                double (&D)[TU][2]) {
  const int lane = threadIdx.x & 31, m = lane >> 2, kq = lane & 3;
#pragma unroll
  for (int x = 0; x < TU; ++x) D[x][0] = D[x][1] = 0.0;
  for (int q0 = 0; q0 < steps; q0 += 32) {
    unsigned act = VP_BALLOT(q0 + lane < steps && (mask[q0 + lane] >> by & 1u));
    while (act) {
      const int q = q0 + __ffs(act) - 1;
      act &= act - 1;
      const unsigned mk = mask[q];
      const double* row = X + (4 * q + kq) * ws + m;
      const double b = row[8 * by];
      double a[TU];  // the unit's loads, all before its first MMA
#pragma unroll
      for (int x = 0; x < TU; ++x) a[x] = bx0 + x < nb ? row[8 * (bx0 + x)] : 0.0;
#pragma unroll
      for (int x = 0; x < TU; ++x)
        if (bx0 + x < nb && (mk >> (bx0 + x) & 1u)) VP_MMA_F64(D[x][0], D[x][1], a[x], b);
    }
  }
}

// Point chunk c: slots [p0, p0 + ns).  Row (j SP + s) 2 + k is slot s's
// observation j, row k; row 2 SP nf + 2 s + k its relo row k.  Block E =
// nf + 2 holds the depths (column s) and r (column SP).  An anchor's own
// observation (j == i) adds its two pose columns in the input type, as the
// twin's scatter.
template <typename T>
__device__ void point_role(const VpBlkArgs& A, const BlkPlan& pl, int c, double* sm) {
  const int nf = A.nf, NR = pl.NR, P = A.P, nf2 = 2 * nf, E = nf + 2;
  const int K = pl.kpt, W = 8 * (nf + 3), ws = W + PAD, steps = K / 4;
  const int p0 = c * SP, ns = P - p0 < SP ? P - p0 : SP;
  int* anc = (int*)(sm + (size_t)K * ws);
  unsigned* mask = (unsigned*)(anc + SP);
  for (int s = threadIdx.x; s < SP; s += NT) anc[s] = s < ns ? (int)A.pt_start[p0 + s] : 0;
  zero_block(sm, K * ws);
  __syncthreads();
  const T* Jp = (const T*)A.J_pt + (size_t)p0 * nf2 * 19;
  const T* rp = (const T*)A.r + A.off_pt + (size_t)p0 * nf2;
  const T* Jr = (const T*)A.J_relo + (size_t)p0 * 38;
  const T* rr = (const T*)A.r + A.off_relo + 2 * p0;
  // a thread per row: slot s's observation (j, k) is source row (s nf + j) 2 + k
  const int n_obs = ns * nf2;
  for (int t = threadIdx.x; t < n_obs + (A.has_relo ? 2 * ns : 0); t += NT) {
    T v[19];
    const bool relo = t >= n_obs;
    const int q = relo ? t - n_obs : t, s = relo ? q / 2 : q / nf2, i = anc[s];
    const int j = relo ? -1 : q / 2 % nf, k = q % 2;
    load_row((relo ? Jr : Jp) + (size_t)q * 19, v);
    const T rv = relo ? rr[q] : rp[q];
    double* row = sm + (size_t)(relo ? 2 * SP * nf + q : (j * SP + s) * 2 + k) * ws;
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      if (j == i) {  // an anchor's own observation: its two pose columns summed
        row[8 * i + o] = (double)(v[o] + v[6 + o]);
      } else {
        row[8 * i + o] = (double)v[o];
        row[8 * (relo ? nf + 1 : j) + o] = (double)v[6 + o];
      }
      row[8 * nf + o] = (double)v[12 + o];
    }
    row[8 * E + s] = (double)v[18];
    row[8 * E + SP] = (double)rv;
  }
  for (int q = threadIdx.x; q < steps; q += NT) {  // the blocks each k-step touches
    unsigned mk = (1u << nf) | (1u << E);
    for (int row = 4 * q; row < 4 * q + 4; ++row) {
      if (row < 2 * SP * nf) {
        const int js = row / 2;
        mk |= (1u << (js / SP)) | (1u << anc[js % SP]);
      } else {
        mk |= (1u << (nf + 1)) | (1u << anc[(row - 2 * SP * nf) / 2]);
      }
    }
    mask[q] = mk;
  }
  __syncthreads();
  // the Gram, a warp per block column, each warp writing its tiles' outputs
  const int nb = W / 8, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  double* part = A.scratch + pl.o_part + (size_t)c * NR * (NR + 1);
  double* gpart = part + NR * NR;
  for (int u = w; u < gram_units(nb); u += WARPS) {
    const int m = lane >> 2, kq = lane & 3;
    int by, bx0;
    gram_unit(u, nb, by, bx0);
    double D[TU][2];
    gram_unit_tiles(sm, ws, bx0, by, nb, mask, steps, D);
#pragma unroll
    for (int x = 0; x < TU; ++x) {
      const int bx = bx0 + x;
      if (bx >= nb) continue;
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        const int mx = m, my = 2 * kq + z;
        const double d = D[x][z];
        if (bx == by && mx < my) continue;  // the upper half of a diagonal tile
        if (bx < E && mx < 6 && my < 6) {
          const int x = 6 * bx + mx, y = 6 * by + my;
          part[x * NR + y] = d;
          part[y * NR + x] = d;
        } else if (bx == E && by < E && my < 6) {
          const int y = 6 * by + my;
          if (mx < ns) A.H_dp[(size_t)dense_of(y, nf) * P + p0 + mx] = d;
          if (mx == SP) gpart[y] = d;
        } else if (bx == E && by == E) {
          if (mx < ns && my == mx) A.h_p[p0 + mx] = d;
          if (mx == SP && my < ns) A.g_p[p0 + my] = -d;
        }
      }
    }
  }
  // H_dp's rows off the reduced dims (a frame's v, ba, bg)
  for (int e = threadIdx.x; e < nf * 9 * ns; e += NT) {
    const int s = e % ns, q = e / ns;
    A.H_dp[(size_t)(15 * (q / 9) + 6 + q % 9) * P + p0 + s] = 0.0;
  }
}

// Line chunk c: slots [l0, l0 + ns).  Row ((j SL + s) nfam + f) 2 + k is slot
// s's observation j, row k, of family f (lines, then VPs).  Blocks 0..nf
// are the frames and the extrinsic; the extra blocks from E = nf + 1 hold
// orth kk of slot s at 4 s + kk and r at 4 SL.
template <typename T>
__device__ void line_role(const VpBlkArgs& A, const BlkPlan& pl, int c, double* sm) {
  const int nf = A.nf, NR = pl.NR, L = A.L, nf2 = 2 * nf, E = nf + 1;
  const int nfam = A.has_vps ? 2 : 1, K = pl.kln, W = 8 * (E + 2), ws = W + PAD, steps = K / 4;
  const int l0 = c * SL, ns = L - l0 < SL ? L - l0 : SL;
  unsigned* mask = (unsigned*)(sm + (size_t)K * ws);
  zero_block(sm, K * ws);
  __syncthreads();
  // a thread per row: family f's value (s nf + j) 2 + k
  const T* Jf[2] = {(const T*)A.J_ln + (size_t)l0 * nf2 * 16, (const T*)A.J_vp + (size_t)l0 * nf2 * 16};
  const T* rf[2] = {(const T*)A.r + A.off_ln + (size_t)l0 * nf2,
                    (const T*)A.r + A.off_vp + (size_t)l0 * nf2};
  for (int t = threadIdx.x; t < nfam * ns * nf2; t += NT) {
    const int fam = t / (ns * nf2), q = t % (ns * nf2), s = q / nf2, j = q / 2 % nf, k = q % 2;
    T v[16];
    load_row(Jf[fam] + (size_t)q * 16, v);
    const T rv = rf[fam][q];
    double* row = sm + (size_t)(((j * SL + s) * nfam + fam) * 2 + k) * ws;
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      row[8 * j + o] = (double)v[o];
      row[8 * nf + o] = (double)v[6 + o];
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) row[8 * E + 4 * s + o] = (double)v[12 + o];
    row[8 * E + 4 * SL] = (double)rv;
  }
  for (int q = threadIdx.x; q < steps; q += NT) {
    unsigned mk = (1u << nf) | (3u << E);
    for (int row = 4 * q; row < 4 * q + 4 && row < 2 * nfam * SL * nf; ++row)
      mk |= 1u << (row / (2 * nfam) / SL);
    mask[q] = mk;
  }
  __syncthreads();
  const int nb = W / 8, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int C = pl.n_pc + c;
  double* part = A.scratch + pl.o_part + (size_t)C * NR * (NR + 1);
  double* gpart = part + NR * NR;
  for (int u = w; u < gram_units(nb); u += WARPS) {
    const int m = lane >> 2, kq = lane & 3;
    int by, bx0;
    gram_unit(u, nb, by, bx0);
    double D[TU][2];
    gram_unit_tiles(sm, ws, bx0, by, nb, mask, steps, D);
#pragma unroll
    for (int x = 0; x < TU; ++x) {
      const int bx = bx0 + x;
      if (bx >= nb) continue;
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        const int mx = m, my = 2 * kq + z;
        const double d = D[x][z];
        if (bx == by && mx < my) continue;
        const int ex = 8 * (bx - E) + mx, ey = 8 * (by - E) + my;  // extra columns
        if (bx < E && mx < 6 && my < 6) {
          const int x = 6 * bx + mx, y = 6 * by + my;
          part[x * NR + y] = d;
          part[y * NR + x] = d;
        } else if (bx >= E && by < E && my < 6) {
          const int y = 6 * by + my;
          if (ex < 4 * ns) A.H_dl[((size_t)dense_of(y, nf) * L + l0 + ex / 4) * 4 + ex % 4] = d;
          if (ex == 4 * SL) gpart[y] = d;
        } else if (bx >= E && by >= E) {
          if (ex < 4 * ns && ey / 4 == ex / 4) {
            A.Hll[(size_t)(l0 + ex / 4) * 16 + ex % 4 * 4 + ey % 4] = d;
            A.Hll[(size_t)(l0 + ex / 4) * 16 + ey % 4 * 4 + ex % 4] = d;
          }
          if (ex == 4 * SL && ey < 4 * ns) A.g_l[(size_t)(l0 + ey / 4) * 4 + ey % 4] = -d;
        }
      }
    }
  }
  // the relo pose's rows and columns of the partial and gradient, and H_dl's
  // rows off the frames and the extrinsic
  for (int e = threadIdx.x; e < 6 * NR; e += NT) {
    const int x = 6 * (nf + 1) + e / NR, y = e % NR;
    part[(size_t)x * NR + y] = 0.0;
    part[(size_t)y * NR + x] = 0.0;
  }
  for (int e = threadIdx.x; e < 6; e += NT) gpart[6 * (nf + 1) + e] = 0.0;
  for (int e = threadIdx.x; e < (nf * 9 + 6) * ns * 4; e += NT) {
    const int sk = e % (ns * 4), q = e / (ns * 4);
    const int d = q < nf * 9 ? 15 * (q / 9) + 6 + q % 9 : 15 * nf + 6 + q - nf * 9;
    A.H_dl[((size_t)d * L + l0) * 4 + sk] = 0.0;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) wblk_partials_kernel(VpBlkArgs A) {
  VP_DYN_SMEM(double, sm);
  const BlkPlan pl = blk_plan(A.nf, A.P, A.L, A.has_lines, A.has_vps);
  int b = blockIdx.x;
  if (b < pl.nb_prior) return prior_role<T>(A, pl, b, sm);
  b -= pl.nb_prior;
  if (b < pl.n_pc) return point_role<T>(A, pl, b, sm);
  line_role<T>(A, pl, b - pl.n_pc, sm);
}

// ---- launch 2: H_dd and g_d from the partials, in a fixed order ----

// Two thread ranges, each a whole number of warps: FG threads per reduced
// pair ru <= rv, then per reduced g entry, each summing every FG-th chunk's
// partial, added by a fixed shuffle tree to the prior and IMU terms launch 1
// left in scratch, and written to H_dd[u][v] and [v][u] (g_d[u]).
__global__ void __launch_bounds__(NT) wblk_finalize_kernel(VpBlkArgs A) {
  const BlkPlan pl = blk_plan(A.nf, A.P, A.L, A.has_lines, A.has_vps);
  const int nf = A.nf, nd = pl.nd, NR = pl.NR, C = pl.n_pc + pl.n_lc;
  const double* S = A.scratch;
  const int n1 = (NR * (NR + 1) / 2 * FG + 31) / 32 * 32;
  const int t = blockIdx.x * NT + threadIdx.x;
  const bool grad = t >= n1;
  const int item = (grad ? t - n1 : t) / FG, g = (grad ? t - n1 : t) % FG;
  const bool live = grad ? item < NR : item < NR * (NR + 1) / 2;
  int ru = 0, rv = 0;
  if (live && grad)
    ru = rv = item;
  else if (live)
    tri_pair(item, NR, ru, rv);
  double x = 0.0;
  if (live) {
    const double* q = S + pl.o_part + (grad ? (size_t)NR * NR + ru : (size_t)ru * NR + rv);
    const size_t stride = (size_t)NR * (NR + 1);
    const int per = (C + FG - 1) / FG;
    for (int k0 = 0; k0 < per; k0 += 16) {
      double v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int cc = g + FG * (k0 + k);
        v[k] = k0 + k < per && cc < C ? q[cc * stride] : 0.0;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) x += v[k];
    }
  }
#pragma unroll
  for (int o = 1; o < FG; o <<= 1) x += VP_SHFL_XOR(x, o);  // a fixed tree: ((x0 + x1) + ...)
  if (!live || g != 0) return;
  const int u = dense_of(ru, nf), v = dense_of(rv, nf);  // u <= v
  if (grad) {
    A.g_d[u] = -(S[pl.o_gprior + u] + x);
  } else {
    const double h = S[pl.o_prior + (size_t)u * pl.ndp + v] + x;
    A.H_dd[(size_t)u * nd + v] = h;
    A.H_dd[(size_t)v * nd + u] = h;
  }
}

// ---- launch ----

template <typename T>
int launch(const VpBlkArgs& A, cudaStream_t stream) {
  const BlkPlan pl = blk_plan(A.nf, A.P, A.L, A.has_lines, A.has_vps);
  if (A.nf + 3 > 32) return (int)cudaErrorInvalidValue;  // a chunk's blocks in a 32-bit mask
  auto* k1 = &wblk_partials_kernel<T>;
  auto* k2 = &wblk_finalize_kernel;
  if (pl.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  VP_LAUNCH(k1, pl.grid1, NT, pl.smem, stream, A);
  VP_LAUNCH(k2, pl.grid2, NT, 0, stream, A);
  return (int)cudaGetLastError();
}

}  // namespace

// doubles of scratch the call needs (the wrapper allocates it)
extern "C" long long vp_window_blocks_scratch(int nf, int P, int L, int lines) {
  return (long long)blk_plan(nf, P, L, lines, 1).scratch;
}

extern "C" int vp_window_blocks(const VpBlkArgs* A, cudaStream_t stream) {
  return A->is_double ? launch<double>(*A, stream) : launch<float>(*A, stream);
}
