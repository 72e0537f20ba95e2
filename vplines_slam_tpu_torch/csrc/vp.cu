// K8 vp_grid + vp_score: the vanishing-point detector's sphere accumulator
// and its hypothesis search.
//
// Replaces: vplines_slam_tpu/ops/vp.py:75 detect_vps -- :87-110 the line-pair
//   votes, their scatter-add into the 1-degree (lat, lon) grid and the
//   4-neighbour smoothing (jnp.roll, wrapping on both axes, the latitude
//   wrap included though it is not geometric); :138-162 the grid mass of
//   every (vp1, swept vp2, vp3) hypothesis, the flat argmax and the line
//   classification.  On the TPU the scatter was an XLA scatter-add and the
//   scoring a doubly vmapped gather.
// Bound on the H100: launch latency.  64 lines give 2016 pairs and 64 x 90
//   hypotheses x 3 lookups into a 130 KB grid: tens of kFLOP.
// vp_grid design: a CTA per latitude row of the output (grid_la CTAs of
//   1,024 threads, no atomics).  Each CTA recomputes every pair's vote: the
//   latitude row of its cell first, then, only for a vote landing in the
//   CTA's row or the rows above and below (the latitude wraps, row 0 next
//   to the last), its weight and longitude.  Those votes are compacted in
//   pair order (a thread takes kPairSlots consecutive pair slots, a block
//   scan of the counts gives the offsets), and one warp adds them into the
//   three rows in shared memory, 32 votes at a time: __match_any_sync
//   groups the lanes that hold the same cell and the group's lowest lane
//   adds the group's weights in lane order.  So every cell's sum is formed
//   from 0 in ascending pair order, as in a sequential scatter (the plain
//   version's index_add uses atomics on the card, so it differs from the
//   kernel by float reassociation).  The CTA then smooths its row from the
//   three and writes it, coalesced.  Under 48 KB of shared memory, so no
//   attribute is set on the frame path.
// vp_score design: one launch of a cluster of kCluster = 16 CTAs.  CTA r
//   takes vp1 hypotheses [r * ppc, (r + 1) * ppc) (ppc = ceil(P / 16): 4 of
//   64) and all S sweep positions of each, two threads a hypothesis (4 x 90
//   x 2 of 768): one finds the v2 cell, the other the v3 cell, and a
//   shuffle brings the two masses together.  vp1's cell depends on p alone,
//   so it is found once per p, by threads that hold no hypothesis, while
//   the others find theirs; each score is then ((0 + g[c1]) + g[c2]) +
//   g[c3], as before.  Each CTA takes its best (value, flat index p * S +
//   s): the greatest score, on ties the LOWEST index -- ties are common,
//   since many hypotheses sum the same three cells, and an all-zero grid
//   ties everywhere (index 0) -- a comparison that is exact in any
//   reduction order.  A score is taken only when above -inf, so a NaN score
//   is never taken.  Each CTA writes its best into the leader's shared
//   memory (distributed shared memory; a cluster barrier arrived at on
//   entry and waited for just before makes sure every CTA has started;
//   only warp 0 and the leader's warps that hold a line take part after
//   the CTA's reduction); after one more cluster barrier the other CTAs
//   leave.  Each of the leader's remaining warps folds the 16 bests,
//   rebuilds the winning VP triple, and its threads label their lines.
//   Warp reductions are two redux.sync instructions (the greatest key,
//   the least index that holds it) and a shuffle of the holder's value.
//   No global state outlives the launch.  (Measured on the H100: a thread
//   a hypothesis, the triple pushed with each best, and the line
//   normalisation between the halves of the last barrier were all slower.)
// Products and sums that feed a bin index or a comparison are rounded one
// operation at a time (no FMA contraction), as the plain version computes
// them.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxGridLo = 1024;  // longitude bins vp_grid takes (VPConfig: 360)
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

__device__ __forceinline__ float norm3(const float* v) {
  return __fsqrt_rn(add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2])));
}

// torch.remainder(a, 2 pi) for a = atan2f(.): |a| <= pi < 2 pi, so fmodf(a, 2 pi)
// is a itself, and the result takes the divisor's sign (-0 and NaN pass as
// they are, as there)
__device__ __forceinline__ float wrap_lon(float a) { return a < 0.f ? add(a, 2.f * kPi) : a; }

// unit direction folded to the upper hemisphere
__device__ __forceinline__ void sphere_dir(const float* v_in, float* v) {
  const float nv = norm3(v_in);
  v[0] = __fdiv_rn(v_in[0], nv);
  v[1] = __fdiv_rn(v_in[1], nv);
  v[2] = __fdiv_rn(v_in[2], nv);
  const float s = v[2] < 0.f ? -1.f : 1.f;
  v[0] = mul(v[0], s);
  v[1] = mul(v[1], s);
  v[2] = mul(v[2], s);
}

__device__ __forceinline__ int sphere_row(const float* v, int grid_la) {
  const float lat = acosf(fminf(fmaxf(v[2], -1.f), 1.f));
  const int la = (int)mul(__fdiv_rn(lat, 0.5f * kPi), (float)grid_la);
  return min(max(la, 0), grid_la - 1);
}

__device__ __forceinline__ int sphere_col(const float* v, int grid_lo) {
  const float lon = wrap_lon(atan2f(v[1], v[0]));
  const int lo = (int)mul(__fdiv_rn(lon, 2.f * kPi), (float)grid_lo);
  return min(max(lo, 0), grid_lo - 1);
}

// unit direction -> flat (lat, lon) cell, folded to the upper hemisphere
__device__ int sphere_cell(const float* v_in, int grid_la, int grid_lo) {
  float v[3];
  sphere_dir(v_in, v);
  return sphere_row(v, grid_la) * grid_lo + sphere_col(v, grid_lo);
}

constexpr int kPairSlots = 4;                          // pair slots a thread takes a round
constexpr int kRoundSlots = kThreads * kPairSlots;     // pair slots f = i * L + j a round

__global__ void __launch_bounds__(kThreads)
vp_grid_kernel(const float* __restrict__ line, const float* __restrict__ length,
               const float* __restrict__ angle, const unsigned char* __restrict__ valid,
               int L, int grid_la, int grid_lo, float pair_gate, float* __restrict__ out) {
  extern __shared__ float rows[];  // [3][grid_lo]: rows r - 1, r, r + 1 (wrapped)
  __shared__ int s_cell[kRoundSlots];  // the round's votes in pair order: d * grid_lo + lo
  __shared__ float s_wt[kRoundSlots];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_total;
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < 3 * grid_lo; c += blockDim.x) rows[c] = 0.f;
  const int n_slots = L * L;
  for (int base = 0; base < n_slots; base += kRoundSlots) {
    int cell[kPairSlots];
    float wt[kPairSlots];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kPairSlots; ++k) {
      cell[k] = -1;
      wt[k] = 0.f;
      const int f = base + tid * kPairSlots + k, i = f / L, j = f % L;
      if (f < n_slots && j > i && valid[i] && valid[j]) {
        float inter[3];
        cross3(line + 3 * i, line + 3 * j, inter);
        float dang = fabsf(sub(angle[i], angle[j]));
        dang = fminf(sub(kPi, dang), dang);
        if (norm3(inter) > 1e-9f && dang <= pair_gate) {
          float v[3];
          sphere_dir(inter, v);
          int d = sphere_row(v, grid_la) - r + 1;  // 0, 1, 2: rows r - 1, r, r + 1
          if (d < 0) d += grid_la;
          if (d >= grid_la) d -= grid_la;
          if (d <= 2) {
            const float w = mul(__fsqrt_rn(mul(length[i], length[j])),
                                add(sinf(mul(2.f, dang)), 0.2f));
            if (w > 0.f) {
              cell[k] = d * grid_lo + sphere_col(v, grid_lo);
              wt[k] = w;
              ++cnt;
            }
          }
        }
      }
    }
    // block scan of the counts: this thread's first slot in the vote list
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int t = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0;
      int x = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += u;
      }
      s_warp[lane] = x - t;
      if (lane == 31) s_total = x;
    }
    __syncthreads();
    int pos = s_warp[warp] + incl - cnt;
#pragma unroll
    for (int k = 0; k < kPairSlots; ++k)
      if (cell[k] >= 0) {
        s_cell[pos] = cell[k];
        s_wt[pos] = wt[k];
        ++pos;
      }
    __syncthreads();
    // one warp adds the votes in list order; lanes on one cell add in lane order
    if (warp == 0) {
      const int total = s_total;
      for (int v0 = 0; v0 < total; v0 += 32) {
        const int v = v0 + lane;
        const int c = v < total ? s_cell[v] : -1 - lane;  // idle lanes: a cell of their own
        const float w = v < total ? s_wt[v] : 0.f;
        const unsigned grp = __match_any_sync(0xffffffffu, c);
        const bool leader = c >= 0 && (grp & ((1u << lane) - 1u)) == 0u;
        float acc = leader ? rows[c] : 0.f;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const float wk = __shfl_sync(0xffffffffu, w, k);
          if (leader && ((grp >> k) & 1u)) acc = add(acc, wk);
        }
        if (leader) rows[c] = acc;
        __syncwarp();
      }
    }
    __syncthreads();
  }
  const float* up = rows;
  const float* mid = rows + grid_lo;
  const float* dn = rows + 2 * grid_lo;
  for (int lo = tid; lo < grid_lo; lo += blockDim.x) {
    const int lf = lo == 0 ? grid_lo - 1 : lo - 1, rt = lo + 1 == grid_lo ? 0 : lo + 1;
    out[(size_t)r * grid_lo + lo] = add(add(add(add(mid[lo], up[lo]), dn[lo]), mid[lf]), mid[rt]);
  }
}

__device__ __forceinline__ void hypothesis(const float* vp1, const float* b1, const float* b2,
                                           const float* sweep, int S, int p, int s,
                                           float* v2, float* v3) {
  const float c = sweep[s], sn = sweep[S + s];
#pragma unroll
  for (int k = 0; k < 3; ++k) v2[k] = add(mul(b1[3 * p + k], c), mul(b2[3 * p + k], sn));
  cross3(vp1 + 3 * p, v2, v3);
}

constexpr int kCluster = 16;         // CTAs of vp_score's cluster (a non-portable size)
constexpr int kScoreThreads = 768;   // a CTA: 4 vp1 x 90 sweep positions, two threads each
constexpr int kMaxPairsPerCta = 64;  // vp1 hypotheses a CTA takes: P <= 1,024

// vp_score's shared memory (dynamic: the leader's is written by the other CTAs)
struct ScoreSmem {
  float g1[kMaxPairsPerCta];  // the grid at each of the CTA's vp1 cells
  float warp_val[kScoreThreads / 32];
  int warp_idx[kScoreThreads / 32];
  float cta_val[kCluster];  // the leader's: each CTA's best
  int cta_idx[kCluster];
};

// (value, index) a beats (value, index) b: greater, or equal with a lower index
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// The warp's best (value, index) in every lane: the greatest value (as an
// order-preserving unsigned key; v is never NaN), the least index among the
// lanes whose value equals it (-0 == +0, as the comparison above), and the
// value of the lane that holds that index (its sign of zero).
__device__ __forceinline__ void warp_best(float& v, int& i) {
  unsigned key = __float_as_uint(v);
  key = key & 0x80000000u ? ~key : key | 0x80000000u;
  key = VP_REDUX_MAX(key);
  const float vmax = __uint_as_float(key & 0x80000000u ? key & 0x7fffffffu : ~key);
  const int imin = VP_REDUX_MIN(v == vmax ? i : INT_MAX);
  v = VP_SHFL_IDX(v, __ffs(VP_BALLOT(v == vmax && i == imin)) - 1);
  i = imin;
}

// the best of n (value, index) pairs in every lane of the calling warp
__device__ __forceinline__ void fold_best(const float* val, const int* idx, int n, int lane,
                                          float& v, int& i) {
  v = -INFINITY;
  i = INT_MAX;
  for (int k = lane; k < n; k += 32)
    if (beats(val[k], idx[k], v, i)) {
      v = val[k];
      i = idx[k];
    }
  warp_best(v, i);
}

__global__ void __launch_bounds__(kScoreThreads)
vp_score_kernel(const float* __restrict__ grid, const float* __restrict__ vp1,
                const float* __restrict__ b1, const float* __restrict__ b2,
                const float* __restrict__ sweep, int P, int S,
                const float* __restrict__ line, const unsigned char* __restrict__ valid,
                int L, int grid_la, int grid_lo, float angle_tol,
                float* __restrict__ vps_out, int* __restrict__ vp_id,
                float* __restrict__ best_out) {
  VP_DYN_SMEM(ScoreSmem, sm);
  VP_CLUSTER_ARRIVE();
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5, rank = VP_CLUSTER_RANK();
  const int ppc = (P + kCluster - 1) / kCluster, p0 = rank * ppc;
  const int np = P - p0 < ppc ? (P - p0 > 0 ? P - p0 : 0) : ppc;
  const int nh = np * S;  // this CTA's hypotheses: flat index p0 * S + h
  const int part = tid & 1, step = nt >> 1;
  // the grid at hypothesis (h0 + tid / 2)'s v2 and v3 cells: each of a pair
  // of lanes finds one, a shuffle swaps them; every thread runs every round
  float g2 = 0.f, g3 = 0.f;
  auto cells = [&](int h0) {
    const int h = h0 + (tid >> 1);
    float g = 0.f;
    if (h < nh) {
      float v2[3], v3[3];
      hypothesis(vp1, b1, b2, sweep, S, p0 + h / S, h % S, v2, v3);
      g = grid[sphere_cell(part ? v3 : v2, grid_la, grid_lo)];
    }
    const float o = VP_SHFL_XOR(g, 1);
    g2 = part ? o : g;
    g3 = part ? g : o;
  };
  // vp1's cells once per p, on the last threads (those without a hypothesis
  // of the first round when 2 * np * S + np <= nt), the first round's cells
  for (int i = nt - 1 - tid; i < np; i += nt)
    sm->g1[i] = grid[sphere_cell(vp1 + 3 * (p0 + i), grid_la, grid_lo)];
  cells(0);
  __syncthreads();
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int h0 = 0; h0 < nh; h0 += step) {  // a thread's hypotheses in increasing order
    if (h0 > 0) cells(h0);
    const int h = h0 + (tid >> 1);
    if (h < nh && part == 0) {
      const float score = add(add(add(0.f, sm->g1[h / S]), g2), g3);
      if (score > bv) {
        bv = score;
        bi = p0 * S + h;
      }
    }
  }
  warp_best(bv, bi);
  if (lane == 0) {
    sm->warp_val[warp] = bv;
    sm->warp_idx[warp] = bi;
  }
  __syncthreads();
  // warp 0 and the leader's warps that hold a line (the other threads have
  // arrived at the first barrier and need not wait)
  if (warp != 0 && (rank != 0 || warp * 32 >= L)) return;
  if (warp == 0) fold_best(sm->warp_val, sm->warp_idx, nwarps, lane, bv, bi);
  VP_CLUSTER_WAIT();  // every CTA of the cluster has started
  if (tid == 0) {
    VP_DSMEM(sm->cta_val, 0)[rank] = bv;
    VP_DSMEM(sm->cta_idx, 0)[rank] = bi;
  }
  VP_CLUSTER_SYNC();  // the bests are in the leader's shared memory
  // the leader's warps that hold a line (and thread 0) stay
  if (rank != 0 || warp * 32 >= (L > 1 ? L : 1)) return;
  // each warp takes the winner (no score above -inf, every one NaN: index 0,
  // best -inf) and rebuilds its VP triple
  fold_best(sm->cta_val, sm->cta_idx, kCluster, lane, bv, bi);
  const int b = bi == INT_MAX ? 0 : bi, p = b / S;
  float vps[9];
  hypothesis(vp1, b1, b2, sweep, S, p, b % S, vps + 3, vps + 6);
  for (int k = 0; k < 3; ++k) vps[k] = vp1[3 * p + k];
  if (tid == 0) {
    for (int k = 0; k < 9; ++k) vps_out[k] = vps[k];
    *best_out = bv;
  }
  // lines2Vps: a line passes through a VP when its homogeneous coefficients
  // are (nearly) orthogonal to the VP direction
  for (int l = tid; l < L; l += nt) {
    const float* ln = line + 3 * l;
    const float nl = fmaxf(norm3(ln), 1e-12f);
    float best_ang = INFINITY;
    int best = 0;
    for (int k = 0; k < 3; ++k) {
      const float* v = vps + 3 * k;
      const float dot = add(add(mul(__fdiv_rn(ln[0], nl), v[0]), mul(__fdiv_rn(ln[1], nl), v[1])),
                            mul(__fdiv_rn(ln[2], nl), v[2]));
      const float ang = fabsf(sub(0.5f * kPi, acosf(fminf(fmaxf(fabsf(dot), -1.f), 1.f))));
      if (ang < best_ang) {
        best_ang = ang;
        best = k;
      }
    }
    vp_id[l] = (valid[l] && best_ang < angle_tol) ? best : 3;
  }
}

// vp_score_kernel's cluster of 16, allowed on the first launch on each
// device and not again
cudaError_t score_attributes() {
  static std::atomic<unsigned> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (done.load() >> dev & 1u)) return e;
  e = cudaFuncSetAttribute(vp_score_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done.fetch_or(1u << dev);
  return e;
}

}  // namespace

extern "C" int vp_vp_grid(const float* line, const float* length, const float* angle,
                          const unsigned char* valid, int L, int grid_la, int grid_lo,
                          float pair_gate, float* grid, cudaStream_t stream) {
  // three rows of the grid beside the static vote list, under the 48 KB a
  // CTA gets without an attribute
  if (grid_la < 3 || grid_lo < 1 || grid_lo > kMaxGridLo) return (int)cudaErrorInvalidValue;
  vp_grid_kernel<<<grid_la, kThreads, sizeof(float) * 3 * grid_lo, stream>>>(
      line, length, angle, valid, L, grid_la, grid_lo, pair_gate, grid);
  return (int)cudaGetLastError();
}

extern "C" int vp_vp_score(const float* grid, const float* vp1, const float* b1,
                           const float* b2, const float* sweep, int P, int S, const float* line,
                           const unsigned char* valid, int L, int grid_la, int grid_lo,
                           float angle_tol, float* vps, int* vp_id, float* best,
                           cudaStream_t stream) {
  if (P * S < 1 || (P + kCluster - 1) / kCluster > kMaxPairsPerCta)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = score_attributes();
  if (e == cudaSuccess)
    e = VP_LAUNCH_CLUSTER(vp_score_kernel, kCluster, kCluster, kScoreThreads, sizeof(ScoreSmem),
                          stream, grid, vp1, b1, b2, sweep, P, S, line, valid, L, grid_la,
                          grid_lo, angle_tol, vps, vp_id, best);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
