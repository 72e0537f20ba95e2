// K7 line_vote: everything of the line matcher after the anchor KLT -- the
// ClosestLine assignment, the Point2Line votes and gates, the duplicate-target
// resolution and the topological (sideness) filter -- in one CTA of 32 warps.
//
// Replaces: vplines_slam_tpu/ops/line_match.py:101-142 (match_lines after the
//   KLT) and :152 topological_filter.  On the TPU the [L0, A, L1] distances
//   were a doubly vmapped broadcast, the votes a one-hot matmul, the
//   duplicate resolution another one-hot product, and the sideness check two
//   [L0, L0] vmapped passes: a dozen small XLA ops per frame.
// Bound on the H100: launch latency and one SM's issue rate.  At L0 = L1 = 64
//   and 8 anchors (~200 of the 512 tracked on a frame, ~35 valid targets)
//   the work is ~7k point-to-segment distances, each with an IEEE division
//   and square root, and a few thousand sideness tests; the inputs are ~8 KB.
// Design: one CTA of 1,024 threads, five barriers, no serial loop over lines:
//   0. every thread reads its anchor slot's ok flag and tracked point (the
//      longest wait, issued first), warps count their live slots and the
//      valid targets by ballot; the segments, the per-target terms of the
//      distance and the midpoints go to shared memory, the [L0, L1] vote
//      table is zeroed;
//   1. the live anchors are compacted in slot order (a warp scan of the
//      ballot counts), and the valid targets in index order;
//   2. ClosestLine: four lanes an anchor, each over every fourth valid
//      target in ascending order, then an argmin over the pair (distance,
//      index) in which the lower index wins on equal distances -- the rule
//      of the ascending scan with a strict `<` (an invalid target, at
//      infinity, never won it); a vote is one integer shared atomic (exact
//      in any order);
//   3. Point2Line: a warp a source row, lanes over the targets, argmax on
//      (votes, index) with the lower index on ties, the tracked count by
//      __popc of a ballot, then the gates (a row with no tracked anchor has
//      no vote and skips the argmax);
//   4. duplicates: a warp a matched source, lanes over the other sources; a
//      source keeps its target unless another source of that target has more
//      votes, or as many and a lower index (the first-argmax rule of the
//      reference's per-target pass, written per source);
//   5. sideness: a warp a matched source, lanes over the others, the
//      consistent and the valid pairs counted by __popc of ballots;
//      jnp.sign(0) = 0 is kept.
//   Eight lanes an anchor, or two, measured slower than four; half warps a
//   row in phases 3-5 measured no faster.
// Arithmetic: every distance, midpoint and sideness product is rounded one
//   operation at a time (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, no
//   contraction) as in the one-CTA kernel this replaces, so that the
//   distances, the `< max_dist` gate and every tie see the same floats; the
//   outputs equal that kernel's to the bit.  The bool masks are read as their
//   bytes and `match` is written as int64, so the wrapper converts nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;       // segments a frame (L0, L1)
constexpr int kMaxRounds = 4;    // anchor slots: L0 * A <= kMaxRounds * kThreads
constexpr int kGroup = 4;        // lanes a tracked anchor in ClosestLine
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// distance from p to the segment t = (x0, y0, abx, aby, max(|ab|^2, 1e-12))
__device__ __forceinline__ float point_to_segment(float px, float py, const float* t) {
  const float t0 = __fdiv_rn(add(mul(sub(px, t[0]), t[2]), mul(sub(py, t[1]), t[3])), t[4]);
  const float u = fminf(fmaxf(t0, 0.f), 1.f);
  const float ex = sub(px, add(t[0], mul(u, t[2]))), ey = sub(py, add(t[1], mul(u, t[3])));
  return __fsqrt_rn(add(mul(ex, ex), mul(ey, ey)));
}

// sign of p relative to the directed segment s (0 stays 0)
__device__ __forceinline__ int side(const float* s, float px, float py) {
  const float c = sub(mul(sub(s[2], s[0]), sub(py, s[1])), mul(sub(s[3], s[1]), sub(px, s[0])));
  return (c > 0.f) - (c < 0.f);
}

__global__ void __launch_bounds__(kThreads)
line_vote_kernel(const float* __restrict__ tracked, const unsigned char* __restrict__ ok,
                 const float* __restrict__ segs0, const unsigned char* __restrict__ valid0,
                 const float* __restrict__ segs1, const unsigned char* __restrict__ valid1,
                 int L0, int A, int L1, float max_dist, float vote_ratio, int min_votes,
                 long long* __restrict__ match_out, float* __restrict__ n_votes_out) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int n_slots = L0 * A;
  float2* s_pt = reinterpret_cast<float2*>(s_dyn);         // [n_slots] live anchors' points
  int* s_live = reinterpret_cast<int*>(s_pt + n_slots);    // [n_slots] and their slots
  int* s_votes = s_live + n_slots;                         // [L0 * L1]
  unsigned char* s_ok = reinterpret_cast<unsigned char*>(s_votes + L0 * L1);  // [n_slots]
  __shared__ float s_tgt[kMaxL][5];  // x0, y0, abx, aby, max(|ab|^2, 1e-12) of segs1
  __shared__ float s_seg0[kMaxL][4], s_seg1[kMaxL][4], s_mid0[kMaxL][2], s_mid1[kMaxL][2];
  __shared__ float s_nv[kMaxL];
  __shared__ int s_v0[kMaxL], s_tj[kMaxL], s_match[kMaxL], s_final[kMaxL];
  __shared__ int s_cnt[kMaxRounds * kWarps], s_tcnt[kMaxL / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rounds = (n_slots + kThreads - 1) / kThreads;

  // 0. the anchors (ok flag and tracked point of every slot), the segments,
  // the valid targets counted
  unsigned live[kMaxRounds];
  float2 pt[kMaxRounds];
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    const int k = r * kThreads + tid;
    const bool in = r < rounds && k < n_slots;
    const unsigned char o = in ? ok[k] : 0;
    pt[r] = in ? make_float2(tracked[2 * k], tracked[2 * k + 1]) : make_float2(0.f, 0.f);
    if (in) s_ok[k] = o;
    live[r] = __ballot_sync(kFull, o != 0);
    if (lane == 0 && r < rounds) s_cnt[r * kWarps + warp] = __popc(live[r]);
  }
  for (int k = tid; k < L0 * L1; k += kThreads) s_votes[k] = 0;
  unsigned tmask = 0;
  if (tid < L0) {
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s_seg0[tid][c] = s[c] = segs0[4 * tid + c];
    s_mid0[tid][0] = mul(0.5f, add(s[0], s[2]));
    s_mid0[tid][1] = mul(0.5f, add(s[1], s[3]));
    s_v0[tid] = valid0[tid];
  } else if (tid >= kMaxL && tid < 2 * kMaxL) {  // warps 4-7: the targets
    const int j = tid - kMaxL;
    bool vj = false;
    if (j < L1) {
      float s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) s_seg1[j][c] = s[c] = segs1[4 * j + c];
      const float abx = sub(s[2], s[0]), aby = sub(s[3], s[1]);
      s_tgt[j][0] = s[0];
      s_tgt[j][1] = s[1];
      s_tgt[j][2] = abx;
      s_tgt[j][3] = aby;
      s_tgt[j][4] = fmaxf(add(mul(abx, abx), mul(aby, aby)), 1e-12f);
      vj = valid1[j] != 0;
    }
    tmask = __ballot_sync(kFull, vj);
    if (lane == 0) s_tcnt[warp - kMaxL / 32] = __popc(tmask);
  }
  __syncthreads();

  // 1. compact the live anchors in slot order (lane l of every warp scans
  // the counts of warp l, round by round) and the valid targets in index order
  int n_live = 0;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r < rounds) {
      const int c = s_cnt[r * kWarps + lane];
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
      }
      const int base = n_live + __shfl_sync(kFull, incl - c, warp);
      n_live += __shfl_sync(kFull, incl, 31);
      if (live[r] >> lane & 1) {
        const int pos = base + __popc(live[r] & ((1u << lane) - 1));
        s_pt[pos] = pt[r];
        s_live[pos] = r * kThreads + tid;
      }
    }
  }
  int n_tgt = 0, t_base = 0;
#pragma unroll
  for (int w = 0; w < kMaxL / 32; ++w) {
    if (w == warp - kMaxL / 32) t_base = n_tgt;
    n_tgt += s_tcnt[w];
  }
  if (tmask >> lane & 1) s_tj[t_base + __popc(tmask & ((1u << lane) - 1))] = tid - kMaxL;
  __syncthreads();

  // 2. ClosestLine: each tracked anchor votes for its nearest valid segment
  const int g = lane / kGroup, gl = lane % kGroup;
  for (int q0 = warp * (32 / kGroup); q0 < n_live; q0 += kWarps * (32 / kGroup)) {
    const int q = q0 + g;
    const bool has = q < n_live;
    float dmin = INFINITY;
    int nearest = 0;
    if (has) {
      const float2 p = s_pt[q];
      for (int t = gl; t < n_tgt; t += kGroup) {  // ascending target index
        const int j = s_tj[t];
        const float d = point_to_segment(p.x, p.y, s_tgt[j]);
        if (d < dmin) {  // strict: the first index wins ties
          dmin = d;
          nearest = j;
        }
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, dmin, off);
      const int oj = __shfl_xor_sync(kFull, nearest, off);
      if (od < dmin || (od == dmin && oj < nearest)) {
        dmin = od;
        nearest = oj;
      }
    }
    if (has && gl == 0 && dmin < max_dist) atomicAdd(&s_votes[(s_live[q] / A) * L1 + nearest], 1);
  }
  __syncthreads();

  // 3. Point2Line: the most-voted target, its votes, the ratio and minimum
  // gates (a source with no tracked anchor has no vote)
  for (int i = warp; i < L0; i += kWarps) {
    int n_tracked = 0;
    for (int a0 = 0; a0 < A; a0 += 32)
      n_tracked += __popc(__ballot_sync(kFull, a0 + lane < A && s_ok[i * A + a0 + lane]));
    int nv = 0, best = 0;
    if (n_tracked > 0) {
      nv = -1;
      for (int j = lane; j < L1; j += 32) {
        const int v = s_votes[i * L1 + j];
        if (v > nv) {
          nv = v;
          best = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(kFull, nv, off);
        const int oj = __shfl_xor_sync(kFull, best, off);
        if (ov > nv || (ov == nv && oj < best)) {
          nv = ov;
          best = oj;
        }
      }
    }
    if (lane == 0) {
      const float fv = (float)nv;
      const bool accept = s_v0[i] && fv >= (float)min_votes &&
                          __fdiv_rn(fv, (float)max(n_tracked, 1)) >= vote_ratio;
      s_nv[i] = fv;
      s_match[i] = accept ? best : -1;
    }
  }
  __syncthreads();

  // 4. duplicate targets: a source keeps its target unless another source of
  // it has more votes, or as many and a lower index
  for (int i = warp; i < L0; i += kWarps) {
    const int m = s_match[i];
    int mf = -1;
    if (m >= 0) {
      const float nv = s_nv[i];
      bool beaten = false;
      for (int o = lane; o < L0; o += 32) {
        const float v = s_match[o] == m ? s_nv[o] : 0.f;
        beaten |= o != i && (v > nv || (v == nv && o < i));
      }
      mf = __any_sync(kFull, beaten) ? -1 : m;
    }
    if (lane == 0) {
      const float* m1 = s_seg1[mf >= 0 ? mf : 0];
      s_final[i] = mf;
      s_mid1[i][0] = mul(0.5f, add(m1[0], m1[2]));
      s_mid1[i][1] = mul(0.5f, add(m1[1], m1[3]));
    }
  }
  __syncthreads();

  // 5. topological filter: line j's midpoint must keep its side of line i
  for (int i = warp; i < L0; i += kWarps) {
    const int mi = s_final[i];
    bool keep = false;
    if (mi >= 0) {
      int n_valid = 0, n_ok = 0;
      for (int j0 = 0; j0 < L0; j0 += 32) {
        const int j = j0 + lane;
        const bool vj = j < L0 && s_final[j] >= 0;
        bool pair_ok = true;
        if (vj && j != i)
          pair_ok = side(s_seg0[i], s_mid0[j][0], s_mid0[j][1]) ==
                    side(s_seg1[mi], s_mid1[j][0], s_mid1[j][1]);
        n_valid += __popc(__ballot_sync(kFull, vj));
        n_ok += __popc(__ballot_sync(kFull, vj && pair_ok));
      }
      keep = __fdiv_rn((float)(n_ok - 1), (float)max(n_valid - 1, 1)) >= 0.6f;
    }
    if (lane == 0) {
      match_out[i] = keep ? mi : -1;
      n_votes_out[i] = s_nv[i];
    }
  }
}

}  // namespace

extern "C" int vp_line_vote(const float* tracked, const unsigned char* ok, const float* segs0,
                            const unsigned char* valid0, const float* segs1,
                            const unsigned char* valid1, int L0, int A, int L1, float max_dist,
                            float vote_ratio, int min_votes, long long* match, float* n_votes,
                            cudaStream_t stream) {
  if (L0 > kMaxL || L1 > kMaxL || L0 < 1 || L1 < 1 || A < 1 || L0 * A > kMaxRounds * kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (sizeof(float2) + sizeof(int) + 1) * L0 * A + sizeof(int) * L0 * L1;
  static size_t smem_allowed = 48 * 1024;  // above it only after the attribute is raised
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        line_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  line_vote_kernel<<<1, kThreads, smem, stream>>>(tracked, ok, segs0, valid0, segs1, valid1,
                                                  L0, A, L1, max_dist, vote_ratio, min_votes,
                                                  match, n_votes);
  return (int)cudaGetLastError();
}
