// K15 fast_tiles + fast_select: the whole of detect_fast (the FAST-9 score
// of every pixel, the 7x7 max-NMS and the top-max_corners of the kept map in
// lax.top_k's order) in two launches, and fast_score in one.
//
// Replaces: vplines_slam_tpu/ops/brief.py:34 fast_score and :70
//   detect_fast.  On the TPU the ring test was 16 rolled copies of the image
//   stacked to [H, W, 16], the arc test an AND of 9 rolled masks, the NMS a
//   reduce_window and the selection lax.top_k over the whole frame.
// Bound on the H100: operations, ~1.2 us at 752x480 (16 * 8 + 40 + 49 f32
//   operations a pixel at 67 TFLOP/s; the image read once and the candidate
//   keys written and read once are ~0.5 us).
// Design:
//   launch 1 (fast_tiles_kernel): a CTA a 32x32 output tile, 360 CTAs in one
//   wave at 752x480.  The 44x44 image region (the tile, 3 px of NMS halo, 3 px
//   of ring) is staged in shared memory, every load in flight before the
//   first store.  Every pixel of the 38x38 tile + halo gets the arc test
//   from its 16 ring reads in shared memory (-inf outside the image: the
//   reference's NMS pad; 0 on the 16 px border), its two masks built in FP32
//   alone (FSET, then FFMA of 0/1 times 2^k onto 2^23, exact, in four partial
//   sums: the integer pipe is half as wide); the pixels that pass the test
//   are compacted into a list by ballots, and their margins summed densely
//   after (~15% of a rendered frame's pixels), added in ring order, each add
//   and subtract rounded on its own, as the previous kernel and the plain
//   version do, so the map is bit-identical.  The 7x7 max is a row pass,
//   then a column pass (max is exact in any order).  A kept pixel with
//   score > 0 (score >= its window's max: plateaus survive) becomes a unique
//   64-bit key, score bits << 32 | (0xFFFFFFFF - flat index): a larger key is
//   a larger score, then a lower index, lax.top_k's order.  Warps compact
//   their keys by ballot, one atomicAdd a CTA reserves the slots in the
//   device buffer of candidates (one slot a pixel, so no input overflows
//   it), and each key adds one to its bin of a 16,384-bin histogram of the
//   key's bits 62..49 (the score's exponent and first six mantissa bits).
//   In score-only mode the launch writes the tile's scores and stops.
//   launch 2 (fast_select_kernel): one CTA of 1,024 threads.  It issues its
//   global loads at once (the count and the histogram, read on the device
//   with no host sync, and the first 8,192 keys), scans the histogram from
//   the top (through shared memory padded against bank conflicts) into each
//   bin's first output slot and finds the bin of the max_corners-th largest
//   key.  One pass places every key of a higher bin at its bin's next slot
//   and lists that bin's keys; each placed key's slot within its bin is its
//   rank there (the number of greater keys: keys are unique), and each
//   listed key's its rank in the list, kept if below the keys still needed
//   (a list of more than 1,024 keys -- ties of score -- is cut first by
//   8-bit digits of the key's lower bits).  So the outputs, xy (idx % W,
//   idx / W) and valid, are written in lax.top_k's order with no sort.  With
//   fewer candidates than k, slots count..k-1 hold the lowest-index pixels
//   whose kept score is 0, in index order, valid false (the reference's
//   stable tie order): each has an index below k, so the candidates below k
//   are marked in a k-bit bitmap and the unmarked bits ranked by a scan.
//   The launch clears the count and the histogram for the next call.  The
//   order of the candidate buffer varies with the atomics; the selection
//   depends only on the key values, so the outputs do not.
// The previous kernel's two passes (0.0134 ms) were latency-bound: a score
//   thread waited 4.6k cycles for its 16 ring loads; the sort of all 360,960
//   pixels and the glue after them took 0.068 ms more (clock64() stamps,
//   torch.profiler).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;          // output tile
constexpr int kS = kT + 6;      // the tile's scores with the NMS halo
constexpr int kI = kT + 12;     // the image region: scores + ring
constexpr int kTileThreads = 256;
constexpr int kSelThreads = 1024;
constexpr int kMaxCorners = 4096;  // ops/brief.MAX_FAST_CORNERS
constexpr int kBinBits = 14;       // the candidates' histogram: key bits 62..49
constexpr int kBins = 1 << kBinBits;
constexpr int kBinsPerThread = kBins / kSelThreads;
constexpr int kBinSlots = kBins + kBins / 32;  // shared memory padded one int in 32
constexpr int kHist = 3;           // the histogram's offset in the state
constexpr int kBoundary = 4096;    // boundary-bin keys held in shared memory
constexpr int kRankMax = 1024;     // a boundary bin ranked within itself up to this
constexpr int kPrefetch = 8;       // keys a thread loads before it places them
constexpr size_t kSmemLimit = 232448;

// the ring (utils' _CIRCLE): offset k of the 16-point Bresenham circle,
// packed three bits an entry (value + 3), so that an unrolled loop folds it
__device__ __forceinline__ int ring_dx(int k) {
  return (int)((0x440053976D63ULL >> (3 * k)) & 7) - 3;
}
__device__ __forceinline__ int ring_dy(int k) {
  return (int)((0x053976D63440ULL >> (3 * k)) & 7) - 3;
}

// 1.0f where a > b (a < b), else 0.0f (C's comparisons: false on NaN): one
// FSET, so that a ring pixel's mask bits cost two FP32 instructions each
// (FSET, FFMA) and no integer ones
__device__ __forceinline__ float one_if_gt(float a, float b) {
  float r;
  asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float one_if_lt(float a, float b) {
  float r;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a circular run of >= 9 set bits in the 16-bit mask m: bit i of a ends up
// set where bits i..i+8 of the doubled mask are (runs of 2, 4, 8, then 9)
__device__ __forceinline__ bool arc9(unsigned m) {
  const unsigned d = m | (m << 16);  // circular: bit k + 16 repeats bit k
  unsigned a = d & (d >> 1);
  a &= a >> 2;
  a &= a >> 4;
  a &= d >> 8;
  return (a & 0xFFFFu) != 0;
}

__device__ __forceinline__ unsigned lanemask_lt(int lane) { return (1u << lane) - 1u; }

// the histogram bin of a candidate key (its score's exponent and first six
// mantissa bits; bit 63 is 0 for a positive score)
__device__ __forceinline__ int key_bin(unsigned long long key) {
  return (int)(key >> (63 - kBinBits)) & (kBins - 1);
}
__device__ __forceinline__ int bin_slot(int bin) { return bin + (bin >> 5); }

// state: [0] the candidate count, [1] the candidates' highest bin, [2]
// kBins - 1 - their lowest bin, [kHist + bin] the candidates' histogram
__global__ void __launch_bounds__(kTileThreads)
fast_tiles_kernel(const float* __restrict__ img, int H, int W, float thresh, int mode,
                  float* __restrict__ score, unsigned long long* __restrict__ keys,
                  unsigned* __restrict__ state) {
  __shared__ float s_img[kI][kI + 1];
  __shared__ float s_sc[kS][kS + 1];
  __shared__ float s_rm[kS][kT];
  __shared__ unsigned short s_list[kS * kS];
  __shared__ int s_wn[kTileThreads / 32];
  __shared__ unsigned s_hi[kTileThreads / 32], s_lo[kTileThreads / 32];
  __shared__ int s_nlist;
  __shared__ unsigned s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx0 = blockIdx.x * kT, ty0 = blockIdx.y * kT;
  if (tid == 0) s_nlist = 0;
  {
    constexpr int kLoads = (kI * kI + kTileThreads - 1) / kTileThreads;
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kTileThreads;
      const int y = ty0 - 6 + i / kI, x = tx0 - 6 + i % kI;
      v[u] = (i < kI * kI && y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kTileThreads;
      if (i < kI * kI) s_img[i / kI][i % kI] = v[u];
    }
  }
  __syncthreads();
  // scores of the tile and its 3 px halo: the arc test for every pixel,
  // the pixels that pass it compacted into a list (a ballot a warp), whose
  // margins are then summed densely (most pixels fail the test)
  constexpr int kPasses = (kS * kS + kTileThreads - 1) / kTileThreads;
  unsigned ball[kPasses];
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int i = u * kTileThreads + tid, sy = i / kS, sx = i % kS;
    const int y = ty0 - 3 + sy, x = tx0 - 3 + sx;
    bool corner = false;
    if (i < kS * kS) {
      float out = -INFINITY;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        out = 0.f;
        if (y >= 16 && y < H - 16 && x >= 16 && x < W - 16) {
          const int iy = sy + 3, ix = sx + 3;
          const float c = s_img[iy][ix];
          const float hi = __fadd_rn(c, thresh), lo = __fsub_rn(c, thresh);
          // the masks as exact sums of powers of two over 2^23, whose low 16
          // mantissa bits they become; four partial sums each, so that the
          // chains are short (any order is exact)
          float ab[4] = {8388608.f, 0.f, 0.f, 0.f}, ad[4] = {8388608.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const float r = s_img[iy + ring_dy(k)][ix + ring_dx(k)];
            ab[k & 3] = fmaf(one_if_gt(r, hi), (float)(1 << k), ab[k & 3]);
            ad[k & 3] = fmaf(one_if_lt(r, lo), (float)(1 << k), ad[k & 3]);
          }
          const float fb = (ab[0] + ab[1]) + (ab[2] + ab[3]);
          const float fd = (ad[0] + ad[1]) + (ad[2] + ad[3]);
          corner = arc9(__float_as_uint(fb) & 0xFFFFu) || arc9(__float_as_uint(fd) & 0xFFFFu);
        }
      }
      s_sc[sy][sx] = out;
    }
    ball[u] = __ballot_sync(0xffffffffu, corner);
  }
  {
    int n = 0;
#pragma unroll
    for (int u = 0; u < kPasses; ++u) n += __popc(ball[u]);
    int base = 0;
    if (lane == 0 && n) base = atomicAdd(&s_nlist, n);
    base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      if ((ball[u] >> lane) & 1u)
        s_list[base + __popc(ball[u] & lanemask_lt(lane))] =
            (unsigned short)(u * kTileThreads + tid);
      base += __popc(ball[u]);
    }
  }
  __syncthreads();
  for (int q = tid; q < s_nlist; q += kTileThreads) {
    const int i = s_list[q], iy = i / kS + 3, ix = i % kS + 3;
    const float c = s_img[iy][ix];
    const float lo = __fsub_rn(c, thresh);
    float sb = 0.f, sd = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float r = s_img[iy + ring_dy(k)][ix + ring_dx(k)];
      const float tb = fmaxf(__fsub_rn(__fsub_rn(r, c), thresh), 0.f);
      const float td = fmaxf(__fsub_rn(lo, r), 0.f);
      sb = k == 0 ? tb : __fadd_rn(sb, tb);
      sd = k == 0 ? td : __fadd_rn(sd, td);
    }
    s_sc[iy - 3][ix - 3] = fmaxf(sb, sd);
  }
  __syncthreads();
  if (mode == 0) {
    for (int i = tid; i < kT * kT; i += kTileThreads) {
      const int y = ty0 + i / kT, x = tx0 + i % kT;
      if (y < H && x < W) score[(size_t)y * W + x] = s_sc[i / kT + 3][i % kT + 3];
    }
    return;
  }
  // the 7x7 maximum: rows, then columns
  for (int i = tid; i < kS * kT; i += kTileThreads) {
    const int sy = i / kT, c = i % kT;
    float m = s_sc[sy][c];
#pragma unroll
    for (int d = 1; d < 7; ++d) m = fmaxf(m, s_sc[sy][c + d]);
    s_rm[sy][c] = m;
  }
  __syncthreads();
  // a lane a column, a warp the rows warp, warp + 8, ...: the kept pixels'
  // keys, compacted by ballot
  constexpr int kRows = kT / (kTileThreads / 32);
  unsigned long long key[kRows];
  unsigned kb[kRows], hi_bin = 0, lo_rev = 0;  // the CTA's bin range (as maxima)
  int n = 0;
  const int x = tx0 + lane;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ty = warp + j * (kTileThreads / 32), y = ty0 + ty;
    const float s = s_sc[ty + 3][lane + 3];
    float m = s_rm[ty][lane];
#pragma unroll
    for (int d = 1; d < 7; ++d) m = fmaxf(m, s_rm[ty + d][lane]);
    const bool cand = y < H && x < W && s > 0.f && s >= m;
    const unsigned idx = (unsigned)y * (unsigned)W + (unsigned)x;
    key[j] = ((unsigned long long)__float_as_uint(s) << 32) | (0xFFFFFFFFu - idx);
    kb[j] = __ballot_sync(0xffffffffu, cand);
    n += __popc(kb[j]);
    if (cand) {
      hi_bin = max(hi_bin, (unsigned)key_bin(key[j]));
      lo_rev = max(lo_rev, (unsigned)(kBins - 1 - key_bin(key[j])));
    }
  }
  hi_bin = __reduce_max_sync(0xffffffffu, hi_bin);
  lo_rev = __reduce_max_sync(0xffffffffu, lo_rev);
  if (lane == 0) {
    s_wn[warp] = n;
    s_hi[warp] = hi_bin;
    s_lo[warp] = lo_rev;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    unsigned h = 0, l = 0;
#pragma unroll
    for (int w = 0; w < kTileThreads / 32; ++w) {
      total += s_wn[w];
      h = max(h, s_hi[w]);
      l = max(l, s_lo[w]);
    }
    s_base = total ? atomicAdd(state, (unsigned)total) : 0u;
    if (total) {
      atomicMax(state + 1, h);
      atomicMax(state + 2, l);
    }
  }
  __syncthreads();
  if (n == 0) return;
  unsigned pos = s_base;
  for (int w = 0; w < warp; ++w) pos += s_wn[w];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if ((kb[j] >> lane) & 1u) {
      keys[pos + __popc(kb[j] & lanemask_lt(lane))] = key[j];
      atomicAdd(state + kHist + key_bin(key[j]), 1u);
    }
    pos += __popc(kb[j]);
  }
}

// Warp 0 of the select kernel: the bin holding the need-th largest key of a
// histogram of <= 256 bins read in descending order (lane l the bins
// 255 - 8 l - j), into (s_d, s_above = the keys in the bins above, s_cnt).
__device__ __forceinline__ void find_bin(const int* hist, int need, int lane, int* s_d,
                                         int* s_above, int* s_cnt) {
  int c[8], s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = hist[255 - 8 * lane - j];
    s += c[j];
  }
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const int excl = incl - s;
  if (excl < need && need <= incl) {
    int run = excl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (run + c[j] >= need) {
        *s_d = 255 - 8 * lane - j;
        *s_above = run;
        *s_cnt = c[j];
        break;
      }
      run += c[j];
    }
  }
}

__global__ void __launch_bounds__(kSelThreads)
fast_select_kernel(const unsigned long long* __restrict__ keys, unsigned* __restrict__ state,
                   int n_px, int W, int k, int bnd_cap, float* __restrict__ xy,
                   unsigned char* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem_[];
  unsigned long long* s_bnd = reinterpret_cast<unsigned long long*>(smem_);
  unsigned long long* s_sel = s_bnd + bnd_cap;
  int* s_pre = reinterpret_cast<int*>(s_sel + k);
  int* s_cur = s_pre + kBinSlots;
  __shared__ int s_h8[256];
  __shared__ int s_wsum[kSelThreads / 32];
  __shared__ unsigned s_bits[kMaxCorners / 32];
  __shared__ int s_wpre[kMaxCorners / 32];
  __shared__ int s_d, s_above, s_cnt, s_nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the count and the occupied bins' range first, then (their latencies
  // overlapping) the range's histogram, lane-consecutive, and this thread's
  // first kPrefetch keys; each thread clears the bins it read for the next
  // call
  const unsigned cnt_raw = __ldcg(state), lo_rev = __ldcg(state + 2);
  const int top = (int)__ldcg(state + 1);
  const int cnt = (int)min(cnt_raw, (unsigned)n_px);
  const int m = min(cnt, k);
  // the occupied bins in descending order: q = top - bin, q < nq
  const int nq = cnt ? top - (kBins - 1 - (int)lo_rev) + 1 : 0;
  unsigned hv[kBinsPerThread];
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    const int q = j * kSelThreads + tid;
    hv[j] = q < nq ? __ldcg(state + kHist + top - q) : 0u;
  }
  unsigned long long kk[kPrefetch];
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) {
    const int i = u * kSelThreads + tid;
    kk[u] = i < cnt ? __ldcg(keys + i) : 0ull;
  }
  // the histogram's exclusive prefix from the top bin (the keys in the bins
  // above each bin): thread t takes the positions q = kBinsPerThread t + j,
  // j = 0.., in that order, read back through shared memory padded one int
  // in 32 (bin_slot), so that neither pass has bank conflicts
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    const int q = j * kSelThreads + tid;
    if (q < nq) {
      s_pre[bin_slot(q)] = (int)hv[j];
      state[kHist + top - q] = 0u;
    }
  }
  if (tid == 0) {
    s_nb = 0;
    s_d = -1;  // no boundary bin when every candidate is taken
    s_above = 0;
    s_cnt = 0;
  }
  __syncthreads();
  int c[kBinsPerThread], s = 0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    const int q = kBinsPerThread * tid + j;
    c[j] = q < nq ? s_pre[bin_slot(q)] : 0;
    s += c[j];
  }
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_wsum[lane];
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    s_wsum[lane] = wi - w;
  }
  __syncthreads();
  {
    int run = s_wsum[warp] + incl - s;
    const bool cut = cnt > k && run < k && k <= run + s;
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const int q = kBinsPerThread * tid + j;
      if (q < nq) {
        s_pre[bin_slot(q)] = run;
        s_cur[bin_slot(q)] = 0;
        if (cut && run < k && k <= run + c[j]) {
          s_d = top - q;
          s_above = run;
          s_cnt = c[j];
        }
      }
      run += c[j];
    }
  }
  __syncthreads();
  // one pass over the keys: those in bins above the k-th key's bin are
  // taken, placed by bin; the k-th key's bin goes to the boundary list
  const int bstar = s_d, above = s_above;
  for (int i0 = 0; i0 < cnt; i0 += kPrefetch * kSelThreads) {
    if (i0 > 0) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int i = i0 + u * kSelThreads + tid;
        kk[u] = i < cnt ? __ldcg(keys + i) : 0ull;
      }
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int i = i0 + u * kSelThreads + tid;
      const int d = i < cnt ? key_bin(kk[u]) : -2;
      if (d > bstar) {
        const int q = bin_slot(top - d);
        s_sel[s_pre[q] + atomicAdd(&s_cur[q], 1)] = kk[u];
      }
      const unsigned b = __ballot_sync(0xffffffffu, d == bstar);
      int base = 0;
      if (lane == 0 && b) base = atomicAdd(&s_nb, __popc(b));
      base = __shfl_sync(0xffffffffu, base, 0);
      const int slot = base + __popc(b & lanemask_lt(lane));
      if (d == bstar && slot < bnd_cap) s_bnd[slot] = kk[u];
    }
  }
  __syncthreads();
  const int nb = s_nb, need = k - above;
  // a boundary bin of at most kRankMax keys is ranked within itself below;
  // a larger one (ties of score) by 8-bit digits of the bits below the
  // bin's until the need-th key's bin holds exactly the keys still needed
  // (then into the index bits), its keys >= T placed after the bins above
  const bool by_rank = bstar >= 0 && nb <= kRankMax;
  if (bstar >= 0 && !by_rank) {
    const bool overflow = nb > bnd_cap;  // then from device memory, filtered
    const unsigned long long* src = overflow ? keys : s_bnd;
    const int n_src = overflow ? cnt : nb;
    int left = need;
    constexpr int kLow = 63 - kBinBits;  // the bits below the bin's
    unsigned long long T = (unsigned long long)bstar << kLow, hi_mask = ~0ull << kLow;
    bool done = s_cnt == left;
    for (int hb = kLow - 1; hb >= 0 && !done; hb -= 8) {
      const int shift = hb >= 7 ? hb - 7 : 0;
      const unsigned long long dmask = (1ull << (hb - shift + 1)) - 1ull;
      __syncthreads();  // the previous pass's results are read
      for (int b = tid; b < 256; b += kSelThreads) s_h8[b] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n_src; i0 += kSelThreads) {
        const int i = i0 + tid;
        unsigned long long key = 0;
        bool in = false;
        if (i < n_src) {
          key = src[i];
          in = (key & hi_mask) == T;
        }
        const int d = (int)((key >> shift) & dmask);
        const unsigned peers = __match_any_sync(0xffffffffu, in ? d : 256 + lane);
        if (in && (peers & lanemask_lt(lane)) == 0) atomicAdd(&s_h8[d], __popc(peers));
      }
      __syncthreads();
      if (warp == 0) find_bin(s_h8, left, lane, &s_d, &s_above, &s_cnt);
      __syncthreads();
      left -= s_above;
      T |= (unsigned long long)s_d << shift;
      hi_mask |= dmask << shift;
      done = s_cnt == left;
    }
    for (int i = tid; i < n_src; i += kSelThreads) {
      const unsigned long long key = src[i];
      if (key_bin(key) == bstar && key >= T)
        s_sel[above + atomicAdd(&s_cur[bin_slot(top - bstar)], 1)] = key;
    }
    __syncthreads();
  }
  // each taken key's place: the keys above its bin, then those of its bin
  // greater than it (keys are unique); the outputs written there
  auto put = [&](int slot, unsigned long long key) {
    const unsigned idx = 0xFFFFFFFFu - (unsigned)key;
    xy[2 * slot] = (float)(idx % (unsigned)W);
    xy[2 * slot + 1] = (float)(idx / (unsigned)W);
    valid[slot] = 1;
  };
  const int n_placed = bstar < 0 ? cnt : (by_rank ? above : k);
  for (int r = tid; r < n_placed; r += kSelThreads) {
    const unsigned long long key = s_sel[r];
    const int q = bin_slot(top - key_bin(key)), start = s_pre[q], end = start + s_cur[q];
    int rank = 0, j = start;
    for (; j + 4 <= end; j += 4)
      rank += (s_sel[j] > key) + (s_sel[j + 1] > key) + (s_sel[j + 2] > key) +
              (s_sel[j + 3] > key);
    for (; j < end; ++j) rank += s_sel[j] > key;
    put(start + rank, key);
  }
  if (by_rank) {
    // G consecutive lanes a boundary key, each over a part of the bin, the
    // counts added by shuffles
    const int G = nb <= kSelThreads / 4 ? 4 : nb <= kSelThreads / 2 ? 2 : 1;
    const int per = (nb + G - 1) / G;
    for (int q0 = 0; q0 < nb * G; q0 += kSelThreads) {
      const int q = q0 + tid, ki = q / G, part = q % G;
      const unsigned long long key = ki < nb ? s_bnd[ki] : 0ull;
      int rank = 0;
      if (ki < nb) {
        const int j1 = min(nb, (part + 1) * per);
        int j = part * per;
        for (; j + 4 <= j1; j += 4)
          rank += (s_bnd[j] > key) + (s_bnd[j + 1] > key) + (s_bnd[j + 2] > key) +
                  (s_bnd[j + 3] > key);
        for (; j < j1; ++j) rank += s_bnd[j] > key;
      }
      for (int o = 1; o < G; o <<= 1) rank += __shfl_xor_sync(0xffffffffu, rank, o);
      if (ki < nb && part == 0 && rank < need) put(above + rank, key);
    }
  }
  if (cnt < k) {
    // the fill: the k - cnt lowest indices that are not candidates
    const int nw = (k + 31) / 32;
    for (int w = tid; w < nw; w += kSelThreads) s_bits[w] = 0u;
    __syncthreads();
    for (int r = tid; r < m; r += kSelThreads) {
      const unsigned idx = 0xFFFFFFFFu - (unsigned)s_sel[r];
      if (idx < (unsigned)k) atomicOr(&s_bits[idx >> 5], 1u << (idx & 31));
    }
    __syncthreads();
    if (warp == 0) {
      // the unmarked bits before each word, 4 words a lane
      int cw[4], sw = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = 4 * lane + j;
        cw[j] = w < nw ? __popc(~s_bits[w]) : 0;
        sw += cw[j];
      }
      int iw = sw;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, iw, o);
        if (lane >= o) iw += t;
      }
      int run = iw - sw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * lane + j < nw) s_wpre[4 * lane + j] = run;
        run += cw[j];
      }
    }
    __syncthreads();
    for (int t = tid; t < k; t += kSelThreads) {
      const unsigned word = s_bits[t >> 5], bit = 1u << (t & 31);
      if (word & bit) continue;
      const int slot = m + s_wpre[t >> 5] + __popc(~word & (bit - 1u));
      if (slot < k) {
        xy[2 * slot] = (float)(t % W);
        xy[2 * slot + 1] = (float)(t / W);
        valid[slot] = 0;
      }
    }
  }
  // every thread read the count and the range before the first barrier
  if (tid == 0) state[0] = state[1] = state[2] = 0u;
}

size_t select_smem(int bnd_cap, int k) {
  return (size_t)(bnd_cap + k) * sizeof(unsigned long long) + 2 * kBinSlots * sizeof(int);
}

}  // namespace

// state: [0] the candidate count, [1..16384] their histogram, both 0
// between calls.  mode 0: the score map into score (keys, state unused);
// mode 1: the kept pixels' keys appended to keys, counted in state.
extern "C" int vp_fast_tiles(const float* img, int H, int W, float thresh, int mode, float* score,
                             unsigned long long* keys, unsigned* state, cudaStream_t stream) {
  const dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT);
  fast_tiles_kernel<<<grid, kTileThreads, 0, stream>>>(img, H, W, thresh, mode, score, keys,
                                                       state);
  return (int)cudaGetLastError();
}

// the top k (1 <= k <= kMaxCorners, k <= H * W) of the keys that
// vp_fast_tiles left, into xy [k, 2] and valid [k]; state back to 0
extern "C" int vp_fast_select(const unsigned long long* keys, unsigned* state, int H, int W,
                              int k, float* xy, unsigned char* valid, cudaStream_t stream) {
  const int n_px = H * W;
  if (k < 1 || k > kMaxCorners || k > n_px) return (int)cudaErrorInvalidValue;
  const int bnd_cap = n_px < kBoundary ? n_px : kBoundary;
  const size_t smem = select_smem(bnd_cap, k);
  if (smem + 8 * 1024 > kSmemLimit) return (int)cudaErrorInvalidValue;  // + the static arrays
  static size_t allowed = 48 * 1024;  // above it only after the attribute is raised
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        fast_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  fast_select_kernel<<<1, kSelThreads, smem, stream>>>(keys, state, n_px, W, k, bnd_cap, xy,
                                                       valid);
  return (int)cudaGetLastError();
}
