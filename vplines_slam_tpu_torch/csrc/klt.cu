// K2 klt_track: pyramidal inverse-compositional Lucas-Kanade for N point
// features, every pyramid level in one launch, four warps per feature.
//
// Replaces: vplines_slam_tpu/ops/klt.py:162 _track_level (with
//   extract_windows :92, _take_row_strips :78, _grad_inwin :109 and
//   _inwin_extract :130) and the level loop and gates of track :347.  On the
//   TPU every window was a row-strip gather plus a one-hot column matmul, and
//   every bilinear patch two one-hot matmuls, because scattered gathers were
//   the TPU's bottleneck.
// Bound on the H100: latency.  A call reads ~2.5 KB of image per feature and
//   level and does ~10 x 441 x 12 flops per feature and level: 150 features
//   over three levels are ~1 MB and ~25 MFLOP, far below a microsecond of
//   bandwidth or compute.  What costs is each feature's chain: per level 10
//   (lines: 8) dependent iterations, each a reduction, the moving windows'
//   loads, each of which depends on the flow so far, and the templates'
//   gradients before them.
// Design (a CTA of four warps per feature: the chain is one warp's, the rest
//   of the work the CTA's):
//   - Every level runs in the launch, coarse to fine; the flow stays in
//     registers and doubles between levels as track does.  The kernel
//     writes what track returns: pts1 = pts0 + flow, ok = level 0's
//     conditioning & in-bounds & resid < max_residual, level 0's residual.
//     The coarser levels' ok gates only their own updates, and their final
//     residual, which track discards, is not computed.  With gate = 0 and
//     one level it is _track_level (flow, that level's ok and residual).
//   - The template supersets of all levels and the coarsest level's first
//     moving region depend on pts0 and the initial flow only: their copies
//     (cp.async, 16 bytes where the level's rows allow it, zero-filled
//     outside the image) are all issued before anything waits.  Then the
//     four warps build every level's Scharr gradients (with the superset's
//     wrap-around borders), bilinear T, Ix, Iy, the 2x2 gradient matrix's
//     inverse and gate and, in gain/bias mode, the template's mean and
//     population std.
//   - The iterations run in warp 0 alone, with no barrier: T, Ix and Iy sit
//     in its lanes' registers (NPL pixels a lane: 14 at P = 21, 8 at P =
//     15), each pixel's four bilinear taps stay in registers while the
//     window's integer offset does not change, and every sum (the gradient's
//     two, in gain/bias mode first the moving patch's mean and two-pass std)
//     is a warp's shuffles.
//   - Every sum is added in the order of the previous design's 256-thread
//     block sum (warp_block_sum, cta_block_sum), and every other operation
//     is written as it was, so each level's outputs equal that kernel's to
//     the bit.  With sums in another order the line anchors' flow along
//     their edge (barely conditioned, the gain/bias mode's gate is relaxed
//     for it) moved further from the twin than the previous kernel's, and
//     the lines slice of chip_smoke.py solved no line where the previous
//     kernel and the twin solve one.
//   - The moving window is read from a region kMargin px wider on every
//     side: the re-anchored and the final window are views of it unless the
//     flow left the margin.  During a level's last round the next level's
//     first region is prefetched around twice the flow so far.  Warps 1-3
//     issue their share of a region's copies on warp 0's commands (a slot in
//     shared memory behind a barrier), so only the rare reload waits on the
//     chain.
//   - Tried on the way: a warp per feature doing everything was no faster
//     than the previous kernel (one warp's serial share of the template
//     work); four warps sharing every iteration through a barrier, and two
//     features a CTA, were slower than this layout; the levels' template
//     loops unrolled (the code runs once a launch, so its size costs) were
//     slower than a level loop.
// The reference's semantics are kept one by one: the zero pad E = r + D + 2
//   (read as a bounds test, never materialised; rows clamp into the padded
//   image, as its row take does), the anchor clips on each level's padded
//   size, Scharr on the integer superset with wrap-around borders then
//   interpolated, min_eig / (P*P) and the det > 1e-12 guard, two rounds of
//   iters // 2 with one re-anchor and the drift inside a round clamped to
//   the window, and in gain/bias mode (replaces _gain_bias :152) every
//   moving patch renormalized to the template's mean and two-pass
//   population std (+1e-6 each).  The level inputs are exact power-of-two
//   scalings: pts0 / 2^l and init_flow / 2^(levels-1).

#include <cuda_runtime.h>

#include "common.cuh"

// The launch's arguments (ops/klt._KLT_ARGS), outside the anonymous namespace
// so that the C entry taking it keeps external linkage.
struct VpKltArgs {
  const float* img0[4];  // level l of the first image's pyramid
  const float* img1[4];
  const float* pts0;   // [N, 2] at level 0
  const float* flow0;  // [N, 2] initial flow at level 0, or null
  float* pts1;         // [N, 2]: gate ? pts0 + flow : flow
  unsigned char* ok;   // [N]
  float* resid;        // [N] level 0's mean |residual|
  int H[4];
  int W[4];
  int vec[4];  // 1 where the level allows 16-byte copies
  int levels, N, P, iters, illum, gate;
  double min_eig, max_residual;
};

namespace {

constexpr int kDrift = 5;      // D: in-window drift margin per round (px)
constexpr int kMargin = 8;     // the moving region's margin around a window (px)
constexpr int kMaxLevels = 4;  // pyramid levels a launch takes (VpKltArgs' arrays)
constexpr int kGroup = 128;    // threads (four warps) a feature, a CTA
constexpr int kSmemLimit = 232448;  // dynamic shared memory a CTA may use
constexpr int kMaxSums = 4;  // sums one cta_block_sum adds at most
// warp 0's commands to the helper warps in the iterations: load a region
// and wait, issue a region's copies, wait for them, leave
constexpr int kLoad = 1, kIssue = 2, kWait = 3, kStop = 0;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Row stride of a tile of side S staged by issue_tile: room for the shift
// of its first column inside a 16-byte chunk.
__host__ __device__ constexpr int tile_stride(int S) { return 4 * ((S + 2) / 4 + 1); }

// Floats of a CTA's shared memory (each part a multiple of 4).
struct FeatSmem {
  int tmpl, prm, red, stage, work, reg, total;
  __host__ __device__ FeatSmem(int P, int L) {
    const int TS = P + 3, RS = P + 1 + 2 * kDrift + 2 * kMargin;
    tmpl = round4(L * 3 * P * P);       // T, Ix, Iy of every level
    prm = 8 * L;                        // i00, i01, i11, ok, mT, sT per level
    red = 2 * kMaxSums * 8;             // two slots of up to kMaxSums sums x 8 warps
    stage = L * TS * tile_stride(TS);   // every level's template superset, then Scharr x
    work = round4(3 * TS * TS);         // a level's row passes and Scharr y
    reg = RS * tile_stride(RS);         // a moving region (two of them)
    total = tmpl + prm + red + stage + work + 2 * reg;
  }
};

__device__ __forceinline__ int floor_div4(int x) { return x >= 0 ? x / 4 : -((3 - x) / 4); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// Issue the copies of the S x S tile at padded (y0, x0) of an H x W image
// zero-padded by E on every side: rows clamp into the padded image, pixels
// outside the image read 0.  Element (r, c) lands at dst[r * Sst + shift +
// c], Sst = tile_stride(S); returns shift (0 on the 4-byte path).  Thread t
// issues every kGroup-th copy; they complete at its next cp_async_wait.
__device__ int issue_tile(const float* img, int H, int W, int E, int vec, int y0, int x0,
                          int S, float* dst, int t) {
  const int Sst = tile_stride(S), Hp = H + 2 * E, xs = x0 - E;
  if (vec) {
    // 16 slots a row (a row spans at most tile_stride(58) / 4 = 16 chunks)
    const int c4lo = floor_div4(xs), nv = floor_div4(xs + S - 1) - c4lo + 1, W4 = W / 4;
    for (int it = t; it < S * 16; it += kGroup) {
      const int r = it >> 4, c = it & 15;
      if (c >= nv) continue;
      const int y = min(y0 + r, Hp - 1) - E, c4 = c4lo + c;
      const bool in = y >= 0 && y < H && c4 >= 0 && c4 < W4;
      cp_async16(dst + r * Sst + 4 * c, in ? img + (size_t)y * W + 4 * c4 : img, in);
    }
    return xs - 4 * c4lo;
  }
  for (int it = t; it < S * S; it += kGroup) {
    const int r = it / S, c = it - r * S;
    const int y = min(y0 + r, Hp - 1) - E, x = xs + c;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    cp_async4(dst + r * Sst + c, in ? img + (size_t)y * W + x : img, in);
  }
  return 0;
}

// Bilinear sample at w[o] (row stride S) with row weight wy, column weight
// wx (gy = 1 - wy, gx = 1 - wx): rows first, then columns.
__device__ __forceinline__ float bilinear(const float* w, int S, int o, float gy, float wy,
                                          float gx, float wx) {
  const float* r0 = w + o;
  const float* r1 = r0 + S;
  const float t0 = gy * r0[0] + wy * r1[0];
  const float t1 = gy * r0[1] + wy * r1[1];
  return gx * t0 + wx * t1;
}

// Window anchor on the padded image: round(c - r) - D clipped to the image.
__device__ __forceinline__ int anchor(float c, float r, int Sp, int MS) {
  return min(max((int)rintf(c - r) - kDrift, 0), max(Sp - MS, 0));
}

// Every sum is added in the order of the previous design's block_sum over
// 256 threads: thread v adds its pixels v, v + 256, ... in turn, each warp
// of eight a butterfly, then one butterfly over the eight warp totals (lane
// j holding warp j's).  So every sum, and with it the flow, equals that
// kernel's to the bit.
//
// The second stage, in every lane of a warp: x[k] in lane j < 8 is warp j's
// total of sum k.
template <int K>
__device__ __forceinline__ void warps_total(float (&x)[K], int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = lane < 8 ? x[k] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] += __shfl_xor_sync(0xffffffffu, x[k], o);
  }
}

// In one warp whose lane l holds the partials p[k][w] of the eight threads
// l + 32 w: the eight warps' butterflies, then warps_total; the K sums come
// back in p[k][0], in every lane.  The butterflies halve the values a lane
// keeps at each of the first three rounds (after them lane l holds warp
// (l >> 2) & 7's sums): every value a lane keeps is the one the full
// butterfly computes there, and the three xor rounds of lanes 4 apart,
// 8 and 16 then add the eight totals as warps_total does (whose first two
// rounds only add +0 in lanes 0-7), so the sums are the same bits with 12
// shuffles a sum instead of 45.
template <int K>
__device__ __forceinline__ void warp_block_sum(float (&p)[K][8], int lane) {
  const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
  float h4[K][4], h2[K][2], h1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float keep = b4 ? p[k][4 + j] : p[k][j], send = b4 ? p[k][j] : p[k][4 + j];
      h4[k][j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float keep = b3 ? h4[k][2 + j] : h4[k][j], send = b3 ? h4[k][j] : h4[k][2 + j];
      h2[k][j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float keep = b2 ? h2[k][1] : h2[k][0], send = b2 ? h2[k][0] : h2[k][1];
    h1[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int o = 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) h1[k] += __shfl_xor_sync(0xffffffffu, h1[k], o);
  }
  // the eight totals: warps_total's rounds 16 and 8 add +0 to lanes 0-7
#pragma unroll
  for (int k = 0; k < K; ++k) h1[k] = __fadd_rn(h1[k], 0.f);
#pragma unroll
  for (int o = 16; o >= 4; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) h1[k] += __shfl_xor_sync(0xffffffffu, h1[k], o);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) p[k][0] = h1[k];
}

// Over the CTA's 128 threads, thread t holding the partials q[k][0] of
// thread t and q[k][1] of thread t + 128: the two butterflies in each warp
// (halved at the first round, as warp_block_sum does), the eight warp
// totals through slot `slot` of red (flipped here) behind one barrier, then
// warps_total in every warp; the sums come back in q[k][0].
template <int K>
__device__ __forceinline__ void cta_block_sum(float (&q)[K][2], float* red, int& slot, int wg,
                                              int lane) {
  static_assert(K <= kMaxSums, "cta_block_sum: too many sums");
  // round 16 halves: lanes 0-15 keep the first partial's butterfly, 16-31
  // the second's (the values the full butterflies compute there)
  const bool hi = lane >= 16;
  float h[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    h[k] = (hi ? q[k][1] : q[k][0]) + __shfl_xor_sync(0xffffffffu, hi ? q[k][0] : q[k][1], 16);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] += __shfl_xor_sync(0xffffffffu, h[k], o);
  }
  float* rs = red + slot * kMaxSums * 8;
  if ((lane & 15) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) rs[k * 8 + wg + (hi ? 4 : 0)] = h[k];
  }
  __syncthreads();
  float x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = rs[k * 8 + (lane & 7)];
  warps_total<K>(x, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) q[k][0] = x[k];
  slot ^= 1;
}

// P_: the window side, or 0 for a generic build that reads it from the
// arguments; NPL pixels a lane in the iterations (ceil(P * P / 32)).  In
// gain/bias mode four CTAs an SM, so the line matcher's 512 anchors run in
// one wave.
template <int P_, int NPL, bool ILLUM>
__global__ void __launch_bounds__(kGroup, ILLUM ? 4 : 1) klt_track_kernel(const VpKltArgs a) {
  const int t = threadIdx.x, lane = t & 31, wg = t >> 5;
  const int n = blockIdx.x;
  const int L = a.levels, P = P_ > 0 ? P_ : a.P, PP = P * P;
  const int TS = P + 3, MS = P + 1 + 2 * kDrift, RS = MS + 2 * kMargin;
  const int E = (P - 1) / 2 + kDrift + 2;
  const int SstT = tile_stride(TS), SstR = tile_stride(RS);
  const float r = 0.5f * (float)(P - 1);
  const float fPP = (float)PP;

  extern __shared__ __align__(16) float smem[];
  const FeatSmem fs(P, L);
  float* tmpl = smem;
  float* prm = tmpl + fs.tmpl;
  float* red = prm + fs.prm;
  float* stage = red + fs.red;
  float* work = stage + fs.stage;
  float* const buf0 = work + fs.work;  // the two moving-region buffers
  float* const buf1 = buf0 + fs.reg;
  int slot = 0;

  const float p0x = a.pts0[2 * n], p0y = a.pts0[2 * n + 1];
  float dx = 0.f, dy = 0.f;
  if (a.flow0 != nullptr) {
    const float sc = (float)(1 << (L - 1));
    dx = a.flow0[2 * n] / sc;
    dy = a.flow0[2 * n + 1] / sc;
  }
  // the template superset's anchor and the bilinear offset inside it, per level
  auto superset = [&](int l, int& ax, int& ay, float& lx, float& ly) {
    const float s = (float)(1 << l);
    const int Hp = a.H[l] + 2 * E, Wp = a.W[l] + 2 * E;
    const float tlx = p0x / s + (float)E - r, tly = p0y / s + (float)E - r;
    ax = min(max((int)floorf(tlx) - 1, 0), max(Wp - TS, 0));
    ay = min(max((int)floorf(tly) - 1, 0), max(Hp - TS, 0));
    lx = fminf(fmaxf(tlx - (float)ax, 0.f), (float)(TS - P - 1));
    ly = fminf(fmaxf(tly - (float)ay, 0.f), (float)(TS - P - 1));
  };

  // ---- every level's template superset, and the coarsest level's first
  // moving region: all copies in flight before the first wait -------------
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    int ax, ay;
    float lx, ly;
    superset(l, ax, ay, lx, ly);
    issue_tile(a.img0[l], a.H[l], a.W[l], E, a.vec[l], ay, ax, TS, stage + l * TS * SstT, t);
  }
  int m0x, m0y, R0x, R0y, shR, cur = 0;
  {
    const int lc = L - 1;
    const float s = (float)(1 << lc);
    m0x = anchor(p0x / s + (float)E + dx, r, a.W[lc] + 2 * E, MS);
    m0y = anchor(p0y / s + (float)E + dy, r, a.H[lc] + 2 * E, MS);
    R0x = m0x - kMargin;
    R0y = m0y - kMargin;
    shR = issue_tile(a.img1[lc], a.H[lc], a.W[lc], E, a.vec[lc], R0y, R0x, RS, buf0, t);
  }
  cp_async_wait();
  __syncthreads();

  // ---- level by level, by the four warps: Scharr on the superset
  // (wrap-around borders), bilinear T / Ix / Iy, the 2x2 gradient matrix's
  // inverse and gate, the template's mean and std (the levels' loop is not
  // unrolled: the code runs once a launch, so its size is what costs) ------
  const float s0 = 3.f / 32.f, s1 = 10.f / 32.f, s2 = 3.f / 32.f;
  // superset cells a thread takes (fixed when P is)
  constexpr int kCells = ((P_ > 0 ? P_ + 3 : 34) * (P_ > 0 ? P_ + 3 : 34) + kGroup - 1) / kGroup;
  constexpr int K = ILLUM ? 4 : 3;  // a, b, c (and in gain/bias mode sum T)
  float* W0 = work;                 // row-smoothed superset
  float* W1 = work + TS * TS;       // row-differenced superset
  float* Gy = work + 2 * TS * TS;   // Scharr y
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    int ax, ay;
    float lx, ly;
    superset(l, ax, ay, lx, ly);
    const int fx = min(max((int)floorf(lx), 0), TS - P - 1);
    const int fy = min(max((int)floorf(ly), 0), TS - P - 1);
    const float wx = lx - floorf(lx), wy = ly - floorf(ly), gx = 1.f - wx, gy = 1.f - wy;
    float* Gx = stage + l * TS * SstT;  // the superset, then Scharr x (stride TS)
    // the superset (y, x) at Sv[y * SstT + x]: issue_tile's shift
    const float* Sv = Gx + (a.vec[l] ? (ax - E) - 4 * floor_div4(ax - E) : 0);
    float* T = tmpl + l * 3 * PP;
    float* Ix = T + PP;
    float* Iy = Ix + PP;
    float q[K][2];  // partials of threads t ([.][0]) and t + 128 ([.][1])
#pragma unroll
    for (int k = 0; k < K; ++k) q[k][0] = q[k][1] = 0.f;
    // the row passes (rows wrap around the superset), and T
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int i = t + kGroup * k;
      if (i < TS * TS) {
        const int y = i / TS, x = i - y * TS;
        const int ym = y == 0 ? TS - 1 : y - 1, yq = y == TS - 1 ? 0 : y + 1;
        const float va = Sv[ym * SstT + x], vb = Sv[y * SstT + x], vc = Sv[yq * SstT + x];
        W0[i] = s0 * va + s1 * vb + s2 * vc;
        W1[i] = -va + vc;
      }
      if (i < PP) {
        const int p = i / P, q_ = i - p * P;
        T[i] = bilinear(Sv, SstT, (fy + p) * SstT + fx + q_, gy, wy, gx, wx);
        if (ILLUM) q[K - 1][k & 1] += T[i];
      }
    }
    __syncthreads();
    // Scharr x from the smoothed rows (over the superset) and Scharr y from
    // the differenced rows; columns wrap around
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int i = t + kGroup * k;
      if (i < TS * TS) {
        const int y = i / TS, x = i - y * TS;
        const int xm = y * TS + (x == 0 ? TS - 1 : x - 1), xq = y * TS + (x == TS - 1 ? 0 : x + 1);
        Gx[i] = -W0[xm] + W0[xq];
        Gy[i] = s0 * W1[xm] + s1 * W1[i] + s2 * W1[xq];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int i = t + kGroup * k;
      if (i < PP) {
        const int p = i / P, q_ = i - p * P;
        const int o = (fy + p) * TS + fx + q_;
        const float ix = bilinear(Gx, TS, o, gy, wy, gx, wx);
        const float iy = bilinear(Gy, TS, o, gy, wy, gx, wx);
        Ix[i] = ix;
        Iy[i] = iy;
        q[0][k & 1] += ix * ix;
        q[1][k & 1] += ix * iy;
        q[2][k & 1] += iy * iy;
      }
    }
    cta_block_sum<K>(q, red, slot, wg, lane);  // also: W0, W1, Gy are free again
    float mT = 0.f, sT = 0.f;
    if (ILLUM) {  // the template's two-pass population std
      mT = q[K - 1][0] / fPP;
      float v[1][2] = {{0.f, 0.f}};
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        const int i = t + kGroup * k;
        if (i < PP) v[0][k & 1] += (T[i] - mT) * (T[i] - mT);
      }
      cta_block_sum<1>(v, red, slot, wg, lane);
      sT = sqrtf(v[0][0] / fPP) + 1e-6f;
    }
    if (t == 0) {
      const float A = q[0][0], B = q[1][0], C = q[2][0];
      const float det = A * C - B * B;
      const float min_eig = (C + A - sqrtf((A - C) * (A - C) + 4.f * B * B)) / (2.f * fPP);
      const float dsafe = det > 1e-12f ? det : 1.f;
      float* pr = prm + 8 * l;
      pr[0] = C / dsafe;
      pr[1] = -B / dsafe;
      pr[2] = A / dsafe;
      pr[3] = min_eig > (float)a.min_eig ? 1.f : 0.f;
      pr[4] = mT;
      pr[5] = sT;
    }
  }
  __syncthreads();  // prm is read by warp 0

  // ---- the iteration chains, coarse to fine, in warp 0 (no barrier in an
  // iteration).  Warps 1-3 help with the moving regions' copies, on warp
  // 0's commands: two alternating slots of {op, level, y0, x0, buffer} in
  // red, each read after a barrier -------------------------------------------
  int* cmd = reinterpret_cast<int*>(red);
  int seq = 0;
  if (wg != 0) {
    for (;;) {
      __syncthreads();
      const int* c = cmd + 8 * (seq++ & 1);
      const int op = c[0], lv = c[1];
      if (op == kStop) return;
      if (op != kWait)
        issue_tile(a.img1[lv], a.H[lv], a.W[lv], E, a.vec[lv], c[2], c[3], RS,
                   c[4] ? buf1 : buf0, t);
      if (op != kIssue) {
        cp_async_wait();
        __syncthreads();
      }
    }
  }
  // warp 0's side of a command; returns its copies' shift
  auto command = [&](int op, int lv, int y0, int x0, int b) {
    int* c = cmd + 8 * (seq++ & 1);
    if (lane == 0) {
      c[0] = op;
      c[1] = lv;
      c[2] = y0;
      c[3] = x0;
      c[4] = b;
    }
    __syncthreads();
    int sh = 0;
    if (op == kLoad || op == kIssue)
      sh = issue_tile(a.img1[lv], a.H[lv], a.W[lv], E, a.vec[lv], y0, x0, RS, b ? buf1 : buf0, t);
    if (op == kLoad || op == kWait) {
      cp_async_wait();
      __syncthreads();
    }
    return sh;
  };
  int off[NPL];  // pixel lane + 32 k at (i / P, i % P) of a region of stride SstR
  const int nval = lane < PP ? (PP - lane + 31) / 32 : 0;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k, p = i / P;
    off[k] = k < nval ? p * SstR + i - p * P : 0;
  }
  const int n_rounds = a.iters >= 4 ? 2 : 1;
  bool ok0 = false, pend = false;
  int qx = 0, qy = 0, qsh = 0;  // the region prefetched for the next level
  // taps in registers (the generic build would spill)
  constexpr bool kCache = P_ > 0;
  float tap[kCache ? NPL : 1][4];
  int tkey = -1;  // where the cached taps were read (-1: read again)
  float res = 0.f;
#pragma unroll 1
  for (int l = L - 1; l >= 0; --l) {
    const float s = (float)(1 << l);
    const float px = p0x / s + (float)E, py = p0y / s + (float)E;
    const int Hp = a.H[l] + 2 * E, Wp = a.W[l] + 2 * E;
    const float* T_ = tmpl + l * 3 * PP;
    float T[NPL], Ix[NPL], Iy[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int i = lane + 32 * k;
      const bool v = k < nval;
      T[k] = v ? T_[i] : 0.f;
      Ix[k] = v ? T_[PP + i] : 0.f;
      Iy[k] = v ? T_[2 * PP + i] : 0.f;
    }
    const float* pr = prm + 8 * l;
    const float i00 = pr[0], i01 = pr[1], i11 = pr[2], mT = pr[4], sT = pr[5];
    const bool ok = pr[3] != 0.f;

    // the window at the current flow: a view of the current region while
    // it fits; a level's first window the prefetched region when it fits;
    // else the region loaded again around the window
    auto make_window = [&](bool first) {
      m0x = anchor(px + dx, r, Wp, MS);
      m0y = anchor(py + dy, r, Hp, MS);
      auto fits = [&](int x0, int y0) {
        return m0x >= x0 && m0y >= y0 && m0x + MS <= x0 + RS && m0y + MS <= y0 + RS;
      };
      if (first) {
        cur ^= 1;  // the previous level's region is done with
        if (pend) {
          pend = false;
          command(kWait, 0, 0, 0, 0);
          if (fits(qx, qy)) {
            R0x = qx;
            R0y = qy;
            shR = qsh;
            tkey = -1;
            return;
          }
        }
      } else if (fits(R0x, R0y)) {
        return;
      }
      R0x = m0x - kMargin;
      R0y = m0y - kMargin;
      tkey = -1;
      shR = command(kLoad, l, R0y, R0x, cur);
    };
    // the bilinear weights and the window's integer offset at the current
    // flow (clamped to the window); key names the taps' place
    float gx, wx, gy, wy;
    const float* base;
    auto weights = [&]() {
      const float lx = fminf(fmaxf(px + dx - r - (float)m0x, 0.f), (float)(MS - P - 1));
      const float ly = fminf(fmaxf(py + dy - r - (float)m0y, 0.f), (float)(MS - P - 1));
      const int fx = min(max((int)floorf(lx), 0), MS - P - 1);
      const int fy = min(max((int)floorf(ly), 0), MS - P - 1);
      wx = lx - floorf(lx);
      wy = ly - floorf(ly);
      gx = 1.f - wx;
      gy = 1.f - wy;
      base = (cur ? buf1 : buf0) + shR + (m0y - R0y + fy) * SstR + (m0x - R0x + fx);
      return (int)(base - smem);
    };
    // the moving patch (the taps as given) minus the template; in gain/bias
    // mode renormalized first
    auto residuals = [&](float (&rr)[NPL]) {
      if (ILLUM) {
        float m[1][8] = {};
#pragma unroll
        for (int k = 0; k < NPL; ++k)
          if (k < nval) m[0][k & 7] += rr[k];
        warp_block_sum<1>(m, lane);
        const float mI = m[0][0] / fPP;
        float v[1][8] = {};
#pragma unroll
        for (int k = 0; k < NPL; ++k)
          if (k < nval) v[0][k & 7] += (rr[k] - mI) * (rr[k] - mI);
        warp_block_sum<1>(v, lane);
        const float gain = sT / (sqrtf(v[0][0] / fPP) + 1e-6f);
#pragma unroll
        for (int k = 0; k < NPL; ++k) rr[k] = (rr[k] - mI) * gain + mT - T[k];
      } else {
#pragma unroll
        for (int k = 0; k < NPL; ++k) rr[k] -= T[k];
      }
    };
    // the gradient sums (g0, g1) = sum over the patch of residual * (Ix, Iy)
    auto gradient = [&](float& g0, float& g1) {
      const int key = weights();
      float rr[NPL];
      if (kCache) {
        // each pixel's four taps stay in registers while the window's
        // integer offset and the region stay the same
        if (key != tkey) {
          tkey = key;
#pragma unroll
          for (int k = 0; k < NPL; ++k) {
            const float* q = base + off[k];
            tap[k][0] = q[0];
            tap[k][1] = q[1];
            tap[k][2] = q[SstR];
            tap[k][3] = q[SstR + 1];
          }
        }
#pragma unroll
        for (int k = 0; k < NPL; ++k)
          rr[k] = gx * (gy * tap[k][0] + wy * tap[k][2]) + wx * (gy * tap[k][1] + wy * tap[k][3]);
      } else {
#pragma unroll
        for (int k = 0; k < NPL; ++k) rr[k] = bilinear(base, SstR, off[k], gy, wy, gx, wx);
      }
      residuals(rr);
      float g[2][8] = {};
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        if (k < nval) {
          g[0][k & 7] += rr[k] * Ix[k];
          g[1][k & 7] += rr[k] * Iy[k];
        }
      }
      warp_block_sum<2>(g, lane);
      g0 = g[0][0];
      g1 = g[1][0];
    };

    for (int rd = 0; rd < n_rounds; ++rd) {
      const int n_it =
          n_rounds == 1 ? a.iters : (rd == 0 ? a.iters / 2 : a.iters - a.iters / 2);
      // the coarsest level's first region is staged
      if (!(l == L - 1 && rd == 0)) make_window(rd == 0);
      if (l > 0 && rd == n_rounds - 1) {
        // prefetch the next level's first region around twice the flow so
        // far, into the other buffer; its copies land during this round
        const float sn = (float)(1 << (l - 1));
        const int mx = anchor(p0x / sn + (float)E + 2.f * dx, r, a.W[l - 1] + 2 * E, MS);
        const int my = anchor(p0y / sn + (float)E + 2.f * dy, r, a.H[l - 1] + 2 * E, MS);
        qx = mx - kMargin;
        qy = my - kMargin;
        qsh = command(kIssue, l - 1, qy, qx, cur ^ 1);
        pend = true;
      }
      for (int it = 0; it < n_it; ++it) {
        float g0, g1;
        gradient(g0, g1);
        if (ok) {
          dx -= i00 * g0 + i01 * g1;
          dy -= i01 * g0 + i11 * g1;
        }
      }
    }
    if (l == 0) {
      make_window(false);
      weights();
      float rr[NPL];
#pragma unroll
      for (int k = 0; k < NPL; ++k) rr[k] = bilinear(base, SstR, off[k], gy, wy, gx, wx);
      residuals(rr);
      float ra[1][8] = {};
#pragma unroll
      for (int k = 0; k < NPL; ++k)
        if (k < nval) ra[0][k & 7] += fabsf(rr[k]);
      warp_block_sum<1>(ra, lane);
      res = ra[0][0] / fPP;
      ok0 = ok;
    } else {
      dx *= 2.f;
      dy *= 2.f;
    }
  }

  command(kStop, 0, 0, 0, 0);
  if (t == 0) {
    if (a.gate) {
      const float x1 = p0x + dx, y1 = p0y + dy;
      const bool inb = x1 >= r && x1 < (float)a.W[0] - r && y1 >= r && y1 < (float)a.H[0] - r;
      a.pts1[2 * n] = x1;
      a.pts1[2 * n + 1] = y1;
      a.ok[n] = ok0 && inb && res < (float)a.max_residual ? 1 : 0;
    } else {
      a.pts1[2 * n] = dx;
      a.pts1[2 * n + 1] = dy;
      a.ok[n] = ok0 ? 1 : 0;
    }
    a.resid[n] = res;
  }
}

template <int P_, int NPL, bool ILLUM>
cudaError_t launch(const VpKltArgs& a, size_t smem, cudaStream_t stream) {
  static size_t opted = 48 * 1024;  // dynamic shared memory opted in so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(klt_track_kernel<P_, NPL, ILLUM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  klt_track_kernel<P_, NPL, ILLUM><<<a.N, kGroup, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int P_, int NPL>
cudaError_t launch_mode(const VpKltArgs& a, size_t smem, cudaStream_t stream) {
  return a.illum ? launch<P_, NPL, true>(a, smem, stream)
                 : launch<P_, NPL, false>(a, smem, stream);
}

}  // namespace

extern "C" int vp_klt_track(const VpKltArgs* A, cudaStream_t stream) {
  const VpKltArgs a = *A;
  if (a.levels < 1 || a.levels > kMaxLevels || a.P < 3 || a.P > 31 || a.P % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (a.N == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * FeatSmem(a.P, a.levels).total;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (a.P == 21)
    e = launch_mode<21, 14>(a, smem, stream);
  else if (a.P == 15)
    e = launch_mode<15, 8>(a, smem, stream);
  else
    e = launch_mode<0, 31>(a, smem, stream);
  return (int)e;
}
