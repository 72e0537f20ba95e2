// K9 clahe: contrast-limited adaptive histogram equalization of one f32
// image, in two launches of one kernel.
//
// Replaces: vplines_slam_tpu/ops/image.py:254 clahe.  On the TPU the tile
//   histograms were one-hot sums and the per-pixel LUT lookup an upsampled
//   [H, W, bins] bf16 channel stack blended with arithmetic bin masks,
//   because gathers were the TPU's bottleneck.
// Semantics kept: tiles x tiles tile histograms of bins bins over the cropped
//   (th*tiles) x (tw*tiles) region, clipped at clip_limit*th*tw/bins with the
//   excess spread evenly, CDF LUTs normalised by their last entry; every pixel
//   of the FULL image is mapped by the bilinear-in-tiles blend of the four
//   nearest tile LUTs, linear between bin-centre knots.  The blend is in f32
//   (the reference rounds its stack to bf16; the port does not copy that).
// Bound on the H100: device-memory bytes.  480x752: the image read once and
//   the output written once (2 x 1.44 MB): ~0.9 us at 3.35 TB/s.
// Design: four CTAs of 256 threads per tile (256 CTAs at 8x8 tiles, two an
//   SM), each owning a quarter of the tile's rows, in two phases.
//   1. Each CTA counts its rows: a warp takes 32 consecutive pixels of a row
//      at a time, each lane loads twelve before it counts any, into the
//      warp's own sub-histogram by shared atomics (exact counts, any order),
//      and the CTA's counts (its sub-histograms added) go to a scratch of
//      partial counts.  (match_any grouping and warp-wide integer reductions
//      of byte counters measured slower on the card.)
//   2. In a second launch of the same kernel, six warps of each CTA build
//      the LUTs its pixels blend (tile rows ty - 1 and ty above the tile's
//      centre, ty and ty + 1 below; columns tx - 1 .. tx + 1) from the tiles'
//      partial counts: exact integers added in a fixed order, so every CTA
//      builds the same LUTs; they clip, redistribute, scan (shuffles) and
//      normalise in the order of the previous design, so the LUTs equal its
//      LUTs to the bit.  Then the CTA maps its rows (the last tile row and
//      column also take the rows and columns the crop left out), four pixels
//      of a row a thread with 16-byte loads and stores where the image's rows
//      allow it, every chunk loaded before any is mapped; its columns'
//      tile-centre terms are computed once into a table, the LUTs sit in
//      shared memory with a row stride of 33 so that tiles fall on other
//      banks.  The index arithmetic (tile-centre coordinates, knots, clips)
//      and the blend repeat the plain version's operations one by one (no FMA
//      contraction), so the output equals the previous design's and the plain
//      version's to the bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxBins = 32;
constexpr int kMaxTiles = 16;
constexpr int kParts = 4;  // CTAs a tile (even: half of them above the tile's centre row)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 12;  // pixels a lane loads before it counts (a 30 x 94 band at once)
constexpr int kChunks = 4;  // chunks a thread loads before it maps them
constexpr int kLutStride = kMaxBins + 1;  // a tile's LUT in shared memory: banks differ by tile
constexpr int kMaxCols = 512;  // column terms a CTA keeps (wider tiles compute the rest)

struct ClaheArgs {
  const float* img;
  float* luts;  // [tiles, tiles, bins]
  int* part;    // [tiles * tiles, kParts, bins] partial counts
  float* out;
  int H, W, tiles, th, tw, bins;
  float limit;
  int phase;  // 1: the partial counts, 2: the LUTs and the mapping
};

// One pixel through the blend of the four nearest tile LUTs, given its
// column's tile-centre terms (x0, x1, fx, gx) and its row's (y0, y1, fy, gy).
__device__ __forceinline__ float map_pixel(const float* lut, float v, int x0, int x1, float fx,
                                           float gx, int tiles, int bins, int y0, int y1,
                                           float fy, float gy) {
  // knots between bin centres: t = clip(v, 0, 1) * bins - 0.5
  v = fminf(fmaxf(v, 0.f), 1.f);
  const float t = __fsub_rn(__fmul_rn(v, (float)bins), 0.5f);
  const int k0 = min(max((int)floorf(t), 0), bins - 1);
  const int k1 = min(k0 + 1, bins - 1);
  const float fr = fminf(fmaxf(__fsub_rn(t, (float)k0), 0.f), 1.f);
  const float* L00 = lut + (y0 * tiles + x0) * kLutStride;
  const float* L10 = lut + (y1 * tiles + x0) * kLutStride;
  const float* L01 = lut + (y0 * tiles + x1) * kLutStride;
  const float* L11 = lut + (y1 * tiles + x1) * kLutStride;
  float val[2];
  const int ks[2] = {k0, k1};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int k = ks[s];
    const float r0 = __fadd_rn(__fmul_rn(gy, L00[k]), __fmul_rn(fy, L10[k]));
    const float r1 = __fadd_rn(__fmul_rn(gy, L01[k]), __fmul_rn(fy, L11[k]));
    val[s] = __fadd_rn(__fmul_rn(gx, r0), __fmul_rn(fx, r1));
  }
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, fr), val[0]), __fmul_rn(fr, val[1]));
}

// The CDF LUT of one tile from its counts h (lane b holds bin b): clip at
// limit, spread the excess evenly, scan, normalise by the last entry.  A
// whole warp calls it.
__device__ __forceinline__ float tile_lut(int cnt, int lane, int bins, float limit) {
  const float fb = (float)bins;
  const float h = lane < bins ? (float)cnt : 0.f;
  float ex = lane < bins ? fmaxf(__fsub_rn(h, limit), 0.f) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ex = __fadd_rn(ex, __shfl_xor_sync(0xffffffffu, ex, o));
  float c = lane < bins ? __fadd_rn(fminf(h, limit), __fdiv_rn(ex, fb)) : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c = __fadd_rn(c, u);
  }
  const float last = __shfl_sync(0xffffffffu, c, bins - 1);
  return __fdiv_rn(c, last);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) clahe_kernel(const ClaheArgs a) {
  __shared__ int sub[kWarps][kMaxBins];
  __shared__ float lut[kMaxTiles * kMaxTiles * kLutStride];
  __shared__ __align__(16) int colx[kMaxCols];
  __shared__ __align__(16) float colfx[kMaxCols];
  __shared__ __align__(16) float colgx[kMaxCols];
  const int tiles = a.tiles, th = a.th, tw = a.tw, bins = a.bins;
  const int tile = blockIdx.x / kParts, part = blockIdx.x % kParts;
  const int ty = tile / tiles, tx = tile % tiles;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  // this CTA's rows of the tile
  const int rb0 = th * part / kParts, rb1 = th * (part + 1) / kParts;

  if (a.phase == 1) {
    // a warp takes 32 consecutive pixels of a row (a run of the row's
    // blocks of 32), each lane kBatch of them, loaded before any is counted,
    // into the warp's own sub-histogram (shared atomics: exact counts, any
    // order)
    sub[wid][lane] = 0;
    __syncwarp();
    const int nb = (tw + 31) / 32, n = (rb1 - rb0) * nb;
    const float fb = (float)bins;
    const float* src = a.img + (size_t)(ty * th + rb0) * a.W + tx * tw;
    for (int b0 = wid; b0 < n; b0 += kWarps * kBatch) {
      float v[kBatch];
      bool in[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int b = b0 + j * kWarps, row = b / nb, x = (b - row * nb) * 32 + lane;
        in[j] = b < n && x < tw;
        v[j] = in[j] ? __ldg(src + (size_t)row * a.W + x) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (in[j])
          atomicAdd(&sub[wid][min((int)__fmul_rn(fminf(fmaxf(v[j], 0.f), 1.f), fb), bins - 1)], 1);
    }
    __syncthreads();
    if (threadIdx.x < bins) {  // bin b over the warps' sub-histograms
      int cnt = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) cnt += sub[w][threadIdx.x];
      a.part[blockIdx.x * bins + threadIdx.x] = cnt;
    }
    return;
  }

  // ---- phase 2: the LUTs of the 3x3 tiles around this one, then the rows --
  // rows above the tile's centre blend tile rows ty - 1 and ty (0 and 1 in
  // the first tile row, whose top rows clip to 0), the others ty and ty + 1;
  // columns tx - 1 .. tx + 1: six LUTs, a warp each
  for (int nbr = wid; nbr < 6; nbr += kWarps) {
    const int ny = (part < kParts / 2 ? max(ty - 1, 0) : ty) + nbr / 3, nx = tx - 1 + nbr % 3;
    if (ny >= 0 && ny < tiles && nx >= 0 && nx < tiles) {  // warp-uniform
      const int nt = ny * tiles + nx;
      int cnt = 0;
      if (lane < bins) {
#pragma unroll
        for (int k = 0; k < kParts; ++k) cnt += __ldcg(a.part + (nt * kParts + k) * bins + lane);
      }
      const float v = tile_lut(cnt, lane, bins, a.limit);
      if (lane < bins) {
        lut[nt * kLutStride + lane] = v;
        if (nt == tile && part == 0) a.luts[nt * bins + lane] = v;
      }
    }
  }
  const int r0 = ty * th + rb0;
  const int r1 = ty == tiles - 1 && part == kParts - 1 ? a.H : ty * th + rb1;
  const int c0 = tx * tw, c1 = tx == tiles - 1 ? a.W : c0 + tw;
  const int v0 = c0 / VEC, nv = (c1 - 1) / VEC - v0 + 1;  // chunks of VEC pixels
  // the column terms of the chunks' pixels, once: x0 | x1 << 8, fx, gx
  const int ncol = nv * VEC;
  for (int k = threadIdx.x; k < ncol && k < kMaxCols; k += kThreads) {
    const int j = v0 * VEC + k;
    const float xx = __fsub_rn(__fdiv_rn(__fadd_rn((float)j, 0.5f), (float)tw), 0.5f);
    const int x0 = min(max((int)floorf(xx), 0), tiles - 1);
    const float fx = fminf(fmaxf(__fsub_rn(xx, (float)x0), 0.f), 1.f);
    colx[k] = x0 | min(x0 + 1, tiles - 1) << 8;
    colfx[k] = fx;
    colgx[k] = __fsub_rn(1.f, fx);
  }
  __syncthreads();
  const int n_items = (r1 - r0) * nv;
  for (int i0 = threadIdx.x; i0 < n_items; i0 += kThreads * kChunks) {
    float in[kChunks][VEC];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {  // every chunk's load first
      const int it = i0 + c * kThreads;
      if (it >= n_items) break;
      const int row = it / nv;
      const size_t base = (size_t)(r0 + row) * a.W + (size_t)(v0 + it - row * nv) * VEC;
      if (VEC == 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(a.img + base));
        in[c][0] = f.x;
        in[c][VEC > 1 ? 1 : 0] = f.y;
        in[c][VEC > 2 ? 2 : 0] = f.z;
        in[c][VEC > 3 ? 3 : 0] = f.w;
      } else {
        in[c][0] = __ldg(a.img + base);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int it = i0 + c * kThreads;
      if (it >= n_items) break;
      const int row = it / nv, i = r0 + row, cv = v0 + it - row * nv;
      // tile-centre coordinates (i + 0.5) / th - 0.5, clipped as the reference
      const float yy = __fsub_rn(__fdiv_rn(__fadd_rn((float)i, 0.5f), (float)th), 0.5f);
      const int y0 = min(max((int)floorf(yy), 0), tiles - 1);
      const int y1 = min(y0 + 1, tiles - 1);
      const float fy = fminf(fmaxf(__fsub_rn(yy, (float)y0), 0.f), 1.f);
      const float gy = __fsub_rn(1.f, fy);
      const size_t base = (size_t)i * a.W + (size_t)cv * VEC;
      const int k0 = (cv - v0) * VEC;  // the chunk's first column in the table
      // the chunk's column terms, read as one vector each where the table has them
      int xs[VEC];
      float fxs[VEC], gxs[VEC];
      if (k0 + VEC <= kMaxCols) {
        if (VEC == 4) {
          const int4 x4 = *reinterpret_cast<const int4*>(colx + k0);
          const float4 f4 = *reinterpret_cast<const float4*>(colfx + k0);
          const float4 g4 = *reinterpret_cast<const float4*>(colgx + k0);
          const int xa[4] = {x4.x, x4.y, x4.z, x4.w};
          const float fa[4] = {f4.x, f4.y, f4.z, f4.w}, ga[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            xs[e] = xa[e];
            fxs[e] = fa[e];
            gxs[e] = ga[e];
          }
        } else {
          xs[0] = colx[k0];
          fxs[0] = colfx[k0];
          gxs[0] = colgx[k0];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int j = cv * VEC + e;
          const float xx = __fsub_rn(__fdiv_rn(__fadd_rn((float)j, 0.5f), (float)tw), 0.5f);
          const int x0 = min(max((int)floorf(xx), 0), tiles - 1);
          xs[e] = x0 | min(x0 + 1, tiles - 1) << 8;
          fxs[e] = fminf(fmaxf(__fsub_rn(xx, (float)x0), 0.f), 1.f);
          gxs[e] = __fsub_rn(1.f, fxs[e]);
        }
      }
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = map_pixel(lut, in[c][e], xs[e] & 255, xs[e] >> 8, fxs[e], gxs[e], tiles, bins, y0,
                         y1, fy, gy);
      const int j = cv * VEC;
      if (VEC == 4 && j >= c0 && j + 4 <= c1) {
        *reinterpret_cast<float4*>(a.out + base) = make_float4(o[0], o[VEC > 1 ? 1 : 0],
                                                               o[VEC > 2 ? 2 : 0], o[VEC > 3 ? 3 : 0]);
      } else {  // one pixel, or a chunk the neighbouring tile shares: this tile's pixels
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (j + e >= c0 && j + e < c1) a.out[base + e] = o[e];
      }
    }
  }
}

template <int VEC>
cudaError_t launch(ClaheArgs a, cudaStream_t stream) {
  const int grid = a.tiles * a.tiles * kParts;
  a.phase = 1;
  clahe_kernel<VEC><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  a.phase = 2;
  clahe_kernel<VEC><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// luts [tiles, tiles, bins] and out [H, W] are written; part holds
// tiles * tiles * kParts * bins ints of scratch.
extern "C" int vp_clahe(const float* img, int H, int W, int tiles, int bins, float limit,
                        float* luts, int* part, float* out, cudaStream_t stream) {
  const int th = H / tiles, tw = W / tiles;
  if (bins < 1 || bins > kMaxBins || tiles < 1 || tiles > kMaxTiles || th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  const ClaheArgs a{img, luts, part, out, H, W, tiles, th, tw, bins, limit, 0};
  const bool vec = W % 4 == 0 && reinterpret_cast<size_t>(img) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  const cudaError_t e = vec ? launch<4>(a, stream) : launch<1>(a, stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
