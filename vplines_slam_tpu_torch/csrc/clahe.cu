// K9 clahe: contrast-limited adaptive histogram equalization of one f32 image,
// in two launches.
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
// Bound on the H100: device-memory bytes.  480x752: the image is read twice
//   and written once (3 x 1.44 MB): ~1.3 us at 3.35 TB/s.
// Design:
//   clahe_lut_kernel: one block per tile.  The histogram is a shared-memory
//     scatter with integer atomics (exact counts, order-free); one warp then
//     clips, redistributes, scans (shuffles) and normalises the 32 bins.
//   clahe_apply_kernel: one thread per pixel, the tiles*tiles*bins LUT (8 KB)
//     staged in shared memory.  The index arithmetic (tile-centre coordinates,
//     knots, clips) and the blend repeat the plain version's operations one
//     by one (no FMA contraction), so the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxBins = 32;

__global__ void clahe_lut_kernel(const float* __restrict__ img, int W, int tiles,
                                 int th, int tw, int bins, float limit,
                                 float* __restrict__ luts) {
  __shared__ int hist[kMaxBins];
  const int ty = blockIdx.x / tiles, tx = blockIdx.x % tiles;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int n = th * tw;
  const float fb = (float)bins;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int y = ty * th + k / tw, x = tx * tw + k % tw;
    const float v = fminf(fmaxf(img[(size_t)y * W + x], 0.f), 1.f);
    const int q = min((int)__fmul_rn(v, fb), bins - 1);
    atomicAdd(&hist[q], 1);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const float h = lane < bins ? (float)hist[lane] : 0.f;
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
  if (lane < bins) luts[blockIdx.x * bins + lane] = __fdiv_rn(c, last);
}

__global__ void clahe_apply_kernel(const float* __restrict__ img,
                                   const float* __restrict__ luts, int H, int W,
                                   int tiles, int th, int tw, int bins,
                                   float* __restrict__ out) {
  extern __shared__ float lut[];
  const int n_lut = tiles * tiles * bins;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < n_lut; k += blockDim.x * blockDim.y) lut[k] = luts[k];
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  // tile-centre coordinates (i + 0.5) / th - 0.5, clipped as the reference
  const float yy = __fsub_rn(__fdiv_rn(__fadd_rn((float)i, 0.5f), (float)th), 0.5f);
  const float xx = __fsub_rn(__fdiv_rn(__fadd_rn((float)j, 0.5f), (float)tw), 0.5f);
  const int y0 = min(max((int)floorf(yy), 0), tiles - 1);
  const int x0 = min(max((int)floorf(xx), 0), tiles - 1);
  const int y1 = min(y0 + 1, tiles - 1), x1 = min(x0 + 1, tiles - 1);
  const float fy = fminf(fmaxf(__fsub_rn(yy, (float)y0), 0.f), 1.f);
  const float fx = fminf(fmaxf(__fsub_rn(xx, (float)x0), 0.f), 1.f);
  const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
  // knots between bin centres: t = clip(v, 0, 1) * bins - 0.5
  const float v = fminf(fmaxf(img[(size_t)i * W + j], 0.f), 1.f);
  const float t = __fsub_rn(__fmul_rn(v, (float)bins), 0.5f);
  const int k0 = min(max((int)floorf(t), 0), bins - 1);
  const int k1 = min(k0 + 1, bins - 1);
  const float fr = fminf(fmaxf(__fsub_rn(t, (float)k0), 0.f), 1.f);
  const float* L00 = lut + (y0 * tiles + x0) * bins;
  const float* L10 = lut + (y1 * tiles + x0) * bins;
  const float* L01 = lut + (y0 * tiles + x1) * bins;
  const float* L11 = lut + (y1 * tiles + x1) * bins;
  float val[2];
  const int ks[2] = {k0, k1};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int k = ks[s];
    const float r0 = __fadd_rn(__fmul_rn(gy, L00[k]), __fmul_rn(fy, L10[k]));
    const float r1 = __fadd_rn(__fmul_rn(gy, L01[k]), __fmul_rn(fy, L11[k]));
    val[s] = __fadd_rn(__fmul_rn(gx, r0), __fmul_rn(fx, r1));
  }
  out[(size_t)i * W + j] =
      __fadd_rn(__fmul_rn(__fsub_rn(1.f, fr), val[0]), __fmul_rn(fr, val[1]));
}

}  // namespace

extern "C" int vp_clahe_lut(const float* img, int W, int tiles, int th, int tw,
                            int bins, float limit, float* luts,
                            cudaStream_t stream) {
  if (bins > kMaxBins) return (int)cudaErrorInvalidValue;
  clahe_lut_kernel<<<tiles * tiles, 256, 0, stream>>>(img, W, tiles, th, tw, bins,
                                                      limit, luts);
  return (int)cudaGetLastError();
}

extern "C" int vp_clahe_apply(const float* img, const float* luts, int H, int W,
                              int tiles, int th, int tw, int bins, float* out,
                              cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  const size_t smem = sizeof(float) * tiles * tiles * bins;
  clahe_apply_kernel<<<grid, block, smem, stream>>>(img, luts, H, W, tiles, th, tw,
                                                    bins, out);
  return (int)cudaGetLastError();
}
