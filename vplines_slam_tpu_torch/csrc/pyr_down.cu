// K1 pyr_down: 5-tap binomial smoothing + 2x decimation of one f32 image.
//
// Replaces: vplines_slam_tpu/ops/image.py:115 pyr_down (via _sep_conv /
//   _axis_corr :18, build_pyramid :122).  The TPU version ran two full-size
//   roll-shifted correlations and then dropped 3 of every 4 outputs.
// Bound on the H100: device-memory bytes.  480x752 -> 240x376 reads 1.4 MB
//   and writes 0.36 MB: ~0.5 us of HBM time at 3.35 TB/s, so one launch is
//   dominated by launch latency, not by the card.
// Design: one thread per OUTPUT pixel computes the separable 5x5 directly at
//   (2y, 2x) with zero padding -- no full-size intermediate, no wasted
//   outputs.  The vertical taps are summed first for each of the five
//   columns, then the horizontal taps, in tap order, as the reference does.
//   Neighbouring threads read neighbouring (stride-2) columns; the 5 rows a
//   block touches stay in L1/L2.

#include <cuda_runtime.h>

namespace {

__constant__ float kTaps[5] = {1.f / 16.f, 4.f / 16.f, 6.f / 16.f, 4.f / 16.f,
                               1.f / 16.f};

__global__ void pyr_down_kernel(const float* __restrict__ src,
                                float* __restrict__ dst, int H, int W, int Ho,
                                int Wo) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Wo || y >= Ho) return;
  int cy = 2 * y, cx = 2 * x;
  float out = 0.f;
  for (int j = 0; j < 5; ++j) {
    int xx = cx + j - 2;
    float col = 0.f;
    if (xx >= 0 && xx < W) {
      for (int i = 0; i < 5; ++i) {
        int yy = cy + i - 2;
        float v = (yy >= 0 && yy < H) ? src[(size_t)yy * W + xx] : 0.f;
        col = (i == 0) ? kTaps[0] * v : col + kTaps[i] * v;
      }
    }
    out = (j == 0) ? kTaps[0] * col : out + kTaps[j] * col;
  }
  dst[(size_t)y * Wo + x] = out;
}

}  // namespace

extern "C" int vp_pyr_down(const float* src, float* dst, int H, int W, int Ho,
                           int Wo, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((Wo + block.x - 1) / block.x, (Ho + block.y - 1) / block.y);
  pyr_down_kernel<<<grid, block, 0, stream>>>(src, dst, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}
