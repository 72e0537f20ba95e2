// K15 fast: the FAST-9 score of every pixel and the 7x7 max-NMS of
// detect_fast.
//
// Replaces: vplines_slam_tpu/ops/brief.py:34 fast_score and the NMS of
//   detect_fast :70.  On the TPU the ring test was 16 rolled copies of the
//   image stacked to [H, W, 16], the arc test an AND of 9 rolled masks, and
//   the NMS a reduce_window: some 60 full-frame passes per keyframe.
// Bound on the H100: device-memory bytes.  At 480x752 the score pass reads
//   the image once (1.4 MB, the ring re-reads hit L1/L2) and writes the score
//   map; the NMS pass reads it and writes the kept map: ~6 MB in all, ~2 us
//   at 3.35 TB/s.
// Design: one thread per pixel for each pass.  The score thread reads its 16
//   ring pixels, builds the brighter/darker bit masks and looks for a run of
//   9 set bits in the mask doubled to 32 bits (circular); the margin sums are
//   added in ring order, each add and subtract rounded on its own, as the
//   plain version does, so the map is bit-identical.  The reference rolls the
//   image (wrapping at the edges); the 16 px border is zeroed, so no ring
//   pixel of a kept pixel wraps and the kernel reads no wrapped pixel.  The
//   NMS thread keeps score >= the maximum of its 7x7 window (out-of-image
//   neighbours do not count, the reference's -inf pad), so plateaus survive.
//   The top-k stays a stable sort in the wrapper.

#include <cuda_runtime.h>

namespace {

__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool arc9(unsigned m) {
  unsigned d = m | (m << 16);  // circular: bit k + 16 repeats bit k
  unsigned acc = d;
#pragma unroll
  for (int k = 1; k < 9; ++k) acc &= d >> k;
  return (acc & 0xFFFFu) != 0;
}

__global__ void fast_score_kernel(const float* __restrict__ img, int H, int W, float thresh,
                                  float* __restrict__ score) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  float out = 0.f;
  if (y >= 16 && y < H - 16 && x >= 16 && x < W - 16) {
    const float c = img[(size_t)y * W + x];
    const float hi = __fadd_rn(c, thresh), lo = __fsub_rn(c, thresh);
    unsigned mb = 0, md = 0;
    float sb = 0.f, sd = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float r = img[(size_t)(y + kDy[k]) * W + (x + kDx[k])];
      mb |= (unsigned)(r > hi) << k;
      md |= (unsigned)(r < lo) << k;
      const float tb = fmaxf(__fsub_rn(__fsub_rn(r, c), thresh), 0.f);
      const float td = fmaxf(__fsub_rn(lo, r), 0.f);
      sb = k == 0 ? tb : __fadd_rn(sb, tb);
      sd = k == 0 ? td : __fadd_rn(sd, td);
    }
    if (arc9(mb) || arc9(md)) out = fmaxf(sb, sd);
  }
  score[(size_t)y * W + x] = out;
}

__global__ void fast_nms_kernel(const float* __restrict__ score, int H, int W,
                                float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const float s = score[(size_t)y * W + x];
  float mx = s;
  for (int dy = -3; dy <= 3; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -3; dx <= 3; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= W) continue;
      mx = fmaxf(mx, score[(size_t)yy * W + xx]);
    }
  }
  out[(size_t)y * W + x] = s >= mx ? s : 0.f;
}

}  // namespace

// nms = 0: the score map only (out unused); nms = 1: score, then the kept map
// into out.
extern "C" int vp_fast(const float* img, int H, int W, float thresh, int nms, float* score,
                       float* out, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  fast_score_kernel<<<grid, block, 0, stream>>>(img, H, W, thresh, score);
  if (nms) fast_nms_kernel<<<grid, block, 0, stream>>>(score, H, W, out);
  return (int)cudaGetLastError();
}
