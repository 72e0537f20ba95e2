// K16 brief: the 7-tap sigma-2 Gaussian blur and the BRIEF-256 descriptors
// at a set of keypoints.
//
// Replaces: vplines_slam_tpu/ops/brief.py:94 describe_brief, with its
//   gaussian_blur(img, 7, 2.0) (ops/image.py:105 via _sep_conv).  On the TPU
//   the blur was 14 roll-shifted full-frame passes and the descriptor a vmap
//   over keypoints of two 256-point gathers and a shifted-bit sum.
// Bound on the H100: device-memory bytes for the blur (read the 1.4 MB frame,
//   write the blurred one); the descriptors read 500 x 512 bilinear taps,
//   mostly from L2.  ~1 us of HBM time in all: launch latency dominates.
// Design: the blur is one launch of 32x8 output tiles; each block first sums
//   the vertical taps for its tile plus a 3-column halo into shared memory,
//   then the horizontal taps, each sum in tap order with every multiply and
//   add rounded on its own (no FMA), as the plain version computes it, so
//   the blurred image is bit-identical.  The descriptor is one warp per
//   keypoint: lane l evaluates pairs l, l + 32, ..., l + 224 with the four
//   bilinear terms in the plain version's order and the zero pad, and
//   __ballot_sync of (va < vb) over the warp is word w itself (bit l = pair
//   32 w + l).  Invalid keypoints write zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8, kR = 3;

__global__ void brief_blur_kernel(const float* __restrict__ img, int H, int W,
                                  const float* __restrict__ taps, float* __restrict__ out) {
  __shared__ float s_v[kTy][kTx + 2 * kR];
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  float w[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) w[i] = taps[i];
  // vertical pass over the tile's columns plus the halo (0 outside the image)
  for (int k = tid; k < kTy * (kTx + 2 * kR); k += kTx * kTy) {
    const int ty = k / (kTx + 2 * kR), tx = k % (kTx + 2 * kR);
    const int y = y0 + ty, x = x0 + tx - kR;
    float acc = 0.f;
    if (x >= 0 && x < W && y < H) {
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        const int yy = y + i - kR;
        const float v = (yy >= 0 && yy < H) ? img[(size_t)yy * W + x] : 0.f;
        const float t = __fmul_rn(w[i], v);
        acc = i == 0 ? t : __fadd_rn(acc, t);
      }
    }
    s_v[ty][tx] = acc;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float t = __fmul_rn(w[i], s_v[threadIdx.y][threadIdx.x + i]);
    acc = i == 0 ? t : __fadd_rn(acc, t);
  }
  out[(size_t)y * W + x] = acc;
}

__device__ __forceinline__ float tap(const float* img, int H, int W, int yi, int xi) {
  return (xi >= 0 && xi < W && yi >= 0 && yi < H) ? img[(size_t)yi * W + xi] : 0.f;
}

// ops/image.bilinear_sample, term by term
__device__ __forceinline__ float bilinear(const float* img, int H, int W, float x, float y) {
  const float fx0 = floorf(x), fy0 = floorf(y);
  const float fx = __fsub_rn(x, fx0), fy = __fsub_rn(y, fy0);
  const int xi = (int)fx0, yi = (int)fy0;
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float a = __fmul_rn(__fmul_rn(tap(img, H, W, yi, xi), gx), gy);
  const float b = __fmul_rn(__fmul_rn(tap(img, H, W, yi, xi + 1), fx), gy);
  const float c = __fmul_rn(__fmul_rn(tap(img, H, W, yi + 1, xi), gx), fy);
  const float d = __fmul_rn(__fmul_rn(tap(img, H, W, yi + 1, xi + 1), fx), fy);
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__global__ void brief_desc_kernel(const float* __restrict__ blur, int H, int W,
                                  const float* __restrict__ pa, const float* __restrict__ pb,
                                  const float* __restrict__ xy,
                                  const unsigned char* __restrict__ valid, int K,
                                  int* __restrict__ desc) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= K) return;  // uniform over the warp
  const float px = xy[2 * k], py = xy[2 * k + 1];
  const bool ok = valid[k] != 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int i = 32 * w + lane;
    const float va =
        bilinear(blur, H, W, __fadd_rn(px, pa[2 * i]), __fadd_rn(py, pa[2 * i + 1]));
    const float vb =
        bilinear(blur, H, W, __fadd_rn(px, pb[2 * i]), __fadd_rn(py, pb[2 * i + 1]));
    const unsigned word = __ballot_sync(0xffffffffu, va < vb);
    if (lane == 0) desc[8 * k + w] = ok ? (int)word : 0;
  }
}

}  // namespace

extern "C" int vp_brief(const float* img, int H, int W, const float* taps, const float* pa,
                        const float* pb, const float* xy, const unsigned char* valid, int K,
                        float* blur, int* desc, cudaStream_t stream) {
  const dim3 block(kTx, kTy);
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  brief_blur_kernel<<<grid, block, 0, stream>>>(img, H, W, taps, blur);
  if (K > 0) {
    const int threads = 256;
    const int blocks = (K * 32 + threads - 1) / threads;
    brief_desc_kernel<<<blocks, threads, 0, stream>>>(blur, H, W, pa, pb, xy, valid, K, desc);
  }
  return (int)cudaGetLastError();
}
