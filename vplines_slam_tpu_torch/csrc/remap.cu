// K5 remap_static: the two-pass static undistortion remap of one f32 image.
//
// Replaces: vplines_slam_tpu/ops/image.py:228 remap_static (with the plan of
//   build_remap_plan :187).  On the TPU each pass was a BANDED sum
//   sum_r tent(d - r) * shift_r(img) over the static integer band of the
//   displacement field (tens of full-size shifted multiply-adds), because
//   gathers were the TPU's bottleneck.
// Semantics kept: each pass is a 1D linear interpolation that reads zeros
//   outside the image.  The vertical pass gives tmp(i,u) = img(i + dy(i,u), u);
//   the horizontal pass out(i,j) = tmp(i, j + dx(i,j)); times valid(i,j).  This
//   is NOT a bilinear sample at (sx, sy): the horizontal pass reads two
//   columns, and each column is interpolated vertically at its OWN dy.
// Bound on the H100: device-memory bytes.  480x752 reads the image and three
//   plan maps (4 x 1.4 MB) and writes 1.4 MB: ~2 us at 3.35 TB/s.
// Design: one thread per output pixel, 2 columns x 2 rows of image reads,
//   all through L1/L2 (neighbouring threads read neighbouring columns).  The
//   tent weights and the sums are evaluated as the reference does: w =
//   clamp(1 - |d - r|, 0, 1) for r = floor(d) and floor(d) + 1, products and
//   sums rounded one by one (no FMA contraction), so the kernel repeats the
//   plain version's arithmetic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float tent(float d, float r) {
  return fminf(fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(d, r))), 0.f), 1.f);
}

// vertical pass at (i, u): zero outside the image's columns and rows
__device__ __forceinline__ float vpass(const float* __restrict__ img,
                                       const float* __restrict__ dy, int H,
                                       int W, int i, int u) {
  if (u < 0 || u >= W) return 0.f;
  const float e = dy[(size_t)i * W + u];
  const float k = floorf(e);
  const int r0 = i + (int)k;
  const float a = (r0 >= 0 && r0 < H) ? img[(size_t)r0 * W + u] : 0.f;
  const float b = (r0 + 1 >= 0 && r0 + 1 < H) ? img[(size_t)(r0 + 1) * W + u] : 0.f;
  return __fadd_rn(__fmul_rn(tent(e, k), a), __fmul_rn(tent(e, k + 1.f), b));
}

__global__ void remap_kernel(const float* __restrict__ img,
                             const float* __restrict__ dy,
                             const float* __restrict__ dx,
                             const float* __restrict__ valid, int H, int W,
                             float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const size_t o = (size_t)i * W + j;
  const float d = dx[o];
  const float c = floorf(d);
  const int u0 = j + (int)c;
  const float acc = __fadd_rn(__fmul_rn(tent(d, c), vpass(img, dy, H, W, i, u0)),
                              __fmul_rn(tent(d, c + 1.f), vpass(img, dy, H, W, i, u0 + 1)));
  out[o] = __fmul_rn(acc, valid[o]);
}

}  // namespace

extern "C" int vp_remap_static(const float* img, const float* dy, const float* dx,
                               const float* valid, int H, int W, float* out,
                               cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  remap_kernel<<<grid, block, 0, stream>>>(img, dy, dx, valid, H, W, out);
  return (int)cudaGetLastError();
}
