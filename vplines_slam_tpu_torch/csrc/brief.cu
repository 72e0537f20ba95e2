// K16 brief_patch: BRIEF-256 descriptors at one or two sets of keypoints,
// each keypoint blurring (7 taps, sigma 2) only the patch its tests read.
//
// Replaces: vplines_slam_tpu/ops/brief.py:94 describe_brief, with its
//   gaussian_blur(img, 7, 2.0) (ops/image.py:105 via _sep_conv).  On the TPU
//   the blur was 14 roll-shifted full-frame passes and the descriptor a vmap
//   over keypoints of two 256-point gathers and a shifted-bit sum.
// Bound on the H100: device-memory bytes: the 1.4 MB frame read once and
//   32 bytes a descriptor written, ~0.43 us at 3.35 TB/s; the patches' blur
//   (~35 k operations a keypoint, ~20 M for a keyframe's 564) is ~0.3 us of
//   f32 issue.  Launch latency and each CTA's chain dominate.
// Design: one launch for both sets of a keyframe (the FAST corners and the
//   window points), a CTA of 256 threads a keypoint.  The pattern's offsets
//   lie in [-15, 15], so once px + pa rounds a test's bilinear taps fall at
//   -16 ... +17 around floor(px): the CTA loads the 40 x 40 input window of
//   that 34 x 34 patch into shared memory (0 outside the image), sums the
//   vertical taps, then the horizontal ones, each product and sum rounded on
//   its own in tap order (__fmul_rn / __fadd_rn, the first term not added to
//   0), which is the arithmetic of the previous design's full-frame blur, so
//   every blurred value equals that frame's to the bit.  Then warp w packs
//   word w: lane l evaluates pair 32 w + l with the four bilinear terms in
//   the plain version's order and the zero pad, and __ballot_sync of va < vb
//   is the word.  A tap outside the patch (a keypoint past ~2^22 px, or not
//   finite) is blurred from the frame with the same arithmetic.  Invalid
//   keypoints write zeros and skip the blur.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kR = 3;                  // blur radius (7 taps)
constexpr int kLo = 16, kP = 34;       // patch: offsets -16 ... +17 around floor(p)
constexpr int kIn = kP + 2 * kR;       // 40: the input window
constexpr int kThreads = 256;          // 8 warps, a word each

struct Blur {
  const float* img;
  int H, W;
  float w[7];

  // the vertical sum at (y, x), x in the image: rows outside read 0
  __device__ __forceinline__ float vert(int y, int x) const {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const int yy = y + i - kR;
      const float v = (yy >= 0 && yy < H) ? img[(size_t)yy * W + x] : 0.f;
      const float t = __fmul_rn(w[i], v);
      acc = i == 0 ? t : __fadd_rn(acc, t);
    }
    return acc;
  }

  // the blurred frame at (y, x) in the image: columns outside sum as 0
  __device__ float at(int y, int x) const {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const int xx = x + i - kR;
      const float t = __fmul_rn(w[i], (xx >= 0 && xx < W) ? vert(y, xx) : 0.f);
      acc = i == 0 ? t : __fadd_rn(acc, t);
    }
    return acc;
  }
};

struct Patch {
  const float (*b)[kP];
  int oy, ox;  // image position of b[0][0]
  const Blur* blur;

  // the blurred frame with its zero pad
  __device__ __forceinline__ float tap(int yi, int xi) const {
    if (!(xi >= 0 && xi < blur->W && yi >= 0 && yi < blur->H)) return 0.f;
    const int ry = yi - oy, rx = xi - ox;
    if ((unsigned)ry < (unsigned)kP && (unsigned)rx < (unsigned)kP) return b[ry][rx];
    return blur->at(yi, xi);
  }

  // ops/image.bilinear_sample, term by term
  __device__ __forceinline__ float bilinear(float x, float y) const {
    const float fx0 = floorf(x), fy0 = floorf(y);
    const float fx = __fsub_rn(x, fx0), fy = __fsub_rn(y, fy0);
    const int xi = (int)fx0, yi = (int)fy0;
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    const float a = __fmul_rn(__fmul_rn(tap(yi, xi), gx), gy);
    const float b2 = __fmul_rn(__fmul_rn(tap(yi, xi + 1), fx), gy);
    const float c = __fmul_rn(__fmul_rn(tap(yi + 1, xi), gx), fy);
    const float d = __fmul_rn(__fmul_rn(tap(yi + 1, xi + 1), fx), fy);
    return __fadd_rn(__fadd_rn(__fadd_rn(a, b2), c), d);
  }
};

// floor(p) - kLo as an int, kept far outside any image when p is huge or
// not finite (those taps then take the slow path or the zero pad)
__device__ __forceinline__ int patch_origin(float p) {
  return (int)fmaxf(fminf(floorf(p), 1e9f), -1e9f) - kLo;
}

__global__ void __launch_bounds__(kThreads) brief_patch_kernel(
    const float* __restrict__ img, int H, int W, const float* __restrict__ taps,
    const float* __restrict__ pa, const float* __restrict__ pb, const float* __restrict__ xy1,
    const unsigned char* __restrict__ valid1, int K1, const float* __restrict__ xy2,
    const unsigned char* __restrict__ valid2, int* __restrict__ desc) {
  __shared__ float s_in[kIn][kIn];
  __shared__ float s_v[kP][kIn];
  __shared__ float s_b[kP][kP];
  const int k = blockIdx.x, tid = threadIdx.x;
  const bool second = k >= K1;
  const float* xy = second ? xy2 + 2 * (k - K1) : xy1 + 2 * k;
  if (!(second ? valid2[k - K1] : valid1[k])) {
    if (tid < 8) desc[8 * k + tid] = 0;
    return;
  }
  Blur blur{img, H, W, {}};
#pragma unroll
  for (int i = 0; i < 7; ++i) blur.w[i] = taps[i];
  const float px = xy[0], py = xy[1];
  const int oy = patch_origin(py), ox = patch_origin(px);

  // the input window: rows oy - 3 ..., columns ox - 3 ...; 0 outside
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int ly = i / kIn, lx = i % kIn;
    const int y = oy - kR + ly, x = ox - kR + lx;
    s_in[ly][lx] = (y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();
  // vertical taps at the patch's rows, over its columns and the halo; a
  // column outside the image sums as 0
  for (int i = tid; i < kP * kIn; i += kThreads) {
    const int ly = i / kIn, lx = i % kIn;
    const int x = ox - kR + lx;
    float acc = 0.f;
    if (x >= 0 && x < W) {
#pragma unroll
      for (int t = 0; t < 7; ++t) {
        const float p = __fmul_rn(blur.w[t], s_in[ly + t][lx]);
        acc = t == 0 ? p : __fadd_rn(acc, p);
      }
    }
    s_v[ly][lx] = acc;
  }
  __syncthreads();
  // horizontal taps (only the patch's in-image values are ever read)
  for (int i = tid; i < kP * kP; i += kThreads) {
    const int ly = i / kP, lx = i % kP;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      const float p = __fmul_rn(blur.w[t], s_v[ly][lx + t]);
      acc = t == 0 ? p : __fadd_rn(acc, p);
    }
    s_b[ly][lx] = acc;
  }
  __syncthreads();

  const Patch patch{s_b, oy, ox, &blur};
  const int w = tid >> 5, lane = tid & 31;
  const int i = 32 * w + lane;
  const float va = patch.bilinear(__fadd_rn(px, pa[2 * i]), __fadd_rn(py, pa[2 * i + 1]));
  const float vb = patch.bilinear(__fadd_rn(px, pb[2 * i]), __fadd_rn(py, pb[2 * i + 1]));
  const unsigned word = __ballot_sync(0xffffffffu, va < vb);
  if (lane == 0) desc[8 * k + w] = (int)word;
}

}  // namespace

// desc rows 0 .. K1 - 1 describe xy1, rows K1 .. K1 + K2 - 1 xy2.
extern "C" int vp_brief_patch(const float* img, int H, int W, const float* taps,
                              const float* pa, const float* pb, const float* xy1,
                              const unsigned char* valid1, int K1, const float* xy2,
                              const unsigned char* valid2, int K2, int* desc,
                              cudaStream_t stream) {
  if (K1 + K2 == 0) return 0;
  brief_patch_kernel<<<K1 + K2, kThreads, 0, stream>>>(img, H, W, taps, pa, pb, xy1, valid1,
                                                       K1, xy2, valid2, desc);
  return (int)cudaGetLastError();
}
