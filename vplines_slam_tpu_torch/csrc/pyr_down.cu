// K1 pyramids: every level of one or two image pyramids in one launch, each
// level the 5-tap binomial smoothing + 2x decimation of the one before.
//
// Replaces: vplines_slam_tpu/ops/image.py:122 build_pyramid (pyr_down :115,
//   via _sep_conv / _axis_corr :18).  The TPU version ran two full-size
//   roll-shifted correlations a level and then dropped 3 of every 4 outputs.
// Bound on the H100: device-memory bytes.  A track call's two 480x752
//   images are read once (2.9 MB) and levels 1-2 of both written (0.9 MB):
//   ~1.1 us at 3.35 TB/s, so the launch ramp and the dependence of each
//   level on the one before, not the bandwidth, set the time.
// Design: no barrier across the grid between levels.  A CTA owns a T x T
//   tile of the coarsest level (blockIdx.z: the image) and recomputes the
//   halo its finer levels need.  It loads the level-0 region under its tile
//   (zeros outside the image; 16-byte loads where the rows allow, all of a
//   thread's issued before any is stored) into shared memory, then computes
//   each level's region from the one before in one pass: a thread takes a
//   column and a run of N rows of the level, forms the vertical sums of its
//   five source columns for those rows from a sliding window of 2N + 3
//   source rows, and then its N outputs; the level's region (zero outside
//   that level's own image: zero padding applies at every level's border)
//   goes to shared memory for the next level, and the pixels the CTA owns
//   to the output.  Regions are stored with their even columns first and
//   then their odd ones, so that the stride-2 reads of a warp's
//   consecutive output columns fall on distinct banks.  For 3 levels a
//   16 x 8 tile of level 2 needs 35 x 19 of level 1 and 73 x 41 of level 0
//   (360 CTAs for a track call's two 480x752 images; 16 x 16 tiles, 32 x 8,
//   8 x 8 and 512 threads measured slower); one barrier a level.
// Arithmetic: each output pixel is formed exactly as the one-level kernel
//   this replaces formed it: the five vertical taps of each source column in
//   tap order, then the five column sums in tap order, each step after the
//   first a fused multiply-add (nvcc contracted that kernel's
//   `col + kTaps[i] * v`; written out here with __fmul_rn / __fmaf_rn so that
//   no contraction choice can differ).  A column or row outside the source
//   image adds +0 there and here.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;  // levels a launch builds (ops/image.MAX_LEVELS)
constexpr float kT0 = 1.f / 16.f, kT1 = 4.f / 16.f, kT2 = 6.f / 16.f;

// t0 a + t1 b + t2 c + t1 d + t0 e in tap order, each step after the first fused
__device__ __forceinline__ float taps5(float a, float b, float c, float d, float e) {
  float s = __fmul_rn(kT0, a);
  s = __fmaf_rn(kT1, b, s);
  s = __fmaf_rn(kT2, c, s);
  s = __fmaf_rn(kT1, d, s);
  return __fmaf_rn(kT0, e, s);
}

// Along an axis where a tile covers T pixels of level D, level k's region
// spans region(D, T, k) pixels and starts halo(D, k) pixels before the
// tile's own part of level k (pixels [tile << (D - k), (tile + T) << (D - k))).
__host__ __device__ constexpr int region(int D, int T, int k) {
  return k == D ? T : 2 * region(D, T, k + 1) + 3;
}
__host__ __device__ constexpr int halo(int D, int k) { return k == D ? 0 : 2 * halo(D, k + 1) + 2; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// rows of a rx x ry region a thread takes, so that one round of nt threads covers it
__host__ __device__ constexpr int rows_of(int rx, int ry, int nt) {
  int n = 1;
  while (rx * cdiv(ry, n) > nt && n < 8) ++n;
  return n;
}

struct PyrArgs {
  const float* src[2];  // level 0 of each image, H x W
  float* dst[2];        // levels 1..D of each image, one after the other
  int H, W;
  int vec;  // 16-byte loads: W a multiple of 4 and both images 16-byte aligned
};

struct Dims {
  int h[kMaxLevels], w[kMaxLevels], off[kMaxLevels];  // level sizes; offsets in dst
};

// a region's column c in its row (even columns first, then odd)
__device__ __forceinline__ int col_at(int c, int half) { return (c & 1) ? half + (c >> 1) : c >> 1; }

// Tiles of TX x TY pixels of level D = levels - 1, NT threads a CTA.
template <int D, int TX, int TY, int NT>
struct Plan {
  __host__ __device__ static constexpr int rx(int k) { return region(D, TX, k); }
  __host__ __device__ static constexpr int ry(int k) { return region(D, TY, k); }
  __host__ __device__ static constexpr int rows(int k) { return rows_of(rx(k), ry(k), NT); }
  // source rows the last runs of level k read past level k - 1's region (left unset)
  __host__ __device__ static constexpr int pad(int k) { return 2 * (cdiv(ry(k), rows(k)) * rows(k) - ry(k)); }
  __host__ __device__ static constexpr int size(int k) { return k > D ? 0 : (ry(k - 1) + pad(k)) * rx(k - 1); }
  // level 0 (and 2) in A, level 1 (and 3) in B
  static constexpr int A_SIZE = size(1) > size(3) ? size(1) : size(3);
  static constexpr int B_SIZE = size(2);
};

// Level K's region from level K - 1's (S, de-interleaved rows), into N_
// (K < D) and the owned pixels to dst.
template <int D, int TX, int TY, int NT, int K>
__device__ __forceinline__ void down_level(const float* S, float* N_, const Dims& d, float* dst,
                                           int ty, int tx, int tid, int nt) {
  using Pl = Plan<D, TX, TY, NT>;
  constexpr int NR = Pl::rows(K), RS = Pl::rx(K - 1), RX = Pl::rx(K), RY = Pl::ry(K);
  constexpr int CO = halo(D, K), HS = (RS + 1) / 2, HO = (RX + 1) / 2;
  constexpr int ITEMS = RX * cdiv(RY, NR);
  const int oy = (ty << (D - K)) - CO, ox = (tx << (D - K)) - CO;
  const int H = d.h[K], W = d.w[K];
  for (int it = tid; it < ITEMS; it += nt) {
    const int j = it % RX, i0 = it / RX * NR;
    // source columns 2j .. 2j + 4: even j, odd j, even j + 1, odd j + 1, even j + 2
    const int cols[5] = {j, HS + j, j + 1, HS + j + 1, j + 2};
    float v[5][NR];
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      float a[2 * NR + 3];
#pragma unroll
      for (int r = 0; r < 2 * NR + 3; ++r) a[r] = S[(2 * i0 + r) * RS + cols[b]];
#pragma unroll
      for (int t = 0; t < NR; ++t)
        v[b][t] = taps5(a[2 * t], a[2 * t + 1], a[2 * t + 2], a[2 * t + 3], a[2 * t + 4]);
    }
    const int gx = ox + j;
    const bool own_x = j >= CO && j < CO + (TX << (D - K));
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      const int i = i0 + t, gy = oy + i;
      if (i >= RY) break;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float out = in ? taps5(v[0][t], v[1][t], v[2][t], v[3][t], v[4][t]) : 0.f;
      if (K < D) N_[i * RX + col_at(j, HO)] = out;
      if (in && own_x && i >= CO && i < CO + (TY << (D - K)))
        dst[d.off[K] + (size_t)gy * W + gx] = out;
    }
  }
  if (K < D) __syncthreads();
}

template <int D, int TX, int TY, int NT>
__global__ void __launch_bounds__(NT) pyramids_kernel(PyrArgs a) {
  using Pl = Plan<D, TX, TY, NT>;
  constexpr int RX0 = Pl::rx(0), RY0 = Pl::ry(0), C0 = halo(D, 0), H0 = (RX0 + 1) / 2;
  __shared__ float A[Pl::A_SIZE];
  __shared__ float B[Pl::B_SIZE > 0 ? Pl::B_SIZE : 1];
  const int tid = threadIdx.x, nt = blockDim.x;
  // selected, not indexed: a parameter array indexed at run time goes to the stack
  const float* __restrict__ src = blockIdx.z ? a.src[1] : a.src[0];
  float* __restrict__ dst = blockIdx.z ? a.dst[1] : a.dst[0];
  Dims d;
  d.h[0] = a.H;
  d.w[0] = a.W;
  d.off[1] = 0;
#pragma unroll
  for (int k = 1; k <= D; ++k) {
    d.h[k] = (d.h[k - 1] + 1) / 2;
    d.w[k] = (d.w[k - 1] + 1) / 2;
    if (k > 1) d.off[k] = d.off[k - 1] + d.h[k - 1] * d.w[k - 1];
  }
  const int ty = blockIdx.y * TY, tx = blockIdx.x * TX;  // the tile's origin on level D
  const int oy = (ty << D) - C0, ox = (tx << D) - C0;
  if (a.vec) {
    // 16-byte loads from lx = ox - 2 (a multiple of 4: ox = 2 mod 4), the
    // row's width a multiple of 4, so a load lies wholly in or out of the image
    constexpr int NQ4 = cdiv(RX0 + 2, 4), NQ = RY0 * NQ4, Q = cdiv(NQ, NT);
    const int lx = ox - 2;
    for (int base = 0; base < NQ; base += nt * Q) {
      float4 v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int e = base + q * nt + tid, r = e / NQ4, gy = oy + r, gx = lx + 4 * (e - r * NQ4);
        v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < NQ && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
          v[q] = __ldg(reinterpret_cast<const float4*>(src + (size_t)gy * a.W + gx));
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int e = base + q * nt + tid, r = e / NQ4, c = 4 * (e - r * NQ4) - 2;
        if (e >= NQ) continue;
        float* row = A + r * RX0;
        const float x4[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c + k >= 0 && c + k < RX0) row[col_at(c + k, H0)] = x4[k];
      }
    }
  } else {
    constexpr int N0 = RY0 * RX0, Q = cdiv(N0, NT);
    for (int base = 0; base < N0; base += nt * Q) {
      float v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int e = base + q * nt + tid, r = e / RX0, gy = oy + r, gx = ox + (e - r * RX0);
        v[q] = (e < N0 && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
                   ? __ldg(src + (size_t)gy * a.W + gx)
                   : 0.f;
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int e = base + q * nt + tid, r = e / RX0;
        if (e < N0) A[r * RX0 + col_at(e - r * RX0, H0)] = v[q];
      }
    }
  }
  __syncthreads();
  down_level<D, TX, TY, NT, 1>(A, B, d, dst, ty, tx, tid, nt);
  if constexpr (D >= 2) down_level<D, TX, TY, NT, 2>(B, A, d, dst, ty, tx, tid, nt);
  if constexpr (D >= 3) down_level<D, TX, TY, NT, 3>(A, B, d, dst, ty, tx, tid, nt);
}

template <int D, int TX, int TY, int NT>
cudaError_t launch(const PyrArgs& a, int n_images, cudaStream_t stream) {
  int h = a.H, w = a.W;
  for (int k = 0; k < D; ++k) {
    h = (h + 1) / 2;
    w = (w + 1) / 2;
  }
  VP_LAUNCH((pyramids_kernel<D, TX, TY, NT>), dim3(cdiv(w, TX), cdiv(h, TY), n_images), NT, 0,
            stream, a);
  return cudaGetLastError();
}

}  // namespace

// levels 2..kMaxLevels of n_images (1 or 2) H x W images: src0/src1 level 0,
// dst0/dst1 levels 1..levels-1 of each, one after the other
extern "C" int vp_pyramids(const float* src0, const float* src1, float* dst0, float* dst1, int H,
                           int W, int levels, int n_images, cudaStream_t stream) {
  if (levels < 2 || levels > kMaxLevels || n_images < 1 || n_images > 2 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  PyrArgs a;
  a.src[0] = src0;
  a.src[1] = src1;
  a.dst[0] = dst0;
  a.dst[1] = dst1;
  a.H = H;
  a.W = W;
  a.vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(src0) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(src1) & 15) == 0;
  switch (levels - 1) {
    case 1: return (int)launch<1, 32, 32, 256>(a, n_images, stream);
    case 2: return (int)launch<2, 16, 8, 256>(a, n_images, stream);
    default: return (int)launch<3, 8, 8, 256>(a, n_images, stream);
  }
}
