// K3 corner_response + corner_select: Shi-Tomasi response with 3x3 NMS, then
// one thresholded, first-index-wins argmax per min_dist x min_dist cell.
//
// Replaces: vplines_slam_tpu/ops/corners.py:25 min_eig_response, :35 _nms and
//   the cell selection of :43 detect (:62-103).  On the TPU the response was
//   ~20 full-size roll-shifted passes (Sobel, three 3x3 box sums), NMS a
//   reduce_window, and the cell argmax a reshape/transpose of the padded
//   response image.
// Bound on the H100: device-memory bytes and launch latency.  The response
//   reads the 1.4 MB image once and writes one 1.4 MB f32 map (the reference
//   materialised ~10 such maps); the selection reads that map once.  Both are
//   ~1 us of HBM time at 3.35 TB/s, so launch latency dominates.
// Design: pass 1 (corner_response) works on 16x16 output tiles: the 22x22
//   image halo, the 20x20 gradient products, the 18x18 box sums and min-eig
//   responses all stay in shared memory; only the NMS output is written, and
//   the tile's maximum goes to one global atomicMax (order-preserving float
//   -> int map).  Pass 2 (corner_select) runs one block per cell: quality
//   threshold against that maximum, border kill, occupied mask, and a block
//   argmax where the first row-major index wins ties, as jnp.argmax does.
//   Zero padding is reproduced stage by stage: gradient products outside the
//   image are 0 (the box filter's SAME padding), responses outside are -inf
//   (reduce_window's padding).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 16;

__global__ void corner_response_kernel(const float* __restrict__ img, int H,
                                       int W, float* __restrict__ nms,
                                       int* __restrict__ gmax) {
  __shared__ float s_img[kTile + 6][kTile + 6];
  __shared__ float s_xx[kTile + 4][kTile + 4];
  __shared__ float s_xy[kTile + 4][kTile + 4];
  __shared__ float s_yy[kTile + 4][kTile + 4];
  __shared__ float s_resp[kTile + 2][kTile + 2];
  __shared__ float s_max[kTile * kTile / 32];

  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthr = kTile * kTile;

  for (int i = tid; i < (kTile + 6) * (kTile + 6); i += nthr) {
    int ly = i / (kTile + 6), lx = i % (kTile + 6);
    int y = ty0 - 3 + ly, x = tx0 - 3 + lx;
    s_img[ly][lx] = (y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();

  // Sobel (vertical taps then horizontal, as the separable reference)
  const float s0 = 1.f / 8.f, s1 = 2.f / 8.f, s2 = 1.f / 8.f;
  for (int i = tid; i < (kTile + 4) * (kTile + 4); i += nthr) {
    int ly = i / (kTile + 4), lx = i % (kTile + 4);
    int y = ty0 - 2 + ly, x = tx0 - 2 + lx;
    float pxx = 0.f, pxy = 0.f, pyy = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      int cy = ly + 1, cx = lx + 1;  // centre in s_img
      float v[3], u[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        int c = cx - 1 + k;
        v[k] = s0 * s_img[cy - 1][c] + s1 * s_img[cy][c] + s2 * s_img[cy + 1][c];
        u[k] = -s_img[cy - 1][c] + s_img[cy + 1][c];
      }
      float gx = -v[0] + v[2];
      float gy = s0 * u[0] + s1 * u[1] + s2 * u[2];
      pxx = gx * gx;
      pxy = gx * gy;
      pyy = gy * gy;
    }
    s_xx[ly][lx] = pxx;
    s_xy[ly][lx] = pxy;
    s_yy[ly][lx] = pyy;
  }
  __syncthreads();

  // 3x3 box SUMS (taps row-major) and the min eigenvalue
  for (int i = tid; i < (kTile + 2) * (kTile + 2); i += nthr) {
    int ly = i / (kTile + 2), lx = i % (kTile + 2);
    int y = ty0 - 1 + ly, x = tx0 - 1 + lx;
    float r = -INFINITY;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      float a = 0.f, b = 0.f, c = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          a += s_xx[ly + di][lx + dj];
          b += s_xy[ly + di][lx + dj];
          c += s_yy[ly + di][lx + dj];
        }
      r = ((a + c) - sqrtf((a - c) * (a - c) + 4.f * b * b)) * 0.5f;
    }
    s_resp[ly][lx] = r;
  }
  __syncthreads();

  // 3x3 NMS (>= against the -inf padded window) + tile maximum
  const int y = ty0 + threadIdx.y, x = tx0 + threadIdx.x;
  float out = -INFINITY;
  if (y < H && x < W) {
    float r = s_resp[threadIdx.y + 1][threadIdx.x + 1];
    float mx = -INFINITY;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        mx = fmaxf(mx, s_resp[threadIdx.y + di][threadIdx.x + dj]);
    out = r >= mx ? r : 0.f;
    nms[(size_t)y * W + x] = out;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    out = fmaxf(out, __shfl_xor_sync(0xffffffffu, out, o));
  if ((tid & 31) == 0) s_max[tid >> 5] = out;
  __syncthreads();
  if (tid == 0) {
    float m = s_max[0];
    for (int k = 1; k < nthr / 32; ++k) m = fmaxf(m, s_max[k]);
    if (m > -INFINITY) atomicMax(gmax, vp::float_to_ordered(m));
  }
}

__global__ void corner_select_kernel(const float* __restrict__ nms,
                                     const int* __restrict__ gmax,
                                     const unsigned char* __restrict__ occupied,
                                     int H, int W, int cw, float quality,
                                     int min_dist, int border,
                                     float* __restrict__ best_val,
                                     int* __restrict__ best_idx) {
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  const int cy = blockIdx.y, cx = blockIdx.x;
  const float thresh = quality * vp::ordered_to_float(*gmax);
  const int n = min_dist * min_dist;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    int y = cy * min_dist + k / min_dist, x = cx * min_dist + k % min_dist;
    float v = 0.f;
    if (y < H && x < W) {
      v = nms[(size_t)y * W + x];
      v = v > thresh ? v : 0.f;
      bool inb = y >= border && y < H - border && x >= border && x < W - border;
      v = inb ? v : 0.f;
    }
    if (v > bv) {  // strict: a thread's first index wins its ties
      bv = v;
      bi = k;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[wid] = bv;
    s_idx[wid] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (s_val[w] > bv || (s_val[w] == bv && s_idx[w] < bi)) {
        bv = s_val[w];
        bi = s_idx[w];
      }
    const int c = cy * cw + cx;
    best_val[c] = occupied[c] ? 0.f : bv;
    best_idx[c] = bi;
  }
}

}  // namespace

extern "C" int vp_corner_response(const float* img, int H, int W, float* nms,
                                  int* gmax, cudaStream_t stream) {
  dim3 block(kTile, kTile);
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  corner_response_kernel<<<grid, block, 0, stream>>>(img, H, W, nms, gmax);
  return (int)cudaGetLastError();
}

extern "C" int vp_corner_select(const float* nms, const int* gmax,
                                const unsigned char* occupied, int H, int W,
                                int ch, int cw, float quality, int min_dist,
                                int border, float* best_val, int* best_idx,
                                cudaStream_t stream) {
  dim3 grid(cw, ch);
  corner_select_kernel<<<grid, 256, 0, stream>>>(
      nms, gmax, occupied, H, W, cw, quality, min_dist, border, best_val,
      best_idx);
  return (int)cudaGetLastError();
}
