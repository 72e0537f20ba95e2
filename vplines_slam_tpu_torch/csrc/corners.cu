// K3 corner_cells + corner_topk: the whole of ``detect`` (Shi-Tomasi
// response, 3x3 NMS, quality threshold, border kill, one first-index-wins
// argmax per min_dist x min_dist cell, the cells of tracked features
// suppressed, the top max_corners cells) in two launches.
//
// Replaces: vplines_slam_tpu/ops/corners.py:25 min_eig_response, :35 _nms and
//   :43 detect.  On the TPU the response was ~20 full-size roll-shifted passes
//   (Sobel, three 3x3 box sums), NMS a reduce_window, the cell argmax a
//   reshape/transpose of the padded response image, the occupied cells a
//   scatter and the selection lax.top_k.
// Bound on the H100: device-memory bytes, ~0.45 us (the 1.4 MB image read
//   once, the few KB of outputs written once); launch latency and each
//   CTA's chain of barriers dominate.
// Design:
//   pass 1 (corner_cells_kernel): 32x32 output tiles, one wave at 752x480
//   (360 CTAs of 256 threads).  The 38x38 image halo, the 36x36 gradient
//   products, the 34x34 responses and the NMS stay in shared memory, each
//   stage a thread a column and a run of rows with its 3x3 windows sliding
//   down in registers; nothing per pixel is written.  A thread keeps the
//   best 64-bit key of its column in the current cell (value bits high,
//   ~in-cell index low: the key's maximum is the cell's greatest value at
//   its first row-major index) and folds it into the tile's copy of the
//   cell with a shared atomicMax, then the tile into the cell with one
//   global atomicMax.  The tile's NMS maximum goes to the image maximum
//   (order-preserving int map).
//   pass 2 (corner_topk_kernel): a CTA per 16 cells.  Every CTA forms every
//   cell's value and index: (v*, i*) if v* > thresh = quality * maximum,
//   else (0, 0), and 0 where a tracked feature owns the cell (the
//   reference's in-order scatter: a cell's last slot and its mask, as a
//   shared atomicMax over 2 slot + mask); then it ranks its own 16 cells
//   against all (greater values, then equal values at lower indices:
//   lax.top_k's order), 16 lanes a cell, and writes the slots of ranks
//   below max_corners.  The last CTA to finish (a __threadfence() and a
//   ticket counter) clears the cell keys, the maximum and the counter for
//   the next call.
// Exactness: the response keeps the previous kernel's arithmetic to the bit.
//   That kernel's nvcc contracted its products into FMAs: a three-tap sum
//   s0*a + s1*b + s2*c as fma(s2, c, fma(s0, a, s1*b)) (its products are
//   exact: powers of two), and (a-c)^2 + 4*b*b as fma(4b, b, (a-c)^2); here
//   every operation is written out with __fmul_rn/__fadd_rn/__fmaf_rn in
//   that order (chip_smoke.py --against holds the outputs to that kernel's
//   to the bit).  The shortcut (v*, i*) equals the thresholded argmax whenever
//   thresh >= 0: a cell whose best is above thresh keeps it at its first
//   index, one whose best is not holds only zeros (index 0).  thresh < 0 only
//   if quality < 0 or every NMS value is negative; then every tile has
//   written its in-border NMS values (0 outside the border) to `map`, and
//   pass 2 takes each cell's thresholded argmax from it.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

// The arguments of both launches (ops/corners._CORNER_ARGS: pointers, ints,
// then the double), passed by pointer to the C entries and by value to the
// kernels.
struct CornerArgs {
  const float* img;
  float* map;                      // [H, W], written only where pass 2 may read it
  int* state;                      // [0]: ordered image maximum, [1]: ticket counter
  unsigned long long* keys;        // [ch * cw], 0 between calls
  const float* exist_xy;           // [n_exist, 2] or null
  const unsigned char* exist_mask; // [n_exist] or null (all set)
  float* xy;                       // [max_corners, 2]
  float* score;                    // [max_corners]
  unsigned char* valid;            // [max_corners]
  int H, W, md, ch, cw, border, n_exist, max_corners, keep_map;
  double quality;
};

namespace {

constexpr int kTX = 32, kTY = 32;  // output tile
constexpr int kCellsThreads = 256;
constexpr int kTopkThreads = 256, kTopkCells = 16;  // a CTA of pass 2: its cells
constexpr int kMaxCells = 16384;  // pass 2 keeps 12 bytes a cell in shared memory


__device__ __forceinline__ unsigned long long cell_key(float v, int i) {
  return ((unsigned long long)__float_as_uint(v) << 32) | (0xffffffffu - (unsigned)i);
}


__device__ __forceinline__ void write_slot(const CornerArgs& a, int r, int c, float v, int i) {
  a.xy[2 * r] = (float)((c % a.cw) * a.md + i % a.md);
  a.xy[2 * r + 1] = (float)((c / a.cw) * a.md + i / a.md);
  a.score[r] = v;
  a.valid[r] = v > 0.f;
}

// Pass 2: the CTA's cells [c_lo, c_hi).  smem holds 12 bytes a cell.
__global__ void __launch_bounds__(kTopkThreads) corner_topk_kernel(CornerArgs a) {
  VP_DYN_SMEM(float, s_v);
  __shared__ int s_ticket;
  const int n = a.ch * a.cw, tid = threadIdx.x;
  int* s_i = reinterpret_cast<int*>(s_v + n);
  int* s_last = s_i + n;  // the occupied scatter: 2 slot + mask of a cell's last slot
  // the global reads first, so that their latencies overlap
  const int gmax = __ldcg(a.state);
  // the keys of this thread's first two cells
  const unsigned long long key0 = tid < n ? __ldcg(a.keys + tid) : 0ull;
  const unsigned long long key1 =
      tid + kTopkThreads < n ? __ldcg(a.keys + tid + kTopkThreads) : 0ull;
  float ex0 = 0.f, ey0 = 0.f;
  int m0 = 1;
  if (tid < a.n_exist) {
    ex0 = a.exist_xy[2 * tid];
    ey0 = a.exist_xy[2 * tid + 1];
    if (a.exist_mask != nullptr) m0 = a.exist_mask[tid] != 0;
  }
  for (int c = tid; c < n; c += kTopkThreads) s_last[c] = -1;
  __syncthreads();
  // torch: (xy / min_dist).long().clamp(0, cw - 1), where CUDA's division by
  // a scalar is a multiplication by its float reciprocal
  const float inv = 1.0f / (float)a.md;
  for (int s = tid; s < a.n_exist; s += kTopkThreads) {
    float x = ex0, y = ey0;
    int m = m0;
    if (s != tid) {
      x = a.exist_xy[2 * s];
      y = a.exist_xy[2 * s + 1];
      m = a.exist_mask == nullptr || a.exist_mask[s] != 0;
    }
    long long cx = (long long)__fmul_rn(x, inv), cy = (long long)__fmul_rn(y, inv);
    cx = cx < 0 ? 0 : (cx > a.cw - 1 ? a.cw - 1 : cx);
    cy = cy < 0 ? 0 : (cy > a.ch - 1 ? a.ch - 1 : cy);
    atomicMax(&s_last[cy * a.cw + cx], 2 * s + m);
  }
  const float thresh = __fmul_rn((float)a.quality, vp::ordered_to_float(gmax));
  if (thresh < 0.f) {
    // exact path: each cell's thresholded argmax from the kept map, a warp
    // a cell (out-of-image pixels of the edge cells count as 0)
    const int lane = tid & 31;
    for (int c = tid >> 5; c < n; c += kTopkThreads / 32) {
      const int y0 = (c / a.cw) * a.md, x0 = (c % a.cw) * a.md;
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int k = lane; k < a.md * a.md; k += 32) {
        const int y = y0 + k / a.md, x = x0 + k % a.md;
        float v = 0.f;
        if (y < a.H && x < a.W) {
          v = __ldcg(a.map + (size_t)y * a.W + x);
          v = v > thresh ? v : 0.f;
        }
        if (v > bv) {
          bv = v;
          bi = k;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_v[c] = bv;
        s_i[c] = bi;
      }
    }
  }
  __syncthreads();
  for (int c = tid, u = 0; c < n; c += kTopkThreads, ++u) {
    float v;
    int i;
    if (thresh < 0.f) {
      v = s_v[c];
      i = s_i[c];
    } else {
      const unsigned long long key = u == 0 ? key0 : u == 1 ? key1 : __ldcg(a.keys + c);
      v = __uint_as_float((unsigned)(key >> 32));  // 0 without a key
      const bool keep = v > thresh;
      i = keep ? (int)(0xffffffffu - (unsigned)key) : 0;
      v = keep ? v : 0.f;
    }
    const int last = s_last[c];
    s_v[c] = last >= 0 && (last & 1) ? 0.f : v;
    s_i[c] = i;
  }
  __syncthreads();
  // the rank of each of this CTA's cells among all: greater values, then
  // equal values at lower indices; kTopkThreads / kTopkCells lanes a cell,
  // each over a contiguous part of the cells, summed by shuffles
  constexpr int G = kTopkThreads / kTopkCells;
  const int c = blockIdx.x * kTopkCells + tid / G, g = tid % G;
  const int per = (n + G - 1) / G, j0 = g * per, j1 = min(n, j0 + per);
  const float v = c < n ? s_v[c] : 0.f;
  int r = 0;
  if (c < n) {
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float o = s_v[j];
      r += o > v || (o == v && j < c);
    }
  }
#pragma unroll
  for (int o = 1; o < G; o <<= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  if (c < n && g == 0 && r < min(a.max_corners, n)) write_slot(a, r, c, v, s_i[c]);
  // slots past the cell count
  if (blockIdx.x == 0)
    for (int q = n + tid; q < a.max_corners; q += kTopkThreads) {
      a.xy[2 * q] = 0.f;
      a.xy[2 * q + 1] = 0.f;
      a.score[q] = 0.f;
      a.valid[q] = 0;
    }
  // the last CTA, once every CTA has read the keys and the maximum, clears
  // them for the next call
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_ticket = atomicAdd(a.state + 1, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_ticket) return;
  for (int q = tid; q < n; q += kTopkThreads) a.keys[q] = 0ull;
  if (tid == 0) {
    a.state[0] = (int)0x80000000;  // the ordered -inf floor of the next call's maximum
    a.state[1] = 0;
  }
}

// The rows [r0, r1) of a run: `rows` split into `runs` near-equal runs.
__device__ __forceinline__ void run_rows(int run, int runs, int rows, int& r0, int& r1) {
  r0 = run * rows / runs;
  r1 = (run + 1) * rows / runs;
}

__global__ void __launch_bounds__(kCellsThreads) corner_cells_kernel(CornerArgs a) {
  __shared__ float s_img[kTY + 6][kTX + 6];
  __shared__ float s_xx[kTY + 4][kTX + 4];
  __shared__ float s_xy[kTY + 4][kTX + 4];
  __shared__ float s_yy[kTY + 4][kTX + 4];
  __shared__ float s_resp[kTY + 2][kTX + 2];
  __shared__ unsigned long long s_cell[kTY * kTX];
  __shared__ float s_max[kCellsThreads / 32];

  const int H = a.H, W = a.W, md = a.md;
  const int ty0 = blockIdx.y * kTY, tx0 = blockIdx.x * kTX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the cells this tile touches
  const int cy0 = ty0 / md, cx0 = tx0 / md;
  const int ncx = (min(tx0 + kTX, W) - 1) / md - cx0 + 1;
  const int ncy = (min(ty0 + kTY, H) - 1) / md - cy0 + 1;

  {
    // every load in flight before the first store
    constexpr int kIn = (kTY + 6) * (kTX + 6), kLoads = (kIn + kCellsThreads - 1) / kCellsThreads;
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kCellsThreads;
      const int y = ty0 - 3 + i / (kTX + 6), x = tx0 - 3 + i % (kTX + 6);
      v[u] = (i < kIn && y >= 0 && y < H && x >= 0 && x < W) ? a.img[(size_t)y * W + x] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kCellsThreads;
      if (i < kIn) (&s_img[0][0])[i] = v[u];
    }
  }
  for (int i = tid; i < ncy * ncx; i += kCellsThreads) s_cell[i] = 0ull;
  __syncthreads();

  // Sobel (vertical taps then horizontal) and the gradient products; 0
  // outside the image (the box filter's zero padding).  A thread a column
  // and a run of rows, the 3x3 image window sliding down in registers.
  constexpr int kSobelRuns = kCellsThreads / (kTX + 4);
  if (tid < kSobelRuns * (kTX + 4)) {
    const int pc = tid % (kTX + 4);
    int r0, r1;
    run_rows(tid / (kTX + 4), kSobelRuns, kTY + 4, r0, r1);
    const int x = tx0 - 2 + pc;
    const bool x_in = x >= 0 && x < W;
    const float s0 = 1.f / 8.f, s1 = 2.f / 8.f, s2 = 1.f / 8.f;
    float t[3], m[3], b[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[k] = s_img[r0][pc + k];
      b[k] = s_img[r0 + 1][pc + k];
    }
    for (int pr = r0; pr < r1; ++pr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        t[k] = m[k];
        m[k] = b[k];
        b[k] = s_img[pr + 2][pc + k];
      }
      const int y = ty0 - 2 + pr;
      float pxx = 0.f, pxy = 0.f, pyy = 0.f;
      if (x_in && y >= 0 && y < H) {
        float v[3], u[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          v[k] = __fmaf_rn(s2, b[k], __fmaf_rn(s0, t[k], __fmul_rn(s1, m[k])));
          u[k] = __fadd_rn(-t[k], b[k]);
        }
        const float gx = __fadd_rn(-v[0], v[2]);
        const float gy = __fmaf_rn(s2, u[2], __fmaf_rn(s0, u[0], __fmul_rn(s1, u[1])));
        pxx = __fmul_rn(gx, gx);
        pxy = __fmul_rn(gx, gy);
        pyy = __fmul_rn(gy, gy);
      }
      s_xx[pr][pc] = pxx;
      s_xy[pr][pc] = pxy;
      s_yy[pr][pc] = pyy;
    }
  }
  __syncthreads();

  // 3x3 box sums (taps row-major) and the min eigenvalue; -inf outside.  A
  // thread a column and a run of rows, the three 3x3 windows sliding down.
  constexpr int kBoxRuns = kCellsThreads / (kTX + 2);
  if (tid < kBoxRuns * (kTX + 2)) {
    const int bc = tid % (kTX + 2);
    int r0, r1;
    run_rows(tid / (kTX + 2), kBoxRuns, kTY + 2, r0, r1);
    const int x = tx0 - 1 + bc;
    const bool x_in = x >= 0 && x < W;
    float wa[3][3], wb[3][3], wc[3][3];
#pragma unroll
    for (int i = 1; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        wa[i][k] = s_xx[r0 + i - 1][bc + k];
        wb[i][k] = s_xy[r0 + i - 1][bc + k];
        wc[i][k] = s_yy[r0 + i - 1][bc + k];
      }
    for (int br = r0; br < r1; ++br) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        wa[0][k] = wa[1][k], wa[1][k] = wa[2][k], wa[2][k] = s_xx[br + 2][bc + k];
        wb[0][k] = wb[1][k], wb[1][k] = wb[2][k], wb[2][k] = s_xy[br + 2][bc + k];
        wc[0][k] = wc[1][k], wc[1][k] = wc[2][k], wc[2][k] = s_yy[br + 2][bc + k];
      }
      const int y = ty0 - 1 + br;
      float r = -INFINITY;
      if (x_in && y >= 0 && y < H) {
        float sa = 0.f, sb = 0.f, sc = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            sa = __fadd_rn(sa, wa[di][dj]);
            sb = __fadd_rn(sb, wb[di][dj]);
            sc = __fadd_rn(sc, wc[di][dj]);
          }
        const float d = __fsub_rn(sa, sc);
        const float q = __fmaf_rn(__fmul_rn(4.f, sb), sb, __fmul_rn(d, d));
        r = __fmul_rn(__fsub_rn(__fadd_rn(sa, sc), __fsqrt_rn(q)), 0.5f);
      }
      s_resp[br][bc] = r;
    }
  }
  __syncthreads();

  // 3x3 NMS (>= against the -inf padded window), the tile maximum, and each
  // positive in-border value into its cell's key.  A lane a column, a warp a
  // run of rows.
  constexpr int kNmsRuns = kCellsThreads / 32;
  constexpr int kPer = (kTY + kNmsRuns - 1) / kNmsRuns;
  float m_keep[kPer];
  float tmax = -INFINITY;
  {
    const int lx = lane, x = tx0 + lx;
    const int r0 = warp * kTY / kNmsRuns, r1 = (warp + 1) * kTY / kNmsRuns;
    const bool xb = x >= a.border && x < W - a.border;
    // the pixel's cell and in-cell position, stepped down the run's rows
    const int cx = x / md, ix = x - cx * md;
    int cy = (ty0 + r0) / md, iy = ty0 + r0 - cy * md;
    unsigned long long best = 0ull;  // this lane's best key in cell (cy, cx)
    auto flush = [&]() {
      if (best) atomicMax(&s_cell[(cy - cy0) * ncx + (cx - cx0)], best);
      best = 0ull;
    };
    float w[3][3];
#pragma unroll
    for (int i = 1; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) w[i][k] = s_resp[r0 + i - 1][lx + k];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int ly = r0 + u;
      float m = 0.f;
      if (ly < r1) {  // uniform over the warp, as every branch on y below
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          w[0][k] = w[1][k];
          w[1][k] = w[2][k];
          w[2][k] = s_resp[ly + 2][lx + k];
        }
        const int y = ty0 + ly;
        if (iy == md) {  // the run enters the next row of cells
          flush();
          ++cy;
          iy = 0;
        }
        if (y < H && x < W) {
          // the window's maximum as a tree (max is exact in any order)
          const float mx = fmaxf(fmaxf(fmaxf(w[0][0], w[0][1]), fmaxf(w[0][2], w[1][0])),
                                 fmaxf(fmaxf(w[1][1], w[1][2]), fmaxf(fmaxf(w[2][0], w[2][1]),
                                                                      w[2][2])));
          const float out = w[1][1] >= mx ? w[1][1] : 0.f;
          tmax = fmaxf(tmax, out);
          m = xb && y >= a.border && y < H - a.border ? out : 0.f;
          if (m > 0.f) {
            const unsigned long long key = cell_key(m, iy * md + ix);
            best = key > best ? key : best;
          }
        }
        ++iy;
      }
      m_keep[u] = m;
    }
    flush();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
  if (lane == 0) s_max[warp] = tmax;
  __syncthreads();
  float m_all = s_max[0];
#pragma unroll
  for (int k = 1; k < kCellsThreads / 32; ++k) m_all = fmaxf(m_all, s_max[k]);
  if (tid == 0 && m_all > -INFINITY) atomicMax(a.state, vp::float_to_ordered(m_all));
  for (int i = tid; i < ncy * ncx; i += kCellsThreads) {
    const unsigned long long key = s_cell[i];
    if (key) atomicMax(a.keys + (size_t)(cy0 + i / ncx) * a.cw + cx0 + i % ncx, key);
  }
  if (a.keep_map || m_all < 0.f) {
    // the exact path's input: in-border NMS values, 0 elsewhere
    const int x = tx0 + lane, r0 = warp * kTY / kNmsRuns, r1 = (warp + 1) * kTY / kNmsRuns;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int y = ty0 + r0 + u;
      if (r0 + u < r1 && y < H && x < W) a.map[(size_t)y * W + x] = m_keep[u];
    }
  }
}

}  // namespace

// Pass 1.  The caller keeps state = {INT_MIN, 0} and keys = 0 between calls;
// pass 2 restores both.
extern "C" int vp_corner_cells(const CornerArgs* a, cudaStream_t stream) {
  if (a->H < 1 || a->W < 1 || a->md < 1 || a->ch * a->cw > kMaxCells)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a->W + kTX - 1) / kTX, (a->H + kTY - 1) / kTY);
  corner_cells_kernel<<<grid, kCellsThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int vp_corner_topk(const CornerArgs* a, cudaStream_t stream) {
  const int n = a->ch * a->cw;
  if (n < 1 || n > kMaxCells) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)12 * n;
  static size_t allowed = 48 * 1024;  // above it only after the attribute is raised
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        corner_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  corner_topk_kernel<<<(n + kTopkCells - 1) / kTopkCells, kTopkThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}
