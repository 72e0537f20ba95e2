// K6 line_anchors + line_select_grow: the EDLine anchor-growth line detector.
//
// Replaces: vplines_slam_tpu/ops/lines.py:63 detect_lines (:70-108 the blur,
//   Scharr, anchor test and per-cell argmax; :96-108 the top-k over cells;
//   :118-212 the ray walk, tube offset, moments and PCA fit).  On the TPU the
//   blur and Scharr were ~16 full-size roll-shifted passes, the cell argmax a
//   reshape/transpose of the padded score image, and the walk of 512 anchors
//   x 2 x 96 steps a batched gather of every sample (three times: the ray and
//   both tube sides) with the sequential stop turned into a prefix-AND over
//   the whole ray.
//
// line_anchors: a CTA of 8 warps a 32x32 tile (2 x 2 cells of 16x16; 360
//   CTAs at 752x480, one wave), three barriers.  (1) 90 threads each take a
//   4-column quad and 4 rows of the vertical Gaussian: the 8 source rows
//   under them come in as 16-byte loads (scalar ones where the rows are not
//   16-byte aligned), all issued before the first tap, and the 4 x 4 results
//   go to shared memory; (2) 252 threads each take a column and a run of 4-5
//   rows: the horizontal Gaussian of the rows the run needs (2 recomputed at
//   each end), then the vertical Scharr passes ([3,10,3]/32 and [-1,0,1]) on
//   that sliding window; (3) a warp takes 4 rows of the tile, a lane a
//   column: the horizontal Scharr passes, the magnitude of the rows above
//   and below (recomputed) and of the columns beside it (shuffled; the two
//   outside the tile computed by the edge lanes), the fields out (a warp a
//   128-byte row), the anchor test and a (value, index) argmax of each half
//   warp in its cell; the four warps of a cell are combined after the last
//   barrier.  The image is read once with a 1.56x halo (the 16x16 CTAs this
//   replaces read 2.25x).
// Arithmetic: every pixel as that kernel formed it: the taps in order,
//   products and sums rounded one by one (__fmul_rn / __fadd_rn, no
//   contraction), zero padding applied stage by stage (each stage is zero
//   outside the image before the next reads it), IEEE sqrt and divisions; a
//   cell's best is its greatest score, the first row-major index in the cell
//   on ties (jnp.argmax).  mag, dx, dy, best_val and best_idx equal that
//   kernel's to the bit.
// Bound on the H100: device-memory bytes: the image read once (1.4 MB) and
//   the three fields written once (4.3 MB), ~1.7 us at 3.35 TB/s.
//
// line_select_grow: the top max_anchors cells and their walks, one launch (a
//   warp a cell, 4 warps a CTA: 353 CTAs at 752x480).  A cell's slot is its
//   rank in the stable descending order of best_val -- the cells with a
//   greater value, plus those with an equal value and a lower index, which
//   is lax.top_k's order and torch.sort(stable=True)'s.  A cell ranked below
//   max_anchors whose value is > 0 (a_ok) is walked and written to its slot;
//   a cell ranked there with value 0, and every slot past the cell count,
//   gets zeros (segs, lens, fits, support) and a_ok false: those slots are
//   not walked, and detect_lines' `good` mask drops them.
//   Order of work, so that no load waits behind another it does not need:
//   the warp's cell value and index, and the CTA's share of every cell value
//   (16-byte loads, all in flight), then the anchor's direction; the values
//   go to shared memory, one barrier, and the warp counts its cell's rank
//   over them (lanes over the cells).  A walking warp then loads mag, dx and
//   dy at every sample of every chunk of both directions (positions depend
//   only on the anchor, its direction and the step; addresses are clamped),
//   takes a ballot a chunk to find the first sample that fails the gate --
//   the walk stops there, exactly the reference's prefix-AND -- and loads
//   the two tube samples of the alive samples only.  Alive samples take the
//   3-tap parabolic offset across the ray; the six moments are warp sums;
//   every lane fits the line (PCA of the support) and the support extremes
//   give the endpoints.  Nearest-pixel rounding is round-half-to-even
//   (__float2int_rn, as jnp.round).  Each lane sums its samples in the same
//   order and the warp in the same __shfl_xor tree as the one-walk-a-warp
//   kernel this replaces, so segs, lens, fits and the support count equal
//   its outputs to the bit on every a_ok slot.  The moments are summed in
//   another order than torch.sum, so the fit differs from the plain version
//   by f32 rounding (see chip_smoke.py for the tolerance).  Issuing the
//   tube samples (or the walks' loads) before the rank measured slower: the
//   scattered loads in flight held back everything behind them.
// Bound on the H100: the dependent chain of a walk: the cell values and the
//   anchor, its direction, the rank, the samples, the tube samples, the fit;
//   its bytes are the cell values read once and the live samples (~0.05 us).

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kCell = 16;
constexpr int kTile = 32;                // line_anchors: a CTA's tile, 2 x 2 cells
constexpr int kAnchorWarps = 8;          // a warp 4 rows of the tile
constexpr int kTvRows = kTile + 4;       // vertical Gaussian: tile rows [-2, 34)
constexpr int kTvCols = kTile + 8;       //   over columns [-4, 36)
constexpr int kSRows = kTile + 2;        // vertical Scharr: rows [-1, 33)
constexpr int kSCols = kTile + 4;        //   over columns [-2, 34)
constexpr int kGrowWarps = 4;            // line_select_grow: a warp a cell
constexpr int kMaxChunks = 8;            // walks of up to 8 x 32 = 256 steps each way
constexpr unsigned kFull = 0xffffffffu;

// cv::getGaussianKernel(5, 1) taps, rounded to f32 as the plain version's
// Python floats are
__constant__ float kGauss[5] = {0.054488684549642945f, 0.24420134200323335f,
                                0.40261994689424746f, 0.24420134200323335f,
                                0.054488684549642945f};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// g0 a + g1 b + g2 c + g3 d + g4 e in tap order
__device__ __forceinline__ float gauss5(float a, float b, float c, float d, float e) {
  float acc = mul(kGauss[0], a);
  acc = add(acc, mul(kGauss[1], b));
  acc = add(acc, mul(kGauss[2], c));
  acc = add(acc, mul(kGauss[3], d));
  return add(acc, mul(kGauss[4], e));
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kAnchorWarps)
line_anchors_kernel(const float* __restrict__ img, int H, int W, int ch, int cw,
                    float grad_thresh, float anchor_thresh, float* __restrict__ mag_out,
                    float* __restrict__ dx_out, float* __restrict__ dy_out,
                    float* __restrict__ best_val, int* __restrict__ best_idx) {
  // regions (rows x columns) relative to the tile's top-left (y0, x0):
  //   tv     [-2, 34) x [-4, 36)  vertical Gaussian
  //   sv, dv [-1, 33) x [-2, 34)  vertical Scharr passes (of the blur)
  __shared__ __align__(16) float s_tv[kTvRows][kTvCols];
  __shared__ float s_sv[kSRows][kSCols], s_dv[kSRows][kSCols];
  __shared__ float s_bv[kAnchorWarps][2];
  __shared__ int s_bi[kAnchorWarps][2];
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto inside = [&](int y, int x) { return y >= 0 && y < H && x >= 0 && x < W; };

  // (1) vertical Gaussian: a quad of columns x 4 rows a thread, zero outside
  // the image's columns (the horizontal pass's padding)
  if (tid < (kTvCols / 4) * (kTvRows / 4)) {
    const int q = tid % (kTvCols / 4), run = tid / (kTvCols / 4);
    const int xa = x0 - 4 + 4 * q;
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int y = y0 - 4 + 4 * run + i;
      if (kVec) {  // W % 4 == 0: a quad lies wholly inside or outside the image
        v[i] = (y >= 0 && y < H && xa >= 0 && xa < W)
                   ? __ldg(reinterpret_cast<const float4*>(img + (size_t)y * W + xa))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const bool row = y >= 0 && y < H;
        const float* p = img + (size_t)(row ? y : 0) * W;
        v[i].x = row && xa >= 0 && xa < W ? __ldg(p + xa) : 0.f;
        v[i].y = row && xa + 1 >= 0 && xa + 1 < W ? __ldg(p + xa + 1) : 0.f;
        v[i].z = row && xa + 2 >= 0 && xa + 2 < W ? __ldg(p + xa + 2) : 0.f;
        v[i].w = row && xa + 3 >= 0 && xa + 3 < W ? __ldg(p + xa + 3) : 0.f;
      }
    }
    const bool c0 = xa >= 0 && xa < W, c1 = xa + 1 >= 0 && xa + 1 < W;
    const bool c2 = xa + 2 >= 0 && xa + 2 < W, c3 = xa + 3 >= 0 && xa + 3 < W;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4 o;
      o.x = c0 ? gauss5(v[k].x, v[k + 1].x, v[k + 2].x, v[k + 3].x, v[k + 4].x) : 0.f;
      o.y = c1 ? gauss5(v[k].y, v[k + 1].y, v[k + 2].y, v[k + 3].y, v[k + 4].y) : 0.f;
      o.z = c2 ? gauss5(v[k].z, v[k + 1].z, v[k + 2].z, v[k + 3].z, v[k + 4].z) : 0.f;
      o.w = c3 ? gauss5(v[k].w, v[k + 1].w, v[k + 2].w, v[k + 3].w, v[k + 4].w) : 0.f;
      *reinterpret_cast<float4*>(&s_tv[4 * run + k][4 * q]) = o;
    }
  }
  __syncthreads();

  // (2) horizontal Gaussian (zero outside the image) of a column's run of
  // rows, then the vertical Scharr passes on it: smoothing [3,10,3]/32 (for
  // gx), difference [-1,0,1] (for gy); zero outside the image's columns
  const float s0 = 3.f / 32.f, s1 = 10.f / 32.f;
  if (tid < kSCols * 7) {
    const int c = tid % kSCols, run = tid / kSCols;
    const int r0 = 5 * run, n = min(5, kSRows - r0);
    const int x = x0 - 2 + c;
    const bool col = x >= 0 && x < W;
    float b[7];  // blur rows r0 .. r0 + n + 1 (blur row r <-> image row y0 - 2 + r)
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const int y = y0 - 2 + r0 + i;
      b[i] = (i < n + 2 && col && y >= 0 && y < H)
                 ? gauss5(s_tv[r0 + i][c], s_tv[r0 + i][c + 1], s_tv[r0 + i][c + 2],
                          s_tv[r0 + i][c + 3], s_tv[r0 + i][c + 4])
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (i < n) {
        float sv = 0.f, dv = 0.f;
        if (col) {
          sv = add(add(mul(s0, b[i]), mul(s1, b[i + 1])), mul(s0, b[i + 2]));
          dv = add(-b[i], b[i + 2]);
        }
        s_sv[r0 + i][c] = sv;
        s_dv[r0 + i][c] = dv;
      }
    }
  }
  __syncthreads();

  // (3) horizontal passes and magnitude (zero outside the image: the anchor
  // test's padding) of rows 4 warp - 1 .. 4 warp + 4 at the lane's column
  // and, in the edge lanes, at the column just outside the tile
  const int xc = x0 + lane;
  const int xe = lane == 0 ? x0 - 1 : x0 + kTile;  // edge lanes only
  float m[6], me[6], gxs[4], gys[4];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int sr = 4 * warp + i;  // s_sv row of tile row 4 warp - 1 + i
    const int y = y0 - 1 + sr;
    float gx = 0.f, gy = 0.f, mm = 0.f;
    if (inside(y, xc)) {
      const int sc = lane + 2;
      gx = add(-s_sv[sr][sc - 1], s_sv[sr][sc + 1]);
      gy = add(add(mul(s0, s_dv[sr][sc - 1]), mul(s1, s_dv[sr][sc])), mul(s0, s_dv[sr][sc + 1]));
      mm = __fsqrt_rn(add(mul(gx, gx), mul(gy, gy)));
    }
    m[i] = mm;
    if (i >= 1 && i <= 4) {
      gxs[i - 1] = gx;
      gys[i - 1] = gy;
    }
    me[i] = 0.f;
    if ((lane == 0 || lane == 31) && inside(y, xe)) {
      const int sc = xe - x0 + 2;
      const float ex = add(-s_sv[sr][sc - 1], s_sv[sr][sc + 1]);
      const float ey =
          add(add(mul(s0, s_dv[sr][sc - 1]), mul(s1, s_dv[sr][sc])), mul(s0, s_dv[sr][sc + 1]));
      me[i] = __fsqrt_rn(add(mul(ex, ex), mul(ey, ey)));
    }
  }

  // the tile's own pixels: fields out, anchor test, argmax in the cell
  float bv = 0.f;
  int bi = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = k + 1;
    float left = __shfl_up_sync(kFull, m[i], 1), right = __shfl_down_sync(kFull, m[i], 1);
    if (lane == 0) left = me[i];
    if (lane == 31) right = me[i];
    const int ty = 4 * warp + k, y = y0 + ty;
    float score = 0.f;
    if (y < H && xc < W) {
      const float mm = m[i], gx = gxs[k], gy = gys[k];
      const float ms = fmaxf(mm, 1e-12f);
      const size_t o = (size_t)y * W + xc;
      mag_out[o] = mm;
      dx_out[o] = __fdiv_rn(-gy, ms);
      dy_out[o] = __fdiv_rn(gx, ms);
      const bool along_x = fabsf(gx) >= fabsf(gy);  // vertical edge
      const bool peak = along_x ? (mm >= add(left, anchor_thresh) && mm >= add(right, anchor_thresh))
                                : (mm >= add(m[i - 1], anchor_thresh) &&
                                   mm >= add(m[i + 1], anchor_thresh));
      if (mm > grad_thresh && peak) score = mm;
    }
    const int idx = (ty % kCell) * kCell + lane % kCell;  // row-major in the cell
    if (k == 0 || score > bv) {
      bv = score;
      bi = idx;
    }
  }
#pragma unroll
  for (int off = kCell / 2; off > 0; off >>= 1) {  // within each half warp
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane % kCell == 0) {
    s_bv[warp][lane / kCell] = bv;
    s_bi[warp][lane / kCell] = bi;
  }
  __syncthreads();
  if (tid < 4) {  // a cell: the four warps over its rows, in row order
    const int cr = tid / 2, cc = tid % 2;
    const int gy = blockIdx.y * 2 + cr, gx = blockIdx.x * 2 + cc;
    float v = s_bv[4 * cr][cc];
    int ix = s_bi[4 * cr][cc];
    for (int w = 4 * cr + 1; w < 4 * cr + 4; ++w)
      if (s_bv[w][cc] > v || (s_bv[w][cc] == v && s_bi[w][cc] < ix)) {
        v = s_bv[w][cc];
        ix = s_bi[w][cc];
      }
    if (gy < ch && gx < cw) {
      best_val[gy * cw + gx] = v;
      best_idx[gy * cw + gx] = ix;
    }
  }
}

__device__ __forceinline__ size_t clamped(int yi, int xi, int H, int W) {
  return (size_t)min(max(yi, 0), H - 1) * W + min(max(xi, 0), W - 1);
}

__device__ __forceinline__ void empty_slot(int s, int A, float* segs, float* lens, float* fits_n,
                                           unsigned char* a_ok) {
  reinterpret_cast<float4*>(segs)[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  lens[s] = 0.f;
  fits_n[s] = 0.f;
  fits_n[A + s] = 0.f;
  a_ok[s] = 0;
}

template <int kChunks>
__global__ void __launch_bounds__(32 * kGrowWarps)
line_select_grow_kernel(const float* __restrict__ best_val, const int* __restrict__ best_idx,
                        int n_cells, int cw, const float* __restrict__ mag,
                        const float* __restrict__ dxf, const float* __restrict__ dyf, int H, int W,
                        int A, int S, float grad_thresh, float cos_tol, float* __restrict__ segs,
                        float* __restrict__ lens, float* __restrict__ fits_n,
                        unsigned char* __restrict__ a_ok) {
  extern __shared__ __align__(16) float s_val[];  // best_val, padded to 4 with -inf
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kGrowWarps + (threadIdx.x >> 5);  // this warp's cell
  const bool cell = c < n_cells;
  // the cell, its anchor and (below) the anchor's direction: they do not
  // wait for the rank
  const float v = cell ? best_val[c] : 0.f;
  const int bi = cell ? best_idx[c] : 0;
  // every cell value, into registers now, into shared memory below
  const int n4 = (n_cells + 3) / 4;
  const bool vec = (reinterpret_cast<uintptr_t>(best_val) & 15) == 0;
  auto load4 = [&](int k) {
    float4 o;
    if (vec && 4 * k + 3 < n_cells) {
      o = __ldg(reinterpret_cast<const float4*>(best_val) + k);
    } else {
      o.x = 4 * k < n_cells ? __ldg(best_val + 4 * k) : -INFINITY;
      o.y = 4 * k + 1 < n_cells ? __ldg(best_val + 4 * k + 1) : -INFINITY;
      o.z = 4 * k + 2 < n_cells ? __ldg(best_val + 4 * k + 2) : -INFINITY;
      o.w = 4 * k + 3 < n_cells ? __ldg(best_val + 4 * k + 3) : -INFINITY;
    }
    return o;
  };
  constexpr int kStage = 4;  // float4 loads a thread in flight
  float4 stage[kStage];
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int k = threadIdx.x + u * blockDim.x;
    stage[u] = k < n4 ? load4(k) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const bool walk = cell && v > 0.f;
  const float ax = (float)((c % cw) * kCell + bi % kCell);
  const float ay = (float)((c / cw) * kCell + bi / kCell);
  float d0x = 0.f, d0y = 0.f;
  if (walk) {
    const size_t ao = (size_t)(int)ay * W + (int)ax;
    d0x = dxf[ao];
    d0y = dyf[ao];
  }
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int k = threadIdx.x + u * blockDim.x;
    if (k < n4) reinterpret_cast<float4*>(s_val)[k] = stage[u];
  }
  for (int k = threadIdx.x + kStage * blockDim.x; k < n4; k += blockDim.x)
    reinterpret_cast<float4*>(s_val)[k] = load4(k);
  // slots past the cell count (lax.top_k's k is min(max_anchors, cells))
  for (int s = n_cells + blockIdx.x * blockDim.x + threadIdx.x; s < A;
       s += gridDim.x * blockDim.x)
    empty_slot(s, A, segs, lens, fits_n, a_ok);
  __syncthreads();
  if (!cell) return;

  // the cell's rank: greater values, then equal values at lower indices
  int rank = 0;
#pragma unroll 4
  for (int k = lane; k < n4; k += 32) {
    const float4 o = reinterpret_cast<const float4*>(s_val)[k];
    rank += (o.x > v || (o.x == v && 4 * k < c)) ? 1 : 0;
    rank += (o.y > v || (o.y == v && 4 * k + 1 < c)) ? 1 : 0;
    rank += (o.z > v || (o.z == v && 4 * k + 2 < c)) ? 1 : 0;
    rank += (o.w > v || (o.w == v && 4 * k + 3 < c)) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rank += __shfl_xor_sync(kFull, rank, off);
  if (rank >= A) return;
  const int a = rank;
  if (!walk) {
    if (lane == 0) empty_slot(a, A, segs, lens, fits_n, a_ok);
    return;
  }
  const float n0x = -d0y, n0y = d0x;

  // the samples of every chunk of both directions: positions, then mag, dx
  // and dy there, all loads issued before the first ballot
  float px_k[2][kChunks], py_k[2][kChunks], ms_k[2][kChunks], fx_k[2][kChunks],
      fy_k[2][kChunks];
  int xi_k[2][kChunks], yi_k[2][kChunks];
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const float sgn = dir == 0 ? 1.f : -1.f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int t = ch * 32 + lane + 1;
      const float st = mul(sgn, (float)t);
      const float px = add(ax, mul(st, d0x)), py = add(ay, mul(st, d0y));
      const int xi = __float2int_rn(px), yi = __float2int_rn(py);
      const size_t o = clamped(yi, xi, H, W);
      px_k[dir][ch] = px;
      py_k[dir][ch] = py;
      xi_k[dir][ch] = xi;
      yi_k[dir][ch] = yi;
      ms_k[dir][ch] = mag[o];
      fx_k[dir][ch] = dxf[o];
      fy_k[dir][ch] = dyf[o];
    }
  }
  // the walks (a ballot a chunk finds the first failing sample), then the
  // tube samples of the alive ones, all issued before the first is used
  bool alive_k[2][kChunks];
  float mp_k[2][kChunks], mm_k[2][kChunks];
  int n_dead = 0;  // samples that are not alive (each reads as 0 in the extremes)
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    bool walking = true;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int t = ch * 32 + lane + 1;
      const bool in_ray = t <= S;
      const int xi = xi_k[dir][ch], yi = yi_k[dir][ch];
      const float align = fabsf(add(mul(fx_k[dir][ch], d0x), mul(fy_k[dir][ch], d0y)));
      const bool ok = in_ray && xi >= 1 && xi < W - 2 && yi >= 1 && yi < H - 2 &&
                      ms_k[dir][ch] > grad_thresh && align > cos_tol;
      // first failing step of this chunk (steps past S fail too)
      const unsigned fails = __ballot_sync(kFull, !ok);
      const int first_fail = fails ? __ffs(fails) - 1 : 32;
      const bool alive = walking && lane < first_fail;
      if (walking && fails) walking = false;
      if (in_ray && !alive) ++n_dead;
      alive_k[dir][ch] = alive;
      mp_k[dir][ch] = mm_k[dir][ch] = 0.f;
      if (alive) {
        const float px = px_k[dir][ch], py = py_k[dir][ch];
        mp_k[dir][ch] =
            mag[clamped(__float2int_rn(add(py, n0y)), __float2int_rn(add(px, n0x)), H, W)];
        mm_k[dir][ch] =
            mag[clamped(__float2int_rn(sub(py, n0y)), __float2int_rn(sub(px, n0x)), H, W)];
      }
    }
  }
  // alive samples: the 3-tap offset across the ray and the moments, in the
  // one-walk-a-warp kernel's order
  float qx_k[2][kChunks], qy_k[2][kChunks];
  float sum[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // n, sx, sy, sxx, sxy, syy
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      qx_k[dir][ch] = 0.f;
      qy_k[dir][ch] = 0.f;
      if (alive_k[dir][ch]) {
        const float px = px_k[dir][ch], py = py_k[dir][ch], m_s = ms_k[dir][ch];
        const float m_p = mp_k[dir][ch], m_m = mm_k[dir][ch];
        float denom = add(sub(m_p, mul(2.f, m_s)), m_m);
        denom = fabsf(denom) > 1e-9f ? denom : 1e-9f;
        const float delta = fminf(fmaxf(__fdiv_rn(mul(0.5f, sub(m_m, m_p)), denom), -1.f), 1.f);
        const float qx = add(px, mul(delta, n0x)), qy = add(py, mul(delta, n0y));
        qx_k[dir][ch] = qx;
        qy_k[dir][ch] = qy;
        sum[0] += 1.f;
        sum[1] = add(sum[1], qx);
        sum[2] = add(sum[2], qy);
        sum[3] = add(sum[3], mul(qx, qx));
        sum[4] = add(sum[4], mul(qx, qy));
        sum[5] = add(sum[5], mul(qy, qy));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum[k] = add(sum[k], __shfl_xor_sync(kFull, sum[k], off));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n_dead += __shfl_xor_sync(kFull, n_dead, off);

  // PCA fit (every lane computes it; the anchor counts with weight 1)
  const float n = add(1.f, sum[0]);
  const float mx = __fdiv_rn(add(ax, sum[1]), n);
  const float my = __fdiv_rn(add(ay, sum[2]), n);
  const float cxx = sub(__fdiv_rn(add(mul(ax, ax), sum[3]), n), mul(mx, mx));
  const float cxy = sub(__fdiv_rn(add(mul(ax, ay), sum[4]), n), mul(mx, my));
  const float cyy = sub(__fdiv_rn(add(mul(ay, ay), sum[5]), n), mul(my, my));
  const float theta = mul(0.5f, atan2f(mul(2.f, cxy), sub(cxx, cyy)));
  const float ux = cosf(theta), uy = sinf(theta);
  const float tr = add(cxx, cyy);
  const float det = sub(mul(cxx, cyy), mul(cxy, cxy));
  const float lam_min =
      sub(__fdiv_rn(tr, 2.f), __fsqrt_rn(fmaxf(sub(__fdiv_rn(mul(tr, tr), 4.f), det), 0.f)));

  // support extremes projected on the fitted line (dead samples read 0)
  float t_hi = n_dead > 0 ? 0.f : -INFINITY, t_lo = n_dead > 0 ? 0.f : INFINITY;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir)
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
      if (alive_k[dir][ch]) {
        const float tq = add(mul(sub(qx_k[dir][ch], mx), ux), mul(sub(qy_k[dir][ch], my), uy));
        t_hi = fmaxf(t_hi, tq);
        t_lo = fminf(t_lo, tq);
      }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t_hi = fmaxf(t_hi, __shfl_xor_sync(kFull, t_hi, off));
    t_lo = fminf(t_lo, __shfl_xor_sync(kFull, t_lo, off));
  }
  if (lane == 0) {
    segs[4 * a + 0] = add(mx, mul(t_lo, ux));
    segs[4 * a + 1] = add(my, mul(t_lo, uy));
    segs[4 * a + 2] = add(mx, mul(t_hi, ux));
    segs[4 * a + 3] = add(my, mul(t_hi, uy));
    lens[a] = sub(t_hi, t_lo);
    fits_n[a] = __fsqrt_rn(fmaxf(lam_min, 0.f));
    fits_n[A + a] = n;
    a_ok[a] = 1;
  }
}

template <int kChunks>
int launch_select_grow(const float* best_val, const int* best_idx, int n_cells, int cw,
                       const float* mag, const float* dx, const float* dy, int H, int W, int A,
                       int S, float grad_thresh, float cos_tol, float* segs, float* lens,
                       float* fits_n, unsigned char* a_ok, cudaStream_t stream) {
  const int blocks = (n_cells + kGrowWarps - 1) / kGrowWarps;
  const size_t smem = sizeof(float) * 4 * ((n_cells + 3) / 4);
  static size_t smem_allowed = 48 * 1024;  // above it only after the attribute is raised
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        line_select_grow_kernel<kChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  line_select_grow_kernel<kChunks><<<blocks, 32 * kGrowWarps, smem, stream>>>(
      best_val, best_idx, n_cells, cw, mag, dx, dy, H, W, A, S, grad_thresh, cos_tol, segs,
      lens, fits_n, a_ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vp_line_anchors(const float* img, int H, int W, float grad_thresh,
                               float anchor_thresh, float* mag, float* dx, float* dy,
                               float* best_val, int* best_idx, cudaStream_t stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const int ch = (H + kCell - 1) / kCell, cw = (W + kCell - 1) / kCell;
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0)
    line_anchors_kernel<true><<<grid, 32 * kAnchorWarps, 0, stream>>>(
        img, H, W, ch, cw, grad_thresh, anchor_thresh, mag, dx, dy, best_val, best_idx);
  else
    line_anchors_kernel<false><<<grid, 32 * kAnchorWarps, 0, stream>>>(
        img, H, W, ch, cw, grad_thresh, anchor_thresh, mag, dx, dy, best_val, best_idx);
  return (int)cudaGetLastError();
}

extern "C" int vp_line_select_grow(const float* best_val, const int* best_idx, int n_cells,
                                   int cw, const float* mag, const float* dx, const float* dy,
                                   int H, int W, int A, int S, float grad_thresh, float cos_tol,
                                   float* segs, float* lens, float* fits_n, unsigned char* a_ok,
                                   cudaStream_t stream) {
  if (n_cells < 1 || cw < 1 || S < 0 || S > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  if (A == 0) return 0;
  switch (S <= 32 ? 1 : (S + 31) / 32) {
#define VP_SELECT_GROW(n) \
  case n:                 \
    return launch_select_grow<n>(best_val, best_idx, n_cells, cw, mag, dx, dy, H, W, A, S, \
                                 grad_thresh, cos_tol, segs, lens, fits_n, a_ok, stream);
    VP_SELECT_GROW(1)
    VP_SELECT_GROW(2)
    VP_SELECT_GROW(3)
    VP_SELECT_GROW(4)
    VP_SELECT_GROW(5)
    VP_SELECT_GROW(6)
    VP_SELECT_GROW(7)
    VP_SELECT_GROW(8)
#undef VP_SELECT_GROW
  }
  return (int)cudaErrorInvalidValue;
}
