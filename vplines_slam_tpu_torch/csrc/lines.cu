// K6 line_anchors + line_grow: the EDLine anchor-growth line detector.
//
// Replaces: vplines_slam_tpu/ops/lines.py:63 detect_lines (:70-108 the blur,
//   Scharr, anchor test and per-cell argmax; :118-212 the ray walk, tube
//   offset, moments and PCA fit).  On the TPU the blur and Scharr were ~16
//   full-size roll-shifted passes, the cell argmax a reshape/transpose of the
//   padded score image, and the walk of 512 anchors x 2 x 96 steps a batched
//   gather of every sample (three times: the ray and both tube sides) with
//   the sequential stop turned into a prefix-AND over the whole ray.
//
// line_anchors: one 16x16 block per 16x16 anchor cell.  The 24x24 image halo,
//   the vertical and horizontal Gaussian passes, the Scharr passes, the
//   gradient magnitude and level-line direction of the 18x18 region around
//   the cell all stay in shared memory; mag/dx/dy of the cell are written
//   (the walk reads them), then the anchor test and a (value, index) argmax
//   where the first row-major index in the cell wins ties (jnp.argmax).  Zero
//   padding is applied stage by stage as the separable reference does: each
//   stage's output is zero outside the image before the next stage reads it.
//   Products and sums are rounded one by one in tap order (no FMA
//   contraction), so the fields repeat the plain version's arithmetic.
// Bound on the H100: launch latency; the image is 1.4 MB and the three
//   fields 4.3 MB of writes (~2 us of HBM time at 3.35 TB/s).
//
// line_grow: one warp per anchor, 8 warps per block.  Each direction walks 32
//   steps at a time (one step per lane); a ballot finds the first sample that
//   fails the gate, and the walk stops there -- exactly the prefix-AND of the
//   reference.  Alive samples take the 3-tap parabolic offset across the ray;
//   the six moments are warp sums; lane 0 fits the line (PCA of the support)
//   and the support extremes give the endpoints.  Nearest-pixel rounding is
//   round-half-to-even (__float2int_rn, as jnp.round).  The moments are summed
//   in another order than torch.sum, so the fit differs from the plain
//   version by f32 rounding (see chip_smoke.py for the tolerance).
// Bound on the H100: latency of the dependent walk; 512 anchors read at most
//   512 x 192 x 3 samples (~3.5 MB of scattered 4-byte reads, cached).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCell = 16;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 8;  // walks of up to 8 x 32 = 256 steps each way

// cv::getGaussianKernel(5, 1) taps, rounded to f32 as the plain version's
// Python floats are
__constant__ float kGauss[5] = {0.054488684549642945f, 0.24420134200323335f,
                                0.40261994689424746f, 0.24420134200323335f,
                                0.054488684549642945f};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kCell * kCell)
line_anchors_kernel(const float* __restrict__ img, int H, int W,
                    float grad_thresh, float anchor_thresh,
                    float* __restrict__ mag_out, float* __restrict__ dx_out,
                    float* __restrict__ dy_out, float* __restrict__ best_val,
                    int* __restrict__ best_idx) {
  // regions (rows x cols), relative to the cell's top-left (y0, x0):
  //   image  [-4, 20) x [-4, 20)   24 x 24
  //   tv     [-2, 18) x [-4, 20)   vertical Gaussian pass, 20 x 24
  //   blur   [-2, 18) x [-2, 18)   20 x 20
  //   sv, dv [-1, 17) x [-2, 18)   vertical Scharr passes, 18 x 20
  //   fields [-1, 17) x [-1, 17)   gx, gy, mag: 18 x 18
  __shared__ float s_img[24][24];
  __shared__ float s_tv[20][24];
  __shared__ float s_blur[20][20];
  __shared__ float s_sv[18][20];
  __shared__ float s_dv[18][20];
  __shared__ float s_mag[18][18];
  __shared__ float s_gx[18][18];
  __shared__ float s_gy[18][18];
  __shared__ float s_bv[kCell * kCell / 32];
  __shared__ int s_bi[kCell * kCell / 32];

  const int y0 = blockIdx.y * kCell, x0 = blockIdx.x * kCell;
  const int tid = threadIdx.y * kCell + threadIdx.x;
  const int nthr = kCell * kCell;
  auto inside = [&](int y, int x) { return y >= 0 && y < H && x >= 0 && x < W; };

  for (int k = tid; k < 24 * 24; k += nthr) {
    int r = k / 24, c = k % 24, y = y0 - 4 + r, x = x0 - 4 + c;
    s_img[r][c] = inside(y, x) ? img[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();
  // vertical Gaussian: zero outside the image's columns (the horizontal
  // pass's padding)
  for (int k = tid; k < 20 * 24; k += nthr) {
    int r = k / 24, c = k % 24, x = x0 - 4 + c;
    float acc = 0.f;
    if (x >= 0 && x < W) {
      acc = mul(kGauss[0], s_img[r][c]);
#pragma unroll
      for (int i = 1; i < 5; ++i) acc = add(acc, mul(kGauss[i], s_img[r + i][c]));
    }
    s_tv[r][c] = acc;
  }
  __syncthreads();
  // horizontal Gaussian; the blurred image is zero outside the image
  for (int k = tid; k < 20 * 20; k += nthr) {
    int r = k / 20, c = k % 20, y = y0 - 2 + r, x = x0 - 2 + c;
    float acc = 0.f;
    if (inside(y, x)) {
      acc = mul(kGauss[0], s_tv[r][c]);
#pragma unroll
      for (int i = 1; i < 5; ++i) acc = add(acc, mul(kGauss[i], s_tv[r][c + i]));
    }
    s_blur[r][c] = acc;
  }
  __syncthreads();
  // Scharr vertical passes: smoothing [3,10,3]/32 (for gx), difference
  // [-1,0,1] (for gy); zero outside the image's columns
  const float s0 = 3.f / 32.f, s1 = 10.f / 32.f;
  for (int k = tid; k < 18 * 20; k += nthr) {
    int r = k / 20, c = k % 20, x = x0 - 2 + c;
    float sv = 0.f, dv = 0.f;
    if (x >= 0 && x < W) {
      sv = add(add(mul(s0, s_blur[r][c]), mul(s1, s_blur[r + 1][c])), mul(s0, s_blur[r + 2][c]));
      dv = add(-s_blur[r][c], s_blur[r + 2][c]);
    }
    s_sv[r][c] = sv;
    s_dv[r][c] = dv;
  }
  __syncthreads();
  // horizontal passes, magnitude (zero outside the image: the anchor test's
  // padding)
  for (int k = tid; k < 18 * 18; k += nthr) {
    int r = k / 18, c = k % 18, y = y0 - 1 + r, x = x0 - 1 + c;
    float gx = 0.f, gy = 0.f, m = 0.f;
    if (inside(y, x)) {
      gx = add(-s_sv[r][c], s_sv[r][c + 2]);
      gy = add(add(mul(s0, s_dv[r][c]), mul(s1, s_dv[r][c + 1])), mul(s0, s_dv[r][c + 2]));
      m = __fsqrt_rn(add(mul(gx, gx), mul(gy, gy)));
    }
    s_gx[r][c] = gx;
    s_gy[r][c] = gy;
    s_mag[r][c] = m;
  }
  __syncthreads();

  // the cell's own pixel: fields out, anchor test, argmax
  const int r = threadIdx.y + 1, c = threadIdx.x + 1;
  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  float score = 0.f;
  if (y < H && x < W) {
    const float m = s_mag[r][c], gx = s_gx[r][c], gy = s_gy[r][c];
    const float ms = fmaxf(m, 1e-12f);
    const size_t o = (size_t)y * W + x;
    mag_out[o] = m;
    dx_out[o] = __fdiv_rn(-gy, ms);
    dy_out[o] = __fdiv_rn(gx, ms);
    const bool along_x = fabsf(gx) >= fabsf(gy);  // vertical edge
    const bool peak = along_x
        ? (m >= add(s_mag[r][c - 1], anchor_thresh) && m >= add(s_mag[r][c + 1], anchor_thresh))
        : (m >= add(s_mag[r - 1][c], anchor_thresh) && m >= add(s_mag[r + 1][c], anchor_thresh));
    if (m > grad_thresh && peak) score = m;
  }
  float bv = score;
  int bi = tid;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((tid & 31) == 0) {
    s_bv[tid >> 5] = bv;
    s_bi[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nthr / 32; ++w)
      if (s_bv[w] > bv || (s_bv[w] == bv && s_bi[w] < bi)) {
        bv = s_bv[w];
        bi = s_bi[w];
      }
    const int cell = blockIdx.y * gridDim.x + blockIdx.x;
    best_val[cell] = bv;
    best_idx[cell] = bi;
  }
}

__device__ __forceinline__ size_t clamped(int yi, int xi, int H, int W) {
  return (size_t)min(max(yi, 0), H - 1) * W + min(max(xi, 0), W - 1);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
line_grow_kernel(const float* __restrict__ ax_in, const float* __restrict__ ay_in,
                 const float* __restrict__ mag, const float* __restrict__ dxf,
                 const float* __restrict__ dyf, int H, int W, int A, int S,
                 float grad_thresh, float cos_tol, float* __restrict__ segs,
                 float* __restrict__ lens, float* __restrict__ fits_n) {
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (a >= A) return;
  const float ax = ax_in[a], ay = ay_in[a];
  const size_t ao = (size_t)(int)ay * W + (int)ax;
  const float d0x = dxf[ao], d0y = dyf[ao];
  const float n0x = -d0y, n0y = d0x;
  const int n_chunks = min((S + 31) / 32, kMaxChunks);

  // alive samples of both directions, kept per lane for the second pass
  float qx_k[2][kMaxChunks], qy_k[2][kMaxChunks];
  bool alive_k[2][kMaxChunks];
  float sum[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // n, sx, sy, sxx, sxy, syy
  int n_dead = 0;  // samples that are not alive (each reads as 0 in the extremes)
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const float sgn = dir == 0 ? 1.f : -1.f;
    bool walking = true;
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      alive_k[dir][ch] = false;
      qx_k[dir][ch] = 0.f;
      qy_k[dir][ch] = 0.f;
      if (ch >= n_chunks) continue;
      const int t = ch * 32 + lane + 1;
      const bool in_ray = t <= S;
      const float st = mul(sgn, (float)t);
      const float px = add(ax, mul(st, d0x)), py = add(ay, mul(st, d0y));
      const int xi = __float2int_rn(px), yi = __float2int_rn(py);
      const size_t o = clamped(yi, xi, H, W);
      const float m_s = mag[o];
      const float align = fabsf(add(mul(dxf[o], d0x), mul(dyf[o], d0y)));
      const bool ok = in_ray && xi >= 1 && xi < W - 2 && yi >= 1 && yi < H - 2 &&
                      m_s > grad_thresh && align > cos_tol;
      // first failing step of this chunk (steps past S fail too)
      const unsigned fails = __ballot_sync(0xffffffffu, !ok);
      const int first_fail = fails ? __ffs(fails) - 1 : 32;
      const bool alive = walking && lane < first_fail;
      if (walking && fails) walking = false;
      if (in_ray && !alive) ++n_dead;
      if (alive) {
        const float m_p = mag[clamped(__float2int_rn(add(py, n0y)), __float2int_rn(add(px, n0x)), H, W)];
        const float m_m = mag[clamped(__float2int_rn(sub(py, n0y)), __float2int_rn(sub(px, n0x)), H, W)];
        float denom = add(sub(m_p, mul(2.f, m_s)), m_m);
        denom = fabsf(denom) > 1e-9f ? denom : 1e-9f;
        const float delta = fminf(fmaxf(__fdiv_rn(mul(0.5f, sub(m_m, m_p)), denom), -1.f), 1.f);
        const float qx = add(px, mul(delta, n0x)), qy = add(py, mul(delta, n0y));
        alive_k[dir][ch] = true;
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
      sum[k] = add(sum[k], __shfl_xor_sync(0xffffffffu, sum[k], off));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n_dead += __shfl_xor_sync(0xffffffffu, n_dead, off);

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
    for (int ch = 0; ch < kMaxChunks; ++ch)
      if (alive_k[dir][ch]) {
        const float tq = add(mul(sub(qx_k[dir][ch], mx), ux), mul(sub(qy_k[dir][ch], my), uy));
        t_hi = fmaxf(t_hi, tq);
        t_lo = fminf(t_lo, tq);
      }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t_hi = fmaxf(t_hi, __shfl_xor_sync(0xffffffffu, t_hi, off));
    t_lo = fminf(t_lo, __shfl_xor_sync(0xffffffffu, t_lo, off));
  }
  if (lane == 0) {
    segs[4 * a + 0] = add(mx, mul(t_lo, ux));
    segs[4 * a + 1] = add(my, mul(t_lo, uy));
    segs[4 * a + 2] = add(mx, mul(t_hi, ux));
    segs[4 * a + 3] = add(my, mul(t_hi, uy));
    lens[a] = sub(t_hi, t_lo);
    fits_n[a] = __fsqrt_rn(fmaxf(lam_min, 0.f));
    fits_n[A + a] = n;
  }
}

}  // namespace

extern "C" int vp_line_anchors(const float* img, int H, int W, float grad_thresh,
                               float anchor_thresh, float* mag, float* dx, float* dy,
                               float* best_val, int* best_idx, cudaStream_t stream) {
  dim3 block(kCell, kCell);
  dim3 grid((W + kCell - 1) / kCell, (H + kCell - 1) / kCell);
  line_anchors_kernel<<<grid, block, 0, stream>>>(img, H, W, grad_thresh, anchor_thresh,
                                                  mag, dx, dy, best_val, best_idx);
  return (int)cudaGetLastError();
}

extern "C" int vp_line_grow(const float* ax, const float* ay, const float* mag,
                            const float* dx, const float* dy, int H, int W, int A, int S,
                            float grad_thresh, float cos_tol, float* segs, float* lens,
                            float* fits_n, cudaStream_t stream) {
  if (S > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  if (A == 0) return 0;
  const int blocks = (A + kWarpsPerBlock - 1) / kWarpsPerBlock;
  line_grow_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      ax, ay, mag, dx, dy, H, W, A, S, grad_thresh, cos_tol, segs, lens, fits_n);
  return (int)cudaGetLastError();
}
