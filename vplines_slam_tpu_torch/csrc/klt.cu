// K2 klt_track_level: one pyramid level of inverse-compositional
// Lucas-Kanade for N point features, one CTA per feature.
//
// Replaces: vplines_slam_tpu/ops/klt.py:162 _track_level (with
//   extract_windows :92, _take_row_strips :78, _grad_inwin :109 and
//   _inwin_extract :130).  On the TPU every window was a row-strip gather
//   plus a one-hot column matmul, and every bilinear patch two one-hot
//   matmuls, because scattered gathers were the TPU's bottleneck.
// Bound on the H100: latency.  A level reads ~2.5 KB of image per feature
//   (one 24x24 template superset, three 32x32 moving windows) and does
//   ~10 x 441 x 12 flops per feature: 150 features are 0.4 MB and 8 MFLOP,
//   far below a microsecond of bandwidth or compute.  What costs is the
//   serial chain of 10 iterations, each a block-wide reduction.
// Design: the template superset [P+3]^2, its Scharr gradients and the
//   moving window [P+1+2D]^2 live in shared memory; every gather is a direct
//   load, every bilinear patch a 4-tap read of shared memory.  Each iteration
//   is one pass over the P*P patch plus one two-value block reduction; all
//   threads keep the flow in registers and apply the same step, so no extra
//   barrier broadcasts it.  The reference's semantics are kept exactly: the
//   zero pad E = r + D + 2 (read as a bounds test, never materialised), the
//   anchor clips, Scharr on the integer superset with wrap-around borders
//   then interpolated, min_eig / (P*P), the det > 1e-12 guard, and two rounds
//   of iters/2 with one re-anchor, the drift inside a round clamped to the
//   window.
// Gain/bias mode (illum != 0; replaces _gain_bias :152, applied at :244 and
//   :258): the moving patch is staged in shared memory, and two more block
//   sums per iteration give its mean and population std (two-pass, as
//   jnp.std); the patch is renormalized to the template's mean and std
//   (+1e-6 each) before the residual, in every iteration and in the final
//   residual.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kDrift = 5;  // D: in-window drift margin per round (px)
constexpr int kThreads = 256;

struct PaddedImage {
  const float* img;
  int H, W, E, Hp, Wp;
  // value at padded (row, col); rows clamp into the padded image, columns
  // past its right edge read 0 (row-take + one-hot select semantics)
  __device__ float at(int yp, int xp) const {
    yp = min(max(yp, 0), Hp - 1);
    if (xp >= Wp) return 0.f;
    int y = yp - E, x = xp - E;
    return (y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.f;
  }
};

__device__ void load_window(const PaddedImage& im, int y0, int x0, int S,
                            float* dst) {
  for (int i = threadIdx.x; i < S * S; i += blockDim.x)
    dst[i] = im.at(y0 + i / S, x0 + i % S);
}

// Bilinear sample of an S x S window at integer top-left (fy, fx) + (p, q),
// fractional weights (wy, wx): rows first, then columns.
__device__ __forceinline__ float bilinear(const float* win, int S, int fy,
                                          float wy, int fx, float wx, int p,
                                          int q) {
  const float* r0 = win + (fy + p) * S + fx + q;
  const float* r1 = r0 + S;
  float t0 = (1.f - wy) * r0[0] + wy * r1[0];
  float t1 = (1.f - wy) * r0[1] + wy * r1[1];
  return (1.f - wx) * t0 + wx * t1;
}

__global__ void __launch_bounds__(kThreads)
klt_level_kernel(const float* __restrict__ img0, const float* __restrict__ img1,
                 int H, int W, const float* __restrict__ pts0,
                 const float* __restrict__ guess, int P, int iters,
                 float min_eig_thresh, int illum, float* __restrict__ flow,
                 unsigned char* __restrict__ ok_out, float* __restrict__ resid) {
  const int n = blockIdx.x;
  const int TS = P + 3, MS = P + 1 + 2 * kDrift;
  const int E = (P - 1) / 2 + kDrift + 2;
  const float r = 0.5f * (float)(P - 1);
  const int Hp = H + 2 * E, Wp = W + 2 * E;
  const int PP = P * P;

  extern __shared__ float smem[];
  float* Tss = smem;            // TS*TS template superset
  float* tA = Tss + TS * TS;    // row-smoothed superset (for gx)
  float* tB = tA + TS * TS;     // row-differenced superset (for gy)
  float* Gx = tB + TS * TS;     // Scharr x on the superset
  float* Gy = Gx + TS * TS;     // Scharr y on the superset
  float* T = Gy + TS * TS;      // P*P template
  float* Ix = T + PP;
  float* Iy = Ix + PP;
  float* M = Iy + PP;           // MS*MS moving window
  float* Mv = M + MS * MS;      // P*P moving patch (gain/bias mode)
  __shared__ float scratch[3 * 32];

  const PaddedImage im0{img0, H, W, E, Hp, Wp};
  const PaddedImage im1{img1, H, W, E, Hp, Wp};
  const float px = pts0[2 * n] + (float)E;
  const float py = pts0[2 * n + 1] + (float)E;

  // ---- template + gradients from one superset ---------------------------
  const float tl0x = px - r, tl0y = py - r;
  const int a0x = min(max((int)floorf(tl0x) - 1, 0), max(Wp - TS, 0));
  const int a0y = min(max((int)floorf(tl0y) - 1, 0), max(Hp - TS, 0));
  load_window(im0, a0y, a0x, TS, Tss);
  __syncthreads();

  const float s0 = 3.f / 32.f, s1 = 10.f / 32.f, s2 = 3.f / 32.f;
  for (int i = threadIdx.x; i < TS * TS; i += blockDim.x) {
    int y = i / TS, x = i % TS;
    int ym = (y + TS - 1) % TS, yq = (y + 1) % TS;
    float a = Tss[ym * TS + x], b = Tss[i], c = Tss[yq * TS + x];
    tA[i] = s0 * a + s1 * b + s2 * c;
    tB[i] = -a + c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TS * TS; i += blockDim.x) {
    int y = i / TS, x = i % TS;
    int xm = y * TS + (x + TS - 1) % TS, xq = y * TS + (x + 1) % TS;
    Gx[i] = -tA[xm] + tA[xq];
    Gy[i] = s0 * tB[xm] + s1 * tB[i] + s2 * tB[xq];
  }
  __syncthreads();

  {
    const float lx = fminf(fmaxf(tl0x - (float)a0x, 0.f), (float)(TS - P - 1));
    const float ly = fminf(fmaxf(tl0y - (float)a0y, 0.f), (float)(TS - P - 1));
    const int fx = min(max((int)floorf(lx), 0), TS - P - 1);
    const int fy = min(max((int)floorf(ly), 0), TS - P - 1);
    const float wx = lx - floorf(lx), wy = ly - floorf(ly);
    for (int i = threadIdx.x; i < PP; i += blockDim.x) {
      int p = i / P, q = i % P;
      T[i] = bilinear(Tss, TS, fy, wy, fx, wx, p, q);
      Ix[i] = bilinear(Gx, TS, fy, wy, fx, wx, p, q);
      Iy[i] = bilinear(Gy, TS, fy, wy, fx, wx, p, q);
    }
  }
  __syncthreads();

  // 2x2 spatial gradient matrix (constant over iterations)
  float abc[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < PP; i += blockDim.x) {
    abc[0] += Ix[i] * Ix[i];
    abc[1] += Ix[i] * Iy[i];
    abc[2] += Iy[i] * Iy[i];
  }
  vp::block_sum<3>(abc, scratch);
  const float a = abc[0], b = abc[1], c = abc[2];
  const float det = a * c - b * b;
  const float min_eig =
      (c + a - sqrtf((a - c) * (a - c) + 4.f * b * b)) / (2.f * (float)PP);
  const bool ok = min_eig > min_eig_thresh;
  const float dsafe = det > 1e-12f ? det : 1.f;
  const float i00 = c / dsafe, i01 = -b / dsafe, i11 = a / dsafe;

  // template mean and population std (gain/bias mode)
  float mT = 0.f, sT = 0.f;
  if (illum) {
    float s1[1] = {0.f};
    for (int i = threadIdx.x; i < PP; i += blockDim.x) s1[0] += T[i];
    vp::block_sum<1>(s1, scratch);
    mT = s1[0] / (float)PP;
    float s2[1] = {0.f};
    for (int i = threadIdx.x; i < PP; i += blockDim.x) s2[0] += (T[i] - mT) * (T[i] - mT);
    vp::block_sum<1>(s2, scratch);
    sT = sqrtf(s2[0] / (float)PP) + 1e-6f;
  }

  // ---- moving-window iterations, re-anchored once mid-level ---------------
  float dx = guess[2 * n], dy = guess[2 * n + 1];
  int m0x = 0, m0y = 0;
  auto make_window = [&]() {
    m0x = min(max((int)rintf(px + dx - r) - kDrift, 0), max(Wp - MS, 0));
    m0y = min(max((int)rintf(py + dy - r) - kDrift, 0), max(Hp - MS, 0));
    load_window(im1, m0y, m0x, MS, M);
    __syncthreads();
  };
  // bilinear read of the moving patch at the current flow, clamped to the
  // window (the reference's in-round drift clamp)
  auto moving_at = [&](int i) {
    const float lx =
        fminf(fmaxf(px + dx - r - (float)m0x, 0.f), (float)(MS - P - 1));
    const float ly =
        fminf(fmaxf(py + dy - r - (float)m0y, 0.f), (float)(MS - P - 1));
    const int fx = min(max((int)floorf(lx), 0), MS - P - 1);
    const int fy = min(max((int)floorf(ly), 0), MS - P - 1);
    return bilinear(M, MS, fy, ly - floorf(ly), fx, lx - floorf(lx), i / P,
                    i % P);
  };

  // the moving patch at the current flow, minus the template; in gain/bias
  // mode renormalized first (stages the patch in Mv and ends with a barrier)
  float gain = 1.f, bias = 0.f;
  auto normalize_patch = [&]() {
    if (!illum) return;
    float s1[1] = {0.f};
    for (int i = threadIdx.x; i < PP; i += blockDim.x) {
      Mv[i] = moving_at(i);
      s1[0] += Mv[i];
    }
    vp::block_sum<1>(s1, scratch);
    const float mI = s1[0] / (float)PP;
    float s2[1] = {0.f};
    for (int i = threadIdx.x; i < PP; i += blockDim.x) s2[0] += (Mv[i] - mI) * (Mv[i] - mI);
    vp::block_sum<1>(s2, scratch);
    gain = sT / (sqrtf(s2[0] / (float)PP) + 1e-6f);
    bias = mI;
  };
  auto residual_at = [&](int i) {
    return illum ? (Mv[i] - bias) * gain + mT - T[i] : moving_at(i) - T[i];
  };

  const int n_rounds = iters >= 4 ? 2 : 1;
  for (int rd = 0; rd < n_rounds; ++rd) {
    const int n_it = n_rounds == 1 ? iters : (rd == 0 ? iters / 2 : iters - iters / 2);
    make_window();
    for (int it = 0; it < n_it; ++it) {
      normalize_patch();
      float g[2] = {0.f, 0.f};
      for (int i = threadIdx.x; i < PP; i += blockDim.x) {
        float rr = residual_at(i);
        g[0] += rr * Ix[i];
        g[1] += rr * Iy[i];
      }
      vp::block_sum<2>(g, scratch);
      if (ok) {
        dx -= i00 * g[0] + i01 * g[1];
        dy -= i01 * g[0] + i11 * g[1];
      }
    }
  }

  make_window();
  normalize_patch();
  float res[1] = {0.f};
  for (int i = threadIdx.x; i < PP; i += blockDim.x)
    res[0] += fabsf(residual_at(i));
  vp::block_sum<1>(res, scratch);
  if (threadIdx.x == 0) {
    flow[2 * n] = dx;
    flow[2 * n + 1] = dy;
    ok_out[n] = ok ? 1 : 0;
    resid[n] = res[0] / (float)PP;
  }
}

}  // namespace

extern "C" int vp_klt_track_level(const float* img0, const float* img1, int H,
                                  int W, const float* pts0, const float* guess,
                                  int N, int P, int iters, float min_eig,
                                  int illum, float* flow, unsigned char* ok,
                                  float* resid, cudaStream_t stream) {
  const int TS = P + 3, MS = P + 1 + 2 * kDrift;
  size_t smem = sizeof(float) * (5 * TS * TS + 4 * P * P + MS * MS);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  klt_level_kernel<<<N, kThreads, smem, stream>>>(
      img0, img1, H, W, pts0, guess, P, iters, min_eig, illum, flow, ok, resid);
  return (int)cudaGetLastError();
}
