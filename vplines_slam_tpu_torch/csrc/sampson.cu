// K4 sampson_score: Sampson distance, inlier mask and inlier count of every
// essential-matrix hypothesis over all tracks.
//
// Replaces: vplines_slam_tpu/ops/mvg.py:307 score (vmapped over the 32
//   hypotheses at :317 and called again for the refit at :324) inside
//   ransac_essential :278.  On the TPU it was a vmapped [N,3]x[3,3] matmul
//   pair plus a masked sum per hypothesis.
// Bound on the H100: launch latency.  32 hypotheses x 150 tracks is ~0.2
//   MFLOP and ~12 KB of input -- nanoseconds of compute or bandwidth.
// Design: one block per hypothesis, one thread per track (looping when N
//   exceeds the block); E sits in registers, each thread writes its inlier
//   flag, and one block reduction gives the count, so the mask and count
//   never round-trip through a second launch.  The +1e-18 guard and the
//   strict < threshold^2 test are the reference's.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sampson_kernel(const float* __restrict__ Es, const float* __restrict__ x1,
               const float* __restrict__ x2,
               const unsigned char* __restrict__ mask, int N, float thr2,
               int* __restrict__ counts, unsigned char* __restrict__ inl) {
  __shared__ float scratch[32];
  const int h = blockIdx.x;
  float E[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) E[k] = Es[h * 9 + k];
  float cnt[1] = {0.f};
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float u1 = x1[2 * n], v1 = x1[2 * n + 1];
    const float u2 = x2[2 * n], v2 = x2[2 * n + 1];
    // Ex1 = E @ [u1, v1, 1];  Etx2 = E^T @ [u2, v2, 1]
    const float e0 = E[0] * u1 + E[1] * v1 + E[2];
    const float e1 = E[3] * u1 + E[4] * v1 + E[5];
    const float e2 = E[6] * u1 + E[7] * v1 + E[8];
    const float f0 = u2 * E[0] + v2 * E[3] + E[6];
    const float f1 = u2 * E[1] + v2 * E[4] + E[7];
    const float num = u2 * e0 + v2 * e1 + e2;
    const float s = num * num / (e0 * e0 + e1 * e1 + f0 * f0 + f1 * f1 + 1e-18f);
    const bool in = (s < thr2) && mask[n];
    inl[(size_t)h * N + n] = in ? 1 : 0;
    cnt[0] += in ? 1.f : 0.f;
  }
  vp::block_sum<1>(cnt, scratch);
  if (threadIdx.x == 0) counts[h] = (int)(cnt[0] + 0.5f);
}

}  // namespace

extern "C" int vp_sampson_score(const float* Es, const float* x1,
                                const float* x2, const unsigned char* mask,
                                int n_hyp, int N, float thr2, int* counts,
                                unsigned char* inl, cudaStream_t stream) {
  sampson_kernel<<<n_hyp, kThreads, 0, stream>>>(Es, x1, x2, mask, N, thr2,
                                                counts, inl);
  return (int)cudaGetLastError();
}
