// K17 hamming: two modes on one XOR + __popc core over 256-bit descriptors
// held as 8 x 32-bit words.
//
// (a) vp_hamming_match replaces vplines_slam_tpu/ops/brief.py:128
//   match_descriptors with :122 hamming_matrix.  On the TPU it was the full
//   [N, M, 8] XOR tensor, a SWAR popcount, a one-hot exclusion for the
//   second best and a masked column argmin.
// (b) vp_simhash_signature replaces :185 global_signature.  On the TPU it was
//   an unpack of every descriptor to 256 f32 bits and an f32 matmul with the
//   256 x 256 +-1 vocabulary.  (bits - 0.5) @ W is the exact half-integer
//   (agreeing bits - disagreeing bits) / 2 = 128 - popcount(desc ^ w_j),
//   where w_j packs column j of W (> 0 -> 1), so the code is the sign of
//   that integer, 0 at distance 128 as jnp.sign gives.
// Bound on the H100: launch latency.  (a) at 64 x 500 is 256k word
//   XOR-popcounts, (b) at 500 x 256 is 1M: microseconds of one SM's integer
//   pipes; the inputs are 18 KB and 16 KB.
// Design: each mode is one block.  (a): a warp per query row finds the
//   first argmin over the valid columns and, with only that column excluded,
//   the second best; a thread per column the first argmin over the valid
//   rows; then a thread per row applies the distance, margin and mutual
//   gates.  Every output is an integer, equal to the plain version's.
//   (b): a thread per vocabulary word sums its codes per 2x2 image cell in
//   integers (exact in any order), one reduction gives the exact integer sum
//   of squares, and the signature is each sum over the rounded norm.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 10000;

__device__ __forceinline__ int ham(const int* __restrict__ a, const int* __restrict__ b) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += __popc((unsigned)(a[k] ^ b[k]));
  return s;
}

// lexicographic (value, index) minimum over the warp: the first index wins ties
__device__ __forceinline__ void warp_argmin(int& v, int& j) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int j2 = __shfl_xor_sync(0xffffffffu, j, o);
    if (v2 < v || (v2 == v && j2 < j)) {
      v = v2;
      j = j2;
    }
  }
}

__global__ void __launch_bounds__(1024)
hamming_match_kernel(const int* __restrict__ da, const unsigned char* __restrict__ va,
                     const int* __restrict__ db, const unsigned char* __restrict__ vb, int N,
                     int M, int max_dist, int margin, int mutual, int* __restrict__ idx_out,
                     int* __restrict__ dist_out, int* __restrict__ d_out) {
  extern __shared__ int smem[];
  int* s_col = smem;          // [M] best row of each column
  int* s_best = smem + M;     // [N]
  int* s_dist = s_best + N;   // [N]
  int* s_second = s_dist + N; // [N]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  for (int i = warp; i < N; i += nwarps) {
    int q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = da[8 * i + k];
    int bv = 2 * kBig, bj = M;  // above any entry: a row always finds column 0..M-1
    for (int j = lane; j < M; j += 32) {
      const int h = ham(q, db + 8 * j);
      if (d_out) d_out[(size_t)i * M + j] = h;
      const int d = vb[j] ? h : kBig;
      if (d < bv) {  // strict: the lane's first j wins
        bv = d;
        bj = j;
      }
    }
    warp_argmin(bv, bj);
    int sv = 2 * kBig, sj = M;
    if (margin > 0) {
      for (int j = lane; j < M; j += 32) {
        const int d = (j == bj || !vb[j]) ? kBig : ham(q, db + 8 * j);
        if (d < sv) {
          sv = d;
          sj = j;
        }
      }
      warp_argmin(sv, sj);
    }
    if (lane == 0) {
      s_best[i] = bj;
      s_dist[i] = bv;
      s_second[i] = sv;
    }
  }
  if (mutual) {
    for (int j = threadIdx.x; j < M; j += blockDim.x) {
      int bv = 2 * kBig, bi = 0;
      for (int i = 0; i < N; ++i) {
        const int d = (va[i] && vb[j]) ? ham(da + 8 * i, db + 8 * j) : kBig;
        if (d < bv) {
          bv = d;
          bi = i;
        }
      }
      s_col[j] = bi;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int best = s_best[i], dist = s_dist[i];
    bool ok = va[i] && dist < max_dist;
    if (margin > 0) ok = ok && (s_second[i] - dist >= margin);
    if (mutual) ok = ok && (s_col[best] == i);
    idx_out[i] = ok ? best : -1;
    dist_out[i] = dist;
  }
}

__global__ void hamming_simhash_kernel(const int* __restrict__ desc,
                                       const unsigned char* __restrict__ valid,
                                       const float* __restrict__ xy, int N, float sy, float sx,
                                       const int* __restrict__ words, int n_words,
                                       float* __restrict__ sig, signed char* __restrict__ codes) {
  extern __shared__ unsigned char s_cell[];  // [N] cell of each keypoint
  __shared__ long long s_sq[1024];
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    int c = 0;
    if (xy) {
      // (int)(y * (2 / H)) truncates as astype(int32) does, then the clip
      const int cy = min(max((int)__fmul_rn(xy[2 * n + 1], sy), 0), 1);
      const int cx = min(max((int)__fmul_rn(xy[2 * n], sx), 0), 1);
      c = cy * 2 + cx;
    }
    s_cell[n] = (unsigned char)c;
  }
  __syncthreads();
  long long sq = 0;
  for (int j = threadIdx.x; j < n_words; j += blockDim.x) {
    int w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = words[8 * j + k];
    int acc[4] = {0, 0, 0, 0};
    for (int n = 0; n < N; ++n) {
      const int s = 128 - ham(desc + 8 * n, w);
      const int code = valid[n] ? (s > 0) - (s < 0) : 0;
      if (codes) codes[(size_t)n * n_words + j] = (signed char)code;
      acc[s_cell[n]] += code;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sig[c * n_words + j] = (float)acc[c];
      sq += (long long)acc[c] * acc[c];
    }
  }
  s_sq[threadIdx.x] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int k = 0; k < blockDim.x; ++k) t += s_sq[k];
    s_sq[0] = t;
  }
  __syncthreads();
  const float nrm = fmaxf(__fsqrt_rn((float)s_sq[0]), 1e-9f);
  for (int j = threadIdx.x; j < n_words; j += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sig[c * n_words + j] = __fdiv_rn(sig[c * n_words + j], nrm);
  }
}

}  // namespace

// d_out (nullable) receives the raw [N, M] distance table.
extern "C" int vp_hamming_match(const int* da, const unsigned char* va, const int* db,
                                const unsigned char* vb, int N, int M, int max_dist,
                                int margin, int mutual, int* idx_out, int* dist_out,
                                int* d_out, cudaStream_t stream) {
  if (N <= 0) return 0;
  const size_t smem = (size_t)(M + 3 * N) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hamming_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  hamming_match_kernel<<<1, 1024, smem, stream>>>(da, va, db, vb, N, M, max_dist, margin,
                                                  mutual, idx_out, dist_out, d_out);
  return (int)cudaGetLastError();
}

// xy (nullable): pixel coordinates [N, 2]; sy = 2/H, sx = 2/W.  codes
// (nullable) receives the [N, n_words] codes.
extern "C" int vp_simhash_signature(const int* desc, const unsigned char* valid,
                                    const float* xy, int N, float sy, float sx,
                                    const int* words, int n_words, float* sig,
                                    signed char* codes, cudaStream_t stream) {
  const int threads = n_words < 1024 ? ((n_words + 31) / 32) * 32 : 1024;
  hamming_simhash_kernel<<<1, threads, (size_t)N, stream>>>(desc, valid, xy, N, sy, sx, words,
                                                             n_words, sig, codes);
  return (int)cudaGetLastError();
}
