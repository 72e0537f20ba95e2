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
//   XOR-popcounts, (b) at 500 x 256 is 1M: microseconds of the integer
//   pipes; the inputs are 18 KB and 16 KB.
// Design.  (a), one block: a warp per query row finds the
//   first argmin over the valid columns and, with only that column excluded,
//   the second best; a thread per column the first argmin over the valid
//   rows; then a thread per row applies the distance, margin and mutual
//   gates.  Every output is an integer, equal to the plain version's.
//   (b): two launches.  A grid of CTAs, one per 16 descriptors (32 at
//   N = 500), stages its descriptors and their cells in shared memory; a
//   thread per vocabulary word codes the 16 (coalesced int8 stores) and sums
//   the codes per 2x2 image cell in int32 into the CTA's own slice of a
//   scratch.  Then one CTA, a thread per (cell, word), adds the slices,
//   reduces the exact integer sum of squares and divides each sum by the
//   rounded norm.  No atomics, and integer sums are exact in any order, so
//   every run is bit-identical.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBig = 10000;
constexpr int kSigChunk = 16;  // descriptors a CTA of the signature (ops/brief.SIG_CHUNK)

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
  VP_DYN_SMEM(int, smem);
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

// signature launch 1: a CTA per SIG_CHUNK descriptors, a thread per
// vocabulary word; the CTA's per-cell integer sums go to its own slice of
// partial [n_chunks, 4, n_words]
__global__ void __launch_bounds__(256)
hamming_simhash_codes_kernel(const int* __restrict__ desc, const unsigned char* __restrict__ valid,
                             const float* __restrict__ xy, int N, float sy, float sx,
                             const int* __restrict__ words, int n_words,
                             int* __restrict__ partial, signed char* __restrict__ codes) {
  VP_DYN_SMEM(int, sm);
  int* s_desc = sm;                       // [SIG_CHUNK][8]
  int* s_cell = s_desc + 8 * kSigChunk;   // [SIG_CHUNK], -1: not valid
  const int n0 = blockIdx.x * kSigChunk, nn = min(kSigChunk, N - n0);
  for (int e = threadIdx.x; e < 8 * nn; e += blockDim.x) s_desc[e] = desc[8 * n0 + e];
  for (int n = threadIdx.x; n < nn; n += blockDim.x) {
    int c = 0;
    if (xy) {
      // (int)(y * (2 / H)) truncates as astype(int32) does, then the clip
      const int cy = min(max((int)__fmul_rn(xy[2 * (n0 + n) + 1], sy), 0), 1);
      const int cx = min(max((int)__fmul_rn(xy[2 * (n0 + n)], sx), 0), 1);
      c = cy * 2 + cx;
    }
    s_cell[n] = valid[n0 + n] ? c : -1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_words; j += blockDim.x) {
    int w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = words[8 * j + k];
    int acc[4] = {0, 0, 0, 0};
    for (int n = 0; n < nn; ++n) {
      const int s = 128 - ham(s_desc + 8 * n, w);
      const int cell = s_cell[n];
      const int code = cell >= 0 ? (s > 0) - (s < 0) : 0;
      if (codes) codes[(size_t)(n0 + n) * n_words + j] = (signed char)code;
      acc[cell >= 0 ? cell : 0] += code;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) partial[((size_t)blockIdx.x * 4 + c) * n_words + j] = acc[c];
  }
}

// signature launch 2, one CTA, a thread per (cell, word): its sum over the
// chunks (integers: exact in any order, so 8 loads are in flight at a
// time), the exact integer sum of squares, then each sum over the rounded
// norm
__global__ void __launch_bounds__(1024)
hamming_simhash_norm_kernel(const int* __restrict__ partial, int n_chunks, int n_words,
                            float* __restrict__ sig) {
  VP_DYN_SMEM(long long, s_sq);  // [warps]
  long long sq = 0;
  const int n = 4 * n_words;  // partial [n_chunks, 4, n_words]: entry e of chunk b at b n + e
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int s8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int b = 0;
    for (; b + 8 <= n_chunks; b += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) s8[u] += partial[(size_t)(b + u) * n + e];
    }
    for (; b < n_chunks; ++b) s8[0] += partial[(size_t)b * n + e];
    const int s = ((s8[0] + s8[1]) + (s8[2] + s8[3])) + ((s8[4] + s8[5]) + (s8[6] + s8[7]));
    sig[e] = (float)s;
    sq += (long long)s * s;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((threadIdx.x & 31) == 0) s_sq[threadIdx.x >> 5] = sq;
  __syncthreads();
  long long t = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) t += s_sq[k];
  const float nrm = fmaxf(__fsqrt_rn((float)t), 1e-9f);
  for (int e = threadIdx.x; e < n; e += blockDim.x) sig[e] = __fdiv_rn(sig[e], nrm);
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
  VP_LAUNCH(hamming_match_kernel, 1, 1024, smem, stream, da, va, db, vb, N, M, max_dist, margin,
            mutual, idx_out, dist_out, d_out);
  return (int)cudaGetLastError();
}

// xy (nullable): pixel coordinates [N, 2]; sy = 2/H, sx = 2/W.  partial:
// [max(n_chunks, 1), 4, n_words] int32 scratch, n_chunks = ceil(N / 16).
// codes (nullable) receives the [N, n_words] codes.
extern "C" int vp_simhash_signature(const int* desc, const unsigned char* valid,
                                    const float* xy, int N, float sy, float sx,
                                    const int* words, int n_words, int* partial, float* sig,
                                    signed char* codes, cudaStream_t stream) {
  const int n_chunks = (N + kSigChunk - 1) / kSigChunk;
  if (n_chunks > 0)
    VP_LAUNCH(hamming_simhash_codes_kernel, n_chunks, 256, sizeof(int) * 9 * kSigChunk, stream,
              desc, valid, xy, N, sy, sx, words, n_words, partial, codes);
  VP_LAUNCH(hamming_simhash_norm_kernel, 1, 1024, sizeof(long long) * 32, stream, partial,
            n_chunks, n_words, sig);
  return (int)cudaGetLastError();
}
