// K17 hamming: two modes on one XOR + __popc core over 256-bit descriptors
// held as 8 x 32-bit words.
//
// (a) vp_hamming_match_tiles replaces vplines_slam_tpu/ops/brief.py:128
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
// Design.  (a), one launch of a cluster of up to 16 CTAs over column tiles
//   of at most ceil(M / 16) columns (32 at M = 500).  Each CTA stages every
//   query row and computes its N x tile block of distances once, a lane a
//   column and a warp a row at a time: each column's first argmin over the
//   valid rows (complete, since every CTA holds every row: a packed
//   (distance, row) key, min-folded across the CTA's warps with shared
//   atomics) and each row's (best, column, second) over the tile (two
//   redux.sync minima of packed (distance, column) keys).  Then each row's
//   tiles merge through distributed shared memory, a warp a row and a lane
//   a tile: best = the (value, index) minimum, second = the min of the
//   winning tile's second and every other tile's best, which for integers
//   is exactly the minimum with only the best column excluded, ties
//   included; lane 0 applies the valid, distance, margin and mutual gates
//   (the winning column's best row read from its owner CTA) and writes the
//   int64 index from the bool masks it reads as bytes, so a match is one
//   launch.  Every output is an integer, equal to the plain version's.
//   (b): two launches.  A grid of CTAs, one per 16 descriptors (32 at
//   N = 500), stages its descriptors and their cells in shared memory; a
//   thread per vocabulary word codes the 16 (coalesced int8 stores) and sums
//   the codes per 2x2 image cell in int32 into the CTA's own slice of a
//   scratch.  Then one CTA, a thread per (cell, word), adds the slices,
//   reduces the exact integer sum of squares and divides each sum by the
//   rounded norm.  No atomics, and integer sums are exact in any order, so
//   every run is bit-identical.

#include <cuda_runtime.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kBig = 10000;
constexpr int kSigChunk = 16;  // descriptors a CTA of the signature (ops/brief.SIG_CHUNK)
constexpr int kMatchThreads = 512;
constexpr int kMatchCluster = 16;   // CTAs at most (a non-portable cluster size)
constexpr int kMaxRows = 4096;      // query rows: 45 bytes of shared memory each
constexpr int kMaxCols = 65535;     // a column index fits 16 bits of a key

__device__ __forceinline__ int ham(const int* __restrict__ a, const int* __restrict__ b) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += __popc((unsigned)(a[k] ^ b[k]));
  return s;
}

// A (value, index) pair as one int: value < 2^15, index < 2^16, so the int
// order is the lexicographic order, the lower index first among ties.
__device__ __forceinline__ int key(int value, int index) { return (value << 16) | index; }

__global__ void __launch_bounds__(kMatchThreads)
hamming_match_kernel(const int* __restrict__ da, const unsigned char* __restrict__ va,
                     const int* __restrict__ db, const unsigned char* __restrict__ vb, int N,
                     int M, int T, int max_dist, int margin, int mutual,
                     long long* __restrict__ idx_out, int* __restrict__ dist_out,
                     int* __restrict__ d_out) {
  VP_DYN_SMEM(int, sm);
  int* s_q = sm;              // [N][8] the query descriptors
  int* s_best = s_q + 8 * N;  // [N] key of each row's best over this tile
  int* s_second = s_best + N; // [N] its second over this tile
  int* s_col = s_second + N;  // [T] key of each column's best row
  unsigned char* s_va = reinterpret_cast<unsigned char*>(s_col + T);  // [N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int rank = VP_CLUSTER_RANK(), C = gridDim.x;
  const int c0 = rank * T, nc = max(0, min(T, M - c0));
  for (int e = tid; e < 8 * N; e += blockDim.x) s_q[e] = da[e];
  for (int i = tid; i < N; i += blockDim.x) {
    s_va[i] = va[i];
    s_best[i] = key(2 * kBig, 0xffff);  // above any column's key
    s_second[i] = kBig;
  }
  for (int j = tid; j < T; j += blockDim.x) s_col[j] = 0x7fffffff;
  __syncthreads();
  for (int k0 = 0; k0 < nc; k0 += 32) {
    // a lane a column of this 32-column slice of the tile, its descriptor in
    // registers; a warp a row at a time, rows in increasing order
    const int jl = k0 + lane, j = c0 + jl;
    const bool live = jl < nc;
    int w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = live ? db[8 * j + k] : 0;
    const bool cvalid = live && vb[j];
    int ck = 0x7fffffff;  // this lane's (distance, row) minimum over its rows
    for (int i = warp; i < N; i += nwarps) {
      const int4 q0 = reinterpret_cast<const int4*>(s_q + 8 * i)[0];
      const int4 q1 = reinterpret_cast<const int4*>(s_q + 8 * i)[1];
      const int h = __popc((unsigned)(q0.x ^ w[0])) + __popc((unsigned)(q0.y ^ w[1])) +
                    __popc((unsigned)(q0.z ^ w[2])) + __popc((unsigned)(q0.w ^ w[3])) +
                    __popc((unsigned)(q1.x ^ w[4])) + __popc((unsigned)(q1.y ^ w[5])) +
                    __popc((unsigned)(q1.z ^ w[6])) + __popc((unsigned)(q1.w ^ w[7]));
      if (d_out && live) d_out[(size_t)i * M + j] = h;
      // the row's best and second over the slice: the key minimum, then the
      // minimum distance of the other columns (kBig for an invalid one)
      const int d = cvalid ? h : kBig;
      const int rk = live ? key(d, j) : key(2 * kBig, 0xffff);
      const int bk = VP_REDUX_MIN(rk);
      const int sv = VP_REDUX_MIN(rk == bk ? kBig : (live ? d : kBig));
      ck = min(ck, key(s_va[i] && cvalid ? h : kBig, i));
      if (lane == 0) {  // merge into the row's running (best, second) over the tile
        const int ob = s_best[i], os = s_second[i];
        if (bk < ob) {
          s_best[i] = bk;
          s_second[i] = min(sv, ob >> 16);
        } else {
          s_second[i] = min(os, bk >> 16);
        }
      }
    }
    if (live) atomicMin(s_col + jl, ck);
  }
  __syncthreads();
  VP_CLUSTER_SYNC();  // every CTA's row and column results are in place
  // a warp a row, rows dealt round-robin over the cluster's warps: lane r
  // reads tile r's (best, second) from CTA r's shared memory, so the row's
  // remote loads are in flight together; the best is the key minimum, the
  // second the minimum over the winning tile's second and every other
  // tile's best (keys name distinct columns, so one lane holds the best)
  for (int i = rank + C * warp; i < N; i += C * nwarps) {
    const bool has = lane < C;
    const int ob = has ? *VP_DSMEM(s_best + i, lane) : 0x7fffffff;
    const int os = has ? *VP_DSMEM(s_second + i, lane) : kBig;
    const int bk = VP_REDUX_MIN(ob);
    const int sv = VP_REDUX_MIN(ob == bk ? os : (has ? ob >> 16 : kBig));
    if (lane == 0) {
      const int dist = bk >> 16, best = bk & 0xffff;
      bool ok = s_va[i] && dist < max_dist;
      if (margin > 0) ok = ok && (sv - dist >= margin);
      if (mutual) ok = ok && ((*VP_DSMEM(s_col + best % T, best / T) & 0xffff) == i);
      idx_out[i] = ok ? best : -1;
      dist_out[i] = dist;
    }
  }
  VP_CLUSTER_SYNC();  // no CTA leaves while another reads its shared memory
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

// hamming_match_kernel's cluster of 16, allowed on the first launch on each
// device and not again
cudaError_t match_attributes(size_t smem) {
  static std::atomic<unsigned> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024) {  // per launch: N sets it
    e = cudaFuncSetAttribute(hamming_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (done.load() >> dev & 1u) return cudaSuccess;
  e = cudaFuncSetAttribute(hamming_match_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1);
  if (e == cudaSuccess) done.fetch_or(1u << dev);
  return e;
}

}  // namespace

// da [N, 8], va [N] (bool bytes), db [M, 8], vb [M]; idx_out [N] int64 (-1:
// no match), dist_out [N]; d_out (nullable) receives the raw [N, M]
// distance table.  1 <= M <= 65,535 and N <= 4,096, else an error code.
extern "C" int vp_hamming_match_tiles(const int* da, const unsigned char* va, const int* db,
                                      const unsigned char* vb, int N, int M, int max_dist,
                                      int margin, int mutual, long long* idx_out,
                                      int* dist_out, int* d_out, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (M < 1 || M > kMaxCols || N > kMaxRows) return (int)cudaErrorInvalidValue;
  const int C = (M + 31) / 32 < kMatchCluster ? (M + 31) / 32 : kMatchCluster;
  const int T = (M + C - 1) / C;
  const size_t smem = (size_t)(10 * N + T) * sizeof(int) + N;
  cudaError_t e = match_attributes(smem);
  if (e == cudaSuccess)
    e = VP_LAUNCH_CLUSTER(hamming_match_kernel, C, C, kMatchThreads, smem, stream, da, va, db,
                          vb, N, M, T, max_dist, margin, mutual, idx_out, dist_out, d_out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
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
