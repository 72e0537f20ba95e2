// K7 line_vote: everything of the line matcher after the anchor KLT -- the
// ClosestLine assignment, the Point2Line votes and gates, the duplicate-target
// resolution and the topological (sideness) filter -- in one block.
//
// Replaces: vplines_slam_tpu/ops/line_match.py:101-142 (match_lines after the
//   KLT) and :152 topological_filter.  On the TPU the [L0, A, L1] distances
//   were a doubly vmapped broadcast, the votes a one-hot matmul, the
//   duplicate resolution another one-hot product, and the sideness check two
//   [L0, L0] vmapped passes: a dozen small XLA ops per frame.
// Bound on the H100: launch latency.  At L0 = L1 = 64 and 8 anchors the work
//   is 32k point-to-segment distances and 8k sideness tests, a few hundred
//   kFLOP, and the inputs are ~8 KB: one block does it in microseconds.
// Design: one block of 512 threads; the [L0, L1] vote table (integer counts,
//   so the shared-memory atomics give the same sums in any order) and every
//   per-line intermediate live in shared memory.  Ties resolve as the
//   reference's argmin/argmax do (first index); jnp.sign(0) = 0 is kept.
//   Distances and sideness products are rounded one operation at a time (no
//   FMA contraction), as the plain version computes them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxL = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ float point_to_segment(float px, float py, const float* s) {
  const float abx = sub(s[2], s[0]), aby = sub(s[3], s[1]);
  const float t0 = __fdiv_rn(add(mul(sub(px, s[0]), abx), mul(sub(py, s[1]), aby)),
                             fmaxf(add(mul(abx, abx), mul(aby, aby)), 1e-12f));
  const float t = fminf(fmaxf(t0, 0.f), 1.f);
  const float ex = sub(px, add(s[0], mul(t, abx))), ey = sub(py, add(s[1], mul(t, aby)));
  return __fsqrt_rn(add(mul(ex, ex), mul(ey, ey)));
}

// sign of p relative to the directed segment s (0 stays 0)
__device__ __forceinline__ int side(const float* s, float px, float py) {
  const float c = sub(mul(sub(s[2], s[0]), sub(py, s[1])), mul(sub(s[3], s[1]), sub(px, s[0])));
  return (c > 0.f) - (c < 0.f);
}

__global__ void __launch_bounds__(kThreads)
line_vote_kernel(const float* __restrict__ tracked, const unsigned char* __restrict__ ok,
                 const float* __restrict__ segs0, const unsigned char* __restrict__ valid0,
                 const float* __restrict__ segs1, const unsigned char* __restrict__ valid1,
                 int L0, int A, int L1, float max_dist, float vote_ratio, int min_votes,
                 int* __restrict__ match_out, float* __restrict__ n_votes_out) {
  extern __shared__ int s_votes[];  // [L0 * L1]
  __shared__ float s_seg0[kMaxL][4], s_seg1[kMaxL][4], s_nv[kMaxL];
  __shared__ int s_match[kMaxL], s_best_src[kMaxL + 1], s_valid[kMaxL];
  __shared__ int s_n_valid;
  const int tid = threadIdx.x;

  for (int k = tid; k < L0 * L1; k += blockDim.x) s_votes[k] = 0;
  for (int k = tid; k < 4 * L0; k += blockDim.x) s_seg0[k / 4][k % 4] = segs0[k];
  for (int k = tid; k < 4 * L1; k += blockDim.x) s_seg1[k / 4][k % 4] = segs1[k];
  __syncthreads();

  // ClosestLine: each tracked anchor votes for its nearest current segment
  for (int k = tid; k < L0 * A; k += blockDim.x) {
    if (!ok[k]) continue;
    const float px = tracked[2 * k], py = tracked[2 * k + 1];
    float dmin = INFINITY;
    int nearest = 0;
    for (int j = 0; j < L1; ++j) {
      const float d = valid1[j] ? point_to_segment(px, py, s_seg1[j]) : INFINITY;
      if (d < dmin) {  // strict: the first index wins ties
        dmin = d;
        nearest = j;
      }
    }
    if (dmin < max_dist) atomicAdd(&s_votes[(k / A) * L1 + nearest], 1);
  }
  __syncthreads();

  // Point2Line: the most-voted target, its votes, the ratio and minimum gates
  if (tid < L0) {
    int nv = -1, best = 0, n_tracked = 0;
    for (int j = 0; j < L1; ++j) {
      const int v = s_votes[tid * L1 + j];
      if (v > nv) {
        nv = v;
        best = j;
      }
    }
    for (int a = 0; a < A; ++a) n_tracked += ok[tid * A + a] ? 1 : 0;
    const float fv = (float)nv;
    const bool accept = valid0[tid] && fv >= (float)min_votes &&
                        __fdiv_rn(fv, (float)max(n_tracked, 1)) >= vote_ratio;
    s_nv[tid] = fv;
    s_match[tid] = accept ? best : -1;
  }
  __syncthreads();

  // duplicate targets: per target (L1 = the unmatched), the first source with
  // the most votes
  for (int t = tid; t <= L1; t += blockDim.x) {
    float bv = -1.f;
    int bs = 0;
    for (int i = 0; i < L0; ++i) {
      const int tgt = s_match[i] >= 0 ? s_match[i] : L1;
      const float v = tgt == t ? s_nv[i] : 0.f;
      if (v > bv) {
        bv = v;
        bs = i;
      }
    }
    s_best_src[t] = bs;
  }
  __syncthreads();
  int m = -1;
  if (tid < L0) {
    m = s_match[tid];
    if (s_best_src[m >= 0 ? m : L1] != tid) m = -1;
  }
  __syncthreads();  // every thread has read s_match
  if (tid < L0) {
    s_match[tid] = m;
    s_valid[tid] = m >= 0;
  }
  if (tid == 0) s_n_valid = 0;
  __syncthreads();
  if (tid < L0 && s_valid[tid]) atomicAdd(&s_n_valid, 1);
  __syncthreads();

  // topological filter: line j's midpoint must keep its side of line i
  if (tid < L0) {
    const int i = tid;
    const float* m1i = s_seg1[s_match[i] >= 0 ? s_match[i] : 0];
    int n_ok = 0;
    for (int j = 0; j < L0; ++j) {
      if (!s_valid[j]) continue;
      bool pair_ok = !s_valid[i] || i == j;
      if (!pair_ok) {
        const float* m1j = s_seg1[s_match[j] >= 0 ? s_match[j] : 0];
        const int s0 = side(s_seg0[i], mul(0.5f, add(s_seg0[j][0], s_seg0[j][2])),
                            mul(0.5f, add(s_seg0[j][1], s_seg0[j][3])));
        const int s1 = side(m1i, mul(0.5f, add(m1j[0], m1j[2])), mul(0.5f, add(m1j[1], m1j[3])));
        pair_ok = s0 == s1;
      }
      n_ok += pair_ok ? 1 : 0;
    }
    const float consist = __fdiv_rn((float)(n_ok - 1), (float)max(s_n_valid - 1, 1));
    match_out[i] = (s_valid[i] && consist >= 0.6f) ? s_match[i] : -1;
    n_votes_out[i] = s_nv[i];
  }
}

}  // namespace

extern "C" int vp_line_vote(const float* tracked, const unsigned char* ok, const float* segs0,
                            const unsigned char* valid0, const float* segs1,
                            const unsigned char* valid1, int L0, int A, int L1, float max_dist,
                            float vote_ratio, int min_votes, int* match, float* n_votes,
                            cudaStream_t stream) {
  if (L0 > kMaxL || L1 > kMaxL || L0 < 1 || L1 < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * L0 * L1;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  line_vote_kernel<<<1, kThreads, smem, stream>>>(tracked, ok, segs0, valid0, segs1, valid1,
                                                  L0, A, L1, max_dist, vote_ratio, min_votes,
                                                  match, n_votes);
  return (int)cudaGetLastError();
}
