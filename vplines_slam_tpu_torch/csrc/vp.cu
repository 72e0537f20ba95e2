// K8 vp_grid + vp_score: the vanishing-point detector's sphere accumulator
// and its hypothesis search.
//
// Replaces: vplines_slam_tpu/ops/vp.py:75 detect_vps -- :87-110 the line-pair
//   votes, their scatter-add into the 1-degree (lat, lon) grid and the
//   4-neighbour smoothing (jnp.roll, wrapping on both axes, the latitude
//   wrap included though it is not geometric); :138-162 the grid mass of
//   every (vp1, swept vp2, vp3) hypothesis, the flat argmax and the line
//   classification.  On the TPU the scatter was an XLA scatter-add and the
//   scoring a doubly vmapped gather.
// Bound on the H100: launch latency.  64 lines give 2016 pairs and 64 x 90
//   hypotheses x 3 lookups into a 130 KB grid: tens of kFLOP.
// vp_grid design: ONE block; the grid lives in dynamic shared memory (90 x
//   360 floats = 127 KB, opted in with cudaFuncSetAttribute).  Pair weights
//   and cells are computed in parallel, then accumulated deterministically:
//   the thread that owns a cell (cell % blockDim) adds that cell's votes in
//   pair order, so the sums are the same in every run and in the order of a
//   sequential scatter (the plain version's index_add uses atomics on the
//   card, so it differs from the kernel by float reassociation).  The
//   smoothing reads the accumulated grid and writes the result.
// vp_score design: ONE block; each thread scores hypotheses (three grid
//   lookups, summed in order), a (value, index) block reduction takes the
//   maximum with the LOWEST flat index on ties -- ties are common, since
//   many hypotheses sum the same three cells -- and the threads then label
//   the lines against the winning VP triple.
// Products and sums that feed a bin index or a comparison are rounded one
// operation at a time (no FMA contraction), as the plain version computes
// them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

__device__ __forceinline__ float norm3(const float* v) {
  return __fsqrt_rn(add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2])));
}

// torch.remainder for floats: the result takes the divisor's sign
__device__ __forceinline__ float torch_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m = add(m, b);
  return m;
}

// unit direction -> flat (lat, lon) cell, folded to the upper hemisphere
__device__ int sphere_cell(const float* v_in, int grid_la, int grid_lo) {
  const float nv = norm3(v_in);
  float v[3] = {__fdiv_rn(v_in[0], nv), __fdiv_rn(v_in[1], nv), __fdiv_rn(v_in[2], nv)};
  const float s = v[2] < 0.f ? -1.f : 1.f;
  v[0] = mul(v[0], s);
  v[1] = mul(v[1], s);
  v[2] = mul(v[2], s);
  const float lat = acosf(fminf(fmaxf(v[2], -1.f), 1.f));
  const float lon = torch_remainder(atan2f(v[1], v[0]), 2.f * kPi);
  int la = (int)mul(__fdiv_rn(lat, 0.5f * kPi), (float)grid_la);
  int lo = (int)mul(__fdiv_rn(lon, 2.f * kPi), (float)grid_lo);
  la = min(max(la, 0), grid_la - 1);
  lo = min(max(lo, 0), grid_lo - 1);
  return la * grid_lo + lo;
}

__global__ void __launch_bounds__(kThreads)
vp_grid_kernel(const float* __restrict__ line, const float* __restrict__ length,
               const float* __restrict__ angle, const unsigned char* __restrict__ valid,
               int L, int grid_la, int grid_lo, float pair_gate, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int n_cells = grid_la * grid_lo;
  float* grid = smem;                         // [n_cells]
  int* cell = (int*)(grid + n_cells);         // [L * L] pair cell, -1 = no vote
  float* wt = (float*)(cell + L * L);         // [L * L] pair weight
  const int tid = threadIdx.x;

  for (int c = tid; c < n_cells; c += blockDim.x) grid[c] = 0.f;
  for (int f = tid; f < L * L; f += blockDim.x) {
    const int i = f / L, j = f % L;
    int c = -1;
    float w = 0.f;
    if (j > i && valid[i] && valid[j]) {
      float inter[3];
      cross3(line + 3 * i, line + 3 * j, inter);
      float dang = fabsf(sub(angle[i], angle[j]));
      dang = fminf(sub(kPi, dang), dang);
      w = mul(__fsqrt_rn(mul(length[i], length[j])), add(sinf(mul(2.f, dang)), 0.2f));
      if (norm3(inter) > 1e-9f && dang <= pair_gate && w > 0.f)
        c = sphere_cell(inter, grid_la, grid_lo);
    }
    cell[f] = c;
    wt[f] = w;
  }
  __syncthreads();
  // deterministic accumulation: the owner of each cell adds its votes in
  // pair order
  for (int f = 0; f < L * L; ++f) {
    const int c = cell[f];
    if (c >= 0 && c % (int)blockDim.x == tid) grid[c] = add(grid[c], wt[f]);
  }
  __syncthreads();
  for (int c = tid; c < n_cells; c += blockDim.x) {
    const int la = c / grid_lo, lo = c % grid_lo;
    const int up = ((la + grid_la - 1) % grid_la) * grid_lo + lo;
    const int dn = ((la + 1) % grid_la) * grid_lo + lo;
    const int lf = la * grid_lo + (lo + grid_lo - 1) % grid_lo;
    const int rt = la * grid_lo + (lo + 1) % grid_lo;
    out[c] = add(add(add(add(grid[c], grid[up]), grid[dn]), grid[lf]), grid[rt]);
  }
}

__device__ __forceinline__ void hypothesis(const float* vp1, const float* b1, const float* b2,
                                           const float* sweep, int S, int p, int s,
                                           float* v2, float* v3) {
  const float c = sweep[s], sn = sweep[S + s];
#pragma unroll
  for (int k = 0; k < 3; ++k) v2[k] = add(mul(b1[3 * p + k], c), mul(b2[3 * p + k], sn));
  cross3(vp1 + 3 * p, v2, v3);
}

__global__ void __launch_bounds__(kThreads)
vp_score_kernel(const float* __restrict__ grid, const float* __restrict__ vp1,
                const float* __restrict__ b1, const float* __restrict__ b2,
                const float* __restrict__ sweep, int P, int S,
                const float* __restrict__ line, const unsigned char* __restrict__ valid,
                int L, int grid_la, int grid_lo, float angle_tol,
                float* __restrict__ vps_out, int* __restrict__ vp_id,
                float* __restrict__ best_out) {
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  __shared__ float s_vps[9];
  const int tid = threadIdx.x;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int h = tid; h < P * S; h += blockDim.x) {
    const int p = h / S, s = h % S;
    float v2[3], v3[3];
    hypothesis(vp1, b1, b2, sweep, S, p, s, v2, v3);
    float score = 0.f;
    score = add(score, grid[sphere_cell(vp1 + 3 * p, grid_la, grid_lo)]);
    score = add(score, grid[sphere_cell(v2, grid_la, grid_lo)]);
    score = add(score, grid[sphere_cell(v3, grid_la, grid_lo)]);
    if (score > bv) {  // a thread's hypotheses come in increasing order
      bv = score;
      bi = h;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((tid & 31) == 0) {
    s_val[tid >> 5] = bv;
    s_idx[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (s_val[w] > bv || (s_val[w] == bv && s_idx[w] < bi)) {
        bv = s_val[w];
        bi = s_idx[w];
      }
    const int p = bi / S, s = bi % S;
    float v2[3], v3[3];
    hypothesis(vp1, b1, b2, sweep, S, p, s, v2, v3);
    for (int k = 0; k < 3; ++k) {
      s_vps[k] = vp1[3 * p + k];
      s_vps[3 + k] = v2[k];
      s_vps[6 + k] = v3[k];
    }
    for (int k = 0; k < 9; ++k) vps_out[k] = s_vps[k];
    *best_out = bv;
  }
  __syncthreads();
  // lines2Vps: a line passes through a VP when its homogeneous coefficients
  // are (nearly) orthogonal to the VP direction
  for (int l = tid; l < L; l += blockDim.x) {
    const float* ln = line + 3 * l;
    const float nl = fmaxf(norm3(ln), 1e-12f);
    float best_ang = INFINITY;
    int best = 0;
    for (int k = 0; k < 3; ++k) {
      const float* v = s_vps + 3 * k;
      const float dot = add(add(mul(__fdiv_rn(ln[0], nl), v[0]), mul(__fdiv_rn(ln[1], nl), v[1])),
                            mul(__fdiv_rn(ln[2], nl), v[2]));
      const float ang = fabsf(sub(0.5f * kPi, acosf(fminf(fmaxf(fabsf(dot), -1.f), 1.f))));
      if (ang < best_ang) {
        best_ang = ang;
        best = k;
      }
    }
    vp_id[l] = (valid[l] && best_ang < angle_tol) ? best : 3;
  }
}

}  // namespace

extern "C" int vp_vp_grid(const float* line, const float* length, const float* angle,
                          const unsigned char* valid, int L, int grid_la, int grid_lo,
                          float pair_gate, float* grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * grid_la * grid_lo + (sizeof(int) + sizeof(float)) * L * L;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(vp_grid_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  vp_grid_kernel<<<1, kThreads, smem, stream>>>(line, length, angle, valid, L, grid_la,
                                                grid_lo, pair_gate, grid);
  return (int)cudaGetLastError();
}

extern "C" int vp_vp_score(const float* grid, const float* vp1, const float* b1,
                           const float* b2, const float* sweep, int P, int S, const float* line,
                           const unsigned char* valid, int L, int grid_la, int grid_lo,
                           float angle_tol, float* vps, int* vp_id, float* best,
                           cudaStream_t stream) {
  if (P * S < 1) return (int)cudaErrorInvalidValue;
  vp_score_kernel<<<1, kThreads, 0, stream>>>(grid, vp1, b1, b2, sweep, P, S, line, valid, L,
                                              grid_la, grid_lo, angle_tol, vps, vp_id, best);
  return (int)cudaGetLastError();
}
