// K19 pgo4: the 4-DoF pose graph's residuals, their analytic Jacobian and
// the dense normal equations H = J^T J, g = -J^T r.
//
// Replaces: vplines_slam_tpu/models/pose_graph.py:322 optimize_4dof, its
//   residual (sequential edges to seq_edges predecessors, loop edges, gauge
//   rows) under jax.jacfwd and normal_equations inside lm_solve.  On the TPU
//   that is 4K forward tangents through the vmapped residual, a dense
//   [24K, 4K] Jacobian (6,144 x 1,024 at K = 256) and a 6,144-deep matmul
//   for H.
// Bound on the H100: device-memory bytes.  The Jacobian has at most 8
//   nonzeros per row, so the work is ~0.1 MFLOP; writing the dense f64 H
//   (4K x 4K, 8 MB at K = 256, 134 MB at K = 1,024) is the cost, ~2.5 us
//   (40 us) at 3.35 TB/s.
// Design: launch 1, a thread per edge, evaluates its 4 residual rows and its
//   two 4x4 Jacobian blocks (yaw in degrees through ypr_to_rot, so
//   d R_i / d yaw = pi/180 (-R_i[1]; R_i[0]; 0); the wrapped yaw residual has
//   derivative 1, as jacfwd of % gives) with its weight folded in, and marks
//   an edge of weight 0 dead (ei = -1): its blocks are exact zeros.  Launch
//   2, a CTA per block row a of H: its threads write the 4 x 4K strip's
//   zeros with 16-byte stores, list the live edges that touch a in
//   for_edges_of's order (a's sequential edges, loop edge and gauge row, the
//   E successors' sequential edges, then the loop edges that point at a,
//   found by a ballot scan of the K loop edges), stage their blocks and
//   residuals in shared memory, and compute only the blocks that can be
//   nonzero -- the diagonal, and once for each other end of a listed edge
//   (the band |a - b| <= E and the loop partners) -- each element by one
//   thread, and g[a].  Each element sums its edges in the order of the
//   previous design (a thread per 4x4 block walking for_edges_of, then
//   add_jtj's rr loop), with the FMAs nvcc formed there written out, so H and
//   g equal that design's to the bit: a dead edge's exact zeros leave a sum
//   that never holds -0 unchanged.  No atomics, so H is the same run to run.
//   Residual-only mode (the LM's cost pass) is launch 1 alone.  All of it is
//   f64: the database is f32 on the card, the solve is f64.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

struct VpPgoArgs {
  const double* x;        // [K, 4] (yaw deg, tx, ty, tz)
  const double* p_vio;    // [K, 3]
  const double* ypr_vio;  // [K, 3] deg
  const double* p_pgo;    // [K, 3]
  const double* yaw_pgo;  // [K]
  const double* loop_t;   // [K, 3]
  const double* loop_yaw; // [K]
  const int* seq;         // [K]
  const int* loop_to;     // [K]
  const int* count;       // [1] keyframes in the database
  double* r;              // [n_edges, 4]
  double* J;              // [n_edges, 2, 4, 4]: block of node i, block of node j
  int* ei;                // [n_edges]
  int* ej;                // [n_edges]
  double* H;              // [4K, 4K]
  double* g;              // [4K]
  int K, E, with_h;
  double lw;
};

namespace {

constexpr double kD2R = 3.14159265358979323846 / 180.0;

__device__ void ypr_to_rot(double y, double p, double r, double R[3][3]) {
  y *= kD2R;
  p *= kD2R;
  r *= kD2R;
  const double cy = cos(y), sy = sin(y), cp = cos(p), sp = sin(p), cr = cos(r), sr = sin(r);
  R[0][0] = cy * cp;
  R[0][1] = cy * sp * sr - sy * cr;
  R[0][2] = cy * sp * cr + sy * sr;
  R[1][0] = sy * cp;
  R[1][1] = sy * sp * sr + cy * cr;
  R[1][2] = sy * sp * cr - cy * sr;
  R[2][0] = -sp;
  R[2][1] = cp * sr;
  R[2][2] = cp * cr;
}

// (v + 180) % 360 - 180 with the floor-mod sign convention
__device__ __forceinline__ double wrap180(double v) {
  double m = fmod(v + 180.0, 360.0);
  if (m != 0.0 && m < 0.0) m += 360.0;
  return m - 180.0;
}

__global__ void pgo4_edges_kernel(VpPgoArgs a) {
  const int K = a.K, E = a.E;
  const int n_edges = K * E + 2 * K;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  double res[4] = {0, 0, 0, 0}, Ji[4][4] = {}, Jj[4][4] = {}, w;
  int i, j;
  if (e >= K * E + K) {  // gauge row of keyframe k
    const int k = e - K * E - K;
    i = j = k;
    const bool fixed = k == 0 || (a.seq[k] == 0 && k < *a.count);
    w = fixed ? 100.0 : 0.0;
    for (int c = 0; c < 3; ++c) {
      res[c] = (a.x[4 * k + 1 + c] - a.p_pgo[3 * k + c]) * w;
      Jj[c][1 + c] = w;
    }
    res[3] = (a.x[4 * k] - a.yaw_pgo[k]) * w;
    Jj[3][0] = w;
  } else {
    double tm[3], ym;
    if (e < K * E) {  // sequential edge: j to its d-th predecessor
      j = e / E;
      const int d = e % E + 1;
      const int iu = j - d;
      i = iu > 0 ? iu : 0;
      const bool ok = iu >= 0 && j < *a.count && j >= 1 && a.seq[i] == a.seq[j];
      w = ok ? 1.0 : 0.0;
      double Rv[3][3];
      ypr_to_rot(a.ypr_vio[3 * i], a.ypr_vio[3 * i + 1], a.ypr_vio[3 * i + 2], Rv);
      double dp[3];
      for (int c = 0; c < 3; ++c) dp[c] = a.p_vio[3 * j + c] - a.p_vio[3 * i + c];
      for (int c = 0; c < 3; ++c) tm[c] = Rv[0][c] * dp[0] + Rv[1][c] * dp[1] + Rv[2][c] * dp[2];
      ym = a.ypr_vio[3 * j] - a.ypr_vio[3 * i];
    } else {  // loop edge of keyframe j
      j = e - K * E;
      const int iu = a.loop_to[j];
      i = iu > 0 ? iu : 0;
      const bool ok = iu >= 0 && j < *a.count;
      w = ok ? a.lw : 0.0;
      for (int c = 0; c < 3; ++c) tm[c] = a.loop_t[3 * j + c];
      ym = a.loop_yaw[j];
    }
    double R[3][3];
    ypr_to_rot(a.x[4 * i], a.ypr_vio[3 * i + 1], a.ypr_vio[3 * i + 2], R);
    double dt[3];
    for (int c = 0; c < 3; ++c) dt[c] = a.x[4 * j + 1 + c] - a.x[4 * i + 1 + c];
    for (int c = 0; c < 3; ++c) {
      res[c] = (R[0][c] * dt[0] + R[1][c] * dt[1] + R[2][c] * dt[2] - tm[c]) * w;
      // d/d yaw_i: (dR/dyaw)^T dt, dR/dyaw rows = (-R[1], R[0], 0) per radian
      Ji[c][0] = (-R[1][c] * dt[0] + R[0][c] * dt[1]) * kD2R * w;
      for (int k = 0; k < 3; ++k) {
        Jj[c][1 + k] = R[k][c] * w;
        Ji[c][1 + k] = -R[k][c] * w;
      }
    }
    res[3] = wrap180(a.x[4 * j] - a.x[4 * i] - ym) / 10.0 * w;
    Jj[3][0] = w / 10.0;
    Ji[3][0] = -w / 10.0;
  }
  for (int c = 0; c < 4; ++c) a.r[4 * e + c] = res[c];
  if (!a.with_h) return;
  a.ei[e] = w != 0.0 ? i : -1;  // an edge of weight 0 adds exact zeros: dead
  a.ej[e] = j;
  double* Je = a.J + (size_t)e * 32;
  for (int rr = 0; rr < 4; ++rr)
    for (int c = 0; c < 4; ++c) {
      Je[rr * 4 + c] = Ji[rr][c];
      Je[16 + rr * 4 + c] = Jj[rr][c];
    }
}

constexpr int kThreads = 256;  // launch 2: a CTA a block row of H
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 32;     // listed edges whose blocks are staged in shared memory
constexpr int kScan = 4;       // loop edges a thread tests per pass of the scan

// a listed edge's flags: live, the row's node is its i, is its j; the
// other end sits above them (code >> 4)
constexpr int kLive = 1, kIsI = 2, kIsJ = 4;

__global__ void __launch_bounds__(kThreads) pgo4_rows_kernel(VpPgoArgs a) {
  VP_DYN_SMEM(int, s_list);  // [2, n_fix + K]: the edges, their codes
  __shared__ double s_J[kStage][32], s_r[kStage][4];
  __shared__ int s_cnt[kScan][kWarps];
  const int K = a.K, E = a.E, row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_fix = 2 * E + 2, cap = n_fix + K;
  int* s_edge = s_list;
  int* s_code = s_list + cap;
  // the strip's zeros: rows 4 row .. 4 row + 3 are 16K contiguous doubles
  double2* strip = reinterpret_cast<double2*>(a.H + (size_t)4 * row * 4 * K);
  for (int i = tid; i < 8 * K; i += kThreads) strip[i] = make_double2(0.0, 0.0);
  // the list: a's E sequential edges, its loop edge, its gauge row, the E
  // successors' sequential edges onto a (fixed slots, -1 where none) ...
  if (tid < n_fix) {
    int e;
    if (tid < E) e = row * E + tid;
    else if (tid == E) e = K * E + row;
    else if (tid == E + 1) e = K * E + K + row;
    else {
      const int d = tid - E - 1, j = row + d;
      e = j < K ? j * E + d - 1 : -1;
    }
    s_edge[tid] = e;
  }
  // ... then the loop edges that point at a, in edge order
  int n = n_fix;
  for (int j0 = 0; j0 < K; j0 += kScan * kThreads) {
    bool hit[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int j = j0 + u * kThreads + tid;
      hit[u] = j < K && j != row && a.ei[K * E + j] == row;
    }
    unsigned bal[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      bal[u] = VP_BALLOT(hit[u]);
      if (lane == 0) s_cnt[u][warp] = __popc(bal[u]);
    }
    __syncthreads();
    // the hits in (u, warp, lane) order, which is edge order
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      int at = n;
      for (int w = 0; w < warp; ++w) at += s_cnt[u][w];
      if (hit[u])
        s_edge[at + __popc(bal[u] & ((1u << lane) - 1u))] = K * E + j0 + u * kThreads + tid;
      for (int w = 0; w < kWarps; ++w) n += s_cnt[u][w];
    }
    __syncthreads();
  }
  // each entry's flags and other end; its blocks and residual staged
  for (int k = tid; k < n; k += kThreads) {
    const int e = s_edge[k];
    int code = 0;
    if (e >= 0) {
      const int ei = a.ei[e], ej = a.ej[e];
      if (ei >= 0) code = kLive | (ei == row ? kIsI : 0) | (ej == row ? kIsJ : 0) |
                          ((ei == row ? ej : ei) << 4);
    }
    s_code[k] = code;
  }
  for (int i = tid; i < min(n, kStage) * 36; i += kThreads) {
    const int k = i / 36, c = i % 36, e = s_edge[k];
    if (e < 0) continue;
    if (c < 32) s_J[k][c] = a.J[(size_t)e * 32 + c];
    else s_r[k][c - 32] = a.r[4 * e + c - 32];
  }
  __syncthreads();
  // tasks of 16 threads: 0 the diagonal block, 1 g[a], 2 + k the block (a,
  // b) of entry k's other end b != a, when no earlier entry has it
  const int D = 4 * K;
  const int el = tid & 15, p = el >> 2, q = el & 3;
  for (int task = tid >> 4; task < n + 2; task += kThreads / 16) {
    if (task == 0) {
      double acc = 0.0;
      for (int k = 0; k < n; ++k) {
        const int code = s_code[k];
        if (!(code & kLive)) continue;
        const double* Je = k < kStage ? s_J[k] : a.J + (size_t)s_edge[k] * 32;
        const bool on_i = code & kIsI, on_j = code & kIsJ;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const double A = (on_i ? Je[rr * 4 + p] : 0.0) + (on_j ? Je[16 + rr * 4 + p] : 0.0);
          const double B = (on_i ? Je[rr * 4 + q] : 0.0) + (on_j ? Je[16 + rr * 4 + q] : 0.0);
          acc = __fma_rn(A, B, acc);
        }
      }
      a.H[(size_t)(4 * row + p) * D + 4 * row + q] = acc;
    } else if (task == 1) {
      if (el >= 4) continue;
      double gs = 0.0;
      for (int k = 0; k < n; ++k) {
        const int code = s_code[k];
        if (!(code & kLive)) continue;
        const double* Je = k < kStage ? s_J[k] : a.J + (size_t)s_edge[k] * 32;
        const double* re = k < kStage ? s_r[k] : a.r + 4 * s_edge[k];
        const bool on_i = code & kIsI, on_j = code & kIsJ;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const double B = (on_i ? Je[rr * 4 + el] : 0.0) + (on_j ? Je[16 + rr * 4 + el] : 0.0);
          gs = __fma_rn(-B, re[rr], gs);
        }
      }
      a.g[4 * row + el] = gs;
    } else {
      const int k0 = task - 2, code0 = s_code[k0], b = code0 >> 4;
      bool first = (code0 & kLive) && b != row;
      for (int k = 0; k < k0; ++k) {
        const int code = s_code[k];
        first = first && !((code & kLive) && (code >> 4) == b);
      }
      if (!first) continue;
      double acc = 0.0;
      for (int k = k0; k < n; ++k) {
        const int code = s_code[k];
        if (!(code & kLive) || (code >> 4) != b) continue;
        const double* Je = k < kStage ? s_J[k] : a.J + (size_t)s_edge[k] * 32;
        // the edge's block of a, and of b: its other node
        const bool on_i = code & kIsI, on_j = code & kIsJ;
        const bool b_i = !on_i, b_j = on_i;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const double A = (on_i ? Je[rr * 4 + p] : 0.0) + (on_j ? Je[16 + rr * 4 + p] : 0.0);
          const double B = (b_i ? Je[rr * 4 + q] : 0.0) + (b_j ? Je[16 + rr * 4 + q] : 0.0);
          acc = __fma_rn(A, B, acc);
        }
      }
      a.H[(size_t)(4 * row + p) * D + 4 * b + q] = acc;
    }
  }
}

}  // namespace

extern "C" int vp_pgo4(const VpPgoArgs* A, cudaStream_t stream) {
  const VpPgoArgs a = *A;
  const int n_edges = a.K * a.E + 2 * a.K;
  if (a.with_h && 2 * a.E + 2 > kThreads) return (int)cudaErrorInvalidValue;
  VP_LAUNCH(pgo4_edges_kernel, (n_edges + 127) / 128, 128, 0, stream, a);
  if (!a.with_h) return (int)cudaGetLastError();
  // the row's list: its fixed slots and every loop edge that can point at it
  const size_t smem = sizeof(int) * 2 * (size_t)(2 * a.E + 2 + a.K);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        pgo4_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  VP_LAUNCH(pgo4_rows_kernel, a.K, kThreads, smem, stream, a);
  return (int)cudaGetLastError();
}
