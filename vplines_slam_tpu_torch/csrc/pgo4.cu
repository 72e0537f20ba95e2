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
//   (4K x 4K, 8 MB at K = 256) is the cost, ~2.5 us at 3.35 TB/s.
// Design: launch 1, a thread per edge, evaluates its 4 residual rows and its
//   two 4x4 Jacobian blocks (yaw in degrees through ypr_to_rot, so
//   d R_i / d yaw = pi/180 (-R_i[1]; R_i[0]; 0); the wrapped yaw residual has
//   derivative 1, as jacfwd of % gives) with its weight folded in.  Launch 2,
//   a thread per 4x4 block (a, b) of H, walks the only edges that can touch
//   both nodes -- those whose newer node is a or b, plus, on the diagonal,
//   those whose older node is a -- in a fixed order, in f64 and without
//   atomics, so H is the same run to run.  A thread per node sums g the
//   same way.  Residual-only mode (the LM's cost pass) skips launch 2.  All
//   of it is f64: the database is f32 on the card, the solve is f64.

#include <cuda_runtime.h>
#include <math.h>

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
  double res[4] = {0, 0, 0, 0}, Ji[4][4] = {}, Jj[4][4] = {};
  int i, j;
  if (e >= K * E + K) {  // gauge row of keyframe k
    const int k = e - K * E - K;
    i = j = k;
    const bool fixed = k == 0 || (a.seq[k] == 0 && k < *a.count);
    const double w = fixed ? 100.0 : 0.0;
    for (int c = 0; c < 3; ++c) {
      res[c] = (a.x[4 * k + 1 + c] - a.p_pgo[3 * k + c]) * w;
      Jj[c][1 + c] = w;
    }
    res[3] = (a.x[4 * k] - a.yaw_pgo[k]) * w;
    Jj[3][0] = w;
  } else {
    double tm[3], ym, w;
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
  a.ei[e] = i;
  a.ej[e] = j;
  double* Je = a.J + (size_t)e * 32;
  for (int rr = 0; rr < 4; ++rr)
    for (int c = 0; c < 4; ++c) {
      Je[rr * 4 + c] = Ji[rr][c];
      Je[16 + rr * 4 + c] = Jj[rr][c];
    }
}

// J_{e,node}: the edge's block for `node` (both blocks when the edge's two
// nodes coincide), row-major 4x4
__device__ __forceinline__ void block_of(const VpPgoArgs& a, int e, int node, double B[16]) {
  const double* Je = a.J + (size_t)e * 32;
  const bool on_i = a.ei[e] == node, on_j = a.ej[e] == node;
  for (int k = 0; k < 16; ++k) B[k] = (on_i ? Je[k] : 0.0) + (on_j ? Je[16 + k] : 0.0);
}

__device__ __forceinline__ void add_jtj(const VpPgoArgs& a, int e, int na, int nb,
                                        double acc[16]) {
  double A[16], B[16];
  block_of(a, e, na, A);
  block_of(a, e, nb, B);
  for (int p = 0; p < 4; ++p)
    for (int q = 0; q < 4; ++q) {
      double s = acc[p * 4 + q];
      for (int rr = 0; rr < 4; ++rr) s += A[rr * 4 + p] * B[rr * 4 + q];
      acc[p * 4 + q] = s;
    }
}

// every edge that touches node n: those whose newer node is n (sequential,
// loop, gauge), then those whose older node is n (sequential edges of the E
// successors, loop edges that point at n)
template <typename F>
__device__ void for_edges_of(const VpPgoArgs& a, int n, F f) {
  const int K = a.K, E = a.E;
  for (int d = 0; d < E; ++d) f(n * E + d);
  f(K * E + n);
  f(K * E + K + n);
  for (int d = 1; d <= E; ++d) {
    const int j = n + d;
    if (j < K && a.ej[j * E + d - 1] != n) f(j * E + d - 1);
  }
  for (int j = 0; j < K; ++j)
    if (j != n && a.ei[K * E + j] == n) f(K * E + j);
}

__global__ void pgo4_normal_kernel(VpPgoArgs a) {
  const int K = a.K, E = a.E;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K * K) return;
  const int na = t / K, nb = t % K;
  double acc[16] = {};
  if (na == nb) {
    for_edges_of(a, na, [&](int e) { add_jtj(a, e, na, na, acc); });
  } else {
    // an edge touching both nodes has one of them as its newer node
    const int nodes[2] = {na, nb};
    for (int s = 0; s < 2; ++s) {
      const int n = nodes[s], other = nodes[1 - s];
      for (int d = 0; d < E; ++d)
        if (a.ei[n * E + d] == other) add_jtj(a, n * E + d, na, nb, acc);
      if (a.ei[K * E + n] == other) add_jtj(a, K * E + n, na, nb, acc);
    }
  }
  const int D = 4 * K;
  for (int p = 0; p < 4; ++p)
    for (int q = 0; q < 4; ++q) a.H[(size_t)(4 * na + p) * D + 4 * nb + q] = acc[p * 4 + q];
  if (nb == 0) {
    double gs[4] = {0, 0, 0, 0};
    for_edges_of(a, na, [&](int e) {
      double B[16];
      block_of(a, e, na, B);
      for (int q = 0; q < 4; ++q)
        for (int rr = 0; rr < 4; ++rr) gs[q] -= B[rr * 4 + q] * a.r[4 * e + rr];
    });
    for (int q = 0; q < 4; ++q) a.g[4 * na + q] = gs[q];
  }
}

}  // namespace

extern "C" int vp_pgo4(const VpPgoArgs* A, cudaStream_t stream) {
  const VpPgoArgs a = *A;
  const int n_edges = a.K * a.E + 2 * a.K;
  pgo4_edges_kernel<<<(n_edges + 127) / 128, 128, 0, stream>>>(a);
  if (a.with_h) pgo4_normal_kernel<<<(a.K * a.K + 127) / 128, 128, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
