// Shared device helpers for the kernels in this directory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Launch through a macro, so that the estimator kernels' sources read the
// same under nvcc and under a host C++ compiler with a serial stand-in (their
// loops stride by blockDim, so one thread per block computes the same).
#ifndef VP_LAUNCH
#define VP_LAUNCH(kern, grid, block, smem, stream, ...) \
  kern<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif
// Dynamic shared memory of the launch, as an array of `type`.
#ifndef VP_DYN_SMEM
#define VP_DYN_SMEM(type, name)                                   \
  extern __shared__ __align__(16) unsigned char vp_dyn_smem_[];   \
  type* name = reinterpret_cast<type*>(vp_dyn_smem_)
#endif
// Warp shuffles and votes (K11, K12, K13, K21), and the f64 tensor-core
// product (K12, K13):
// D (8x8, two per lane) += A (8x4, one per lane) B (4x8, one per lane); lane
// l holds A[l / 4][l % 4], B[l % 4][l / 4], D[l / 4][2 (l % 4) + {0, 1}].
// A host stand-in of the CUDA runtime defines them first.
#ifndef VP_SHFL_IDX
#define VP_SHFL_IDX(v, l) __shfl_sync(0xffffffffu, (v), (l))
#endif
#ifndef VP_SHFL_XOR
#define VP_SHFL_XOR(v, o) __shfl_xor_sync(0xffffffffu, (v), (o))
#endif
#ifndef VP_BALLOT
#define VP_BALLOT(p) __ballot_sync(0xffffffffu, (p))
#endif
// The warp's greatest unsigned / least int in one instruction (K8's vp_score)
#ifndef VP_REDUX_MAX
#define VP_REDUX_MAX(v) __reduce_max_sync(0xffffffffu, (unsigned)(v))
#define VP_REDUX_MIN(v) __reduce_min_sync(0xffffffffu, (int)(v))
#endif
#ifndef VP_MMA_F64
#define VP_MMA_F64(d0, d1, a, b)                                                     \
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, " \
               "{%0, %1};"                                                           \
               : "+d"(d0), "+d"(d1)                                                  \
               : "d"(a), "d"(b))
#endif

// Thread-block clusters (K20): the cluster's barrier, this CTA's rank in it,
// a pointer into another CTA's shared memory (distributed shared memory),
// and a launch of `grid` CTAs in clusters of `cl`.
#ifndef VP_CLUSTER_SYNC
#include <cooperative_groups.h>
#define VP_CLUSTER_SYNC() cooperative_groups::this_cluster().sync()
#define VP_CLUSTER_RANK() ((int)cooperative_groups::this_cluster().block_rank())
#define VP_DSMEM(p, rank) cooperative_groups::this_cluster().map_shared_rank((p), (rank))
#define VP_LAUNCH_CLUSTER(kern, cl, grid, block, smem, stream, ...)  \
  [&]() {                                                             \
    cudaLaunchConfig_t cfg_ = {};                                     \
    cfg_.gridDim = dim3(grid);                                        \
    cfg_.blockDim = dim3(block);                                      \
    cfg_.dynamicSmemBytes = (smem);                                   \
    cfg_.stream = (stream);                                           \
    cudaLaunchAttribute at_[1];                                       \
    at_[0].id = cudaLaunchAttributeClusterDimension;                  \
    at_[0].val.clusterDim.x = (cl);                                   \
    at_[0].val.clusterDim.y = 1;                                      \
    at_[0].val.clusterDim.z = 1;                                      \
    cfg_.attrs = at_;                                                 \
    cfg_.numAttrs = 1;                                                \
    return cudaLaunchKernelEx(&cfg_, kern, __VA_ARGS__);              \
  }()
#endif
// The cluster's barrier in two halves (K8's vp_score): every thread of the
// cluster arrives without ordering memory on entry, works on, and waits
// before it first touches another CTA's shared memory (all CTAs of the
// cluster have started by then).
#ifndef VP_CLUSTER_ARRIVE
#define VP_CLUSTER_ARRIVE() asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory")
#define VP_CLUSTER_WAIT() asm volatile("barrier.cluster.wait.aligned;" ::: "memory")
#endif

namespace vp {

// ---------------------------------------------------------------------------
// A parallel-ordered Jacobi eigensolve of a symmetric kN x kN matrix (kN even,
// <= 32) in one warp's registers (K4's refit, K18's hypotheses): lane r holds
// row r of A (a) and of the eigenvectors V (v); lanes past kN repeat row
// kN - 1 and their results are not read.  A matrix of odd size is padded with
// a zero row and column, which no rotation touches.
// ---------------------------------------------------------------------------

constexpr int kJacobiMaxSweeps = 30;

// the partner of index i in step s of the round-robin (circle method): index
// kN - 1 stays, the others pair as (s + k, s - k) mod kN - 1
template <int kN>
__host__ __device__ constexpr int jacobi_partner(int s, int i) {
  return i == kN - 1 ? s : (i == s ? kN - 1 : (2 * s - i + 2 * (kN - 1)) % (kN - 1));
}

// a[i] for an index i that differs between lanes: a chain of selects, so that
// a stays in registers
template <int n>
__device__ __forceinline__ double pick(const double (&a)[n], int i) {
  double v = a[0];
#pragma unroll
  for (int c = 1; c < n; ++c) v = i == c ? a[c] : v;
  return v;
}

__device__ __forceinline__ double warp_sum64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += VP_SHFL_XOR(v, o);
  return v;
}

// one step of the parallel-ordered Jacobi: the kN / 2 rotations of round s.
template <int kN, int s>
__device__ __forceinline__ void jacobi_step(double (&a)[kN], double (&v)[kN], int r) {
  const int pr = jacobi_partner<kN>(s, r);
  const double d = pick(a, r), apq = pick(a, pr);
  const double d_pr = VP_SHFL_IDX(d, pr);
  const bool lo = r < pr;
  // the pair's smaller lane forms the rotation zeroing A[p][q] (p < q):
  // with h = |(aqq - app, 2 apq)|, cos 2phi = |aqq - app| / h,
  // c = sqrt((1 + cos 2phi) / 2), s = sin 2phi / (2 c), |phi| <= pi / 4
  double c = 1.0, sn = 0.0;
  if (apq != 0.0) {
    const double app = lo ? d : d_pr, aqq = lo ? d_pr : d;
    const double dd = aqq - app, e = 2.0 * apq;
    const double rh = rsqrt(dd * dd + e * e);
    const double w = 0.5 + 0.5 * (fabs(dd) * rh);
    const double ic = rsqrt(w);
    c = w * ic;
    sn = (dd >= 0.0 ? 0.5 : -0.5) * (e * rh) * ic;
  }
  // columns: A <- A J, V <- V J, every pair in registers, each pair's
  // rotation from its smaller lane
#pragma unroll
  for (int p = 0; p < kN; ++p) {
    const int q = jacobi_partner<kN>(s, p);
    if (p < q) {
      const double cp = VP_SHFL_IDX(c, p), sp = VP_SHFL_IDX(sn, p);
      const double ap = a[p], aq = a[q], vp = v[p], vq = v[q];
      a[p] = cp * ap - sp * aq;
      a[q] = sp * ap + cp * aq;
      v[p] = cp * vp - sp * vq;
      v[q] = sp * vp + cp * vq;
    }
  }
  // rows: A <- J^T A, the partner's row by shuffles
  const int p_of_r = lo ? r : pr;
  const double cr = VP_SHFL_IDX(c, p_of_r), sr = VP_SHFL_IDX(sn, p_of_r);
  const double ss = lo ? -sr : sr;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const double b = VP_SHFL_IDX(a[k], pr);
    a[k] = ss * b + cr * a[k];
  }
}

template <int kN, int s>
__device__ __forceinline__ void jacobi_steps(double (&a)[kN], double (&v)[kN], int r) {
  jacobi_step<kN, s>(a, v, r);
  if constexpr (s + 1 < kN - 1) jacobi_steps<kN, s + 1>(a, v, r);
}

// sweeps until the off-diagonal mass is 1e-32 of the diagonal's or, below
// 1e-20 of it, a sweep no longer halves it (the rounding floor); the whole
// warp calls it with r = min(lane, kN - 1)
template <int kN>
__device__ __forceinline__ void jacobi_eig(double (&a)[kN], double (&v)[kN], int r, int lane) {
  const bool row_lane = lane < kN;
  double prev = INFINITY;
  for (int sweep = 0; sweep < kJacobiMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int c = 0; c < kN; ++c) off += c == r ? 0.0 : a[c] * a[c];
    const double dr = pick(a, r);
    off = warp_sum64(row_lane ? off : 0.0);
    const double diag = warp_sum64(row_lane ? dr * dr : 0.0);
    if (off <= 1e-32 * diag || off == 0.0 || (off <= 1e-20 * diag && off >= 0.5 * prev)) break;
    prev = off;
    jacobi_steps<kN, 0>(a, v, r);
  }
}

// the index of the smallest eigenvalue among the first n_live (the lowest
// index on a tie), in every lane
template <int kN>
__device__ __forceinline__ int jacobi_min_index(const double (&a)[kN], int r, int lane,
                                                int n_live) {
  double best = lane < n_live ? pick(a, r) : INFINITY;
  int kmin = r;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double ob = VP_SHFL_XOR(best, o);
    const int ok = VP_SHFL_XOR(kmin, o);
    if (ob < best || (ob == best && ok < kmin)) {
      best = ob;
      kmin = ok;
    }
  }
  return kmin;
}

// Order-preserving map float -> int so atomicMax on ints is a float max.
__device__ __forceinline__ int float_to_ordered(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float ordered_to_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

}  // namespace vp

// ---------------------------------------------------------------------------
// Forward-mode jets: Jet<T, N> is a value and N tangents (Ceres' Jet), with
// the arithmetic, the math functions, and 3-vectors and quaternions of jets
// that follow utils/geometry.  K11 (window_lin.cu) differentiates its
// residuals with them; K21 (pnp_refine.cu) takes the quaternion rotation on
// constants (Jet<T, 0>).
// ---------------------------------------------------------------------------

namespace {

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double m_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float m_asin(float x) { return asinf(x); }
__device__ __forceinline__ double m_asin(double x) { return asin(x); }
__device__ __forceinline__ bool m_finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool m_finite(double x) { return isfinite(x); }

// ---------------------------------------------------------------------------
// Jet<T, N>: value a and tangents v[0..N)
// ---------------------------------------------------------------------------

template <typename T, int N>
struct Jet {
  T a;
  T v[N > 0 ? N : 1];
};

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> cst(T a) {
  Jet<T, N> r;
  r.a = a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = T(0);
  return r;
}

// a with tangent 1 in direction k (a constant when k is out of range); k may
// be a run-time value (a lane's slice of the tangents), so the tangents are
// set by compile-time index and stay in registers
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> seed(T a, int k) {
  Jet<T, N> r;
  r.a = a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = i == k ? T(1) : T(0);
  return r;
}

#define JET_T template <typename T, int N>
#define JN Jet<T, N>

JET_T __device__ __forceinline__ JN operator+(const JN& x, const JN& y) {
  JN r;
  r.a = x.a + y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = x.v[k] + y.v[k];
  return r;
}
JET_T __device__ __forceinline__ JN operator-(const JN& x, const JN& y) {
  JN r;
  r.a = x.a - y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = x.v[k] - y.v[k];
  return r;
}
JET_T __device__ __forceinline__ JN operator-(const JN& x) {
  JN r;
  r.a = -x.a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = -x.v[k];
  return r;
}
JET_T __device__ __forceinline__ JN operator*(const JN& x, const JN& y) {
  JN r;
  r.a = x.a * y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = x.v[k] * y.a + x.a * y.v[k];
  return r;
}
JET_T __device__ __forceinline__ JN operator/(const JN& x, const JN& y) {
  JN r;
  r.a = x.a / y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = (x.v[k] - r.a * y.v[k]) / y.a;
  return r;
}
JET_T __device__ __forceinline__ JN operator+(const JN& x, T s) {
  JN r = x;
  r.a = x.a + s;
  return r;
}
JET_T __device__ __forceinline__ JN operator+(T s, const JN& x) {
  JN r = x;
  r.a = s + x.a;
  return r;
}
JET_T __device__ __forceinline__ JN operator-(const JN& x, T s) {
  JN r = x;
  r.a = x.a - s;
  return r;
}
JET_T __device__ __forceinline__ JN operator-(T s, const JN& x) {
  JN r;
  r.a = s - x.a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = -x.v[k];
  return r;
}
JET_T __device__ __forceinline__ JN operator*(const JN& x, T s) {
  JN r;
  r.a = x.a * s;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = x.v[k] * s;
  return r;
}
JET_T __device__ __forceinline__ JN operator*(T s, const JN& x) { return x * s; }
JET_T __device__ __forceinline__ JN operator/(const JN& x, T s) {
  JN r;
  r.a = x.a / s;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = x.v[k] / s;
  return r;
}
JET_T __device__ __forceinline__ JN operator/(T s, const JN& x) {
  JN r;
  r.a = s / x.a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = -r.a * x.v[k] / x.a;
  return r;
}
JET_T __device__ __forceinline__ JN jsqrt(const JN& x) {
  JN r;
  r.a = m_sqrt(x.a);
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = x.v[k] / (T(2) * r.a);
  return r;
}
JET_T __device__ __forceinline__ JN jsin(const JN& x) {
  JN r;
  r.a = m_sin(x.a);
  const T d = m_cos(x.a);
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = d * x.v[k];
  return r;
}
JET_T __device__ __forceinline__ JN jcos(const JN& x) {
  JN r;
  r.a = m_cos(x.a);
  const T d = -m_sin(x.a);
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = d * x.v[k];
  return r;
}
JET_T __device__ __forceinline__ JN jatan2(const JN& y, const JN& x) {
  JN r;
  r.a = m_atan2(y.a, x.a);
  const T n = x.a * x.a + y.a * y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = (x.a * y.v[k] - y.a * x.v[k]) / n;
  return r;
}
JET_T __device__ __forceinline__ JN jasin(const JN& x) {
  JN r;
  r.a = m_asin(x.a);
  const T d = T(1) / m_sqrt(T(1) - x.a * x.a);
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = d * x.v[k];
  return r;
}
// torch.clamp: the tangent passes where lo <= x <= hi
JET_T __device__ __forceinline__ JN jclamp(const JN& x, T lo, T hi) {
  JN r = x;
  if (!(x.a >= lo && x.a <= hi)) {
    r = cst<T, N>(x.a < lo ? lo : (x.a > hi ? hi : x.a));
  }
  return r;
}
// torch.clamp(min=lo): the tangent passes where x >= lo
JET_T __device__ __forceinline__ JN jclamp_min(const JN& x, T lo) {
  return x.a >= lo ? x : cst<T, N>(x.a < lo ? lo : x.a);
}

// ---------------------------------------------------------------------------
// vectors and quaternions [w, x, y, z] (Hamilton) of jets, as utils/geometry
// ---------------------------------------------------------------------------

JET_T struct V3 {
  JN x, y, z;
};
JET_T struct Q4 {
  JN w, x, y, z;
};
#define V3N V3<T, N>
#define Q4N Q4<T, N>

JET_T __device__ __forceinline__ V3N vconst(const T* p) {
  return {cst<T, N>(p[0]), cst<T, N>(p[1]), cst<T, N>(p[2])};
}
JET_T __device__ __forceinline__ Q4N qconst(const T* q) {
  return {cst<T, N>(q[0]), cst<T, N>(q[1]), cst<T, N>(q[2]), cst<T, N>(q[3])};
}
JET_T __device__ __forceinline__ V3N vadd(const V3N& a, const V3N& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
JET_T __device__ __forceinline__ V3N vsub(const V3N& a, const V3N& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
JET_T __device__ __forceinline__ V3N vneg(const V3N& a) { return {-a.x, -a.y, -a.z}; }
JET_T __device__ __forceinline__ V3N vmul(const JN& s, const V3N& a) {
  return {s * a.x, s * a.y, s * a.z};
}
JET_T __device__ __forceinline__ V3N vdiv(const V3N& a, const JN& s) {
  return {a.x / s, a.y / s, a.z / s};
}
// torch.linalg.cross
JET_T __device__ __forceinline__ V3N vcross(const V3N& a, const V3N& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
JET_T __device__ __forceinline__ JN vdot(const V3N& a, const V3N& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
JET_T __device__ __forceinline__ JN vnorm(const V3N& a) {
  return jsqrt(a.x * a.x + a.y * a.y + a.z * a.z);
}

JET_T __device__ __forceinline__ Q4N qmul(const Q4N& q, const Q4N& p) {
  return {q.w * p.w - q.x * p.x - q.y * p.y - q.z * p.z,
          q.w * p.x + q.x * p.w + q.y * p.z - q.z * p.y,
          q.w * p.y - q.x * p.z + q.y * p.w + q.z * p.x,
          q.w * p.z + q.x * p.y - q.y * p.x + q.z * p.w};
}
JET_T __device__ __forceinline__ Q4N qconj(const Q4N& q) { return {q.w, -q.x, -q.y, -q.z}; }
JET_T __device__ __forceinline__ Q4N qnormalize(const Q4N& q) {
  const JN n = jsqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}
// quat_rotate: v + 2 (w (u x v) + u x (u x v))
JET_T __device__ __forceinline__ V3N qrot(const Q4N& q, const V3N& v) {
  const V3N u = {q.x, q.y, q.z};
  const V3N uv = vcross(u, v);
  const V3N c = vcross(u, uv);
  const T two = T(2);
  return {v.x + two * (q.w * uv.x + c.x), v.y + two * (q.w * uv.y + c.y),
          v.z + two * (q.w * uv.z + c.z)};
}
// quat_to_rot: R[r][c]
JET_T __device__ __forceinline__ void qtorot(const Q4N& q, JN (&R)[3][3]) {
  const T one = T(1), two = T(2);
  const JN w = q.w, x = q.x, y = q.y, z = q.z;
  R[0][0] = one - two * (y * y + z * z);
  R[0][1] = two * (x * y - w * z);
  R[0][2] = two * (x * z + w * y);
  R[1][0] = two * (x * y + w * z);
  R[1][1] = one - two * (x * x + z * z);
  R[1][2] = two * (y * z - w * x);
  R[2][0] = two * (x * z - w * y);
  R[2][1] = two * (y * z + w * x);
  R[2][2] = one - two * (x * x + y * y);
}
// so3_exp_quat, with its small-angle branch
JET_T __device__ __forceinline__ Q4N so3_exp(const V3N& th) {
  const JN asq = th.x * th.x + th.y * th.y + th.z * th.z;
  JN k, w;
  if (asq.a < T(1e-12)) {
    k = T(0.5) - asq / T(48);
    w = T(1) - asq / T(8);
  } else {
    const JN ang = jsqrt(asq);
    const JN half = ang * T(0.5);
    k = jsin(half) / ang;
    w = jcos(half);
  }
  return {w, k * th.x, k * th.y, k * th.z};
}

}  // namespace
