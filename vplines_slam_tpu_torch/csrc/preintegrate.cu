// K10 preintegrate: IMU mid-point preintegration of B padded intervals, with
// the 15x15 jacobian and covariance propagation, in one launch.
//
// Replaces: vplines_slam_tpu/models/imu.py:79 preintegrate (a lax.scan over
//   the fixed-capacity sample buffer, vmapped over intervals by its callers).
//   In plain PyTorch each of the N steps is ~100 small ops, so one interval
//   of 64 steps costs ~6,400 launches.
// Semantics kept: step i integrates samples i -> i+1 over dt_i * mask_i; a
//   masked step still runs (dq is renormalised, everything else adds zero),
//   exactly as the reference.  F, V and the noise Q (18x18 diagonal) are the
//   reference's blocks (integration_base.h:76-166); J <- F J,
//   P <- (F P) F^T + (V Q) V^T.  sum_dt is the masked sum.
// Bound on the H100: operations, far below a microsecond (64 steps x ~38 kFLOP
//   per interval); the kernel is a serial chain of dependent steps, so it is
//   latency-bound by design: what it buys is one launch instead of thousands.
// Design: one block per interval, 256 threads.  Thread 0 advances dp/dq/dv
//   and forms the rotations of each step; 9 threads form the 3x3 products;
//   then one thread per entry builds F and V and computes the 15x15 products,
//   with J, P, F, V and F P in shared memory and __syncthreads between the
//   phases.  Templated on the element type (f32 on the card; f64 also
//   builds).  The order of summation in the products differs from the plain
//   version's matmuls, so the two agree to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Q4 {
  T w, x, y, z;
};

template <typename T>
__device__ __forceinline__ Q4<T> qmul(Q4<T> q, Q4<T> p) {
  return {q.w * p.w - q.x * p.x - q.y * p.y - q.z * p.z,
          q.w * p.x + q.x * p.w + q.y * p.z - q.z * p.y,
          q.w * p.y - q.x * p.z + q.y * p.w + q.z * p.x,
          q.w * p.z + q.x * p.y - q.y * p.x + q.z * p.w};
}

// v + 2 (w (u x v) + u x (u x v)), as utils/geometry.quat_rotate
template <typename T>
__device__ __forceinline__ void qrot(Q4<T> q, const T* v, T* out) {
  const T uv0 = q.y * v[2] - q.z * v[1];
  const T uv1 = q.z * v[0] - q.x * v[2];
  const T uv2 = q.x * v[1] - q.y * v[0];
  const T c0 = q.y * uv2 - q.z * uv1;
  const T c1 = q.z * uv0 - q.x * uv2;
  const T c2 = q.x * uv1 - q.y * uv0;
  out[0] = v[0] + T(2) * (q.w * uv0 + c0);
  out[1] = v[1] + T(2) * (q.w * uv1 + c1);
  out[2] = v[2] + T(2) * (q.w * uv2 + c2);
}

template <typename T>
__device__ __forceinline__ void qrotmat(Q4<T> q, T* R) {
  const T w = q.w, x = q.x, y = q.y, z = q.z;
  R[0] = T(1) - T(2) * (y * y + z * z);
  R[1] = T(2) * (x * y - w * z);
  R[2] = T(2) * (x * z + w * y);
  R[3] = T(2) * (x * y + w * z);
  R[4] = T(1) - T(2) * (x * x + z * z);
  R[5] = T(2) * (y * z - w * x);
  R[6] = T(2) * (x * z - w * y);
  R[7] = T(2) * (y * z + w * x);
  R[8] = T(1) - T(2) * (x * x + y * y);
}

template <typename T>
__device__ __forceinline__ void skew3(const T* v, T* S) {
  S[0] = T(0);  S[1] = -v[2]; S[2] = v[1];
  S[3] = v[2];  S[4] = T(0);  S[5] = -v[0];
  S[6] = -v[1]; S[7] = v[0];  S[8] = T(0);
}

template <typename T>
__device__ __forceinline__ T sqrt_t(T x);
template <>
__device__ __forceinline__ float sqrt_t<float>(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double sqrt_t<double>(double x) { return sqrt(x); }

template <typename T>
struct Shared {
  T J[225], P[225], F[225], V[270], FP[225];
  T R0[9], R1[9], Ra0[9], Ra1[9], Rw[9], A[9], C[9], IRw[9], B[9];
  T nz[18];
  T dt;
};

// entry (r, c) of F (15x15); blocks of the reference
template <typename T>
__device__ __forceinline__ T f_entry(const Shared<T>& s, int r, int c) {
  const int br = r / 3, bc = c / 3, i = r % 3, j = c % 3;
  const T dt = s.dt, dt2 = dt * dt;
  const T eye = i == j ? T(1) : T(0);
  const int k = i * 3 + j;
  switch (br * 5 + bc) {
    case 0: return eye;                                                   // p,p
    case 1: return T(-0.25) * s.A[k] * dt2 - T(0.25) * s.B[k] * dt2;      // p,q
    case 2: return eye * dt;                                              // p,v
    case 3: return T(-0.25) * (s.R0[k] + s.R1[k]) * dt2;                  // p,ba
    case 4: return T(0.25) * s.C[k] * dt2 * dt;                           // p,bg
    case 6: return s.IRw[k];                                              // q,q
    case 9: return -eye * dt;                                             // q,bg
    case 11: return T(-0.5) * s.A[k] * dt - T(0.5) * s.B[k] * dt;         // v,q
    case 12: return eye;                                                  // v,v
    case 13: return T(-0.5) * (s.R0[k] + s.R1[k]) * dt;                   // v,ba
    case 14: return T(0.5) * s.C[k] * dt2;                                // v,bg
    case 18: return eye;                                                  // ba,ba
    case 24: return eye;                                                  // bg,bg
    default: return T(0);
  }
}

// entry (r, c) of V (15x18)
template <typename T>
__device__ __forceinline__ T v_entry(const Shared<T>& s, int r, int c) {
  const int br = r / 3, bc = c / 3, i = r % 3, j = c % 3;
  const T dt = s.dt, dt2 = dt * dt;
  const T eye = i == j ? T(1) : T(0);
  const int k = i * 3 + j;
  switch (br * 6 + bc) {
    case 0: return T(0.25) * s.R0[k] * dt2;
    case 1: case 3: return T(-0.125) * s.C[k] * dt2 * dt;
    case 2: return T(0.25) * s.R1[k] * dt2;
    case 7: case 9: return T(0.5) * eye * dt;
    case 12: return T(0.5) * s.R0[k] * dt;
    case 13: case 15: return T(-0.25) * s.C[k] * dt2;
    case 14: return T(0.5) * s.R1[k] * dt;
    case 22: return eye * dt;  // (ba, nba)
    case 29: return eye * dt;  // (bg, nbg)
    default: return T(0);
  }
}

template <typename T>
__global__ void preintegrate_kernel(const T* __restrict__ dts, const T* __restrict__ accs,
                                    const T* __restrict__ gyrs,
                                    const uint8_t* __restrict__ mask,
                                    const T* __restrict__ ba_in, const T* __restrict__ bg_in,
                                    const T* __restrict__ noise, int N,
                                    T* __restrict__ dp_out, T* __restrict__ dq_out,
                                    T* __restrict__ dv_out, T* __restrict__ J_out,
                                    T* __restrict__ P_out, T* __restrict__ sum_dt_out) {
  __shared__ Shared<T> s;
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* dt_b = dts + (size_t)b * N;
  const T* acc_b = accs + (size_t)b * (N + 1) * 3;
  const T* gyr_b = gyrs + (size_t)b * (N + 1) * 3;
  const uint8_t* m_b = mask + (size_t)b * N;
  const T ba[3] = {ba_in[b * 3], ba_in[b * 3 + 1], ba_in[b * 3 + 2]};
  const T bg[3] = {bg_in[b * 3], bg_in[b * 3 + 1], bg_in[b * 3 + 2]};
  if (tid < 225) {
    s.J[tid] = (tid / 15 == tid % 15) ? T(1) : T(0);
    s.P[tid] = T(0);
  }
  if (tid < 18) {
    const int g = tid / 3;  // [na0, ng0, na1, ng1, nba, nbg]
    const T n = noise[g == 4 ? 2 : g == 5 ? 3 : (g & 1)];
    s.nz[tid] = n * n;
  }
  // thread 0's running state
  T dp[3] = {T(0), T(0), T(0)}, dv[3] = {T(0), T(0), T(0)}, sum_dt = T(0);
  Q4<T> dq = {T(1), T(0), T(0), T(0)};
  __syncthreads();
  for (int i = 0; i < N; ++i) {
    if (tid == 0) {
      const T dt = dt_b[i] * (m_b[i] ? T(1) : T(0));
      sum_dt += dt;
      T a0[3], a1[3], w[3], ua0[3], ua1[3];
      for (int d = 0; d < 3; ++d) {
        a0[d] = acc_b[i * 3 + d] - ba[d];
        a1[d] = acc_b[(i + 1) * 3 + d] - ba[d];
        w[d] = T(0.5) * (gyr_b[i * 3 + d] + gyr_b[(i + 1) * 3 + d]) - bg[d];
      }
      qrot(dq, a0, ua0);
      const Q4<T> dth = {T(1), w[0] * dt * T(0.5), w[1] * dt * T(0.5), w[2] * dt * T(0.5)};
      Q4<T> dn = qmul(dq, dth);
      const T nrm = sqrt_t(dn.w * dn.w + dn.x * dn.x + dn.y * dn.y + dn.z * dn.z);
      dn = {dn.w / nrm, dn.x / nrm, dn.y / nrm, dn.z / nrm};
      qrot(dn, a1, ua1);
      for (int d = 0; d < 3; ++d) {
        const T ua = T(0.5) * (ua0[d] + ua1[d]);
        dp[d] = dp[d] + dv[d] * dt + T(0.5) * ua * dt * dt;
        dv[d] = dv[d] + ua * dt;
      }
      qrotmat(dq, s.R0);
      qrotmat(dn, s.R1);
      skew3(a0, s.Ra0);
      skew3(a1, s.Ra1);
      skew3(w, s.Rw);
      s.dt = dt;
      dq = dn;
    }
    __syncthreads();
    if (tid < 9) {
      const int r = tid / 3, c = tid % 3;
      T a = T(0), cc = T(0);
      for (int k = 0; k < 3; ++k) {
        a += s.R0[r * 3 + k] * s.Ra0[k * 3 + c];
        cc += s.R1[r * 3 + k] * s.Ra1[k * 3 + c];
      }
      s.A[tid] = a;
      s.C[tid] = cc;
      s.IRw[tid] = (r == c ? T(1) : T(0)) - s.Rw[tid] * s.dt;
    }
    __syncthreads();
    if (tid < 9) {
      const int r = tid / 3, c = tid % 3;
      T acc = T(0);
      for (int k = 0; k < 3; ++k) acc += s.C[r * 3 + k] * s.IRw[k * 3 + c];
      s.B[tid] = acc;
    }
    __syncthreads();
    if (tid < 225) s.F[tid] = f_entry(s, tid / 15, tid % 15);
    for (int e = tid; e < 270; e += blockDim.x) s.V[e] = v_entry(s, e / 18, e % 18);
    __syncthreads();
    T jn = T(0);
    if (tid < 225) {
      const int r = tid / 15, c = tid % 15;
      T fp = T(0);
      for (int k = 0; k < 15; ++k) {
        const T f = s.F[r * 15 + k];
        jn += f * s.J[k * 15 + c];
        fp += f * s.P[k * 15 + c];
      }
      s.FP[tid] = fp;
    }
    __syncthreads();
    if (tid < 225) {
      const int r = tid / 15, c = tid % 15;
      T pn = T(0), vq = T(0);
      for (int k = 0; k < 15; ++k) pn += s.FP[r * 15 + k] * s.F[c * 15 + k];
      for (int k = 0; k < 18; ++k) vq += s.V[r * 18 + k] * s.nz[k] * s.V[c * 18 + k];
      s.J[tid] = jn;
      s.P[tid] = pn + vq;
    }
    __syncthreads();
  }
  if (tid < 225) {
    J_out[(size_t)b * 225 + tid] = s.J[tid];
    P_out[(size_t)b * 225 + tid] = s.P[tid];
  }
  if (tid == 0) {
    for (int d = 0; d < 3; ++d) {
      dp_out[b * 3 + d] = dp[d];
      dv_out[b * 3 + d] = dv[d];
    }
    dq_out[b * 4 + 0] = dq.w;
    dq_out[b * 4 + 1] = dq.x;
    dq_out[b * 4 + 2] = dq.y;
    dq_out[b * 4 + 3] = dq.z;
    sum_dt_out[b] = sum_dt;
  }
}

template <typename T>
int launch(const void* dts, const void* accs, const void* gyrs, const uint8_t* mask,
           const void* ba, const void* bg, const void* noise, int B, int N, void* dp,
           void* dq, void* dv, void* J, void* P, void* sum_dt, cudaStream_t stream) {
  preintegrate_kernel<T><<<B, 256, 0, stream>>>(
      (const T*)dts, (const T*)accs, (const T*)gyrs, mask, (const T*)ba, (const T*)bg,
      (const T*)noise, N, (T*)dp, (T*)dq, (T*)dv, (T*)J, (T*)P, (T*)sum_dt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vp_preintegrate(const void* dts, const void* accs, const void* gyrs,
                               const uint8_t* mask, const void* ba, const void* bg,
                               const void* noise, int B, int N, int is_double, void* dp,
                               void* dq, void* dv, void* J, void* P, void* sum_dt,
                               cudaStream_t stream) {
  if (B <= 0) return 0;
  if (is_double)
    return launch<double>(dts, accs, gyrs, mask, ba, bg, noise, B, N, dp, dq, dv, J, P,
                          sum_dt, stream);
  return launch<float>(dts, accs, gyrs, mask, ba, bg, noise, B, N, dp, dq, dv, J, P,
                       sum_dt, stream);
}
