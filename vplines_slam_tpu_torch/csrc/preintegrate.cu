// K10 preintegrate: IMU mid-point preintegration of B padded intervals, with
// the 15x15 jacobian and covariance propagation, in one launch.
//
// Replaces: vplines_slam_tpu/models/imu.py:79 preintegrate (a lax.scan over
//   the fixed-capacity sample buffer, vmapped over intervals by its callers).
//   In plain PyTorch each of the N steps is ~100 small ops, so one interval
//   of 64 steps costs ~6,400 launches.
// Semantics kept: step i integrates samples i -> i+1 over dt_i * mask_i; a
//   masked step still renormalises dq, exactly as the reference.  F, V and
//   the noise Q (18x18 diagonal) are the reference's blocks
//   (integration_base.h:76-166); J <- F J, P <- (F P) F^T + (V Q) V^T.
//   sum_dt is the masked sum.  `noise` holds the four squared densities
//   [acc_n^2, gyr_n^2, acc_w^2, gyr_w^2].
// Why masked steps are skipped in the matrix recurrence: on a step with
//   dt * mask == 0 every dt-scaled block of F is an exact (signed) zero, the
//   (q, q) block is I - Rw * 0 = I exactly, and V is exactly zero, so F is
//   the identity and (V Q) V^T is zero: F J == J and (F P) F^T + 0 == P bit
//   for bit, provided the step's samples and biases are finite (0 * inf is
//   NaN).  The callers guarantee that: VioEngine._pack_imu zero-fills the
//   padding and the slide's merged interval repeats its last real sample.
//   dp, dv and sum_dt gain exact zeros on such a step too.  dq still runs
//   through every step, so it is renormalised as often and in the same
//   order as in the reference and the plain twin, up to the point where a
//   run of masked steps reaches a fixed point (below).
// Bound on the H100: operations, far below a microsecond (each live step's
//   non-zero blocks of F and V: chip_smoke.preintegrate_step_ops); the
//   kernel is a chain of dependent steps, so it is latency-bound by design.
// Design: one warp per interval, two intervals per CTA at f32 (one at f64),
//   no __syncthreads.  The steps go in chunks of 32, a lane per step:
//   (1) each lane loads its step's samples; every lane chains dq through the
//       chunk on the increments shuffled from lane k (lane k keeps dq before
//       and after its step), renormalising as the twin does (an IEEE
//       square root and four divisions);
//       each live lane then forms its step's mean acceleration and a record
//       of F's non-trivial 3x3 blocks and the upper triangle of (V Q) V^T
//       from closed-form 3x3 blocks (Q is diagonal), compacted in step
//       order by a ballot; every lane advances dp, dv and sum_dt through
//       the live steps in order, on shuffled values;
//   (2) the live steps' matrix recurrence, each step's record read with
//       vector loads into every lane's registers: J's rows 9-14 never
//       change, so lanes 15-29 each hold a column of J's rows 0-8 in
//       registers and apply F to it, while lanes 0-14 form F P column by
//       column (F's rows 9-14 are the identity, so F P's rows 9-14 are P's);
//       then lanes 0-14 form the upper triangle of (F P) F^T + (V Q) V^T
//       column by column, each entry written to both mirrors, so P stays
//       exactly symmetric.  Two __syncwarp a live step, and no branch: the
//       lanes differ only in what they load and which stores they make.
//   Templated on the element type (f32 on the card; f64 also builds).  The
//   order of summation differs from the plain version's matmuls, so the two
//   agree to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // steps per chunk: one lane each

// fields of a live step's record (a slot of kSlot elements: 16-byte aligned,
// and the lanes writing their slots' field f meet at most 4 to a bank)
enum : int {
  kFpq = 0,    // F (p, q)
  kFpba = 9,   // F (p, ba)
  kFpbg = 18,  // F (p, bg)
  kFqq = 27,   // F (q, q) = I - skew(w) dt
  kFvq = 36,   // F (v, q)
  kFvba = 45,  // F (v, ba)
  kFvbg = 54,  // F (v, bg)
  kDt = 63,    // dt; F (p, v) = I dt, F (q, bg) = -I dt
  kW = 64,     // (V Q) V^T over rows p, q, v: upper triangle, column c at c (c + 1) / 2
  kWba = 109,  // its (ba, ba) diagonal
  kWbg = 110,  // its (bg, bg) diagonal
  kFields = 111
};
constexpr int kSlot = 116;

template <typename T>
struct alignas(4 * sizeof(T)) Quad {  // four record fields, one vector load
  T v[4];
};

template <typename T>
__host__ __device__ constexpr int warps_per_cta() { return sizeof(T) == 4 ? 2 : 1; }

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
__device__ __forceinline__ void matmul3(const T* A, const T* B, T* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C[r * 3 + c] = A[r * 3] * B[c] + A[r * 3 + 1] * B[3 + c] + A[r * 3 + 2] * B[6 + c];
}

template <typename T>
__device__ __forceinline__ T sqrt_t(T x);
template <>
__device__ __forceinline__ float sqrt_t<float>(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double sqrt_t<double>(double x) { return sqrt(x); }

template <typename T>
struct alignas(4 * sizeof(T)) WarpSmem {
  T rec[kChunk * kSlot];    // the chunk's live steps' records, slot-major
  T P[225];                 // the covariance, both triangles
  T FP[225];                // F P; its rows 9-14 are P's
};

// A live step's record, into slot `slot` of rec.
template <typename T>
__device__ void write_record(T* rec, int slot, Q4<T> q0, Q4<T> q1, const T* a0,
                             const T* a1, const T* w, T dt, T an2, T gn2, T aw2, T gw2) {
  T R0[9], R1[9], Ra0[9], Ra1[9], Rw[9], A[9], C[9], IRw[9], B[9];
  qrotmat(q0, R0);
  qrotmat(q1, R1);
  skew3(a0, Ra0);
  skew3(a1, Ra1);
  skew3(w, Rw);
  matmul3(R0, Ra0, A);
  matmul3(R1, Ra1, C);
#pragma unroll
  for (int k = 0; k < 9; ++k) IRw[k] = (k % 4 == 0 ? T(1) : T(0)) - Rw[k] * dt;
  matmul3(C, IRw, B);
  const T dt2 = dt * dt;
  auto put = [&](int f, T v) { rec[slot * kSlot + f] = v; };
  // rows 0-8 of V by noise column (acc0, gyr0, acc1, gyr1), the q rows'
  // two diagonal entries apart
  T Vr[9][12];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    put(kFpq + k, T(-0.25) * A[k] * dt2 - T(0.25) * B[k] * dt2);
    put(kFpba + k, T(-0.25) * (R0[k] + R1[k]) * dt2);
    put(kFpbg + k, T(0.25) * C[k] * dt2 * dt);
    put(kFqq + k, IRw[k]);
    put(kFvq + k, T(-0.5) * A[k] * dt - T(0.5) * B[k] * dt);
    put(kFvba + k, T(-0.5) * (R0[k] + R1[k]) * dt);
    put(kFvbg + k, T(0.5) * C[k] * dt2);
    const int i = k / 3, j = k % 3;
    const T pc = T(-0.125) * C[k] * dt2 * dt, vc = T(-0.25) * C[k] * dt2;
    Vr[i][j] = T(0.25) * R0[k] * dt2;
    Vr[i][3 + j] = pc;
    Vr[i][6 + j] = T(0.25) * R1[k] * dt2;
    Vr[i][9 + j] = pc;
    Vr[6 + i][j] = T(0.5) * R0[k] * dt;
    Vr[6 + i][3 + j] = vc;
    Vr[6 + i][6 + j] = T(0.5) * R1[k] * dt;
    Vr[6 + i][9 + j] = vc;
  }
  put(kDt, dt);
  const T h = T(0.5) * dt;
  const T qn[4] = {an2, gn2, an2, gn2};
#pragma unroll
  for (int c = 0; c < 9; ++c)
#pragma unroll
    for (int m = 0; m <= c; ++m) {
      T acc = T(0);
      if (m / 3 == 1 && c / 3 == 1) {
        // (q, q): two diagonal noise terms
        if (m == c) acc = h * gn2 * h + h * gn2 * h;
      } else if (m / 3 == 1 || c / 3 == 1) {
        // (q, p) or (q, v): the q row's entries meet column 3 + i and 9 + i
        const int i = (m / 3 == 1 ? m : c) - 3, o = (m / 3 == 1 ? c : m);
        acc = h * gn2 * Vr[o][3 + i] + h * gn2 * Vr[o][9 + i];
      } else {
#pragma unroll
        for (int k = 0; k < 12; ++k) acc = acc + Vr[m][k] * qn[k / 3] * Vr[c][k];
      }
      put(kW + c * (c + 1) / 2 + m, acc);
    }
  put(kWba, dt * aw2 * dt);
  put(kWbg, dt * gw2 * dt);
}

// y = rows 0-8 of F x, F from f (a live step's record fields 0..kDt); F's
// rows 9-14 are the identity
template <typename T>
__device__ __forceinline__ void apply_f(const T* f, const T* x, T* y) {
  const T dt = f[kDt];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T p = x[i], q = T(0), v = T(0);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p = p + f[kFpq + 3 * i + j] * x[3 + j];
      q = q + f[kFqq + 3 * i + j] * x[3 + j];
      v = v + f[kFvq + 3 * i + j] * x[3 + j];
    }
    p = p + dt * x[6 + i];
    v = v + x[6 + i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p = p + f[kFpba + 3 * i + j] * x[9 + j];
      v = v + f[kFvba + 3 * i + j] * x[9 + j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p = p + f[kFpbg + 3 * i + j] * x[12 + j];
      v = v + f[kFvbg + 3 * i + j] * x[12 + j];
    }
    q = q - dt * x[12 + i];
    y[i] = p;
    y[3 + i] = q;
    y[6 + i] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * warps_per_cta<T>())
preintegrate_kernel(const T* __restrict__ dts, const T* __restrict__ accs,
                    const T* __restrict__ gyrs, const uint8_t* __restrict__ mask,
                    const T* __restrict__ ba_in, const T* __restrict__ bg_in,
                    const T* __restrict__ noise, int B, int N, T* __restrict__ dp_out,
                    T* __restrict__ dq_out, T* __restrict__ dv_out, T* __restrict__ J_out,
                    T* __restrict__ P_out, T* __restrict__ sum_dt_out) {
  constexpr int kWarps = warps_per_cta<T>();
  __shared__ WarpSmem<T> smem[kWarps];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp; nothing below synchronises the CTA
  WarpSmem<T>& s = smem[threadIdx.x >> 5];
  const T* dt_b = dts + (size_t)b * N;
  const T* acc_b = accs + (size_t)b * (N + 1) * 3;
  const T* gyr_b = gyrs + (size_t)b * (N + 1) * 3;
  const uint8_t* m_b = mask + (size_t)b * N;
  const T ba[3] = {ba_in[b * 3], ba_in[b * 3 + 1], ba_in[b * 3 + 2]};
  const T bg[3] = {bg_in[b * 3], bg_in[b * 3 + 1], bg_in[b * 3 + 2]};
  const T an2 = noise[0], gn2 = noise[1], aw2 = noise[2], gw2 = noise[3];

  for (int e = lane; e < 225; e += 32) s.P[e] = T(0);
  // lanes 15-29: column jc of J, rows 0-8 (rows 9-14 stay the identity's)
  const int jc = lane - 15;
  T Jc[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) Jc[r] = r == jc ? T(1) : T(0);
  // the scalar state, the same in every lane
  Q4<T> dq = {T(1), T(0), T(0), T(0)};
  T dp[3] = {T(0), T(0), T(0)}, dv[3] = {T(0), T(0), T(0)}, sum_dt = T(0);
  bool fixed = false;  // dq is a fixed point of a masked step
  __syncwarp();

  constexpr unsigned kAll = 0xffffffffu;
  for (int i0 = 0; i0 < N; i0 += kChunk) {
    const int n = min(kChunk, N - i0), i = i0 + lane;
    T dt = T(0), a0[3] = {T(0), T(0), T(0)}, a1[3] = {T(0), T(0), T(0)},
      w[3] = {T(0), T(0), T(0)}, h[3] = {T(0), T(0), T(0)};
    if (lane < n) {
      dt = dt_b[i] * (m_b[i] ? T(1) : T(0));
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        a0[d] = acc_b[i * 3 + d] - ba[d];
        a1[d] = acc_b[(i + 1) * 3 + d] - ba[d];
        w[d] = T(0.5) * (gyr_b[i * 3 + d] + gyr_b[(i + 1) * 3 + d]) - bg[d];
        h[d] = w[d] * dt * T(0.5);  // the twin's delta_quat: [1, w dt / 2]
      }
    }
    const bool live = lane < n && dt != T(0);
    const unsigned live_mask = __ballot_sync(kAll, live);
    // the chain of dq through the chunk's steps, masked ones included: every
    // lane runs it on the increments shuffled from lane k, and lane k keeps
    // dq before and after its step.  A masked step maps dq to dq / |dq|
    // (its increment is exactly [1, 0, 0, 0]); once that leaves dq
    // unchanged, the rest of the run of masked steps would too, so they are
    // skipped: the result is the same bits
    Q4<T> q0 = dq, q1 = dq;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const bool masked = !((live_mask >> k) & 1u);
      if (masked && fixed) continue;
      const Q4<T> dth = {T(1), __shfl_sync(kAll, h[0], k), __shfl_sync(kAll, h[1], k),
                         __shfl_sync(kAll, h[2], k)};
      if (lane == k) q0 = dq;
      const Q4<T> dn = qmul(dq, dth);
      const T nrm = sqrt_t(dn.w * dn.w + dn.x * dn.x + dn.y * dn.y + dn.z * dn.z);
      const Q4<T> was = dq;
      dq = {dn.w / nrm, dn.x / nrm, dn.y / nrm, dn.z / nrm};
      if (lane == k) q1 = dq;
      fixed = masked && dq.w == was.w && dq.x == was.x && dq.y == was.y && dq.z == was.z;
    }
    T ua[3] = {T(0), T(0), T(0)};
    if (live) {
      T ua0[3], ua1[3];
      qrot(q0, a0, ua0);
      qrot(q1, a1, ua1);
#pragma unroll
      for (int d = 0; d < 3; ++d) ua[d] = T(0.5) * (ua0[d] + ua1[d]);
      write_record(s.rec, __popc(live_mask & ((1u << lane) - 1u)), q0, q1, a0, a1, w, dt,
                   an2, gn2, aw2, gw2);
    }
    // dp, dv and sum_dt through the live steps in order, in every lane, on
    // lane k's dt and mean acceleration (a masked step adds exact zeros to
    // them, as to J and P)
    for (unsigned lm = live_mask; lm; lm &= lm - 1u) {
      const int k = __ffs(lm) - 1;
      const T t = __shfl_sync(kAll, dt, k);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T u = __shfl_sync(kAll, ua[d], k);
        dp[d] = dp[d] + dv[d] * t + T(0.5) * u * t * t;
        dv[d] = dv[d] + u * t;
      }
      sum_dt += t;
    }
    __syncwarp();  // the records are written
    const int n_live = __popc(live_mask);
    for (int k = 0; k < n_live; ++k) {
      // the step's blocks of F and dt, and column c = lane of (V Q) V^T
      // (lanes 0-14), in every lane's registers
      const T* r = s.rec + k * kSlot;
      T f[kDt + 1], wq[15];
#pragma unroll
      for (int e = 0; e <= kDt / 4; ++e) {
        const Quad<T> fq = reinterpret_cast<const Quad<T>*>(r)[e];
#pragma unroll
        for (int j = 0; j < 4; ++j) f[4 * e + j] = fq.v[j];
      }
      const int c = lane < 15 ? lane : 0, cw = c < 9 ? c : 8;  // cw: a column of the packed triangle
#pragma unroll
      for (int m = 0; m < 15; ++m)
        wq[m] = m < 9 ? r[kW + (m <= cw ? cw * (cw + 1) / 2 + m : m * (m + 1) / 2 + cw)]
                      : r[m < 12 ? kWba : kWbg];
      // lanes 0-14: column `lane` of F P; lanes 15-29: column jc of F J (no
      // branch: every lane loads a column of P and keeps what it needs)
      T x[15], y[9];
#pragma unroll
      for (int m = 0; m < 15; ++m) {
        const T pm = s.P[m * 15 + c];
        x[m] = lane < 15 ? pm : m < 9 ? Jc[m] : m == jc ? T(1) : T(0);
      }
      apply_f(f, x, y);
#pragma unroll
      for (int m = 0; m < 15; ++m)
        if (lane < 15) s.FP[m * 15 + lane] = m < 9 ? y[m] : x[m];
#pragma unroll
      for (int m = 0; m < 9; ++m) Jc[m] = y[m];
      __syncwarp();
      // lanes 0-14: column c of (F P) F^T + (V Q) V^T, rows 0..c, written to
      // both mirrors
#pragma unroll
      for (int m = 0; m < 15; ++m) x[m] = s.FP[c * 15 + m];
      apply_f(f, x, y);
#pragma unroll
      for (int m = 0; m < 15; ++m) {
        const T v = m < 9 ? y[m] + (c < 9 ? wq[m] : T(0)) : x[m] + (m == c ? wq[m] : T(0));
        if (lane < 15 && m <= c) {
          s.P[m * 15 + c] = v;
          s.P[c * 15 + m] = v;
        }
      }
      __syncwarp();
    }
  }

  T* J_b = J_out + (size_t)b * 225;
  if (jc >= 0 && jc < 15) {
#pragma unroll
    for (int m = 0; m < 9; ++m) J_b[m * 15 + jc] = Jc[m];
  }
  for (int e = lane; e < 90; e += 32) J_b[135 + e] = 9 + e / 15 == e % 15 ? T(1) : T(0);
  for (int e = lane; e < 225; e += 32) P_out[(size_t)b * 225 + e] = s.P[e];
  if (lane == 0) {
#pragma unroll
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
  constexpr int kWarps = warps_per_cta<T>();
  preintegrate_kernel<T><<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
      (const T*)dts, (const T*)accs, (const T*)gyrs, mask, (const T*)ba, (const T*)bg,
      (const T*)noise, B, N, (T*)dp, (T*)dq, (T*)dv, (T*)J, (T*)P, (T*)sum_dt);
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
