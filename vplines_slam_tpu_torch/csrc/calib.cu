// Online self-calibration: K22 (the gyro yaw curve), K23 (the time-offset
// ICP) and K24 (the hand-eye extrinsic rotation), each one launch a call.
//
// K22 gyro_yaw
// Replaces: vplines_slam_tpu/estimator/online_calib.py:163 push_imu_angles
//   (its lax.scan of gyro quaternion steps, the yaw of each, the wrapped
//   differences times the mask, the cumulative sum and the masked write into
//   the fixed-capacity curve) and vplines_slam_tpu/models/calibration.py:61
//   integrate_gyro_yaw (the same chain, its yaws alone).
// Semantics kept: every step q <- normalize(q (x) [1, 0.5 (0.5 (w0 + w1) dt)])
//   with dt = (t1 - t0) * mask is applied, a masked one too (normalizing
//   can move q's last bit), as the reference does.  The yaw is
//   atan2(R10, R00) taken to degrees and back, as rot_to_ypr and deg2rad
//   do; the wrap is the floor-mod of torch.remainder and jnp's %: the exact
//   fmod, plus 2 pi where it is negative (a - 2 pi floor((a + pi) / 2 pi)
//   rounds differently on ~6e-4 of inputs).  The sum runs in step order, as
//   a sequential cumsum does.  Ring slots are written last-write-wins in
//   step order, as XLA's scatter on the CPU resolves the clamped index
//   M - 1: a slot takes its last writer's value (new where the step is
//   live and below capacity, else the slot's old value).
// Bound on the H100: latency.  The chain is serial by nature: ~60 dependent
//   f64 operations a step (a square root, four divisions).  Bytes: the
//   curve's old values read and the new written once, 2 x 2 x 8 x M.
// Design: one CTA of 128 threads.  Warp 0 computes: its lanes load a chunk
//   of 32 steps' increments, lane 0 runs the chain through the chunk, the
//   lanes take the yaws and the wrapped differences in parallel, lane 0
//   sums them in order and the lanes write their steps.  Warps 1-3 copy the
//   curve's slots that the batch cannot touch meanwhile, so the outputs
//   are new tensors (the accumulator stays functional) and no barrier is
//   needed: warp 0 writes every slot of [min(n, M-1), min(n+I-1, M-1)].
//
// K23 time_offset
// Replaces: vplines_slam_tpu/models/calibration.py:81 calibrate_time_offset
//   (10 Gauss-Newton iterations over (td, c): per camera sample the first
//   nearest IMU stamp by argmin, its forward segment, the perpendicular
//   residual, J by jax.jacfwd, a 2x2 solve of J^T J + 1e-9 I; then the RMS)
//   and, with the counts given, vplines_slam_tpu/estimator/online_calib.py:198
//   solve_time_offset (the unfilled IMU curve padded as 1e9 + m with its
//   last angle, the camera mask cut at n_cam, ok = n_cam >= min_cam and td
//   finite).
// Semantics kept: the first minimum wins a tie (a strict scan, no binary
//   search); J is jacfwd's in closed form, (perp . dperp) / |perp| times the
//   mask (jacfwd's (2 a) / (2 |perp|) is the same number), so a zero
//   residual gives 0 / 0 = NaN even on a masked sample, and the step is NaN,
//   as in the reference; the 2x2 solve is Cramer's rule.
// Bound on the H100: operations.  Each pass compares every camera sample
//   with every IMU stamp: C x M x 11 passes f64 subtract / compare ~ 6 x 10^6
//   operations at C = 128, M = 4,096 (chip_smoke.py time_offset_ops).
// Design: one CTA of 1,024 threads, both IMU curves in dynamic shared memory
//   (64 KB at M = 4,096, above 48 KB after the attribute is raised).  Eight
//   threads a camera sample scan interleaved eighths of the curve, each
//   keeping its first minimum, and merge by (distance, index) over three
//   shuffles; the group's leader forms r and J.  Thread 0 sums J^T J and
//   J^T r in sample order and solves; all 10 iterations and the RMS run in
//   the one launch.
//
// K24 hand_eye
// Replaces: vplines_slam_tpu/models/calibration.py:24
//   calibrate_extrinsic_rotation (vmap(block) of the robust-weighted
//   (L(q_imu) - R(q_cam)) w blocks into A [4K, 4], jnp.linalg.svd, the
//   smallest right singular vector with q0 >= 0, sigma_3 > 0.25) and the
//   count gate of vplines_slam_tpu/estimator/online_calib.py:206
//   solve_extrinsic.
// Semantics changed on purpose: the solve is the eigenproblem of A^T A
//   (4 x 4) in f64 whatever the input type (the reference's SVD runs in the
//   engine's type); sigma_3 = sqrt(lambda_2), the second-smallest
//   eigenvalue.  q and sigma come back in the input type.
// Bound on the H100: latency: 16 x 10 f64 products a pair and a 4x4 Jacobi.
// Design: one CTA of 128 threads; thread t sums the 10 entries of B^T B
//   over pairs t, t + 128, ... in order, a fixed-order tree adds the
//   threads; thread 0 runs a cyclic Jacobi (marg.cu's jacobi_eig4), sorts
//   the eigenvalues with the index breaking ties, and writes q, the flag and
//   sigma.  No host sync: the cuSOLVER SVD syncs the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the argument structs the C entries take by pointer (kernels.args_struct's
// field order: pointers, then ints, then doubles)
struct GyroYawArgs {
  const double* ts;       // [I + 1]
  const double* gyrs;     // [I + 1, 3]
  const uint8_t* mask;    // [I] or null: every step live
  const double* q_in;     // [4]
  double* q_out;          // [4]
  double* yaws;           // [I + 1]: yaw of q_in, then after each step
  const double* t_ring;   // [M] or null: no curve to write
  const double* a_ring;   // [M]
  const int64_t* n_in;    // [1]
  double* t_out;          // [M]
  double* a_out;          // [M]
  int64_t* n_out;         // [1]
  int I;
  int M;
};

struct TimeOffsetArgs {
  const double* t_cam;      // [C]
  const double* a_cam;      // [C]
  const uint8_t* cam_valid; // [C]
  const int64_t* n_cam;     // [1] or null: every slot filled
  const double* t_imu;      // [M]
  const double* a_imu;      // [M]
  const int64_t* n_imu;     // [1] or null: every slot filled
  double* out;              // [3]: td, c, rms
  uint8_t* ok;              // [1] or null
  int C;
  int M;
  int iters;
  int min_cam;
  double td_init;
};

struct HandEyeArgs {
  const void* q_cam;      // [K, 4]
  const void* q_imu;      // [K, 4]
  const uint8_t* valid;   // [K]
  const int64_t* count;   // [1] or null: no pair-count gate
  void* q_out;            // [4]
  uint8_t* converged;     // [1]
  void* sigma;            // [1]
  int K;
  int min_pairs;
  int is_double;
};

namespace {

constexpr double kPi = 3.14159265358979323846;

// floor-mod wrap to [-pi, pi): (a + pi) % 2 pi - pi as torch.remainder and
// jnp.remainder compute it
__device__ __forceinline__ double wrap_pi(double a) {
  const double two_pi = 2.0 * kPi;
  double r = fmod(a + kPi, two_pi);
  if (r != 0.0 && r < 0.0) r += two_pi;
  return r - kPi;
}

// yaw (rad) of unit quaternion [w, x, y, z]: atan2(R10, R00) in degrees and
// back, as deg2rad(rot_to_ypr(quat_to_rot(q))[0])
__device__ __forceinline__ double quat_yaw(double w, double x, double y, double z) {
  const double r00 = 1.0 - 2.0 * (y * y + z * z);
  const double r10 = 2.0 * (x * y + w * z);
  return atan2(r10, r00) * (180.0 / kPi) * (kPi / 180.0);
}

// ---------------------------------------------------------------------------
// K22
// ---------------------------------------------------------------------------

constexpr int kYawThreads = 128;

__global__ void __launch_bounds__(kYawThreads) gyro_yaw_kernel(GyroYawArgs a) {
  __shared__ double s_h[32][3];  // the chunk's half-angle increments
  __shared__ double s_q[32][4];  // q after each step of the chunk
  __shared__ double s_d[32];     // the chunk's wrapped, masked yaw steps
  __shared__ double s_c[32];     // the chunk's cumulative curve values
  const int tid = threadIdx.x, lane = tid & 31;
  const bool ring = a.t_ring != nullptr;
  const int64_t n = ring ? a.n_in[0] : 0;
  // the slots the batch can touch: min(n + i, M - 1) over its steps
  int lo = 0, hi = -1;
  if (ring && a.I > 0) {
    lo = (int)min(n, (int64_t)a.M - 1);
    hi = (int)min(n + a.I - 1, (int64_t)a.M - 1);
  }
  if (tid >= 32) {
    if (ring)
      for (int m = tid - 32; m < a.M; m += kYawThreads - 32)
        if (m < lo || m > hi) {
          a.t_out[m] = a.t_ring[m];
          a.a_out[m] = a.a_ring[m];
        }
    return;
  }
  double qw = a.q_in[0], qx = a.q_in[1], qy = a.q_in[2], qz = a.q_in[3];
  double yaw_prev = quat_yaw(qw, qx, qy, qz);
  if (lane == 0) a.yaws[0] = yaw_prev;
  const double prev_ang = (ring && n > 0) ? a.a_ring[max(n - 1, (int64_t)0)] : 0.0;
  double run = 0.0;  // the cumulative sum of the steps so far
  int live = 0;
  for (int base = 0; base < a.I; base += 32) {
    const int i = base + lane, cnt = min(32, a.I - base);
    const bool in = lane < cnt;
    double m = 0.0;
    if (in) {
      m = (a.mask == nullptr || a.mask[i]) ? 1.0 : 0.0;
      const double dt = (a.ts[i + 1] - a.ts[i]) * m;
      for (int c = 0; c < 3; ++c)
        s_h[lane][c] = 0.5 * (a.gyrs[3 * i + c] + a.gyrs[3 * i + 3 + c]) * dt * 0.5;
    }
    live += __popc(__ballot_sync(0xffffffffu, in && m != 0.0));
    __syncwarp();
    if (lane == 0) {
      for (int s = 0; s < cnt; ++s) {
        const double hx = s_h[s][0], hy = s_h[s][1], hz = s_h[s][2];
        const double w = qw - qx * hx - qy * hy - qz * hz;
        const double x = qw * hx + qx + qy * hz - qz * hy;
        const double y = qw * hy - qx * hz + qy + qz * hx;
        const double z = qw * hz + qx * hy - qy * hx + qz;
        const double nrm = sqrt(w * w + x * x + y * y + z * z);
        qw = w / nrm;
        qx = x / nrm;
        qy = y / nrm;
        qz = z / nrm;
        s_q[s][0] = qw;
        s_q[s][1] = qx;
        s_q[s][2] = qy;
        s_q[s][3] = qz;
      }
    }
    __syncwarp();
    const double yaw = in ? quat_yaw(s_q[lane][0], s_q[lane][1], s_q[lane][2], s_q[lane][3])
                          : 0.0;
    if (in) a.yaws[i + 1] = yaw;
    double before = __shfl_up_sync(0xffffffffu, yaw, 1);
    if (lane == 0) before = yaw_prev;
    s_d[lane] = in ? wrap_pi(yaw - before) * m : 0.0;
    yaw_prev = __shfl_sync(0xffffffffu, yaw, cnt - 1);
    __syncwarp();
    if (lane == 0)
      for (int s = 0; s < cnt; ++s) {
        run += s_d[s];
        s_c[s] = prev_ang + run;
      }
    __syncwarp();
    if (ring && in) {
      // slot min(n + i, M - 1): below M - 1 its only writer is step i; M - 1
      // is written by the batch's last step, the last of its writers
      const int64_t slot = min(n + i, (int64_t)a.M - 1);
      if (slot < a.M - 1 || i == a.I - 1) {
        const bool write = m != 0.0 && n + i < a.M;
        a.t_out[slot] = write ? a.ts[i + 1] : a.t_ring[slot];
        a.a_out[slot] = write ? s_c[lane] : a.a_ring[slot];
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    a.q_out[0] = qw;
    a.q_out[1] = qx;
    a.q_out[2] = qy;
    a.q_out[3] = qz;
    if (ring) a.n_out[0] = min(n + live, (int64_t)a.M);
  }
}

// ---------------------------------------------------------------------------
// K23
// ---------------------------------------------------------------------------

constexpr int kTdThreads = 1024;
constexpr int kTdGroup = 8;  // threads a camera sample
constexpr int kTdGroups = kTdThreads / kTdGroup;

// (d, i) before (d2, i2): the smaller distance, NaN first, the first index
// on a tie (argmin's order)
__device__ __forceinline__ bool nn_before(double d, int i, double d2, int i2) {
  const bool n1 = isnan(d), n2 = isnan(d2);
  if (n1 != n2) return n1;
  if (n1 || d == d2) return i < i2;
  return d < d2;
}

__global__ void __launch_bounds__(kTdThreads) time_offset_kernel(TimeOffsetArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_t = reinterpret_cast<double*>(smem_raw);  // [M] padded stamps
  double* s_a = s_t + a.M;                             // [M] padded angles
  double* s_j0 = s_a + a.M;                            // [C] J[:, 0]
  double* s_j1 = s_j0 + a.C;                           // [C] J[:, 1]
  double* s_r = s_j1 + a.C;                            // [C] r
  __shared__ double s_x[2];
  const int tid = threadIdx.x;
  const int64_t n_imu = a.n_imu ? a.n_imu[0] : a.M;
  const int64_t n_cam = a.n_cam ? a.n_cam[0] : a.C;
  const double a_last = a.a_imu[max(n_imu - 1, (int64_t)0)];
  for (int m = tid; m < a.M; m += kTdThreads) {
    const bool filled = m < n_imu;
    s_t[m] = filled ? a.t_imu[m] : 1e9 + (double)m;
    s_a[m] = filled ? a.a_imu[m] : a_last;
  }
  if (tid == 0) {
    s_x[0] = a.td_init;
    s_x[1] = 0.0;
  }
  __syncthreads();
  const int g = tid / kTdGroup, j = tid % kTdGroup;
  for (int it = 0; it <= a.iters; ++it) {
    const double td = s_x[0], c = s_x[1];
    for (int i0 = 0; i0 < a.C; i0 += kTdGroups) {
      const int i = i0 + g;
      const bool in = i < a.C;  // uniform within the group
      double tq = 0.0, best = 0.0;
      int bi = 0x7fffffff;
      if (in) {
        tq = a.t_cam[i] + td;
        for (int m = j; m < a.M; m += kTdGroup) {
          const double d = fabs(s_t[m] - tq);
          if (bi == 0x7fffffff || nn_before(d, m, best, bi)) {
            best = d;
            bi = m;
          }
        }
      }
#pragma unroll
      for (int o = kTdGroup / 2; o > 0; o >>= 1) {
        const double d2 = __shfl_xor_sync(0xffffffffu, best, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
        if (i2 != 0x7fffffff && (bi == 0x7fffffff || nn_before(d2, i2, best, bi))) {
          best = d2;
          bi = i2;
        }
      }
      if (in && j == 0) {
        const int k = min(max(bi, 0), a.M - 2);
        const double v = (a.cam_valid[i] && i < n_cam) ? 1.0 : 0.0;
        const double p0t = s_t[k], p0a = s_a[k];
        double u0 = s_t[k + 1] - p0t, u1 = s_a[k + 1] - p0a;
        const double nu = fmax(sqrt(u0 * u0 + u1 * u1), 1e-9);
        u0 = u0 / nu;
        u1 = u1 / nu;
        const double dp0 = tq - p0t, dp1 = (a.a_cam[i] + c) - p0a;
        const double dot = dp0 * u0 + dp1 * u1;
        const double e0 = dp0 - dot * u0, e1 = dp1 - dot * u1;
        const double nr = sqrt(e0 * e0 + e1 * e1);
        s_r[i] = nr * v;
        // d perp / d td = e_t - u0 u, d perp / d c = e_y - u1 u
        s_j0[i] = (e0 * (1.0 - u0 * u0) + e1 * (0.0 - u0 * u1)) / nr * v;
        s_j1[i] = (e0 * (0.0 - u1 * u0) + e1 * (1.0 - u1 * u1)) / nr * v;
      }
    }
    __syncthreads();
    if (tid == 0) {
      if (it < a.iters) {
        double h00 = 0.0, h01 = 0.0, h11 = 0.0, g0 = 0.0, g1 = 0.0;
        for (int i = 0; i < a.C; ++i) {
          const double j0 = s_j0[i], j1 = s_j1[i], r = s_r[i];
          h00 += j0 * j0;
          h01 += j0 * j1;
          h11 += j1 * j1;
          g0 += j0 * r;
          g1 += j1 * r;
        }
        h00 += 1e-9;
        h11 += 1e-9;
        const double det = h00 * h11 - h01 * h01;
        s_x[0] = td - (h11 * g0 - h01 * g1) / det;
        s_x[1] = c - (h00 * g1 - h01 * g0) / det;
      } else {
        double ss = 0.0;
        for (int i = 0; i < a.C; ++i) ss += s_r[i] * s_r[i];
        a.out[0] = td;
        a.out[1] = c;
        a.out[2] = sqrt(ss / (double)a.C);
        if (a.ok) a.ok[0] = (n_cam >= a.min_cam) && isfinite(td);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K24
// ---------------------------------------------------------------------------

constexpr int kEyeThreads = 128;

// eigen-decomposition of a symmetric 4x4 by cyclic Jacobi: A -> diag,
// V's columns the eigenvectors (as csrc/marg.cu's jacobi_eig4)
__device__ void eig4(double (&A)[4][4], double (&V)[4][4]) {
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) V[r][c] = r == c ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = 0.0, tot = 0.0;
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        tot += A[r][c] * A[r][c];
        if (r != c) off += A[r][c] * A[r][c];
      }
    if (!(off > 1e-32 * tot)) break;
    for (int p = 0; p < 3; ++p)
      for (int q = p + 1; q < 4; ++q) {
        const double apq = A[p][q];
        if (apq == 0.0) continue;
        const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
        const double at = fabs(theta);
        double t = at > 1e150 ? 0.5 / at : 1.0 / (at + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 4; ++k) {  // A <- A G (columns p, q)
          const double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 4; ++k) {  // A <- G^T A (rows p, q)
          const double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 4; ++k) {  // V <- V G
          const double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
  }
}

template <typename T>
__device__ void load_quat(const void* p, int k, double (&q)[4]) {
  const T* t = static_cast<const T*>(p) + 4 * k;
  for (int c = 0; c < 4; ++c) q[c] = (double)t[c];
}

template <typename T>
__global__ void __launch_bounds__(kEyeThreads) hand_eye_kernel(HandEyeArgs a) {
  __shared__ double s_m[kEyeThreads][10];
  const int tid = threadIdx.x;
  double acc[10];
  for (int e = 0; e < 10; ++e) acc[e] = 0.0;
  const double thr = 5.0 * (kPi / 180.0);
  for (int k = tid; k < a.K; k += kEyeThreads) {
    double qc[4], qi[4];
    load_quat<T>(a.q_cam, k, qc);
    load_quat<T>(a.q_imu, k, qi);
    // robust weight: the pair's rotation angles agree within 5 degrees, else
    // thr / their difference
    const double ang_c = 2.0 * acos(fmin(fmax(fabs(qc[0]), 0.0), 1.0));
    const double ang_i = 2.0 * acos(fmin(fmax(fabs(qi[0]), 0.0), 1.0));
    const double d = fabs(ang_c - ang_i);
    const double w = (d < thr ? 1.0 : thr / fmax(d, 1e-9)) * (a.valid[k] ? 1.0 : 0.0);
    // B = (L(q_imu) - R(q_cam)) w
    const double L[4][4] = {{qi[0], -qi[1], -qi[2], -qi[3]},
                            {qi[1], qi[0], -qi[3], qi[2]},
                            {qi[2], qi[3], qi[0], -qi[1]},
                            {qi[3], -qi[2], qi[1], qi[0]}};
    const double R[4][4] = {{qc[0], -qc[1], -qc[2], -qc[3]},
                            {qc[1], qc[0], qc[3], -qc[2]},
                            {qc[2], -qc[3], qc[0], qc[1]},
                            {qc[3], qc[2], -qc[1], qc[0]}};
    double B[4][4];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) B[r][c] = (L[r][c] - R[r][c]) * w;
    int e = 0;
    for (int p = 0; p < 4; ++p)
      for (int q = p; q < 4; ++q, ++e) {
        double s = 0.0;
        for (int r = 0; r < 4; ++r) s += B[r][p] * B[r][q];
        acc[e] += s;
      }
  }
  for (int e = 0; e < 10; ++e) s_m[tid][e] = acc[e];
  __syncthreads();
  for (int half = kEyeThreads / 2; half > 0; half >>= 1) {
    if (tid < half)
      for (int e = 0; e < 10; ++e) s_m[tid][e] += s_m[tid + half][e];
    __syncthreads();
  }
  if (tid != 0) return;
  double A[4][4], V[4][4];
  int e = 0;
  for (int p = 0; p < 4; ++p)
    for (int q = p; q < 4; ++q, ++e) A[p][q] = A[q][p] = s_m[0][e];
  eig4(A, V);
  // eigenvalues ascending, the index breaking ties
  int order[4] = {0, 1, 2, 3};
  for (int x = 1; x < 4; ++x)
    for (int y = x; y > 0 && A[order[y]][order[y]] < A[order[y - 1]][order[y - 1]]; --y) {
      const int tmp = order[y];
      order[y] = order[y - 1];
      order[y - 1] = tmp;
    }
  double q[4];
  for (int r = 0; r < 4; ++r) q[r] = V[r][order[0]];
  if (q[0] < 0.0)
    for (int r = 0; r < 4; ++r) q[r] = -q[r];
  const double nq = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const double sig = sqrt(fmax(A[order[1]][order[1]], 0.0));
  T* qo = static_cast<T*>(a.q_out);
  for (int r = 0; r < 4; ++r) qo[r] = (T)(q[r] / nq);
  static_cast<T*>(a.sigma)[0] = (T)sig;
  a.converged[0] = sig > 0.25 && (a.count == nullptr || a.count[0] >= a.min_pairs);
}

}  // namespace

extern "C" int vp_gyro_yaw(const GyroYawArgs* a, cudaStream_t stream) {
  if (a->I < 0 || (a->t_ring != nullptr && a->M < 1)) return (int)cudaErrorInvalidValue;
  gyro_yaw_kernel<<<1, kYawThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int vp_time_offset(const TimeOffsetArgs* a, cudaStream_t stream) {
  if (a->C < 1 || a->M < 2 || a->iters < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * (2 * (size_t)a->M + 3 * (size_t)a->C);
  static size_t allowed = 48 * 1024;  // above it only after the attribute is raised
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        time_offset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  time_offset_kernel<<<1, kTdThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int vp_hand_eye(const HandEyeArgs* a, cudaStream_t stream) {
  if (a->K < 1) return (int)cudaErrorInvalidValue;
  if (a->is_double)
    hand_eye_kernel<double><<<1, kEyeThreads, 0, stream>>>(*a);
  else
    hand_eye_kernel<float><<<1, kEyeThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
