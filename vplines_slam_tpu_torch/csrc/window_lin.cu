// K11 window_lin: the window's whitened residual stack and, per observation,
// the compact block of its Jacobian, by forward-mode jets.
//
// Replaces: vplines_slam_tpu/estimator/window.py:438 window_residuals (the
//   families at :299 imu, :321 points, :353 lines, :379 vps, :408 relo, the
//   prior at :445-447) differentiated by vplines_slam_tpu/solver/lm.py:209
//   _structured_linearize: nd + 1 (+ 4 with lines) jvps of the WHOLE stack.
//   In plain PyTorch that is vmap(jvp) over ~180 tangents of a graph of a few
//   hundred ops: thousands of launches per linearization.
// What each row depends on: a point observation (p, j) on pose i = start[p]
//   and pose j (p, theta: 6 + 6), the extrinsic (6) and its inverse depth
//   (19 tangents); a relo row on pose i, the relo pose, the extrinsic and
//   the depth (19); a line or VP observation on pose j, the extrinsic and
//   the line's 4 orth coordinates (16); an IMU interval on frames k and k+1
//   (15 + 15).
// Semantics kept from the reference:
//   - the jets are seeded THROUGH the retraction at delta = 0, as retract_all:
//     p + dp, normalize(q (x) exp(dtheta)), orth_boxplus for lines; the
//     residual-only mode (the LM's cost pass) evaluates at x itself, as
//     window_residuals(x);
//   - the Huber weight multiplies the row but is not differentiated (the
//     reference's stop_gradient);
//   - a row that is invalid or not finite gets r = 0 and zero tangents;
//   - prior rows: dx = x [-] x_prior with the 3x3 jet blocks D of its
//     quaternion parts; r = valid ? r0 + J dx : 0, rows of J D.  r0 + J dx
//     is summed in f64: its terms are whitened (up to ~1e4) and cancel, so an
//     f32 sum in any order is off by ~1e-4 of the largest row.
// Design: ONE launch, a grid of four block ranges that run side by side:
//   - prior: each CTA recomputes dx and D (nf + 2 quaternion logs on 3-tangent
//     jets) into shared memory, then a warp per prior row sums r0 + J dx (a
//     fixed shuffle tree in f64) and writes the row of J D;
//   - IMU: a warp per interval, a lane per tangent (30 of 32 busy);
//   - points + relo: 4 lanes per observation, 5 tangents each (f64: 8, 3);
//   - lines + VPs: 4 lanes per observation, 4 tangents each (f64: 8, 2).
//   Forward-mode tangents are independent (tangent k of a product depends
//   only on tangent k of its factors), so each lane evaluates the residual
//   on Jet<T, N>, the value and its own slice of N tangents: every lane
//   computes the same value, and each tangent the same arithmetic as a jet of
//   all of them.  Short jets keep the registers low (no spill); the residual
//   is recomputed per lane instead.  The residual-only mode runs the same
//   grid with one lane per item and no tangents.
// Bound on the H100: operations, a few MFLOP per call (e.g. 1,408 point
//   observations x ~6,000 jet FLOP): microseconds; the kernel is the chain of
//   one lane's dependent jet arithmetic, so it is latency-bound by design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// arguments (one struct, mirrored by the ctypes Structure in the wrapper)
// ---------------------------------------------------------------------------

struct VpLinArgs {
  // state x = (state, inv_depth[, orth])
  const void *p, *q, *v, *ba, *bg, *p_ic, *q_ic, *p_relo, *q_relo, *inv_depth, *orth;
  // prior and its linearization state
  const void *prior_J, *prior_r0;
  const uint8_t* prior_valid;
  const void *ps_p, *ps_q, *ps_v, *ps_ba, *ps_bg, *ps_p_ic, *ps_q_ic, *ps_p_relo, *ps_q_relo;
  // IMU intervals
  const void *pre_dp, *pre_dq, *pre_dv, *pre_J, *pre_sum_dt, *pre_lba, *pre_lbg, *imu_sqrt;
  const uint8_t* imu_valid;
  const void* g;
  // point tracks and relocalization
  const int64_t* pt_id;
  const void* pt_obs;
  const uint8_t* pt_mask;
  const int64_t* pt_start;
  const uint8_t* pt_solved;
  const void* relo_obs;
  const uint8_t *relo_mask, *relo_valid;
  // lines
  const int64_t* ln_id;
  const void *ln_obs, *ln_vp;
  const uint8_t *ln_mask, *ln_vp_mask, *ln_solved;
  // outputs: r [R], prior rows' J D [nd, nd], J_imu [nf-1, 15, 30],
  // J_pt [P, nf, 2, 19], J_relo [P, 2, 19], J_ln / J_vp [L, nf, 2, 16]
  void *r, *J_prior, *J_imu, *J_pt, *J_relo, *J_ln, *J_vp;
  int nf, P, L, use_relo, use_lines, use_vps, with_j, line_min_obs;
  int off_imu, off_pt, off_ln, off_vp, off_relo, is_double;
  double point_sqrt_info, line_sqrt_info, vp_sqrt_info, huber_delta;
};

namespace {

constexpr int NT = 128;  // threads a CTA
constexpr int WARPS = NT / 32;

// lanes per item and tangents per lane of each family (f64 jets take twice
// the registers, so their observations split over twice the lanes); the
// residual-only mode takes one lane per item and no tangents
template <typename T, bool WITH_J>
struct Split {
  static constexpr bool D = sizeof(T) == 8;
  static constexpr int IMU = WITH_J ? 32 : 1, MI = WITH_J ? 1 : 0;
  static constexpr int PT = WITH_J ? (D ? 8 : 4) : 1, MP = WITH_J ? (D ? 3 : 5) : 0;
  static constexpr int LN = WITH_J ? (D ? 8 : 4) : 1, ML = WITH_J ? (D ? 2 : 4) : 0;
  static constexpr int NQ = WITH_J ? 3 : 0;  // the prior's quaternion-log jets
};

struct LinPlan {
  int nb_prior, nb_imu, nb_pts, nb_lns, grid;
};

template <typename T, bool WITH_J>
__host__ __device__ inline LinPlan lin_plan(const VpLinArgs& a) {
  using S = Split<T, WITH_J>;
  const int nf = a.nf, nd = 15 * nf + 12;
  const int n_pts = a.P * nf + (a.use_relo ? a.P : 0);
  const int n_lns = a.use_lines ? a.L * nf * (a.use_vps ? 2 : 1) : 0;
  LinPlan p;
  p.nb_prior = (nd + WARPS - 1) / WARPS;  // a warp per row
  p.nb_imu = nf > 1 ? ((nf - 1) * S::IMU + NT - 1) / NT : 0;
  p.nb_pts = (n_pts * S::PT + NT - 1) / NT;
  p.nb_lns = (n_lns * S::LN + NT - 1) / NT;
  p.grid = p.nb_prior + p.nb_imu + p.nb_pts + p.nb_lns;
  return p;
}

// the jet type, its arithmetic and the vector/quaternion helpers of jets are
// in common.cuh (shared with K21 pnp_refine)
// quat_log
JET_T __device__ __forceinline__ V3N quat_log(Q4N q) {
  if (q.w.a < T(0)) q = {-q.w, -q.x, -q.y, -q.z};
  const JN w = jclamp(q.w, T(-1), T(1));
  const JN vn = jsqrt(q.x * q.x + q.y * q.y + q.z * q.z);
  JN scale;
  if (vn.a < T(1e-12)) {
    scale = T(2) / jclamp_min(w, T(1e-6));
  } else {
    scale = T(2) * jatan2(vn, w) / vn;
  }
  return {scale * q.x, scale * q.y, scale * q.z};
}

// pose (p, q) of a frame, seeded through the retraction p + dp,
// normalize(q (x) exp(dtheta)) with tangents k0..k0+5; RETRACT false (the
// cost pass) evaluates at (p, q) itself
template <typename T, int N, bool RETRACT>
__device__ __forceinline__ void pose_jet(const T* p, const T* q, int k0, V3N& pj, Q4N& qj) {
  pj = {seed<T, N>(p[0], k0), seed<T, N>(p[1], k0 + 1), seed<T, N>(p[2], k0 + 2)};
  if (RETRACT) {
    const V3N th = {seed<T, N>(T(0), k0 + 3), seed<T, N>(T(0), k0 + 4),
                    seed<T, N>(T(0), k0 + 5)};
    qj = qnormalize(qmul(qconst<T, N>(q), so3_exp(th)));
  } else {
    qj = qconst<T, N>(q);
  }
}

// _robust: whiten, zero a non-finite component or an invalid row (value and
// tangents), then the Huber weight of the values, held constant
JET_T __device__ __forceinline__ void robust(JN& r0, JN& r1, bool valid, double sqrt_info,
                                             double huber) {
  const T si = T(sqrt_info);
  r0 = r0 * si;
  r1 = r1 * si;
  if (!(valid && m_finite(r0.a))) r0 = cst<T, N>(T(0));
  if (!(valid && m_finite(r1.a))) r1 = cst<T, N>(T(0));
  const T rsq = r0.a * r0.a + r1.a * r1.a;
  const T d = T(huber);
  T w = T(1);
  if (!(rsq <= d * d)) w = d / m_sqrt(rsq > T(1e-30) ? rsq : T(1e-30));
  w = m_sqrt(w);
  r0 = r0 * w;
  r1 = r1 * w;
}

// one residual row: the value (from the item's first lane) and this lane's
// tangents t0.. of the row's ntan
JET_T __device__ __forceinline__ void store_row(const JN& x, int sub, int t0, int ntan, T* r_out,
                                                T* j_out) {
  if (sub == 0) *r_out = x.a;
  if (j_out == nullptr) return;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (t0 + k < ntan) j_out[t0 + k] = x.v[k];
}

// ---------------------------------------------------------------------------
// prior: dx = x [-] x_prior and the jet blocks D, then the prior rows
// ---------------------------------------------------------------------------

// quaternion block of a dense column c: node n and component b, or n = -1
__device__ __forceinline__ int quat_block(int c, int nf, int& b) {
  int n = -1, o;
  if (c < 15 * nf) {
    n = c / 15, o = c % 15;
  } else if (c < 15 * nf + 6) {
    n = nf, o = c - 15 * nf;
  } else {
    n = nf + 1, o = c - 15 * nf - 6;
  }
  b = o - 3;
  return (o >= 3 && o < 6) ? n : -1;
}

template <typename T, int N>
__device__ void prior_role(const VpLinArgs& a, int blk, int nblk) {
  constexpr bool RETRACT = N > 0;
  const int nf = a.nf, nd = 15 * nf + 12, nodes = nf + 2;
  VP_DYN_SMEM(T, sm);
  T* dx = sm;        // [nd]
  T* Dq = sm + nd;   // [nf + 2, 3, 3]
  for (int n = threadIdx.x; n < nodes; n += NT) {
    const T *p, *q, *p0, *q0;
    int base;
    if (n < nf) {
      p = (const T*)a.p + 3 * n, q = (const T*)a.q + 4 * n;
      p0 = (const T*)a.ps_p + 3 * n, q0 = (const T*)a.ps_q + 4 * n;
      base = 15 * n;
    } else if (n == nf) {
      p = (const T*)a.p_ic, q = (const T*)a.q_ic, p0 = (const T*)a.ps_p_ic,
      q0 = (const T*)a.ps_q_ic;
      base = 15 * nf;
    } else {
      p = (const T*)a.p_relo, q = (const T*)a.q_relo, p0 = (const T*)a.ps_p_relo,
      q0 = (const T*)a.ps_q_relo;
      base = 15 * nf + 6;
    }
    for (int d = 0; d < 3; ++d) dx[base + d] = p[d] - p0[d];
    V3N pj;
    Q4N qj;
    pose_jet<T, N, RETRACT>(p, q, -3, pj, qj);  // tangents 0..2: dtheta
    const V3N th = quat_log(qmul(qconj(qconst<T, N>(q0)), qj));
    const JN c[3] = {th.x, th.y, th.z};
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      dx[base + 3 + b] = c[b].a;
      if constexpr (N == 3) {
#pragma unroll
        for (int k = 0; k < 3; ++k) Dq[(n * 3 + b) * 3 + k] = c[b].v[k];
      }
    }
    if (n < nf) {
      const T* vs[3] = {(const T*)a.v, (const T*)a.ba, (const T*)a.bg};
      const T* v0[3] = {(const T*)a.ps_v, (const T*)a.ps_ba, (const T*)a.ps_bg};
      for (int f = 0; f < 3; ++f)
        for (int d = 0; d < 3; ++d) dx[base + 6 + 3 * f + d] = vs[f][3 * n + d] - v0[f][3 * n + d];
    }
  }
  __syncthreads();
  const bool valid = a.prior_valid[0] != 0;
  const T* J = (const T*)a.prior_J;
  const int lane = threadIdx.x & 31;
  for (int row = blk * WARPS + (threadIdx.x >> 5); row < nd; row += nblk * WARPS) {
    const T* Jr = J + (size_t)row * nd;
    double acc = 0.0;  // r0 + J dx in f64 (the terms cancel): a lane's strided sum, then a tree
    for (int k = lane; k < nd; k += 32) acc += (double)Jr[k] * (double)dx[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += VP_SHFL_XOR(acc, o);
    if (lane == 0) ((T*)a.r)[row] = valid ? (T)((double)((const T*)a.prior_r0)[row] + acc) : T(0);
    if (N > 0) {
      T* out = (T*)a.J_prior + (size_t)row * nd;
      for (int c = lane; c < nd; c += 32) {
        int b;
        const int n = quat_block(c, nf, b);
        T val = Jr[c];
        if (n >= 0) {
          const int q0 = c - b;  // first dense column of the block
          val = Jr[q0] * Dq[(n * 3 + 0) * 3 + b] + Jr[q0 + 1] * Dq[(n * 3 + 1) * 3 + b] +
                Jr[q0 + 2] * Dq[(n * 3 + 2) * 3 + b];
        }
        out[c] = valid ? val : T(0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// IMU intervals: models/imu.evaluate, whitened by imu_sqrt, times imu_valid;
// LANES lanes an interval, each with N of its 30 tangents
// ---------------------------------------------------------------------------

template <typename T, int N, int LANES>
__device__ void imu_role(const VpLinArgs& a, int blk) {
  constexpr bool RETRACT = N > 0;
  const int nf = a.nf, gt = blk * NT + threadIdx.x;
  const int k = gt / LANES, sub = gt % LANES, t0 = sub * N;
  if (k >= nf - 1) return;
  V3N P[2], V[2], Ba[2], Bg[2];
  Q4N Qf[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int f = k + s, k0 = 15 * s - t0;
    pose_jet<T, N, RETRACT>((const T*)a.p + 3 * f, (const T*)a.q + 4 * f, k0, P[s], Qf[s]);
    const T* vv = (const T*)a.v + 3 * f;
    const T* aa = (const T*)a.ba + 3 * f;
    const T* gg = (const T*)a.bg + 3 * f;
    V[s] = {seed<T, N>(vv[0], k0 + 6), seed<T, N>(vv[1], k0 + 7), seed<T, N>(vv[2], k0 + 8)};
    Ba[s] = {seed<T, N>(aa[0], k0 + 9), seed<T, N>(aa[1], k0 + 10),
             seed<T, N>(aa[2], k0 + 11)};
    Bg[s] = {seed<T, N>(gg[0], k0 + 12), seed<T, N>(gg[1], k0 + 13),
             seed<T, N>(gg[2], k0 + 14)};
  }
  const T* Jp = (const T*)a.pre_J + (size_t)k * 225;
  const T* lba = (const T*)a.pre_lba + 3 * k;
  const T* lbg = (const T*)a.pre_lbg + 3 * k;
  const V3N dba = vsub(Ba[0], vconst<T, N>(lba));
  const V3N dbg = vsub(Bg[0], vconst<T, N>(lbg));
  // mv(M, x) over the 3x3 block of the jacobian at (r0, c0)
  auto mv = [&](int r0, int c0, const V3N& x) -> V3N {
    const T* M = Jp + r0 * 15 + c0;
    return {M[0] * x.x + M[1] * x.y + M[2] * x.z,
            M[15] * x.x + M[16] * x.y + M[17] * x.z,
            M[30] * x.x + M[31] * x.y + M[32] * x.z};
  };
  const V3N th = mv(3, 12, dbg);
  const T h = T(0.5);
  const Q4N dq_bg = {cst<T, N>(T(1)), th.x * h, th.y * h, th.z * h};  // delta_quat
  const Q4N corr_q = qmul(qconst<T, N>((const T*)a.pre_dq + 4 * k), dq_bg);
  const V3N corr_v = vadd(vadd(vconst<T, N>((const T*)a.pre_dv + 3 * k), mv(6, 9, dba)),
                          mv(6, 12, dbg));
  const V3N corr_p = vadd(vadd(vconst<T, N>((const T*)a.pre_dp + 3 * k), mv(0, 9, dba)),
                          mv(0, 12, dbg));
  const T* g = (const T*)a.g;
  const T dt = ((const T*)a.pre_sum_dt)[k];
  const Q4N qi_inv = qconj(Qf[0]);
  const T hdt2[3] = {h * g[0] * dt * dt, h * g[1] * dt * dt, h * g[2] * dt * dt};
  // 0.5 g dt^2 + Pj - Pi - Vi dt
  const V3N dp_w = {((hdt2[0] + P[1].x) - P[0].x) - V[0].x * dt,
                    ((hdt2[1] + P[1].y) - P[0].y) - V[0].y * dt,
                    ((hdt2[2] + P[1].z) - P[0].z) - V[0].z * dt};
  const V3N r_p = vsub(qrot(qi_inv, dp_w), corr_p);
  const Q4N rq = qmul(qconj(corr_q), qmul(qi_inv, Qf[1]));
  const V3N dv_w = {(g[0] * dt + V[1].x) - V[0].x, (g[1] * dt + V[1].y) - V[0].y,
                    (g[2] * dt + V[1].z) - V[0].z};
  const V3N r_v = vsub(qrot(qi_inv, dv_w), corr_v);
  const JN res[15] = {r_p.x, r_p.y, r_p.z, T(2) * rq.x, T(2) * rq.y, T(2) * rq.z,
                      r_v.x, r_v.y, r_v.z, Ba[1].x - Ba[0].x, Ba[1].y - Ba[0].y,
                      Ba[1].z - Ba[0].z, Bg[1].x - Bg[0].x, Bg[1].y - Bg[0].y,
                      Bg[1].z - Bg[0].z};
  const T* Sq = (const T*)a.imu_sqrt + (size_t)k * 225;
  const T valid = a.imu_valid[k] ? T(1) : T(0);
  T* r_out = (T*)a.r + a.off_imu + 15 * k;
  T* j_out = N > 0 ? (T*)a.J_imu + (size_t)k * 15 * 30 : nullptr;
#pragma unroll
  for (int m = 0; m < 15; ++m) {
    JN acc = Sq[m * 15] * res[0];
#pragma unroll
    for (int c = 1; c < 15; ++c) acc = acc + Sq[m * 15 + c] * res[c];
    acc = acc * valid;
    store_row<T, N>(acc, sub, t0, 30, r_out + m, j_out ? j_out + m * 30 : nullptr);
  }
}

// ---------------------------------------------------------------------------
// points and relocalization: factors/residuals.point_reprojection; LANES
// lanes an observation, each with N of its 19 tangents
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void tangent_basis(const T* ray, T* b1, T* b2) {
  const T n = m_sqrt(ray[0] * ray[0] + ray[1] * ray[1] + ray[2] * ray[2]);
  const T a0 = ray[0] / n, a1 = ray[1] / n, a2 = ray[2] / n;
  const bool use_z = (a2 < T(0) ? -a2 : a2) < T(0.9);
  const T t0 = use_z ? T(0) : T(1), t1 = T(0), t2 = use_z ? T(1) : T(0);
  const T d = a0 * t0 + a1 * t1 + a2 * t2;
  T c0 = t0 - a0 * d, c1 = t1 - a1 * d, c2 = t2 - a2 * d;
  const T cn = m_sqrt(c0 * c0 + c1 * c1 + c2 * c2);
  c0 = c0 / cn, c1 = c1 / cn, c2 = c2 / cn;
  b1[0] = c0, b1[1] = c1, b1[2] = c2;
  b2[0] = a1 * c2 - a2 * c1, b2[1] = a2 * c0 - a0 * c2, b2[2] = a0 * c1 - a1 * c0;
}

// (tangents: pose i 0..5, pose j 6..11, extrinsic 12..17, inverse depth 18)
template <typename T, int N>
__device__ __forceinline__ void point_residual(const V3N& p_i, const Q4N& q_i, const V3N& p_j,
                                               const Q4N& q_j, const V3N& p_ic, const Q4N& q_ic,
                                               const JN& rho, const T* obs_i, const T* obs_j,
                                               JN& r0, JN& r1) {
  const T pi[3] = {obs_i[0] / obs_i[2], obs_i[1] / obs_i[2], obs_i[2] / obs_i[2]};
  const V3N pc = {pi[0] / rho, pi[1] / rho, pi[2] / rho};
  const V3N pb = vadd(qrot(q_ic, pc), p_ic);
  const V3N pw = vadd(qrot(q_i, pb), p_i);
  const V3N pbj = qrot(qconj(q_j), vsub(pw, p_j));
  const V3N pcj = qrot(qconj(q_ic), vsub(pbj, p_ic));
  T b1[3], b2[3];
  tangent_basis(obs_j, b1, b2);
  const V3N d = vdiv(pcj, vnorm(pcj));
  const T on = m_sqrt(obs_j[0] * obs_j[0] + obs_j[1] * obs_j[1] + obs_j[2] * obs_j[2]);
  const V3N e = {d.x - obs_j[0] / on, d.y - obs_j[1] / on, d.z - obs_j[2] / on};
  r0 = (b1[0] * e.x + b1[1] * e.y) + b1[2] * e.z;
  r1 = (b2[0] * e.x + b2[1] * e.y) + b2[2] * e.z;
}

template <typename T, int N, int LANES>
__device__ void points_role(const VpLinArgs& a, int blk) {
  constexpr bool RETRACT = N > 0;
  const int nf = a.nf, P = a.P;
  const int n_obs = P * nf, n_all = n_obs + (a.use_relo ? P : 0);
  const int gt = blk * NT + threadIdx.x;
  const int idx = gt / LANES, sub = gt % LANES, t0 = sub * N;
  if (idx >= n_all) return;
  const bool relo = idx >= n_obs;
  const int p = relo ? idx - n_obs : idx / nf;
  const int j = relo ? 0 : idx % nf;
  const int i = (int)a.pt_start[p];
  bool valid = a.pt_id[p] >= 0 && a.pt_solved[p] != 0;
  if (relo)
    valid = valid && a.relo_valid[0] != 0 && a.relo_mask[p] != 0;
  else
    valid = valid && a.pt_mask[p * nf + j] != 0 && j != i;
  V3N p_i, p_j, p_ic;
  Q4N q_i, q_j, q_ic;
  pose_jet<T, N, RETRACT>((const T*)a.p + 3 * i, (const T*)a.q + 4 * i, -t0, p_i, q_i);
  if (relo)
    pose_jet<T, N, RETRACT>((const T*)a.p_relo, (const T*)a.q_relo, 6 - t0, p_j, q_j);
  else
    pose_jet<T, N, RETRACT>((const T*)a.p + 3 * j, (const T*)a.q + 4 * j, 6 - t0, p_j, q_j);
  pose_jet<T, N, RETRACT>((const T*)a.p_ic, (const T*)a.q_ic, 12 - t0, p_ic, q_ic);
  const JN rho = seed<T, N>(((const T*)a.inv_depth)[p], 18 - t0);
  const T* obs = (const T*)a.pt_obs;
  const T* obs_j = relo ? (const T*)a.relo_obs + 3 * p : obs + (size_t)(p * nf + j) * 3;
  JN r0, r1;
  point_residual<T, N>(p_i, q_i, p_j, q_j, p_ic, q_ic, rho, obs + (size_t)(p * nf + i) * 3,
                       obs_j, r0, r1);
  robust<T, N>(r0, r1, valid, a.point_sqrt_info, a.huber_delta);
  const int row = relo ? a.off_relo + 2 * p : a.off_pt + 2 * (p * nf + j);
  T* jb = nullptr;
  if (N > 0)
    jb = relo ? (T*)a.J_relo + (size_t)p * 2 * 19 : (T*)a.J_pt + (size_t)(p * nf + j) * 2 * 19;
  store_row<T, N>(r0, sub, t0, 19, (T*)a.r + row, jb);
  store_row<T, N>(r1, sub, t0, 19, (T*)a.r + row + 1, jb ? jb + 19 : nullptr);
}

// ---------------------------------------------------------------------------
// lines and VPs: line_reprojection / vp_alignment through utils/plucker
// (tangents: pose j 0..5, extrinsic 6..11, orth 12..15); LANES lanes an
// observation, each with N of its 16 tangents
// ---------------------------------------------------------------------------


// R = Rz(th3) Ry(th2) Rx(th1), line_geometry.cpp:99
JET_T __device__ __forceinline__ void euler_zyx(const JN& t1, const JN& t2, const JN& t3,
                                                JN (&R)[3][3]) {
  const JN s1 = jsin(t1), c1 = jcos(t1), s2 = jsin(t2), c2 = jcos(t2), s3 = jsin(t3),
           c3 = jcos(t3);
  R[0][0] = c2 * c3;
  R[0][1] = s1 * s2 * c3 - c1 * s3;
  R[0][2] = c1 * s2 * c3 + s1 * s3;
  R[1][0] = c2 * s3;
  R[1][1] = s1 * s2 * s3 + c1 * c3;
  R[1][2] = c1 * s2 * s3 - s1 * c3;
  R[2][0] = -s2;
  R[2][1] = s1 * c2;
  R[2][2] = c1 * c2;
}

// plk_transform(plk, R^T, -rot(conj(q), p)) with R = quat_to_rot(q): world
// (or body) line -> the frame of pose (p, q)
JET_T __device__ __forceinline__ void plk_to_frame(const JN (&n)[3], const JN (&v)[3],
                                                   const V3N& p, const Q4N& q, JN (&nc)[3],
                                                   JN (&vc)[3]) {
  JN R[3][3];
  qtorot(q, R);
  const V3N t = vneg(qrot(qconj(q), p));
  JN Rn[3];
  for (int r = 0; r < 3; ++r) {  // (R^T)[r][c] = R[c][r]
    vc[r] = R[0][r] * v[0] + R[1][r] * v[1] + R[2][r] * v[2];
    Rn[r] = R[0][r] * n[0] + R[1][r] * n[1] + R[2][r] * n[2];
  }
  nc[0] = Rn[0] + (t.y * vc[2] - t.z * vc[1]);
  nc[1] = Rn[1] + (t.z * vc[0] - t.x * vc[2]);
  nc[2] = Rn[2] + (t.x * vc[1] - t.y * vc[0]);
}

template <typename T, int N, int LANES>
__device__ void lines_role(const VpLinArgs& a, int blk) {
  constexpr bool RETRACT = N > 0;
  const int nf = a.nf, L = a.L;
  const int n_obs = L * nf, n_all = n_obs * (a.use_vps ? 2 : 1);
  const int gt = blk * NT + threadIdx.x;
  const int idx = gt / LANES, sub = gt % LANES, t0 = sub * N;
  if (idx >= n_all) return;
  const bool is_vp = idx >= n_obs;
  const int o = is_vp ? idx - n_obs : idx;
  const int l = o / nf, j = o % nf;
  int n_seen = 0;
  for (int f = 0; f < nf; ++f) n_seen += a.ln_mask[l * nf + f] != 0;
  bool valid = a.ln_id[l] >= 0 && a.ln_solved[l] != 0 && n_seen >= a.line_min_obs &&
               a.ln_mask[l * nf + j] != 0;
  if (is_vp) valid = valid && a.ln_vp_mask[l * nf + j] != 0;
  V3N p_j, p_ic;
  Q4N q_j, q_ic;
  pose_jet<T, N, RETRACT>((const T*)a.p + 3 * j, (const T*)a.q + 4 * j, -t0, p_j, q_j);
  pose_jet<T, N, RETRACT>((const T*)a.p_ic, (const T*)a.q_ic, 6 - t0, p_ic, q_ic);
  const T* orth = (const T*)a.orth + 4 * l;
  JN th1, th2, th3, phi;
  if (RETRACT) {  // orth_boxplus(orth, delta) at delta = 0
    JN R[3][3], E[3][3];
    euler_zyx(cst<T, N>(orth[0]), cst<T, N>(orth[1]), cst<T, N>(orth[2]), R);
    const V3N d = {seed<T, N>(T(0), 12 - t0), seed<T, N>(T(0), 13 - t0),
                   seed<T, N>(T(0), 14 - t0)};
    qtorot(so3_exp(d), E);
    auto rn = [&](int r, int c) { return R[r][0] * E[0][c] + R[r][1] * E[1][c] + R[r][2] * E[2][c]; };
    th1 = jatan2(rn(2, 1), rn(2, 2));
    th2 = jasin(jclamp(-rn(2, 0), T(-1), T(1)));
    th3 = jatan2(rn(1, 0), rn(0, 0));
    phi = seed<T, N>(orth[3], 15 - t0);
  } else {
    th1 = cst<T, N>(orth[0]), th2 = cst<T, N>(orth[1]), th3 = cst<T, N>(orth[2]);
    phi = cst<T, N>(orth[3]);
  }
  // orth_to_plk: n = cos(phi) U[:, 0], v = sin(phi) U[:, 1]
  JN U[3][3];
  euler_zyx(th1, th2, th3, U);
  const JN cp = jcos(phi), sp = jsin(phi);
  const JN nw[3] = {cp * U[0][0], cp * U[1][0], cp * U[2][0]};
  const JN vw[3] = {sp * U[0][1], sp * U[1][1], sp * U[2][1]};
  JN nb[3], vb[3], nc[3], vc[3];
  plk_to_frame(nw, vw, p_j, q_j, nb, vb);
  plk_to_frame(nb, vb, p_ic, q_ic, nc, vc);
  JN r0, r1;
  if (!is_vp) {  // endpoint distances to the projected line
    const T* ob = (const T*)a.ln_obs + (size_t)(l * nf + j) * 4;
    const JN den = jsqrt(jclamp_min(nc[0] * nc[0] + nc[1] * nc[1], T(1e-18)));
    r0 = (ob[0] * nc[0] + ob[1] * nc[1] + nc[2]) / den;
    r1 = (ob[2] * nc[0] + ob[3] * nc[1] + nc[2]) / den;
  } else {  // projected direction against the observed VP
    const T* vp = (const T*)a.ln_vp + (size_t)(l * nf + j) * 3;
    const T tiny = T(1e-9);
    const JN dz = ((vc[2].a < T(0) ? -vc[2].a : vc[2].a) < tiny) ? cst<T, N>(tiny) : vc[2];
    const T vz = ((vp[2] < T(0) ? -vp[2] : vp[2]) < tiny) ? tiny : vp[2];
    r0 = vc[0] / dz - vp[0] / vz;
    r1 = vc[1] / dz - vp[1] / vz;
  }
  robust<T, N>(r0, r1, valid, is_vp ? a.vp_sqrt_info : a.line_sqrt_info, a.huber_delta);
  const int row = (is_vp ? a.off_vp : a.off_ln) + 2 * o;
  T* jb = N > 0 ? (T*)(is_vp ? a.J_vp : a.J_ln) + (size_t)o * 2 * 16 : nullptr;
  store_row<T, N>(r0, sub, t0, 16, (T*)a.r + row, jb);
  store_row<T, N>(r1, sub, t0, 16, (T*)a.r + row + 1, jb ? jb + 16 : nullptr);
}

// ---------------------------------------------------------------------------
// the one kernel: block ranges prior | IMU | points + relo | lines + VPs
// ---------------------------------------------------------------------------

template <typename T, bool WITH_J>
__global__ void __launch_bounds__(NT) wlin_kernel(VpLinArgs a) {
  using S = Split<T, WITH_J>;
  const LinPlan pl = lin_plan<T, WITH_J>(a);
  int b = blockIdx.x;
  if (b < pl.nb_prior) return prior_role<T, S::NQ>(a, b, pl.nb_prior);
  b -= pl.nb_prior;
  if (b < pl.nb_imu) return imu_role<T, S::MI, S::IMU>(a, b);
  b -= pl.nb_imu;
  if (b < pl.nb_pts) return points_role<T, S::MP, S::PT>(a, b);
  lines_role<T, S::ML, S::LN>(a, b - pl.nb_pts);
}

template <typename T, bool WITH_J>
int launch(const VpLinArgs& a, cudaStream_t stream) {
  const LinPlan pl = lin_plan<T, WITH_J>(a);
  const size_t smem = sizeof(T) * (size_t)(15 * a.nf + 12 + 9 * (a.nf + 2));  // dx, D
  auto* k = &wlin_kernel<T, WITH_J>;
  VP_LAUNCH(k, pl.grid, NT, smem, stream, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vp_window_lin(const VpLinArgs* a, cudaStream_t stream) {
  if (a->is_double)
    return a->with_j ? launch<double, true>(*a, stream) : launch<double, false>(*a, stream);
  return a->with_j ? launch<float, true>(*a, stream) : launch<float, false>(*a, stream);
}
