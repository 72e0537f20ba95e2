// K20 selector: the attention feature selector's information matrices and
// its greedy log-det pass, f64 throughout.
//
// Replaces: vplines_slam_tpu/models/selector.py:135 feature_information
//   (a vmap over candidates of a vmap over the 5 horizon states, then an
//   einsum and 25 block writes into a dense [45, 45] per candidate) and
//   :210 select_features (a lax.scan of max_features rounds, each a batched
//   45x45 slogdet of every candidate's Omega + Omega_f[i] + 1e-9 I, a masked
//   argmax and the update; here the same gains in the 12-dim Schur form).
// Bound on the H100: selector_info by bytes, its [N, 45, 45] f64 output
//   (2.4 MB at N = 150); selector_greedy by operations: one elimination of
//   the 33 columns off the support (~60 kFLOP) and ~n^3 / 3 f64 FLOP per
//   12x12 LU (~1.3 kFLOP) for the base and every live candidate a round,
//   but each round is a chain of 12 dependent pivot steps and the rounds
//   are sequential through the argmax, so latency sets the time.
// Design:
//   - selector_info: a CTA of four warps per candidate.  Warp 0 does the
//     candidate's geometry, four lanes per horizon state, each with the
//     state's camera point, its inputs loaded up front in one trip to
//     memory: three take a component of the bearing u, the fourth the
//     visibility, so that no lane runs more than one division after the
//     square root, and three write a row of the bearing factor C_k = B^T B
//     (B = [u]x R_cw); then a lane per entry the sum of the C_k and, each
//     lane with all nine cofactors, its entry of the adjugate and of W =
//     (sum C + 1e-9 I)^-1 (nine divisions at once).  Meanwhile warps 1-3
//     write every entry off the position blocks (0; 1,881 of the 2,025 at 5
//     states), two a 16-byte store where the candidate's block is 16-byte
//     aligned, stepping (row, column) along without a division per entry.
//     After one barrier the CTA writes the position blocks, C_i - C_i W C_i^T
//     and -C_i W C_j^T (each entry forming its row of C_i W), or 0 for a
//     candidate seen by fewer than 2 states.  Each product and sum is rounded
//     on its own (__dmul_rn / __dadd_rn) in the order of the previous kernel
//     (one thread a state, one thread's adjugate, C_k W) and of the plain
//     twin, feature_information_plain, so the output is the previous
//     kernel's to the bit.  That kernel spent ~58% of its 12.6k cycles
//     writing the 2,025 entries with 64 threads, each with a division by the
//     run-time size, ~22% in one state's geometry and ~16% in one thread's
//     adjugate (clock64() stamps); now the geometry is the critical path.
//   - selector_greedy: one launch of a cluster of 16 CTAs for the whole
//     pass, no host sync.  Every F_i is zero off the support S (the
//     position rows and columns of the states that can see a candidate: 12
//     of the 45), so with Omega' = Omega + 1e-9 I and N the other indices,
//     det(Omega' + F_i) = det(Omega'_NN) det(Sigma + F_i,SS), Sigma =
//     Omega'_SS - Omega'_SN Omega'_NN^-1 Omega'_NS.  Each CTA forms Sigma
//     once in shared memory (the twin's LU on [N, S]-ordered Omega' over
//     the N columns, pivots from the N rows); then per round it factors the
//     base Sigma and its share of the live candidates' Sigma + F_SS[i]
//     (candidate i on CTA i % 16) by the twin's LU, 16 lanes a matrix with
//     a row in each lane's registers: partial pivoting with the first
//     largest |pivot| (an integer max over |x|'s bits, ties to the smaller
//     position, each lane tracking its row's position so a swap moves no
//     data), the pivot row by shuffles, multipliers times the pivot's
//     reciprocal (computed as soon as the entry is final, off the search),
//     each product and difference rounded on its own, the logs summed in
//     pivot order.  Each CTA takes its best gain, and after one cluster
//     barrier every CTA reads the 16 bests through distributed shared
//     memory and takes the same first best, so each adds F_SS[best] to its
//     own Sigma with no second exchange.  A round that selects nothing ends
//     the pass (every later round would be identical); candidates off the
//     mask or selected are not factored.  The support is the caller's: with
//     all 45 indices the same kernel runs the dense case (a warp a 45x45
//     matrix in shared memory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kMaxStates = 8;
constexpr int kInfoThreads = 128;
constexpr size_t kSmemLimit = 232448;  // a CTA's shared memory on the H100
constexpr int kMaxThreads = 512;       // selector_greedy's CTA (its launch bounds)

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// torch.linalg.cross
__device__ __forceinline__ void cross3(const double* a, const double* b, double* c) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}
// utils/geometry.quat_rotate: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ void qrot(const double* q, const double* v, double* out) {
  double uv[3], c[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, c);
  for (int i = 0; i < 3; ++i) out[i] = add(v[i], mul(2.0, add(mul(q[0], uv[i]), c[i])));
}
// quat_mul (Hamilton), summed left to right
__device__ __forceinline__ void qmul4(const double* q, const double* p, double* o) {
  o[0] = sub(sub(sub(mul(q[0], p[0]), mul(q[1], p[1])), mul(q[2], p[2])), mul(q[3], p[3]));
  o[1] = sub(add(add(mul(q[0], p[1]), mul(q[1], p[0])), mul(q[2], p[3])), mul(q[3], p[2]));
  o[2] = add(add(sub(mul(q[0], p[2]), mul(q[1], p[3])), mul(q[2], p[0])), mul(q[3], p[1]));
  o[3] = add(sub(add(mul(q[0], p[3]), mul(q[1], p[2])), mul(q[2], p[1])), mul(q[3], p[0]));
}
// quat_to_rot
__device__ __forceinline__ void q2r(const double* q, double* R) {
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = sub(1.0, mul(2.0, add(mul(y, y), mul(z, z))));
  R[1] = mul(2.0, sub(mul(x, y), mul(w, z)));
  R[2] = mul(2.0, add(mul(x, z), mul(w, y)));
  R[3] = mul(2.0, add(mul(x, y), mul(w, z)));
  R[4] = sub(1.0, mul(2.0, add(mul(x, x), mul(z, z))));
  R[5] = mul(2.0, sub(mul(y, z), mul(w, x)));
  R[6] = mul(2.0, sub(mul(x, z), mul(w, y)));
  R[7] = mul(2.0, add(mul(y, z), mul(w, x)));
  R[8] = sub(1.0, mul(2.0, add(mul(x, x), mul(y, y))));
}
// selector._mm3: C = A @ B, each entry ((0 + 1) + 2)
__device__ __forceinline__ void mm3(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = add(add(mul(A[3 * i], B[j]), mul(A[3 * i + 1], B[3 + j])),
                         mul(A[3 * i + 2], B[6 + j]));
}

// A candidate's point in the camera of horizon state k, Xc, and that
// camera's rotation q_cw, from values already in registers (the ray and its
// depth, the extrinsic, the observation state's pose o, state k's): the
// landmark in the world from pose o, then (q_cw, p_cw) = inverse(q_k (x)
// q_ic, p_k + R_k p_ic).
__device__ __forceinline__ void camera_point(const double* ray, double depth, const double* q_ic,
                                             const double* p_ic, const double* qo,
                                             const double* po, const double* qk,
                                             const double* pk, double* Xc, double* qcw) {
  double rd[3], a[3], b[3], Xw[3];
  for (int i = 0; i < 3; ++i) rd[i] = mul(ray[i], depth);
  qrot(q_ic, rd, a);
  for (int i = 0; i < 3; ++i) a[i] = add(a[i], p_ic[i]);
  qrot(qo, a, b);
  for (int i = 0; i < 3; ++i) Xw[i] = add(b[i], po[i]);
  double qwc[4], pwc[3], t[3], pcw[3];
  qmul4(qk, q_ic, qwc);
  qrot(qk, p_ic, t);
  for (int i = 0; i < 3; ++i) pwc[i] = add(t[i], pk[i]);
  qcw[0] = qwc[0];
  for (int i = 1; i < 4; ++i) qcw[i] = -qwc[i];
  qrot(qcw, pwc, t);
  for (int i = 0; i < 3; ++i) pcw[i] = -t[i];
  qrot(qcw, Xw, t);
  for (int i = 0; i < 3; ++i) Xc[i] = add(t[i], pcw[i]);
}

// entry (r, c) of the n x n block lies on a position block (a, b < 3)
__device__ __forceinline__ bool on_position(int r, int c) { return r % 9 < 3 && c % 9 < 3; }

__global__ void __launch_bounds__(kInfoThreads)
selector_info_kernel(const double* __restrict__ rays, const double* __restrict__ depths,
                     const uint8_t* __restrict__ valid, const double* __restrict__ ps,
                     const double* __restrict__ qs, const double* __restrict__ q_ic,
                     const double* __restrict__ p_ic, int nh, int o, double fov,
                     double* __restrict__ out) {
  __shared__ double s_C[kMaxStates][9], s_E[9], s_W[9];
  __shared__ int s_keep;
  const int f = blockIdx.x, n = 9 * nh, tid = threadIdx.x, lane = tid & 31;
  double* o_f = out + (size_t)f * n * n;
  if (tid < 32) {
    // warp 0: four lanes a horizon state (nh <= 8), each with the state's
    // camera point (the same chain in each: shuffling it from one lane
    // measured slower); three take a bearing component Xc_j / |Xc| and the
    // fourth the visibility (two divisions), so no lane runs more than one
    // division after the square root; then three of them a row each of the
    // factor, C = B^T B with B = [u]x R_cw
    const int st = lane >> 2, part = lane & 3, grp = lane & ~3;
    double Xc[3], qcw[4], u_j = 0.0;
    bool vis = false, ok_f = false;
    if (st < nh) {
      // every input first, so that they come in one trip to memory (a load
      // behind a branch, as the mask's was, waits a trip of its own)
      double ray[3], qic[4], pic[3], qo[4], po[3], qk[4], pk[3];
      for (int i = 0; i < 3; ++i) {
        ray[i] = rays[3 * f + i];
        pic[i] = p_ic[i];
        po[i] = ps[3 * o + i];
        pk[i] = ps[3 * st + i];
      }
      for (int i = 0; i < 4; ++i) {
        qic[i] = q_ic[i];
        qo[i] = qs[4 * o + i];
        qk[i] = qs[4 * st + i];
      }
      const double depth = depths[f];
      ok_f = valid[f] != 0;
      camera_point(ray, depth, qic, pic, qo, po, qk, pk, Xc, qcw);
      if (part == 3) {
        const double z = Xc[2];
        vis = (st >= o) && (z > 0.2) && (fabs(Xc[0] / z) < fov) && (fabs(Xc[1] / z) < fov);
      } else {
        double nrm = sqrt(add(add(mul(Xc[0], Xc[0]), mul(Xc[1], Xc[1])), mul(Xc[2], Xc[2])));
        nrm = nrm < 1e-9 ? 1e-9 : nrm;
        u_j = (part == 0 ? Xc[0] : part == 1 ? Xc[1] : Xc[2]) / nrm;
      }
    }
    double u[3];
    for (int i = 0; i < 3; ++i) u[i] = __shfl_sync(0xffffffffu, u_j, grp + i);
    const bool vis_k = __shfl_sync(0xffffffffu, vis, grp + 3);
    const int nv = __popc(__ballot_sync(0xffffffffu, part == 3 && vis));
    if (st < nh && part < 3) {
      double S[9], R[9], B[9], bt[3];
      S[0] = 0.0, S[1] = -u[2], S[2] = u[1];
      S[3] = u[2], S[4] = 0.0, S[5] = -u[0];
      S[6] = -u[1], S[7] = u[0], S[8] = 0.0;
      q2r(qcw, R);
      mm3(S, R, B);
      // row `part` of B^T, column `part` of B (selects: no local array)
      for (int r = 0; r < 3; ++r)
        bt[r] = part == 0 ? B[3 * r] : part == 1 ? B[3 * r + 1] : B[3 * r + 2];
      const double w = (vis_k && ok_f) ? 1.0 : 0.0;
      // selector._mm3(B^T, B), row part: ((0 + 1) + 2), times w
      for (int c = 0; c < 3; ++c)
        s_C[st][3 * part + c] =
            mul(add(add(mul(bt[0], B[c]), mul(bt[1], B[3 + c])), mul(bt[2], B[6 + c])), w);
    }
    __syncwarp();
    if (lane < 9) {
      // E = sum_k C_k + 1e-9 I, a lane an entry, in state order
      double e = s_C[0][lane];
      for (int k = 1; k < nh; ++k) e = add(e, s_C[k][lane]);
      s_E[lane] = lane % 4 == 0 ? add(e, 1e-9) : e;
    }
    __syncwarp();
    if (lane < 9) {
      // selector._inv3: the adjugate over the first-row expansion; every
      // lane forms all nine cofactors (no divergent branch) and takes its
      // own
      const double a = s_E[0], b = s_E[1], c = s_E[2], d = s_E[3], e = s_E[4], f6 = s_E[5],
                   g = s_E[6], h = s_E[7], i = s_E[8];
      const double c00 = sub(mul(e, i), mul(f6, h)), c01 = sub(mul(c, h), mul(b, i)),
                   c02 = sub(mul(b, f6), mul(c, e));
      const double c10 = sub(mul(f6, g), mul(d, i)), c11 = sub(mul(a, i), mul(c, g)),
                   c12 = sub(mul(c, d), mul(a, f6));
      const double c20 = sub(mul(d, h), mul(e, g)), c21 = sub(mul(b, g), mul(a, h)),
                   c22 = sub(mul(a, e), mul(b, d));
      const double det = add(add(mul(a, c00), mul(b, c10)), mul(c, c20));
      const double adj = lane == 0 ? c00 : lane == 1 ? c01 : lane == 2 ? c02
                       : lane == 3 ? c10 : lane == 4 ? c11 : lane == 5 ? c12
                       : lane == 6 ? c20 : lane == 7 ? c21 : c22;
      s_W[lane] = adj / det;
    }
    if (lane == 0) s_keep = nv >= 2;
  } else {
    // the other warps meanwhile: every entry off the position blocks is 0,
    // two a 16-byte store where the block is so aligned; (r, c) stepped
    // along without a division per entry
    const int zt = tid - 32, nz = blockDim.x - 32, nn = n * n;
    const int head = (reinterpret_cast<uintptr_t>(o_f) & 15) ? 1 : 0;
    // a misaligned block's first entry, (0, 0), lies on a position block
    const int pairs = (nn - head) / 2;
    int e = head + 2 * zt, r = e / n, c = e - r * n;
    const int step = 2 * nz, dr = step / n, dc = step - dr * n;
    for (int p = zt; p < pairs; p += nz) {
      const int r2 = c + 1 == n ? r + 1 : r, c2 = c + 1 == n ? 0 : c + 1;
      const bool z1 = !on_position(r, c), z2 = !on_position(r2, c2);
      double* q = o_f + head + 2 * p;
      if (z1 && z2) {
        *reinterpret_cast<double2*>(q) = make_double2(0.0, 0.0);
      } else if (z1) {
        q[0] = 0.0;
      } else if (z2) {
        q[1] = 0.0;
      }
      r += dr;
      c += dc;
      if (c >= n) {
        c -= n;
        ++r;
      }
    }
    if (zt == 0 && head + 2 * pairs < nn) {
      const int t = nn - 1;
      if (!on_position(t / n, t % n)) o_f[t] = 0.0;
    }
  }
  __syncthreads();
  // the position blocks: C_i - C_i W C_i^T, -C_i W C_j^T (0 unless >= 2 states see it)
  const bool keep = s_keep;
  for (int q = tid; q < 9 * nh * nh; q += blockDim.x) {
    const int blk = q / 9, ab = q - 9 * blk, si = blk / nh, sj = blk - si * nh;
    const int a = ab / 3, b = ab - 3 * a;
    double v = 0.0;
    if (keep) {
      // row a of C_i W (selector._mm3: each entry ((0 + 1) + 2)), formed here
      // by every entry that needs it rather than in a stage of its own
      const double* ci = s_C[si] + 3 * a;
      double cw[3];
      for (int c = 0; c < 3; ++c)
        cw[c] = add(add(mul(ci[0], s_W[c]), mul(ci[1], s_W[3 + c])), mul(ci[2], s_W[6 + c]));
      const double* cj = s_C[sj] + 3 * b;  // row b of C_j = column b of C_j^T
      const double d = add(add(mul(cw[0], cj[0]), mul(cw[1], cj[1])), mul(cw[2], cj[2]));
      v = sub(si == sj ? s_C[si][3 * a + b] : 0.0, d);
    }
    o_f[(size_t)(9 * si + a) * n + 9 * sj + b] = v;
  }
}

// ---- selector_greedy ----

// the order-preserving key of a gain: larger gain, larger key; every NaN
// the largest (torch.argmax's NaN first), -0 as +0; 0 is below every key
__device__ __forceinline__ unsigned long long gain_key(double g) {
  if (isnan(g)) return ~0ull;
  const unsigned long long b = (unsigned long long)__double_as_longlong(g == 0.0 ? 0.0 : g);
  return b >> 63 ? ~b : b | (1ull << 63);
}
__device__ __forceinline__ double key_gain(unsigned long long k) {
  return __longlong_as_double((long long)(k >> 63 ? k ^ (1ull << 63) : ~k));
}

// A pivot search's entry: key, the bits of |x| (their unsigned order is the
// order of |x|, every NaN above infinity); code, position * 32 + lane (the
// first largest |x| is the largest key, then the smallest position).  An
// empty entry is {0, kNone}.
constexpr int kNone = 0x7fffffff;
struct Piv {
  unsigned long long key;
  int code;
};
__device__ __forceinline__ unsigned long long abs_key(double x) {
  return (unsigned long long)__double_as_longlong(fabs(x));
}
__device__ __forceinline__ void piv_take(Piv& a, double x, int code) {
  const unsigned long long k = abs_key(x);
  if (a.code == kNone || k > a.key || (k == a.key && code < a.code)) a = Piv{k, code};
}
// the best entry over the xor-butterfly of `width` lanes: the largest key,
// then the smallest code (an empty entry's key 0 never beats a live one:
// its code is the largest); as a pivot search, NaNs of other payloads may
// tie otherwise than torch.argmax, where the log-det is NaN either way
__device__ __forceinline__ Piv piv_reduce(Piv a, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) {
    const unsigned long long bk = VP_SHFL_XOR(a.key, o);
    const int bc = VP_SHFL_XOR(a.code, o);
    if (bk > a.key || (bk == a.key && bc < a.code)) a = Piv{bk, bc};
  }
  return a;
}

// log|det| of an n x n matrix (n <= 16) by selector.logdet_plain's LU on a
// group of 16 lanes of one warp, lane gl holding row gl in r (destroyed).
// Rows keep their lanes: each lane tracks its row's position, so the row
// swap moves no data and the pivot search breaks ties by position, as the
// twin's; the pivot row comes by shuffles.  buf: the group's 16 doubles of
// shared memory (the logs by position).  Every lane of the warp calls
// it; all of the group's lanes get the result.
__device__ double group_logdet16(double (&r)[16], int n, int gl, int lane, double* buf) {
  int pos = gl;
  double piv_mine = 1.0;  // the pivot of the step that retires this row
  // each live row's reciprocal of its entry in the next pivot column, in
  // flight from the update that finalizes it (no division by 0: the
  // special-case path would hold the warp)
  double my_rcp = gl < n && r[0] != 0.0 ? 1.0 / r[0] : INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k >= n) break;
    const bool live = pos >= k && gl < n;
    Piv a = {0ull, kNone};
    if (live) a = Piv{abs_key(r[k]), pos * 32 + lane};
    const int code = piv_reduce(a, 16).code;
    const int pl = code & 31;
    const double piv = VP_SHFL_IDX(r[k], pl), rcp = VP_SHFL_IDX(my_rcp, pl);
    double pr[16];  // the pivot row, from its lane
#pragma unroll
    for (int j = k + 1; j < 16; ++j)
      if (j < n) pr[j] = VP_SHFL_IDX(r[j], pl);
    if (pos == k) pos = code >> 5;  // the row at position k takes the pivot's
    if (lane == pl) {
      pos = k;
      piv_mine = piv;
    } else if (live) {
      const double l = piv != 0.0 ? mul(r[k], rcp) : r[k];
      if (k + 1 < 16 && k + 1 < n) {
        r[k + 1] = sub(r[k + 1], mul(l, pr[k + 1]));
        my_rcp = r[k + 1] != 0.0 ? 1.0 / r[k + 1] : INFINITY;  // unused for a 0 pivot
      }
#pragma unroll
      for (int j = k + 2; j < 16; ++j)
        if (j < n) r[j] = sub(r[j], mul(l, pr[j]));
    }
    if (lane == pl || !live) my_rcp = INFINITY;
  }
  // the logs in parallel, summed in pivot order
  if (gl < n) buf[pos] = log(fabs(piv_mine));
  __syncwarp();
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n) s = add(s, buf[k]);
  __syncwarp();
  return s;
}

// log|det| of the n x n matrix M (row a at M + a ld, destroyed) by
// selector.logdet_plain's LU (rows swapped in place), on a group of G lanes
// of one warp (lane gl owns rows gl and gl + G; n <= 2 G): the dense case,
// n > 16.  Every lane of the warp calls it; all of the group's lanes get
// the result.
__device__ double group_logdet(double* M, int n, int ld, int G, int gl, int lane) {
  double piv0 = 1.0, piv1 = 1.0;
  for (int k = 0; k < n; ++k) {
    Piv a = {0ull, kNone};
    for (int i = gl; i < n; i += G)
      if (i >= k) piv_take(a, M[i * ld + k], i * 32 + lane);
    const int p = piv_reduce(a, G).code >> 5;
    const double piv = M[p * ld + k];
    __syncwarp();
    if (p != k)
      for (int j = k + gl; j < n; j += G) {
        const double t = M[k * ld + j];
        M[k * ld + j] = M[p * ld + j];
        M[p * ld + j] = t;
      }
    __syncwarp();
    if (k == gl) piv0 = piv;
    if (k == gl + G) piv1 = piv;
    const double rcp = 1.0 / piv;
    for (int i = gl; i < n; i += G) {
      if (i <= k) continue;
      const double l = piv != 0.0 ? mul(M[i * ld + k], rcp) : M[i * ld + k];
      for (int j = k + 1; j < n; ++j) M[i * ld + j] = sub(M[i * ld + j], mul(l, M[k * ld + j]));
    }
    __syncwarp();
  }
  const double l0 = log(fabs(piv0)), l1 = log(fabs(piv1));
  const int base = lane - gl;
  double s = 0.0;
  for (int k = 0; k < n; ++k) s = add(s, VP_SHFL_IDX(k < G ? l0 : l1, base + k % G));
  return s;
}

// Shared memory of one CTA (doubles, then ints, then bytes): Sigma [ns x ld];
// the work area: the permuted Omega' [dim x ldd] while Sigma is formed, then
// a group's buffers [groups][16] (ns <= 16: the rows live in registers) or
// matrix [groups][ns x ld]; the log-dets of this CTA's matrices [N + 1];
// the best gain of this CTA by round parity [2]; then the ints: best,
// improved, the best's index by round parity [2]; the permutation [dim];
// the rows of the positions while Sigma is formed [dim]; then the mask and
// the selected flags [N] each.
struct GreedySmem {
  double *sig, *work, *lds, *slot;
  int *ints, *perm, *rowp;
  uint8_t *mask, *sel;
};
__host__ __device__ inline size_t greedy_smem(int N, int dim, int ns, int groups,
                                              GreedySmem* out, void* base) {
  const int ld = ns | 1, ldd = dim | 1;
  const size_t per_group = ns <= 16 ? 16 : (size_t)ns * ld;
  const size_t work = (size_t)groups * per_group > (size_t)dim * ldd ? (size_t)groups * per_group
                                                                     : (size_t)dim * ldd;
  const size_t n_dbl = (size_t)ns * ld + work + (size_t)(N + 1) + 2;
  const size_t n_int = 4 + 2 * (size_t)dim;
  if (out) {
    double* d = (double*)base;
    out->sig = d, out->work = d + ns * ld, out->lds = out->work + work;
    out->slot = out->lds + N + 1;
    out->ints = (int*)(d + n_dbl), out->perm = out->ints + 4, out->rowp = out->perm + dim;
    out->mask = (uint8_t*)(out->ints + n_int), out->sel = out->mask + N;
  }
  return n_dbl * sizeof(double) + n_int * sizeof(int) + 2 * (size_t)N;
}

}  // namespace

constexpr int kMaxDim = 64;

// prior [dim, dim], feats [N, dim, dim] f64, mask [N], budget [1] int64 (a
// device scalar); out selected [N] (0/1), gains [N] f64 (the first round's,
// 0 off the mask).  perm: the indices off the support, then the support's
// ns (every feats[i] is zero outside support x support: the kernel reads
// only that block).
struct VpGreedyArgs {
  const double* prior;
  const double* feats;
  const uint8_t* mask;
  const int64_t* budget;
  uint8_t* selected;
  double* gains;
  int N, dim, ns, rounds;
  int perm[kMaxDim];
};

namespace {

constexpr int kCluster = 16;  // CTAs of selector_greedy's cluster (a non-portable size)

__global__ void __launch_bounds__(kMaxThreads) greedy_kernel(VpGreedyArgs A, int G, int groups) {
  VP_DYN_SMEM(unsigned char, smem_base);
  GreedySmem S;
  const int N = A.N, dim = A.dim, ns = A.ns, nn = dim - ns;
  greedy_smem(N, dim, ns, groups, &S, smem_base);
  const int ld = ns | 1, ldd = dim | 1;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int rank = VP_CLUSTER_RANK();
  for (int a = tid; a < dim; a += nt) S.perm[a] = A.perm[a], S.rowp[a] = a;
  for (int i = tid; i < N; i += nt) {
    S.mask[i] = A.mask[i];
    S.sel[i] = 0;
    if (rank == 0) A.selected[i] = 0;
  }
  __syncthreads();
  // Omega' = prior + 1e-9 I in the order (off the support, support)
  double* W = S.work;
  for (int e = tid; e < dim * dim; e += nt) {
    const int pa = S.perm[e / dim], pb = S.perm[e % dim];
    const double m = A.prior[pa * dim + pb];
    W[(e / dim) * ldd + e % dim] = pa == pb ? add(m, 1e-9) : m;
  }
  __syncthreads();
  // Sigma: eliminate the nn columns off the support, pivots from their rows;
  // position i's row is rowp[i], so a swap exchanges two indices
  for (int k = 0; k < nn; ++k) {
    if (warp == 0) {  // the pivot, its reciprocal in flight during the search
      Piv a = {0ull, kNone};
      double v = 0.0;
      for (int i = k + lane; i < nn; i += 32) {
        const double x = W[S.rowp[i] * ldd + k];
        const int c = a.code;
        piv_take(a, x, i * 32 + lane);
        if (a.code != c) v = x;
      }
      const double my_rcp = v != 0.0 ? 1.0 / v : INFINITY;  // unused for a 0 pivot
      const int code = piv_reduce(a, 32).code, pl = code & 31, p = code >> 5;
      const double piv = VP_SHFL_IDX(v, pl), rcp = VP_SHFL_IDX(my_rcp, pl);
      if (lane == 0) {
        const int t = S.rowp[k];
        S.rowp[k] = S.rowp[p];
        S.rowp[p] = t;
        S.slot[0] = piv, S.slot[1] = rcp;
      }
    }
    __syncthreads();
    const double* Wk = W + S.rowp[k] * ldd;
    const double piv = S.slot[0], rcp = S.slot[1];
    // the trailing block: a warp 4 rows at a time, a lane 2 columns
    const int j0 = k + 1 + lane, j1 = j0 + 32, nw = nt >> 5;
    const double u0 = j0 < dim ? Wk[j0] : 0.0, u1 = j1 < dim ? Wk[j1] : 0.0;
    for (int i0 = k + 1 + 4 * warp; i0 < dim; i0 += 4 * nw) {
      double* Wi[4];
      double lk[4], w0[4], w1[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        Wi[t] = i0 + t < dim ? W + S.rowp[i0 + t] * ldd : nullptr;
        lk[t] = Wi[t] ? Wi[t][k] : 0.0;
        w0[t] = Wi[t] && j0 < dim ? Wi[t][j0] : 0.0;
        w1[t] = Wi[t] && j1 < dim ? Wi[t][j1] : 0.0;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (!Wi[t]) continue;
        const double l = piv != 0.0 ? mul(lk[t], rcp) : lk[t];
        if (j0 < dim) Wi[t][j0] = sub(w0[t], mul(l, u0));
        if (j1 < dim) Wi[t][j1] = sub(w1[t], mul(l, u1));
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < ns * ns; e += nt)  // positions >= nn never moved
    S.sig[(e / ns) * ld + e % ns] = W[(nn + e / ns) * ldd + nn + e % ns];
  __syncthreads();

  // the rounds: every CTA factors the base Sigma (q = 0) and its candidates
  // i = rank + kCluster (q - 1) (q >= 1), group q % groups in pass q / groups (a
  // warp with no live matrix skips the pass); takes the best of them, and
  // after the cluster barrier the best of the CTAs' bests
  const int64_t budget = A.budget[0];
  const int n_rounds = A.rounds > 0 ? A.rounds : 1;
  const int n_mine = 1 + (N > rank ? (N - 1 - rank) / kCluster + 1 : 0);
  const int n_pass = (n_mine + groups - 1) / groups;
  const int grp = tid / G, gl = tid % G;
  const bool regs = ns <= 16;  // then G = 16 and lane gl holds row gl
  double* M = S.work + (size_t)grp * (regs ? 16 : ns * ld);
  const int* sup = S.perm + nn;
  double f[16];  // the group's candidate's row of F_SS, kept while it has one
  int f_of = -1;
  for (int r = 0; r < n_rounds; ++r) {
    for (int pass = 0; pass < n_pass; ++pass) {
      const int q = pass * groups + grp, i = rank + kCluster * (q - 1);
      const bool live = q < n_mine && (q == 0 || (S.mask[i] && !S.sel[i]));
      if (!VP_BALLOT(live)) continue;
      double v;
      if (regs) {
        if (live && q > 0 && i != f_of && gl < ns) {
          const double* Fa = A.feats + (size_t)i * dim * dim + (size_t)sup[gl] * dim;
#pragma unroll
          for (int b = 0; b < 16; ++b) f[b] = b < ns ? Fa[sup[b]] : 0.0;
          f_of = i;
        }
        double row[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const double sg = b < ns && gl < ns ? S.sig[gl * ld + b] : 0.0;
          row[b] = q > 0 ? add(sg, f[b]) : sg;
        }
        v = group_logdet16(row, ns, gl, lane, M);
      } else {
        if (live) {
          const double* F = q > 0 ? A.feats + (size_t)i * dim * dim : nullptr;
          for (int a = gl; a < ns; a += G) {
            const double* Fa = F ? F + (size_t)sup[a] * dim : nullptr;
            for (int b = 0; b < ns; ++b)
              M[a * ld + b] = Fa ? add(S.sig[a * ld + b], Fa[sup[b]]) : S.sig[a * ld + b];
          }
        }
        __syncwarp();
        v = group_logdet(M, ns, ld, G, gl, lane);
      }
      if (live && gl == 0) S.lds[q] = v;
    }
    __syncthreads();
    // this CTA's masked argmax of the gains (round 0 also writes its
    // gains): the largest key, then the smallest index
    if (warp == 0) {
      const double base = S.lds[0];
      Piv a = {0ull, kNone};
      for (int q = 1 + lane; q < n_mine; q += 32) {
        const int i = rank + kCluster * (q - 1);
        const bool cand = S.mask[i] && !S.sel[i];
        const double g = cand ? sub(S.lds[q], base) : 0.0;
        if (r == 0) A.gains[i] = g;
        const unsigned long long key = gain_key(cand ? g : -INFINITY);
        if (a.code == kNone || key > a.key) a = Piv{key, i};  // i rises with q
      }
      a = piv_reduce(a, 32);
      if (lane == 0) S.slot[r & 1] = __longlong_as_double((long long)a.key),
                     S.ints[2 + (r & 1)] = a.code;
    }
    VP_CLUSTER_SYNC();
    // the best of the CTAs' bests, in every CTA alike
    if (warp == 0) {
      Piv a = {0ull, kNone};
      if (lane < kCluster) {
        const double* key = VP_DSMEM(S.slot + (r & 1), lane);
        const int* idx = VP_DSMEM(S.ints + 2 + (r & 1), lane);
        a = Piv{(unsigned long long)__double_as_longlong(*key), *idx};
      }
      a = piv_reduce(a, 32);
      if (lane == 0) {
        S.ints[0] = a.code;
        S.ints[1] = r < A.rounds && key_gain(a.key) > 0.0 && (int64_t)r < budget;
      }
    }
    __syncthreads();
    if (!S.ints[1]) break;
    // Sigma += F_SS[best]
    const int best = S.ints[0];
    const double* F = A.feats + (size_t)best * dim * dim;
    for (int e = tid; e < ns * ns; e += nt) {
      const int a = e / ns, b = e % ns;
      S.sig[a * ld + b] = add(S.sig[a * ld + b], F[(size_t)sup[a] * dim + sup[b]]);
    }
    if (tid == 0) {
      S.sel[best] = 1;
      if (rank == 0) A.selected[best] = 1;
    }
    __syncthreads();
  }
  // no CTA leaves while another may still read its shared memory
  VP_CLUSTER_SYNC();
}

// greedy_kernel's attributes (all of a CTA's shared memory, the cluster of
// 16), set on the first launch on each device and not again
cudaError_t greedy_attributes() {
  static std::atomic<unsigned> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (done.load() >> dev & 1u)) return e;
  e = cudaFuncSetAttribute(greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemLimit);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(greedy_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done.fetch_or(1u << dev);
  return e;
}

}  // namespace

// rays [N, 3], depths [N], valid [N], ps [nh, 3], qs [nh, 4], q_ic [4],
// p_ic [3], all f64; out [N, 9 nh, 9 nh] f64.
extern "C" int vp_selector_info(const double* rays, const double* depths, const uint8_t* valid,
                                const double* ps, const double* qs, const double* q_ic,
                                const double* p_ic, int N, int nh, int obs_frame, double fov,
                                double* out, cudaStream_t stream) {
  if (nh > kMaxStates) return (int)cudaErrorInvalidValue;
  VP_LAUNCH(selector_info_kernel, N, kInfoThreads, 0, stream, rays, depths, valid, ps, qs, q_ic,
            p_ic, nh, obs_frame, fov, out);
  return (int)cudaGetLastError();
}

extern "C" int vp_selector_greedy(const VpGreedyArgs* A, cudaStream_t stream) {
  const int N = A->N, dim = A->dim, ns = A->ns;
  if (dim > kMaxDim || ns > dim) return (int)cudaErrorInvalidValue;
  // 16 lanes a matrix up to 16 rows, else a warp; as many groups as a CTA's
  // matrices (the base and ceil(N / kCluster) candidates), within
  // kMaxThreads threads and the shared memory
  const int G = ns <= 16 ? 16 : 32, per_cta = 1 + (N + kCluster - 1) / kCluster;
  int groups = per_cta < kMaxThreads / G ? per_cta : kMaxThreads / G;
  groups = (groups * G + 31) / 32 * 32 / G;
  while (groups > 32 / G && greedy_smem(N, dim, ns, groups, nullptr, nullptr) > kSmemLimit)
    groups -= 32 / G;
  const size_t smem = greedy_smem(N, dim, ns, groups, nullptr, nullptr);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t e = greedy_attributes();
  if (e == cudaSuccess)
    e = VP_LAUNCH_CLUSTER(greedy_kernel, kCluster, kCluster, groups * G, smem, stream, *A, G,
                          groups);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
