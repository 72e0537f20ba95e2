// K12 window_blocks: the block normal equations of the window from K11's
// per-observation Jacobian blocks.
//
// Replaces: vplines_slam_tpu/solver/lm.py:243 _assemble_blocks (JᵀJ of the
//   dense [R, nd] Jacobian, the per-slot point and line reductions).
// Outputs (all f64): H_dd [nd, nd], g_d [nd], H_dp [nd, P], h_p [P],
//   g_p [P] and, with lines, H_dl [nd, L, 4], Hll_b [L, 4, 4], g_l [L, 4];
//   g = -Jᵀr.
// Accumulates in f64 and emits f64, where the reference sums in f32: the LM
//   solves in f64 and the whitened information spans ~7 decades.  Each
//   output entry is one thread's sum over its rows in a fixed order, with no
//   atomics, so a run repeats to the last bit.
// Design: the dense dims fall into nf + 2 nodes (frame k: 15 dims at 15k;
//   the extrinsic: 6 at 15 nf; the relo pose: 6 at 15 nf + 6).  One CTA per
//   node pair (a <= b) reduces its tile of H_dd over the rows that touch both
//   nodes (the prior rows, the IMU intervals of a frame pair, the point, line
//   and VP observations, the relo rows), reading each row's entries through
//   its compact block; the diagonal tiles also give g_d.  One CTA per point
//   slot and one per line slot reduce the landmark blocks.
// Bound on the H100: bytes (the blocks are read once: ~0.4 MB at the EuRoC
//   window), a few microseconds; the tile CTAs re-read the rows they share.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

struct VpBlkArgs {
  // inputs: r [R], J_prior [nd, nd], J_imu [nf-1, 15, 30], J_pt [P, nf, 2, 19],
  // J_relo [P, 2, 19], J_ln / J_vp [L, nf, 2, 16], pt_start [P]
  const void *r, *J_prior, *J_imu, *J_pt, *J_relo, *J_ln, *J_vp;
  const int64_t* pt_start;
  // outputs
  double *H_dd, *g_d, *H_dp, *h_p, *g_p, *H_dl, *Hll, *g_l;
  int nf, P, L, has_relo, has_lines, has_vps;
  int off_imu, off_pt, off_ln, off_vp, off_relo, is_double;
};

namespace {

__device__ __forceinline__ int node_dim(int n, int nf) { return n < nf ? 15 : 6; }
__device__ __forceinline__ int node_base(int n, int nf) {
  return n < nf ? 15 * n : (n == nf ? 15 * nf : 15 * nf + 6);
}
__device__ __forceinline__ void node_of(int d, int nf, int& n, int& o) {
  if (d < 15 * nf) {
    n = d / 15, o = d % 15;
  } else if (d < 15 * nf + 6) {
    n = nf, o = d - 15 * nf;
  } else {
    n = nf + 1, o = d - 15 * nf - 6;
  }
}

// column of dense dim (node n, offset o) in each family's compact block, -1
// where the row does not depend on it
__device__ __forceinline__ int imu_col(int n, int o, int k) {
  return n == k ? o : (n == k + 1 ? 15 + o : -1);
}
__device__ __forceinline__ int pt_col(int n, int o, int i, int j, int nf) {
  if (o >= 6) return -1;
  if (n == i) return o;
  if (n == j) return 6 + o;
  return n == nf ? 12 + o : -1;
}
__device__ __forceinline__ int relo_col(int n, int o, int i, int nf) {
  if (o >= 6) return -1;
  if (n == i) return o;
  if (n == nf + 1) return 6 + o;
  return n == nf ? 12 + o : -1;
}
__device__ __forceinline__ int ln_col(int n, int o, int j, int nf) {
  if (o >= 6) return -1;
  if (n == j) return o;
  return n == nf ? 6 + o : -1;
}

// H_dd tiles (and g_d on the diagonal tiles): one CTA per node pair a <= b
template <typename T>
__global__ void wblk_tiles_kernel(VpBlkArgs A) {
  const int nf = A.nf, nd = 15 * nf + 12, nn = nf + 2, P = A.P, L = A.L;
  const T* r = (const T*)A.r;
  const T* Jpr = (const T*)A.J_prior;
  const T* Ji = (const T*)A.J_imu;
  const T* Jp = (const T*)A.J_pt;
  const T* Jr = (const T*)A.J_relo;
  const T* Jl = (const T*)A.J_ln;
  const T* Jv = (const T*)A.J_vp;
  for (int t = blockIdx.x; t < nn * (nn + 1) / 2; t += gridDim.x) {
    int a = 0, rem = t;
    while (rem >= nn - a) rem -= nn - a, ++a;
    const int b = a + rem;
    const int da = node_dim(a, nf), db = node_dim(b, nf);
    const int ba = node_base(a, nf), bb = node_base(b, nf);
    const bool diag = a == b;
    for (int e = threadIdx.x; e < da * db; e += blockDim.x) {
      const int ra = e / db, rb = e % db;
      const bool do_g = diag && rb == 0;
      double h = 0.0, g = 0.0;
      // prior rows (dense)
      for (int row = 0; row < nd; ++row) {
        const double ja = (double)Jpr[(size_t)row * nd + ba + ra];
        h += ja * (double)Jpr[(size_t)row * nd + bb + rb];
        if (do_g) g += ja * (double)r[row];
      }
      // IMU intervals
      for (int k = 0; k < nf - 1; ++k) {
        const int ca = imu_col(a, ra, k), cb = imu_col(b, rb, k);
        if (ca < 0) continue;
        for (int m = 0; m < 15; ++m) {
          const T* row = Ji + ((size_t)k * 15 + m) * 30;
          const double ja = (double)row[ca];
          if (cb >= 0) h += ja * (double)row[cb];
          if (do_g) g += ja * (double)r[A.off_imu + 15 * k + m];
        }
      }
      // point observations
      for (int p = 0; p < P; ++p) {
        const int i = (int)A.pt_start[p];
        for (int j = 0; j < nf; ++j) {
          const int ca = pt_col(a, ra, i, j, nf);
          if (ca < 0) continue;
          const int cb = pt_col(b, rb, i, j, nf);
          for (int k = 0; k < 2; ++k) {
            const int ri = 2 * (p * nf + j) + k;
            const T* row = Jp + (size_t)ri * 19;
            const double ja = (double)row[ca];
            if (cb >= 0) h += ja * (double)row[cb];
            if (do_g) g += ja * (double)r[A.off_pt + ri];
          }
        }
      }
      // line and VP observations
      for (int fam = 0; fam < 2; ++fam) {
        if (!A.has_lines || (fam == 1 && !A.has_vps)) continue;
        const T* Jf = fam == 0 ? Jl : Jv;
        const int off = fam == 0 ? A.off_ln : A.off_vp;
        for (int l = 0; l < L; ++l) {
          for (int j = 0; j < nf; ++j) {
            const int ca = ln_col(a, ra, j, nf);
            if (ca < 0) continue;
            const int cb = ln_col(b, rb, j, nf);
            for (int k = 0; k < 2; ++k) {
              const int ri = 2 * (l * nf + j) + k;
              const T* row = Jf + (size_t)ri * 16;
              const double ja = (double)row[ca];
              if (cb >= 0) h += ja * (double)row[cb];
              if (do_g) g += ja * (double)r[off + ri];
            }
          }
        }
      }
      // relo rows
      if (A.has_relo) {
        for (int p = 0; p < P; ++p) {
          const int i = (int)A.pt_start[p];
          const int ca = relo_col(a, ra, i, nf);
          if (ca < 0) continue;
          const int cb = relo_col(b, rb, i, nf);
          for (int k = 0; k < 2; ++k) {
            const T* row = Jr + ((size_t)p * 2 + k) * 19;
            const double ja = (double)row[ca];
            if (cb >= 0) h += ja * (double)row[cb];
            if (do_g) g += ja * (double)r[A.off_relo + 2 * p + k];
          }
        }
      }
      A.H_dd[(size_t)(ba + ra) * nd + bb + rb] = h;
      if (!diag) A.H_dd[(size_t)(bb + rb) * nd + ba + ra] = h;
      if (do_g) A.g_d[ba + ra] = -g;
    }
  }
}

// point slots: H_dp[:, p], h_p[p], g_p[p] over the slot's point rows, then
// its relo rows (item nd: h_p and g_p)
template <typename T>
__global__ void wblk_point_slots_kernel(VpBlkArgs A) {
  const int nf = A.nf, nd = 15 * nf + 12, P = A.P;
  const T* r = (const T*)A.r;
  const T* Jp = (const T*)A.J_pt;
  const T* Jr = (const T*)A.J_relo;
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int i = (int)A.pt_start[p];
    for (int d = threadIdx.x; d <= nd; d += blockDim.x) {
      int n = -1, o = 0;
      if (d < nd) node_of(d, nf, n, o);
      double s = 0.0, hp = 0.0, gp = 0.0;
      for (int j = 0; j < nf; ++j) {
        const int c = d < nd ? pt_col(n, o, i, j, nf) : -1;
        for (int k = 0; k < 2; ++k) {
          const int ri = 2 * (p * nf + j) + k;
          const T* row = Jp + (size_t)ri * 19;
          const double cp = (double)row[18];
          if (d == nd) {
            hp += cp * cp;
            gp += cp * (double)r[A.off_pt + ri];
          } else if (c >= 0) {
            s += (double)row[c] * cp;
          }
        }
      }
      if (A.has_relo) {
        const int c = d < nd ? relo_col(n, o, i, nf) : -1;
        for (int k = 0; k < 2; ++k) {
          const T* row = Jr + ((size_t)p * 2 + k) * 19;
          const double cp = (double)row[18];
          if (d == nd) {
            hp += cp * cp;
            gp += cp * (double)r[A.off_relo + 2 * p + k];
          } else if (c >= 0) {
            s += (double)row[c] * cp;
          }
        }
      }
      if (d < nd) {
        A.H_dp[(size_t)d * P + p] = s;
      } else {
        A.h_p[p] = hp;
        A.g_p[p] = -gp;
      }
    }
  }
}

// line slots: H_dl[:, l, :], Hll_b[l], g_l[l] over the slot's line rows,
// then its VP rows
template <typename T>
__global__ void wblk_line_slots_kernel(VpBlkArgs A) {
  const int nf = A.nf, nd = 15 * nf + 12, L = A.L;
  const T* r = (const T*)A.r;
  const int n_items = 4 * nd + 16 + 4;
  for (int l = blockIdx.x; l < L; l += gridDim.x) {
    for (int e = threadIdx.x; e < n_items; e += blockDim.x) {
      int n = -1, o = 0, kk = 0, m1 = 0, m2 = 0, kind;
      if (e < 4 * nd) {
        kind = 0, kk = e % 4;
        node_of(e / 4, nf, n, o);
      } else if (e < 4 * nd + 16) {
        kind = 1, m1 = (e - 4 * nd) / 4, m2 = (e - 4 * nd) % 4;
      } else {
        kind = 2, m1 = e - 4 * nd - 16;
      }
      double s = 0.0;
      for (int fam = 0; fam < 2; ++fam) {
        if (fam == 1 && !A.has_vps) continue;
        const T* Jf = (const T*)(fam == 0 ? A.J_ln : A.J_vp);
        const int off = fam == 0 ? A.off_ln : A.off_vp;
        for (int j = 0; j < nf; ++j) {
          const int c = kind == 0 ? ln_col(n, o, j, nf) : -1;
          if (kind == 0 && c < 0) continue;
          for (int k = 0; k < 2; ++k) {
            const int ri = 2 * (l * nf + j) + k;
            const T* row = Jf + (size_t)ri * 16;
            if (kind == 0)
              s += (double)row[c] * (double)row[12 + kk];
            else if (kind == 1)
              s += (double)row[12 + m1] * (double)row[12 + m2];
            else
              s += (double)row[12 + m1] * (double)r[off + ri];
          }
        }
      }
      if (kind == 0)
        A.H_dl[((size_t)(e / 4) * L + l) * 4 + kk] = s;
      else if (kind == 1)
        A.Hll[(size_t)l * 16 + m1 * 4 + m2] = s;
      else
        A.g_l[(size_t)l * 4 + m1] = -s;
    }
  }
}

// ---- launch ----

template <typename T>
int launch(const VpBlkArgs& A, cudaStream_t stream) {
  const int nn = A.nf + 2;
  auto* k_tiles = &wblk_tiles_kernel<T>;
  auto* k_pts = &wblk_point_slots_kernel<T>;
  auto* k_lns = &wblk_line_slots_kernel<T>;
  VP_LAUNCH(k_tiles, nn * (nn + 1) / 2, 256, 0, stream, A);
  if (A.P > 0) VP_LAUNCH(k_pts, A.P, 192, 0, stream, A);
  if (A.has_lines && A.L > 0) VP_LAUNCH(k_lns, A.L, 256, 0, stream, A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vp_window_blocks(const VpBlkArgs* A, cudaStream_t stream) {
  return A->is_double ? launch<double>(*A, stream) : launch<float>(*A, stream);
}
