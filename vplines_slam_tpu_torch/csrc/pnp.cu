// K18 pnp: the hypotheses of PnP-RANSAC -- a six-point DLT pose from each
// sample and its reprojection inliers over all points.
//
// Replaces: vplines_slam_tpu/ops/mvg.py:241 ransac_pnp, the vmapped hyp
//   (pnp_dlt :180 on each sample's mask) and score.  On the TPU each of the
//   256 hypotheses built a [2N, 12] A over all N points (zero rows outside
//   the sample), a batched 12x12 eigh and a 3x3 SVD, then a vmapped
//   reprojection of all N points.
// Bound on the H100: operations, serial ones.  256 hypotheses x (a 12x12
//   Jacobi eigensolve, ~10 sweeps of 66 rotations, + 64 reprojections) is
//   ~30 MFLOP of f64, a microsecond of the card's f64 rate, but each
//   eigensolve is a chain of dependent rotations: the latency of one block's
//   sweep sets the time.
// Design: one block of 128 threads per hypothesis.  The sample SET (a
//   repeated draw counts once, as .at[sample].set(True) does) intersected
//   with the mask builds A^T A in f64 (a thread per upper entry, only the
//   sample's rows: the other rows are zero).  Warp 0 runs a cyclic Jacobi
//   sweep on it in shared memory, a lane per row and column of each
//   rotation; the smallest eigenvalue's vector is P (3x4).  Thread 0 fixes
//   its sign by the summed sample depths, takes M = P[:, :3] = U S V^T from a
//   3x3 Jacobi of M^T M, R = M V S^-1 V^T = U V^T times sign(det), scale =
//   mean(S), t = P[:, 3] / scale.  Every thread then scores its points
//   (z > 0.05, reprojection error < threshold, mask) and a shared counter
//   sums the inliers.  All of it is f64 whatever the input type: A^T A spans
//   ~1e4 against a near-zero smallest eigenvalue.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double sgn(double v) { return (v > 0.0) - (v < 0.0); }

// one rotation of the cyclic Jacobi method zeroing A[p][q] (n x n, row-major
// in shared memory), run by the lanes of one warp; V accumulates the vectors
__device__ void jacobi_rotate(double* A, double* V, int n, int p, int q, int lane) {
  const double apq = A[p * n + q];
  const double app = A[p * n + p], aqq = A[q * n + q];
  __syncwarp();
  if (apq == 0.0) return;
  const double theta = (aqq - app) / (2.0 * apq);
  const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
  if (lane < n) {  // columns p, q of A and V
    const double akp = A[lane * n + p], akq = A[lane * n + q];
    A[lane * n + p] = c * akp - s * akq;
    A[lane * n + q] = s * akp + c * akq;
    const double vkp = V[lane * n + p], vkq = V[lane * n + q];
    V[lane * n + p] = c * vkp - s * vkq;
    V[lane * n + q] = s * vkp + c * vkq;
  }
  __syncwarp();
  if (lane < n) {  // rows p, q
    const double apk = A[p * n + lane], aqk = A[q * n + lane];
    A[p * n + lane] = c * apk - s * aqk;
    A[q * n + lane] = s * apk + c * aqk;
  }
  __syncwarp();
}

// symmetric n x n eigen-decomposition by cyclic Jacobi sweeps, run by one warp
__device__ void jacobi_eigen(double* A, double* V, int n, int lane) {
  for (int k = lane; k < n * n; k += 32) V[k] = (k / n == k % n) ? 1.0 : 0.0;
  __syncwarp();
  for (int sweep = 0; sweep < 40; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int p = 0; p < n; ++p) {
      diag += A[p * n + p] * A[p * n + p];
      for (int q = p + 1; q < n; ++q) off += A[p * n + q] * A[p * n + q];
    }
    __syncwarp();
    if (off <= 1e-32 * diag || off == 0.0) break;
    for (int p = 0; p < n - 1; ++p)
      for (int q = p + 1; q < n; ++q) jacobi_rotate(A, V, n, p, q, lane);
  }
}

// 3x3 symmetric eigen-decomposition by cyclic Jacobi, one thread
__device__ void jacobi3(double (&A)[3][3], double (&V)[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 40; ++sweep) {
    const double off = A[0][1] * A[0][1] + A[0][2] * A[0][2] + A[1][2] * A[1][2];
    const double diag = A[0][0] * A[0][0] + A[1][1] * A[1][1] + A[2][2] * A[2][2];
    if (off <= 1e-32 * diag || off == 0.0) break;
    for (int p = 0; p < 2; ++p)
      for (int q = p + 1; q < 3; ++q) {
        const double apq = A[p][q];
        if (apq == 0.0) continue;
        const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 3; ++k) {
          const double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
          const double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
        for (int k = 0; k < 3; ++k) {
          const double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pnp_kernel(const T* __restrict__ X, const T* __restrict__ x,
           const unsigned char* __restrict__ mask, const long long* __restrict__ idx, int N,
           int S, double thr, double* __restrict__ Rs, double* __restrict__ ts,
           int* __restrict__ counts, unsigned char* __restrict__ inl) {
  extern __shared__ unsigned char s_sm[];  // [N] sample set & mask
  __shared__ double s_A[144], s_V[144], s_R[9], s_t[3];
  __shared__ int s_count;
  const int h = blockIdx.x, tid = threadIdx.x;
  for (int n = tid; n < N; n += blockDim.x) {
    bool in = false;
    for (int k = 0; k < S; ++k) in = in || (idx[(size_t)h * S + k] == n);
    s_sm[n] = in && mask[n];
  }
  if (tid == 0) s_count = 0;
  __syncthreads();
  // A^T A over the sample's rows r0 = [X 1 0 -uX -u], r1 = [0 X 1 -vX -v]
  for (int e = tid; e < 78; e += blockDim.x) {
    int a = 0, rem = e;
    while (rem >= 12 - a) {
      rem -= 12 - a;
      ++a;
    }
    const int b = a + rem;
    double acc = 0.0;
    for (int n = 0; n < N; ++n) {
      if (!s_sm[n]) continue;
      const double Xh[4] = {(double)X[3 * n], (double)X[3 * n + 1], (double)X[3 * n + 2], 1.0};
      const double u = (double)x[2 * n], v = (double)x[2 * n + 1];
      double r0[12], r1[12];
      for (int k = 0; k < 4; ++k) {
        r0[k] = Xh[k];
        r0[4 + k] = 0.0;
        r0[8 + k] = -u * Xh[k];
        r1[k] = 0.0;
        r1[4 + k] = Xh[k];
        r1[8 + k] = -v * Xh[k];
      }
      acc += r0[a] * r0[b] + r1[a] * r1[b];
    }
    s_A[a * 12 + b] = acc;
    s_A[b * 12 + a] = acc;
  }
  __syncthreads();
  if (tid < 32) jacobi_eigen(s_A, s_V, 12, tid);
  __syncthreads();
  if (tid == 0) {
    int kmin = 0;
    for (int k = 1; k < 12; ++k)
      if (s_A[k * 12 + k] < s_A[kmin * 12 + kmin]) kmin = k;
    double P[3][4];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 4; ++c) P[r][c] = s_V[(4 * r + c) * 12 + kmin];
    // sign: the summed depths of the sample points positive
    double dsum = 0.0;
    for (int n = 0; n < N; ++n)
      if (s_sm[n])
        dsum += P[2][0] * (double)X[3 * n] + P[2][1] * (double)X[3 * n + 1] +
                P[2][2] * (double)X[3 * n + 2] + P[2][3];
    const double sign = sgn(dsum + 1e-30);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 4; ++c) P[r][c] *= sign;
    // M = U S V^T from M^T M = V S^2 V^T; R = M V S^-1 V^T = U V^T
    double B[3][3], V3[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        B[i][j] = P[0][i] * P[0][j] + P[1][i] * P[1][j] + P[2][i] * P[2][j];
    jacobi3(B, V3);
    double s[3], MV[3][3];
    for (int k = 0; k < 3; ++k) s[k] = sqrt(fmax(B[k][k], 0.0));
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k)
        MV[i][k] = (P[i][0] * V3[0][k] + P[i][1] * V3[1][k] + P[i][2] * V3[2][k]) /
                   (s[k] > 0.0 ? s[k] : 1.0);  // a rank-deficient M stays finite
    double R[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        R[i][j] = MV[i][0] * V3[j][0] + MV[i][1] * V3[j][1] + MV[i][2] * V3[j][2];
    const double det = R[0][0] * (R[1][1] * R[2][2] - R[1][2] * R[2][1]) -
                       R[0][1] * (R[1][0] * R[2][2] - R[1][2] * R[2][0]) +
                       R[0][2] * (R[1][0] * R[2][1] - R[1][1] * R[2][0]);
    const double sd = sgn(det), scale = (s[0] + s[1] + s[2]) / 3.0;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        s_R[3 * i + j] = R[i][j] * sd;
        Rs[(size_t)h * 9 + 3 * i + j] = R[i][j] * sd;
      }
      s_t[i] = P[i][3] / scale;
      ts[(size_t)h * 3 + i] = P[i][3] / scale;
    }
  }
  __syncthreads();
  int local = 0;
  for (int n = tid; n < N; n += blockDim.x) {
    const double X0 = (double)X[3 * n], X1 = (double)X[3 * n + 1], X2 = (double)X[3 * n + 2];
    const double zc = s_R[6] * X0 + s_R[7] * X1 + s_R[8] * X2 + s_t[2];
    const double xc = s_R[0] * X0 + s_R[1] * X1 + s_R[2] * X2 + s_t[0];
    const double yc = s_R[3] * X0 + s_R[4] * X1 + s_R[5] * X2 + s_t[1];
    const bool good_z = zc > 0.05;
    const double z = good_z ? zc : 1.0;
    const double dx = xc / z - (double)x[2 * n], dy = yc / z - (double)x[2 * n + 1];
    const bool in = (sqrt(dx * dx + dy * dy) < thr) && mask[n] && good_z;
    inl[(size_t)h * N + n] = in;
    local += in;
  }
  if (local) atomicAdd(&s_count, local);
  __syncthreads();
  if (tid == 0) counts[h] = s_count;
}

}  // namespace

// X [N, 3], x [N, 2] (float, or double when is_double), mask [N], idx
// [n_hyp, S] int64 sample indices into [0, N).  Rs [n_hyp, 3, 3], ts
// [n_hyp, 3] f64; counts [n_hyp]; inl [n_hyp, N].
extern "C" int vp_pnp_hypotheses(const void* X, const void* x, const unsigned char* mask,
                                 const long long* idx, int n_hyp, int N, int S, double thr,
                                 int is_double, double* Rs, double* ts, int* counts,
                                 unsigned char* inl, cudaStream_t stream) {
  if (is_double)
    pnp_kernel<double><<<n_hyp, kThreads, (size_t)N, stream>>>(
        (const double*)X, (const double*)x, mask, idx, N, S, thr, Rs, ts, counts, inl);
  else
    pnp_kernel<float><<<n_hyp, kThreads, (size_t)N, stream>>>(
        (const float*)X, (const float*)x, mask, idx, N, S, thr, Rs, ts, counts, inl);
  return (int)cudaGetLastError();
}
