// Pose-only bundle adjustment (motion-only BA) of one camera in one launch:
// 4 rounds of at most 10 Levenberg-Marquardt steps over N monocular
// reprojection edges, the Huber kernel (delta = sqrt(5.991)) in the first 3
// rounds, and after each round every valid edge re-gated at chi2 <= 5.991
// and z > 0.
//
// Replaces no Pallas kernel: the JAX package left this function to XLA
// (orbslam_in_practice_tpu/optim/pose_opt.py::pose_optimization). Plain
// PyTorch version: orbslam_in_practice_tpu_torch/optim/pose_opt.py
// (pose_optimization_plain): the same schedule as thousands of small torch
// launches a call, whose host time was most of a fused frame's on the card.
//
// Bound: latency. The work is a sequential chain of 40 LM steps of two
// block-wide reductions each (the normal equations and the old error, then
// the new error) and a 6x6 solve, plus 4 gating passes; the bytes are at
// most ~25 bytes an edge, read again from L1/L2 every pass (4000 edges:
// 0.1 MB, 0.03 us at 3.35 TB/s). So one block does it all, with no
// grid-wide synchronisation and no host round trip.
//
// Launch: one block of THREADS threads. The pose (float, as the plain
// version keeps it), lambda and the converged flag live in shared memory.
//   1. Each thread strides over the edges (e = tid, tid + THREADS, ...) and,
//      for the edges still in, computes in float32 the residual, the
//      Jacobian of a left perturbation [rho, phi], the Huber IRLS weight and
//      the robust error, and accumulates in float64 the 21 upper entries of
//      H = sum w J^T J, the 6 of g = -sum w J^T r and the old error.
//   2. The block sums them in a fixed order: a shuffle tree inside each
//      warp, then the warps' partials in warp order; no atomics, so two
//      launches give the same bits.
//   3. Thread 0 damps H (H + lambda diag(H) + 1e-9 I), solves by Cholesky in
//      float64, and forms exp_se3(delta) @ Tcw, rounded to float32.
//   4. A second strided pass sums the new robust error; thread 0 accepts the
//      step if it is lower (lambda x 0.5, else x 4) and counts it, and the
//      round ends once |delta|^2 < 1e-12 (the plain version's masked
//      convergence: once converged, its later steps change nothing).
//   5. After each round the block re-gates the inlier mask in place; the
//      last pass also counts the inliers.
// A solve whose Cholesky pivot is not positive is a rejected step, as the
// plain version's NaN step is.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 4;           // optim/pose_opt.py::ROUNDS
constexpr int ITERS_PER_ROUND = 10; // optim/pose_opt.py::ITERS_PER_ROUND
constexpr float CHI2_MONO = 5.991f;
constexpr float HUBER_DELTA = 2.44765193603992607f;  // sqrt(5.991)
constexpr float HUBER_D2 = HUBER_DELTA * HUBER_DELTA;
constexpr int NH = 21;              // upper triangle of the 6x6 H
constexpr int NSUM = NH + 6 + 1;    // H, g, the old robust error

struct Cam {
  float fx, fy, cx, cy;
};

// Camera-frame point (x, y, z), the clamped depth and the residual
// uv - proj of edge e under the pose T (row-major 4x4; rows 0-2 used).
__device__ __forceinline__ void project(const float* T, const float* __restrict__ Xw,
                                        const float* __restrict__ uv, const Cam& c, int e, float& x,
                                        float& y, float& z, float& zs, float& r0, float& r1) {
  const float X = Xw[3 * e], Y = Xw[3 * e + 1], Z = Xw[3 * e + 2];
  x = T[0] * X + T[1] * Y + T[2] * Z + T[3];
  y = T[4] * X + T[5] * Y + T[6] * Z + T[7];
  z = T[8] * X + T[9] * Y + T[10] * Z + T[11];
  zs = fabsf(z) < 1e-6f ? 1e-6f : z;
  r0 = uv[2 * e] - (c.fx * x / zs + c.cx);
  r1 = uv[2 * e + 1] - (c.fy * y / zs + c.cy);
}

__device__ __forceinline__ float robust(float chi2, bool huber) {
  if (!huber || chi2 <= HUBER_D2) return chi2;
  return 2.0f * HUBER_DELTA * sqrtf(chi2) - HUBER_D2;
}

// v[0..M) summed over the block into out[0..M) (shared), in a fixed order.
// Every thread must call it.
template <int M>
__device__ __forceinline__ void block_sum(const double (&v)[M], double* part, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    double s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) part[warp * M + k] = s;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += part[w * M + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Solves (H + lam diag(H) + 1e-9 I) delta = g, H given by its upper
// triangle row by row; false if a Cholesky pivot is not positive.
__device__ bool solve6(const double* Hu, const double* g, double lam, double* delta) {
  double A[6][6], L[6][6] = {};
  for (int i = 0, k = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j, ++k) A[i][j] = A[j][i] = Hu[k];
  }
  for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] + lam * A[i][i] + 1e-9;
  for (int j = 0; j < 6; ++j) {
    double s = A[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    if (!(s > 0.0)) return false;
    L[j][j] = sqrt(s);
    for (int i = j + 1; i < 6; ++i) {
      double t = A[i][j];
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double t = g[i];
    for (int k = 0; k < i; ++k) t -= L[i][k] * y[k];
    y[i] = t / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double t = y[i];
    for (int k = i + 1; k < 6; ++k) t -= L[k][i] * delta[k];
    delta[i] = t / L[i][i];
  }
  for (int i = 0; i < 6; ++i) {
    if (!isfinite(delta[i])) return false;
  }
  return true;
}

// Tn = exp_se3(xi) @ T in float64, rounded to float32
// (geometry/se3.py::exp_se3, its small-angle branches included).
__device__ void exp_se3_times(const double* xi, const float* T, float* Tn) {
  const double p0 = xi[3], p1 = xi[4], p2 = xi[5];
  const double th2 = p0 * p0 + p1 * p1 + p2 * p2;
  const bool small = th2 < 1e-8;
  const double th = sqrt(th2 < 1e-8 ? 1e-8 : th2);
  const double a = small ? 1.0 - th2 / 6.0 : sin(th) / th;
  const double b = small ? 0.5 - th2 / 24.0 : (1.0 - cos(th)) / th2;
  const double c = small ? 1.0 / 6.0 - th2 / 120.0 : (th - sin(th)) / (th2 * th);
  const double W[3][3] = {{0.0, -p2, p1}, {p2, 0.0, -p0}, {-p1, p0, 0.0}};
  double W2[3][3], R[3][3], V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const double eye = i == j ? 1.0 : 0.0;
      R[i][j] = eye + a * W[i][j] + b * W2[i][j];
      V[i][j] = eye + b * W[i][j] + c * W2[i][j];
    }
  }
  double t[3];
  for (int i = 0; i < 3; ++i) t[i] = V[i][0] * xi[0] + V[i][1] * xi[1] + V[i][2] * xi[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 4; ++j) {
      const double s = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j] + t[i] * T[12 + j];
      Tn[4 * i + j] = static_cast<float>(s);
    }
  }
  for (int j = 0; j < 4; ++j) Tn[12 + j] = T[12 + j];
}

__global__ void __launch_bounds__(THREADS)
    pose_opt_kernel(const float* __restrict__ Tcw0, const float* __restrict__ Xw,
                    const float* __restrict__ uv, const float* __restrict__ inv_s2,
                    const unsigned char* __restrict__ valid, const float* __restrict__ K, int n,
                    float* __restrict__ Tcw, unsigned char* __restrict__ inlier,
                    long long* __restrict__ counts) {
  __shared__ float T[16], Tn[16];
  __shared__ double part[WARPS * NSUM];
  __shared__ double sums[NSUM];
  __shared__ double delta[6], lam, err_old;
  __shared__ int status;  // bit 0: try the step; bit 1: the round converged
  const int tid = threadIdx.x;
  const Cam cam = {K[0], K[4], K[2], K[5]};
  if (tid < 16) T[tid] = Tcw0[tid];
  for (int e = tid; e < n; e += THREADS) inlier[e] = valid[e] ? 1 : 0;
  long long accepted = 0;  // thread 0's
  __syncthreads();

  for (int rnd = 0; rnd < ROUNDS; ++rnd) {
    const bool huber = rnd < ROUNDS - 1;
    if (tid == 0) lam = 1e-3;
    for (int it = 0; it < ITERS_PER_ROUND; ++it) {
      // the normal equations and the old error at T
      double acc[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) acc[k] = 0.0;
      for (int e = tid; e < n; e += THREADS) {
        if (!inlier[e]) continue;
        float x, y, z, zs, r0, r1;
        project(T, Xw, uv, cam, e, x, y, z, zs, r0, r1);
        const float s2 = inv_s2[e];
        const float chi2 = (r0 * r0 + r1 * r1) * s2;
        const float wh = huber ? fminf(HUBER_DELTA / sqrtf(fmaxf(chi2, 1e-12f)), 1.0f) : 1.0f;
        const float zi = 1.0f / zs, zi2 = zi * zi;
        const float fx = cam.fx, fy = cam.fy;
        const float ja[6] = {-fx * zi, 0.0f, fx * x * zi2, fx * x * y * zi2, -(fx * z * zi + fx * x * x * zi2),
                             fx * y * zi};
        const float jb[6] = {0.0f, -fy * zi, fy * y * zi2, fy * z * zi + fy * y * y * zi2, -fy * x * y * zi2,
                             -fy * x * zi};
        const double w = static_cast<double>(s2 * wh);
        double a[6], b[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          a[i] = ja[i];
          b[i] = jb[i];
        }
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j, ++k) acc[k] += w * (a[i] * a[j] + b[i] * b[j]);
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[NH + i] -= w * (a[i] * r0 + b[i] * r1);
        acc[NSUM - 1] += robust(chi2, huber);
      }
      block_sum<NSUM>(acc, part, sums);
      if (tid == 0) {
        err_old = sums[NSUM - 1];
        const bool ok = solve6(sums, sums + NH, lam, delta);
        double d2 = 0.0;
        for (int i = 0; i < 6; ++i) d2 += delta[i] * delta[i];
        if (ok) exp_se3_times(delta, T, Tn);
        status = (ok ? 1 : 0) | (ok && d2 < 1e-12 ? 2 : 0);
      }
      __syncthreads();
      const int st = status;
      // the new error at Tn
      double err_new[1] = {0.0};
      if (st & 1) {
        for (int e = tid; e < n; e += THREADS) {
          if (!inlier[e]) continue;
          float x, y, z, zs, r0, r1;
          project(Tn, Xw, uv, cam, e, x, y, z, zs, r0, r1);
          err_new[0] += robust((r0 * r0 + r1 * r1) * inv_s2[e], huber);
        }
      }
      block_sum<1>(err_new, part, sums);
      if (tid == 0) {
        const bool accept = (st & 1) && sums[0] < err_old;
        if (accept) {
          for (int i = 0; i < 16; ++i) T[i] = Tn[i];
          ++accepted;
        }
        lam = accept ? lam * 0.5 : lam * 4.0;
      }
      __syncthreads();
      if (st & 2) break;
    }

    // re-gate every valid edge at the round's pose
    double kept[1] = {0.0};
    for (int e = tid; e < n; e += THREADS) {
      float x, y, z, zs, r0, r1;
      project(T, Xw, uv, cam, e, x, y, z, zs, r0, r1);
      const bool in = valid[e] && (r0 * r0 + r1 * r1) * inv_s2[e] <= CHI2_MONO && z > 0.0f;
      inlier[e] = in ? 1 : 0;
      kept[0] += in ? 1.0 : 0.0;
    }
    block_sum<1>(kept, part, sums);
  }

  if (tid < 16) Tcw[tid] = T[tid];
  if (tid == 0) {
    counts[0] = static_cast<long long>(sums[0]);
    counts[1] = accepted;
  }
}

}  // namespace

// One launch on `stream`: Tcw0 (4, 4), Xw (n, 3), uv (n, 2), inv_s2 (n,)
// float32; valid (n,) bool; K (3, 3) float32 -> Tcw (4, 4) float32, inlier
// (n,) bool, counts (2,) int64: the inliers and the LM steps accepted.
extern "C" int pose_optimization_launch(const void* Tcw0, const void* Xw, const void* uv, const void* inv_s2,
                                        const void* valid, const void* K, int n, void* Tcw, void* inlier,
                                        void* counts, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  pose_opt_kernel<<<1, THREADS, 0, stream>>>(
      static_cast<const float*>(Tcw0), static_cast<const float*>(Xw), static_cast<const float*>(uv),
      static_cast<const float*>(inv_s2), static_cast<const unsigned char*>(valid), static_cast<const float*>(K), n,
      static_cast<float*>(Tcw), static_cast<unsigned char*>(inlier), static_cast<long long*>(counts));
  return (int)cudaGetLastError();
}
