// The tiled pairwise squared distance shared by kernels K1 (stationary_k1.cu)
// and K2 (stationary_k2.cu), and the tails h and h' of the six isotropic
// families of gpflow_tpu/ops/pallas_distance.py. Both kernels form d2 with
// this one routine, so the backward pass sees exactly the d2 of the forward.
//
// d2 is taken directly as a sum of squared differences with fp32 FMAs, not by
// the norm expansion |x|^2 - 2 x.z + |z|^2 that the TPU kernels and the plain
// versions use. Every term is non-negative, so d2 carries a relative error of
// at most about (D + 1) * 2^-24 and never goes negative; the expansion
// instead carries an absolute error of about 2^-24 * (|x|^2 + |z|^2), which
// near x = z swamps d2 itself and must be clamped. The direct form also gives
// d2 = 0 exactly on the diagonal of K(Z, Z) and an exactly symmetric Kuu. No
// tensor-core (TF32) arithmetic is used: rounding the cross term to 10
// mantissa bits is what makes Kuu indefinite (pallas_distance.py:128-131).
//
// Layout: a block of 32 x 8 threads owns a 64-row x 128-column output tile;
// each thread owns 8 rows x 4 columns, with consecutive threads of a warp on
// consecutive columns, so that a warp's access to a row of an [N, M] matrix
// covers 128 contiguous bytes. The block stages its Xs and Zs rows in shared
// memory, eight dimensions at a time, and accumulates d2 in registers. No
// padding: out-of-range rows and missing dimensions of the last chunk are
// zero-filled (they add exactly 0 to d2) and the caller masks the ragged
// edge of N and M when it touches memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gpflow_stationary {

constexpr int kThreadsX = 32;      // threads along the columns (one warp)
constexpr int kThreadsY = 8;       // threads along the rows
constexpr int kColsPerThread = 4;
constexpr int kRowsPerThread = 8;
constexpr int kTileM = kThreadsX * kColsPerThread;  // 128 output columns per block
constexpr int kTileN = kThreadsY * kRowsPerThread;  // 64 output rows per block
constexpr int kChunkD = 8;         // dimensions staged in shared memory per step
constexpr int kThreads = kThreadsX * kThreadsY;

// Family codes; gpflow_tpu_torch/ops/pallas_distance.py holds the same table.
enum Family : int { kRbf = 0, kExponential = 1, kMatern12 = 2, kMatern32 = 3, kMatern52 = 4, kRq = 5 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// h(d2) of pallas_distance.py::_tail_value, with the same 1e-36 clip under
// the square root of the r-based families.
template <int FAMILY>
__device__ __forceinline__ float tail_value(float d2, float alpha) {
  if constexpr (FAMILY == kRbf) {
    return expf(-0.5f * d2);
  } else if constexpr (FAMILY == kRq) {
    return expf(-alpha * log1pf(0.5f * d2 / alpha));
  } else {
    const float r = sqrtf(fmaxf(d2, 1e-36f));
    if constexpr (FAMILY == kExponential) {
      return expf(-0.5f * r);
    } else if constexpr (FAMILY == kMatern12) {
      return expf(-r);
    } else if constexpr (FAMILY == kMatern32) {
      const float s = 1.7320508075688772f;  // sqrt(3)
      return (1.0f + s * r) * expf(-s * r);
    } else {
      const float s = 2.23606797749979f;  // sqrt(5)
      return (1.0f + s * r + (5.0f / 3.0f) * d2) * expf(-s * r);
    }
  }
}

// dh/d(d2) of pallas_distance.py::_tail_grad for the families whose
// backward needs it, and 0 wherever d2 falls under the 1e-36 clip: the
// derivative of h(sqrt(max(d2, 1e-36))), as the JAX package's XLA path
// differentiates it. Exponential and Matern12 carry 1/r, which would give
// about -5e17 at coincident points (d2 is exactly 0 there) and turn the input
// gradient into rounding noise of that size; for Matern32 and Matern52 the
// zero changes nothing, since their term is multiplied by xs_i - zs_j = 0.
template <int FAMILY>
__device__ __forceinline__ float tail_grad(float d2) {
  const float r = sqrtf(fmaxf(d2, 1e-36f));
  float grad;
  if constexpr (FAMILY == kExponential) {
    grad = -expf(-0.5f * r) / (4.0f * r);
  } else if constexpr (FAMILY == kMatern12) {
    grad = -expf(-r) / (2.0f * r);
  } else if constexpr (FAMILY == kMatern32) {
    const float s = 1.7320508075688772f;  // sqrt(3)
    grad = -1.5f * expf(-s * r);
  } else {
    static_assert(FAMILY == kMatern52, "tail_grad: exponential and Matern families only");
    const float s = 2.23606797749979f;  // sqrt(5)
    grad = -(5.0f / 6.0f) * (1.0f + s * r) * expf(-s * r);
  }
  return d2 < 1e-36f ? 0.0f : grad;
}

// acc[r][c] = d2 between row row0 + ty + r * kThreadsY of xs and column
// col0 + tx + c * kThreadsX of zs (both [*, d] row-major); rows and columns
// past n and m get the distance of zero-filled points. Called by all threads
// of the block (it synchronises).
template <typename T>
__device__ __forceinline__ void tile_d2(const T* __restrict__ xs, const T* __restrict__ zs,
                                        int n, int m, int d, int row0, int col0,
                                        float (&acc)[kRowsPerThread][kColsPerThread]) {
  __shared__ float xs_s[kChunkD][kTileN];
  __shared__ float zs_s[kChunkD][kTileM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kChunkD) {
    // Stage this chunk of dimensions; out-of-range rows and dimensions are 0.
    for (int i = tid; i < kTileN * kChunkD; i += kThreads) {
      const int rr = i / kChunkD;
      const int kk = i % kChunkD;
      const int gr = row0 + rr;
      const int gk = k0 + kk;
      xs_s[kk][rr] = (gr < n && gk < d) ? to_float(xs[static_cast<int64_t>(gr) * d + gk]) : 0.0f;
    }
    for (int i = tid; i < kTileM * kChunkD; i += kThreads) {
      const int cc = i / kChunkD;
      const int kk = i % kChunkD;
      const int gc = col0 + cc;
      const int gk = k0 + kk;
      zs_s[kk][cc] = (gc < m && gk < d) ? to_float(zs[static_cast<int64_t>(gc) * d + gk]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kChunkD; ++kk) {
      float xv[kRowsPerThread];
      float zv[kColsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) xv[r] = xs_s[kk][ty + r * kThreadsY];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) zv[c] = zs_s[kk][tx + c * kThreadsX];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const float diff = xv[r] - zv[c];
          acc[r][c] = fmaf(diff, diff, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace gpflow_stationary
