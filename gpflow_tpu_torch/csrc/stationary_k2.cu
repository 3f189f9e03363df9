// K2: the VJP weight of a stationary covariance matrix, hand-written for
// Hopper (sm_90a).
//
// Replaces gpflow_tpu/ops/pallas_distance.py::_wgrad_block_kernel (launched
// by _stationary_pallas_wgrad). For inputs already divided by the
// lengthscales and the cotangent g of K = var * h(d2) it computes
//
//     W[i, j] = g[i, j] * (var * h'(d2)),   d2 = sum_k (xs[i, k] - zs[j, k])^2
//
// for the families whose h' is not a multiple of h (exponential and
// Matern 1/2, 3/2, 5/2), chosen at compile time; rbf and rq take W from the
// saved K without a kernel. Inputs are f32 or bf16 and are upcast on load; g,
// the arithmetic and the [N, M] output are f32. d2 is rematerialised tile by
// tile with the routine K1 uses (stationary_tile.cuh), so the backward sees
// bit for bit the d2 of the forward. Where d2 falls under the 1e-36 clip of
// r (coincident points, such as the diagonal of a Gram matrix K(X, X)), W is
// 0, the derivative of h(sqrt(max(d2, 1e-36))); the 1/r of exponential and
// Matern 1/2 would otherwise give about -5e17 there.
//
// What bounds it on an H100: at D = 8 an element costs about 3D + 12 flops,
// against 8 bytes of device-memory traffic (g read, W written) that grow with
// N * M: the 2048 x 8192 Kuf of a training step is 128 MiB, at least about
// 40 us at 3.35 TB/s. The kernel is bound by memory bandwidth. It reads each
// g and writes each W exactly once, where the plain version (matmul, norm
// broadcast, clamp, sqrt, tail, two scales) makes several passes over
// [N, M]. The layout is K1's: a warp's 32 threads sit on 32 consecutive
// columns, so every load of g and every store of W moves 128 contiguous bytes
// per warp. Each thread issues its 32 loads of g before the d2 loop, so that
// they are in flight while d2 is formed. No padding: the block masks its own
// ragged edge. No tensor-core arithmetic.
//
// var is read from device memory, so the launch needs no host
// synchronisation.

#include "stationary_tile.cuh"

namespace {

using namespace gpflow_stationary;

template <int FAMILY, typename T>
__global__ void __launch_bounds__(kThreads)
stationary_k2_kernel(const T* __restrict__ xs, const T* __restrict__ zs,
                     const float* __restrict__ var_ptr, const float* __restrict__ g,
                     float* __restrict__ w, int n, int m, int d) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int col0 = blockIdx.x * kTileM;
  const int row0 = blockIdx.y * kTileN;

  float gv[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + ty + r * kThreadsY;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = col0 + tx + c * kThreadsX;
      gv[r][c] = (row < n && col < m) ? g[static_cast<int64_t>(row) * m + col] : 0.0f;
    }
  }

  float acc[kRowsPerThread][kColsPerThread];
  tile_d2(xs, zs, n, m, d, row0, col0, acc);

  const float var = *var_ptr;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + ty + r * kThreadsY;
    if (row >= n) break;
    float* w_row = w + static_cast<int64_t>(row) * m;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = col0 + tx + c * kThreadsX;
      if (col < m) w_row[col] = gv[r][c] * (var * tail_grad<FAMILY>(acc[r][c]));
    }
  }
}

template <typename T>
int launch(int family, const void* xs, const void* zs, const float* var, const float* g,
           float* w, int n, int m, int d, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  const T* x = static_cast<const T*>(xs);
  const T* z = static_cast<const T*>(zs);
  switch (family) {
    case kExponential:
      stationary_k2_kernel<kExponential, T><<<grid, block, 0, stream>>>(x, z, var, g, w, n, m, d);
      break;
    case kMatern12:
      stationary_k2_kernel<kMatern12, T><<<grid, block, 0, stream>>>(x, z, var, g, w, n, m, d);
      break;
    case kMatern32:
      stationary_k2_kernel<kMatern32, T><<<grid, block, 0, stream>>>(x, z, var, g, w, n, m, d);
      break;
    case kMatern52:
      stationary_k2_kernel<kMatern52, T><<<grid, block, 0, stream>>>(x, z, var, g, w, n, m, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. family: a code of
// stationary_tile.cuh (exponential, matern12, matern32 or matern52); xs:
// [n, d], zs: [m, d], both row-major and of one type (f32, or bf16 when
// input_is_bf16 != 0); var: one f32 in device memory; g and w: [n, m]
// row-major f32. Launches on `stream` and returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int gpflow_k2_stationary_wgrad(int family, int input_is_bf16, const void* xs,
                                          const void* zs, const void* var, const void* g,
                                          void* w, int n, int m, int d, void* stream) {
  const float* v = static_cast<const float*>(var);
  const float* gp = static_cast<const float*>(g);
  float* o = static_cast<float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (input_is_bf16) return launch<__nv_bfloat16>(family, xs, zs, v, gp, o, n, m, d, s);
  return launch<float>(family, xs, zs, v, gp, o, n, m, d, s);
}
