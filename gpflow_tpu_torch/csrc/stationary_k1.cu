// K1: fused stationary covariance matrix, hand-written for Hopper (sm_90a).
//
// Replaces gpflow_tpu/ops/pallas_distance.py::_value_block_kernel (launched
// by _stationary_pallas_forward). For inputs already divided by the
// lengthscales it computes
//
//     out[i, j] = var * h(d2),   d2 = sum_k (xs[i, k] - zs[j, k])^2
//
// for the six isotropic families of that module (rbf, exponential,
// matern12/32/52, rq), chosen at compile time. Inputs are f32 or bf16 and are
// upcast on load; arithmetic and the [N, M] output are f32.
//
// What bounds it on an H100: at D = 8 an element costs about 3D + 10 flops
// (a subtract and an FMA per dimension plus the tail), while its 4-byte
// output store is the only device-memory traffic that grows with N * M: the
// 2048 x 8192 Kuf of the serving path is 64 MB written against 320 KB read.
// The kernel is therefore bound by the write bandwidth of device memory. The
// design writes every output element exactly once, straight from registers,
// where the plain PyTorch version (matmul, norm broadcast, clamp, tail,
// scale) makes several full passes over the [N, M] matrix.
//
// d2 comes from the tile routine shared with K2 (stationary_tile.cuh), which
// says how it is formed and why. A block of 32 x 8 threads owns a 64-row x
// 128-column output tile, each thread 8 rows x 4 columns with a warp on 32
// consecutive columns, so that every store instruction of a warp writes 128
// contiguous bytes; the block masks the ragged edge of N and M itself.
//
// var and alpha are read from device memory, so the launch needs no host
// synchronisation.

#include "stationary_tile.cuh"

namespace {

using namespace gpflow_stationary;

template <int FAMILY, typename T>
__global__ void __launch_bounds__(kThreads)
stationary_k1_kernel(const T* __restrict__ xs, const T* __restrict__ zs,
                     const float* __restrict__ var_ptr, const float* __restrict__ alpha_ptr,
                     float* __restrict__ out, int n, int m, int d) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int col0 = blockIdx.x * kTileM;
  const int row0 = blockIdx.y * kTileN;

  float acc[kRowsPerThread][kColsPerThread];
  tile_d2(xs, zs, n, m, d, row0, col0, acc);

  const float var = *var_ptr;
  const float alpha = *alpha_ptr;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + ty + r * kThreadsY;
    if (row >= n) break;
    float* out_row = out + static_cast<int64_t>(row) * m;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = col0 + tx + c * kThreadsX;
      if (col < m) out_row[col] = var * tail_value<FAMILY>(acc[r][c], alpha);
    }
  }
}

template <typename T>
int launch(int family, const void* xs, const void* zs, const float* var, const float* alpha,
           float* out, int n, int m, int d, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  const T* x = static_cast<const T*>(xs);
  const T* z = static_cast<const T*>(zs);
  switch (family) {
    case kRbf:
      stationary_k1_kernel<kRbf, T><<<grid, block, 0, stream>>>(x, z, var, alpha, out, n, m, d);
      break;
    case kExponential:
      stationary_k1_kernel<kExponential, T><<<grid, block, 0, stream>>>(x, z, var, alpha, out, n, m, d);
      break;
    case kMatern12:
      stationary_k1_kernel<kMatern12, T><<<grid, block, 0, stream>>>(x, z, var, alpha, out, n, m, d);
      break;
    case kMatern32:
      stationary_k1_kernel<kMatern32, T><<<grid, block, 0, stream>>>(x, z, var, alpha, out, n, m, d);
      break;
    case kMatern52:
      stationary_k1_kernel<kMatern52, T><<<grid, block, 0, stream>>>(x, z, var, alpha, out, n, m, d);
      break;
    case kRq:
      stationary_k1_kernel<kRq, T><<<grid, block, 0, stream>>>(x, z, var, alpha, out, n, m, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. xs: [n, d], zs: [m, d], both
// row-major and of one type (f32, or bf16 when input_is_bf16 != 0); var and
// alpha: one f32 each in device memory; out: [n, m] row-major f32. Launches
// on `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int gpflow_k1_stationary_forward(int family, int input_is_bf16, const void* xs,
                                            const void* zs, const void* var, const void* alpha,
                                            void* out, int n, int m, int d, void* stream) {
  const float* v = static_cast<const float*>(var);
  const float* a = static_cast<const float*>(alpha);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (input_is_bf16) return launch<__nv_bfloat16>(family, xs, zs, v, a, o, n, m, d, s);
  return launch<float>(family, xs, zs, v, a, o, n, m, d, s);
}
