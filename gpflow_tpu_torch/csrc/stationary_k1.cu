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
// What bounds it on an H100: at D = 8 an element costs about 3D + 8 flops,
// while its 4-byte output store is the only device-memory traffic that grows
// with N * M: the [32768, 4096] block of the matrix-free CGLB is 512 MiB
// written against 1.1 MiB read. The kernel is bound by the write bandwidth of
// device memory, and every output element is written exactly
// once, where the plain PyTorch version (matmul, norm broadcast, clamp, tail,
// scale) makes several full passes over the [N, M] matrix.
//
// Design (stationary_tile.cuh says how d2 is formed, staged and tiled): a
// persistent grid of at most the resident blocks walks ROWS x 128 tiles. On
// the TMA path a block writes a finished tile into one of two shared-memory
// buffers as float4s and one thread stores it with a bulk tensor copy, so the
// block computes tile t + 1 while tile t drains to device memory; before a
// buffer is written again, that thread waits until the store of two tiles ago
// has read it. The tensor map, made on the host on every call (it holds the
// output's base), clips the ragged edge, so the tile needs no masks. The edge
// path, for an M % 4 != 0 or an unaligned output, writes each element with a
// masked store from registers instead.
//
// var and alpha are read from device memory, so the launch needs no host
// synchronisation.

#include "stationary_tile.cuh"

namespace {

using namespace gpflow_stationary;

template <int FAMILY, typename T, int ROWS, bool TMA>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm<ROWS>)
stationary_k1_kernel(const __grid_constant__ CUtensorMap out_map, const void* __restrict__ xs_ptr,
                     const void* __restrict__ zs_ptr, const float* __restrict__ var_ptr,
                     const float* __restrict__ alpha_ptr, float* __restrict__ out, int n, int m, int d, int vec) {
  constexpr int R = ROWS / kThreadsY;
  using Layout = SmemLayout<ROWS, TMA>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  float* xs_s = reinterpret_cast<float*>(smem + Layout::kXsOffset);
  float* zs_s = reinterpret_cast<float*>(smem + Layout::kZsOffset);
  const T* xs = static_cast<const T*>(xs_ptr);
  const T* zs = static_cast<const T*>(zs_ptr);

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const float var = *var_ptr;
  const float alpha = *alpha_ptr;
  const TileGrid grid(n, m, ROWS);
  int xs_row0 = -1;

  int it = 0;
  for (int64_t t = blockIdx.x; t < grid.tiles; t += gridDim.x, ++it) {
    const int row0 = grid.row0(t, ROWS);
    const int col0 = grid.col0(t);
    // This tile's buffer was last stored two tiles ago; tile_d2's barrier
    // passes the wait on to every thread before any of them writes it.
    if (TMA && tid == 0) bulk_wait_read<1>();

    float acc[R][kColsPerThread];
    tile_d2<ROWS>(xs, zs, n, m, d, row0, col0, vec != 0, xs_s, zs_s, xs_row0, acc);

    if constexpr (TMA) {
      float* buf = reinterpret_cast<float*>(smem + (it & 1) * Layout::kTileBytes);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = make_float4(var * tail_value<FAMILY>(acc[r][0], alpha),
                                     var * tail_value<FAMILY>(acc[r][1], alpha),
                                     var * tail_value<FAMILY>(acc[r][2], alpha),
                                     var * tail_value<FAMILY>(acc[r][3], alpha));
        *reinterpret_cast<float4*>(buf + (ty + r * kThreadsY) * kTileM + kColsPerThread * tx) = v;
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) tma_store_2d(&out_map, buf, col0, row0);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + ty + r * kThreadsY;
        if (row >= n) break;
        float* out_row = out + static_cast<int64_t>(row) * m;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const int col = col0 + kColsPerThread * tx + c;
          if (col < m) out_row[col] = var * tail_value<FAMILY>(acc[r][c], alpha);
        }
      }
      __syncthreads();  // every thread is done with the staged Xs and Zs
    }
  }
  if (TMA && tid == 0) bulk_wait_all();
}

template <int FAMILY, typename T>
const void* kernel_for_rows(int rows, bool tma) {
  switch (rows) {
    case 64:
      return tma ? reinterpret_cast<const void*>(stationary_k1_kernel<FAMILY, T, 64, true>)
                 : reinterpret_cast<const void*>(stationary_k1_kernel<FAMILY, T, 64, false>);
    case 32:
      return tma ? reinterpret_cast<const void*>(stationary_k1_kernel<FAMILY, T, 32, true>)
                 : reinterpret_cast<const void*>(stationary_k1_kernel<FAMILY, T, 32, false>);
    case 16:
      return tma ? reinterpret_cast<const void*>(stationary_k1_kernel<FAMILY, T, 16, true>)
                 : reinterpret_cast<const void*>(stationary_k1_kernel<FAMILY, T, 16, false>);
    default:
      return nullptr;
  }
}

template <typename T>
const void* kernel_for_family(int family, int rows, bool tma) {
  switch (family) {
    case kRbf: return kernel_for_rows<kRbf, T>(rows, tma);
    case kExponential: return kernel_for_rows<kExponential, T>(rows, tma);
    case kMatern12: return kernel_for_rows<kMatern12, T>(rows, tma);
    case kMatern32: return kernel_for_rows<kMatern32, T>(rows, tma);
    case kMatern52: return kernel_for_rows<kMatern52, T>(rows, tma);
    case kRq: return kernel_for_rows<kRq, T>(rows, tma);
    default: return nullptr;
  }
}

// The instantiation for these runtime choices, or nullptr; its dynamic
// shared memory in *smem.
const void* kernel_for(int family, int input_is_bf16, int rows, int tma, int* smem) {
  switch (rows) {
    case 64: *smem = tma ? SmemLayout<64, true>::kBytes : SmemLayout<64, false>::kBytes; break;
    case 32: *smem = tma ? SmemLayout<32, true>::kBytes : SmemLayout<32, false>::kBytes; break;
    case 16: *smem = tma ? SmemLayout<16, true>::kBytes : SmemLayout<16, false>::kBytes; break;
    default: return nullptr;
  }
  return input_is_bf16 ? kernel_for_family<__nv_bfloat16>(family, rows, tma != 0)
                       : kernel_for_family<float>(family, rows, tma != 0);
}

}  // namespace

// Plain C entry points, loaded with ctypes.
//
// gpflow_k1_occupancy: for the instantiation (family, input type, tile
// height, TMA or edge path), the SMs of the current device and the blocks
// one SM keeps resident. Returns a cudaError_t (0 on success).
extern "C" int gpflow_k1_occupancy(int family, int input_is_bf16, int tile_rows, int tma, int* sms,
                                   int* ctas_per_sm) {
  int smem = 0;
  const void* kernel = kernel_for(family, input_is_bf16, tile_rows, tma, &smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return gpflow_stationary_host::occupancy(kernel, smem, sms, ctas_per_sm);
}

// gpflow_k1_stationary_forward: xs: [n, d], zs: [m, d], both row-major and of
// one type (f32, or bf16 when input_is_bf16 != 0); var and alpha: one f32
// each in device memory; out: [n, m] row-major f32. The launch plan of
// gpflow_tpu_torch/ops/pallas_distance.py::_launch_plan: tile_rows (one of
// 64, 32, 16), grid (persistent blocks), tma (1: M % 4 == 0 and out 16-byte
// aligned) and vec (1: d % 4 == 0 and xs, zs aligned to four elements).
// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success), or a negative code if the output's tensor map cannot be made.
extern "C" int gpflow_k1_stationary_forward(int family, int input_is_bf16, const void* xs, const void* zs,
                                            const void* var, const void* alpha, void* out, int n, int m, int d,
                                            int tile_rows, int grid, int tma, int vec, void* stream) {
  int smem = 0;
  const void* kernel = kernel_for(family, input_is_bf16, tile_rows, tma, &smem);
  if (kernel == nullptr || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap out_map = {};
  if (tma) {
    const int err = gpflow_stationary_host::make_tile_map(&out_map, out, n, m, tile_rows);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&out_map, &xs, &zs, &var, &alpha, &out, &n, &m, &d, &vec};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(gpflow_stationary::kThreadsX, gpflow_stationary::kThreadsY),
                         args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
