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
// N * M: the [32768, 4096] block of a Matern52 CGLB backward moves 1 GiB.
// The kernel is bound by memory bandwidth; it
// reads each g and writes each W exactly once, where the plain version
// (matmul, norm broadcast, clamp, sqrt, tail, two scales) makes several
// passes over [N, M]. No tensor-core arithmetic.
//
// Design (stationary_tile.cuh says how d2 is formed, staged and tiled): a
// persistent grid walks ROWS x 128 tiles. On the TMA path g arrives by bulk
// tensor loads into a ring of two shared-memory buffers, each with an
// mbarrier that completes when its bytes have landed: once a tile's d2 is
// formed, one thread asks for the next tile's g in the other buffer (whose
// store has read it by then), so the load is in flight while this tile
// finishes and the next one's d2 is formed. W then overwrites g
// in the same buffer (a float4 per thread and row, read and written in
// place) and leaves by a bulk tensor store, as in K1; no cotangent is held in
// registers across the d2 loop. Both tensor maps are made on the host on
// every call and clip the ragged edge (the loads fill it with zeros). The
// edge path, for an M % 4 != 0 or a g or W not 16-byte aligned, reads g and
// writes W with masked 4-byte accesses instead.
//
// var is read from device memory, so the launch needs no host
// synchronisation.

#include "stationary_tile.cuh"

namespace {

using namespace gpflow_stationary;

template <int FAMILY, typename T, int ROWS, bool TMA>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm<ROWS>)
stationary_k2_kernel(const __grid_constant__ CUtensorMap g_map, const __grid_constant__ CUtensorMap w_map,
                     const void* __restrict__ xs_ptr, const void* __restrict__ zs_ptr,
                     const float* __restrict__ var_ptr, const float* __restrict__ g, float* __restrict__ w, int n,
                     int m, int d, int vec) {
  constexpr int R = ROWS / kThreadsY;
  using Layout = SmemLayout<ROWS, TMA>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  float* xs_s = reinterpret_cast<float*>(smem + Layout::kXsOffset);
  float* zs_s = reinterpret_cast<float*>(smem + Layout::kZsOffset);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Layout::kBarOffset);
  const T* xs = static_cast<const T*>(xs_ptr);
  const T* zs = static_cast<const T*>(zs_ptr);

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const float var = *var_ptr;
  const TileGrid grid(n, m, ROWS);
  int xs_row0 = -1;

  if constexpr (TMA) {
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      mbar_init_fence();
      if (blockIdx.x < grid.tiles) {
        tma_load_2d(&g_map, smem, &bars[0], grid.col0(blockIdx.x), grid.row0(blockIdx.x, ROWS),
                    Layout::kTileBytes);
      }
    }
    __syncthreads();
  }

  int it = 0;
  for (int64_t t = blockIdx.x; t < grid.tiles; t += gridDim.x, ++it) {
    const int row0 = grid.row0(t, ROWS);
    const int col0 = grid.col0(t);
    float acc[R][kColsPerThread];
    tile_d2<ROWS>(xs, zs, n, m, d, row0, col0, vec != 0, xs_s, zs_s, xs_row0, acc);

    if constexpr (TMA) {
      // The next tile's g goes to the other buffer, which the previous tile's
      // store has read by now (d2 took the time): it lands while this tile
      // finishes and the next one's d2 is formed.
      const int64_t next = t + gridDim.x;
      if (tid == 0 && next < grid.tiles) {
        const int other = (it + 1) & 1;
        bulk_wait_read<0>();
        tma_load_2d(&g_map, smem + other * Layout::kTileBytes, &bars[other], grid.col0(next),
                    grid.row0(next, ROWS), Layout::kTileBytes);
      }
      const int b = it & 1;
      float* buf = reinterpret_cast<float*>(smem + b * Layout::kTileBytes);
      mbar_wait(&bars[b], (it >> 1) & 1);  // the k-th use of a buffer completes its phase k
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float4* p = reinterpret_cast<float4*>(buf + (ty + r * kThreadsY) * kTileM + kColsPerThread * tx);
        float4 v = *p;
        v.x *= var * tail_grad<FAMILY>(acc[r][0]);
        v.y *= var * tail_grad<FAMILY>(acc[r][1]);
        v.z *= var * tail_grad<FAMILY>(acc[r][2]);
        v.w *= var * tail_grad<FAMILY>(acc[r][3]);
        *p = v;
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) tma_store_2d(&w_map, buf, col0, row0);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + ty + r * kThreadsY;
        if (row >= n) break;
        const int64_t offset = static_cast<int64_t>(row) * m;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const int col = col0 + kColsPerThread * tx + c;
          if (col < m) w[offset + col] = g[offset + col] * (var * tail_grad<FAMILY>(acc[r][c]));
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
      return tma ? reinterpret_cast<const void*>(stationary_k2_kernel<FAMILY, T, 64, true>)
                 : reinterpret_cast<const void*>(stationary_k2_kernel<FAMILY, T, 64, false>);
    case 32:
      return tma ? reinterpret_cast<const void*>(stationary_k2_kernel<FAMILY, T, 32, true>)
                 : reinterpret_cast<const void*>(stationary_k2_kernel<FAMILY, T, 32, false>);
    case 16:
      return tma ? reinterpret_cast<const void*>(stationary_k2_kernel<FAMILY, T, 16, true>)
                 : reinterpret_cast<const void*>(stationary_k2_kernel<FAMILY, T, 16, false>);
    default:
      return nullptr;
  }
}

template <typename T>
const void* kernel_for_family(int family, int rows, bool tma) {
  switch (family) {
    case kExponential: return kernel_for_rows<kExponential, T>(rows, tma);
    case kMatern12: return kernel_for_rows<kMatern12, T>(rows, tma);
    case kMatern32: return kernel_for_rows<kMatern32, T>(rows, tma);
    case kMatern52: return kernel_for_rows<kMatern52, T>(rows, tma);
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
// gpflow_k2_occupancy: for the instantiation (family, input type, tile
// height, TMA or edge path), the SMs of the current device and the blocks
// one SM keeps resident. Returns a cudaError_t (0 on success).
extern "C" int gpflow_k2_occupancy(int family, int input_is_bf16, int tile_rows, int tma, int* sms,
                                   int* ctas_per_sm) {
  int smem = 0;
  const void* kernel = kernel_for(family, input_is_bf16, tile_rows, tma, &smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return gpflow_stationary_host::occupancy(kernel, smem, sms, ctas_per_sm);
}

// gpflow_k2_stationary_wgrad: family, a code of stationary_tile.cuh
// (exponential, matern12, matern32 or matern52); xs: [n, d], zs: [m, d], both
// row-major and of one type (f32, or bf16 when input_is_bf16 != 0); var: one
// f32 in device memory; g and w: [n, m] row-major f32. The launch plan of
// gpflow_tpu_torch/ops/pallas_distance.py::_launch_plan: tile_rows (one of
// 64, 32, 16), grid (persistent blocks), tma (1: M % 4 == 0 and g, w 16-byte
// aligned) and vec (1: d % 4 == 0 and xs, zs aligned to four elements).
// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success), or a negative code if a tensor map cannot be made.
extern "C" int gpflow_k2_stationary_wgrad(int family, int input_is_bf16, const void* xs, const void* zs,
                                          const void* var, const void* g, void* w, int n, int m, int d,
                                          int tile_rows, int grid, int tma, int vec, void* stream) {
  int smem = 0;
  const void* kernel = kernel_for(family, input_is_bf16, tile_rows, tma, &smem);
  if (kernel == nullptr || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap g_map = {};
  CUtensorMap w_map = {};
  if (tma) {
    int err = gpflow_stationary_host::make_tile_map(&g_map, const_cast<void*>(g), n, m, tile_rows);
    if (err == 0) err = gpflow_stationary_host::make_tile_map(&w_map, w, n, m, tile_rows);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&g_map, &w_map, &xs, &zs, &var, &g, &w, &n, &m, &d, &vec};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(gpflow_stationary::kThreadsX, gpflow_stationary::kThreadsY),
                         args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
