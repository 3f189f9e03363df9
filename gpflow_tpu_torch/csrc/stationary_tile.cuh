// The persistent tile walk, the pairwise squared distance and the TMA plumbing
// shared by kernels K1 (stationary_k1.cu) and K2 (stationary_k2.cu), and the
// tails h and h' of the six isotropic families of
// gpflow_tpu/ops/pallas_distance.py. Both kernels form d2 with this one
// routine, so the backward pass sees exactly the d2 of the forward.
//
// d2 is taken directly as a sum of squared differences with fp32 FMAs, not by
// the norm expansion |x|^2 - 2 x.z + |z|^2 that the TPU kernels and the plain
// versions use. Every term is non-negative, so d2 carries a relative error of
// at most about (D + 1) * 2^-24 and never goes negative; the expansion
// instead carries an absolute error of about 2^-24 * (|x|^2 + |z|^2), which
// near x = z swamps d2 itself and must be clamped. The direct form also gives
// d2 = 0 exactly on the diagonal of K(Z, Z) and an exactly symmetric Kuu. No
// tensor-core (TF32) arithmetic is used: rounding the cross term to 10
// mantissa bits is what makes Kuu indefinite (pallas_distance.py:124-131).
// The cost is about 3D + 8 flops per 4-byte output, some 8 flop/B at D = 8,
// under the ratio of an H100's fp32 rate to its memory rate: the bytes bound
// both kernels, with the instructions close behind (see the tails below).
//
// Tiles. The [N, M] output is cut into ROWS x 128 tiles, ROWS one of 64, 32
// and 16 (kernel_for in each kernel's source), picked per launch by the host
// (_launch_plan in gpflow_tpu_torch/ops/pallas_distance.py) so that the
// smallest shape of a path still gives several tiles per SM. A block of
// 32 x 8 threads is persistent: the grid holds at most as many blocks as the
// card keeps resident, and block b walks tiles b, b + gridDim.x, ... in
// row-major order.
// Thread (tx, ty) owns rows ty + 8 r of a tile and the four consecutive
// columns 4 tx .. 4 tx + 3, so that it reads Zs and moves its outputs as
// 16-byte vectors. Each tile stages its Zs rows (and its Xs rows, unless the
// block stays on the same row strip and D fits in one chunk) in shared memory
// eight dimensions at a time, transposed to [dimension][point] so that the
// d2 loop reads Xs as warp-wide broadcasts and Zs as one float4 per thread.
// The staging maps consecutive threads to consecutive points, so its stores
// are free of bank conflicts; it loads four dimensions at once (a float4, or
// two __nv_bfloat162) where D % 4 == 0 and both bases are aligned to that
// vector (the host's `vec`), else one element at a time. Points past N or M
// and dimensions past D are zero-filled: they add exactly 0 to d2.
//
// Output. On the TMA path (the host's `tma`: M % 4 == 0, so that a row of
// the [N, M] matrix is a multiple of 16 bytes, and 16-byte aligned bases)
// a finished tile goes to one of two shared-memory buffers, and one thread
// hands it to the Tensor Memory Accelerator with a 2-D bulk tensor store,
// which clips the ragged edge of N and M; the block computes the next tile
// while the store drains, and waits for a buffer's previous store to have
// read it before writing it again. On the edge path (any other M or
// alignment) each thread writes its outputs with masked 4-byte stores, still
// from the persistent walk.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gpflow_stationary {

constexpr int kThreadsX = 32;      // threads along the columns (one warp)
constexpr int kThreadsY = 8;       // threads along the rows
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kColsPerThread = 4;  // consecutive columns: one float4
constexpr int kTileM = kThreadsX * kColsPerThread;  // 128 output columns per tile
constexpr int kChunkD = 8;         // dimensions staged in shared memory per step

// Family codes; gpflow_tpu_torch/ops/pallas_distance.py holds the same table.
enum Family : int { kRbf = 0, kExponential = 1, kMatern12 = 2, kMatern32 = 3, kMatern52 = 4, kRq = 5 };

// A failed cuTensorMapEncodeTiled (or a CUDA without it) returns
// kTensorMapError - CUresult from an entry point: negative, apart from every
// cudaError_t.
constexpr int kTensorMapError = -1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The tails stay IEEE float32 (expf, sqrtf, division). The special-function
// unit's approximations (ex2.approx, sqrt.approx, rcp.approx) made K1 8%
// (rbf) to 28% (matern52) faster at [32768, 4096, 8] on an H100 80GB HBM3 at
// 700 W, with the same error against float64 entry by entry, but their
// errors are correlated from one entry to the next: the ill-conditioned
// Nystrom solve of a float32 CGLB turned them into a bound above the upper
// bound at an adversarial v (chip_smoke.py, cglb_adversarial).

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

// ---------------------------------------------------------------------------
// Shared memory of one block: on the TMA path two [ROWS][kTileM] f32 tile
// buffers first (128-byte aligned, as the bulk tensor copies need), then the
// staged Xs [kChunkD][ROWS] and Zs [kChunkD][kTileM] and two mbarriers.
template <int ROWS, bool TMA>
struct SmemLayout {
  static constexpr int kTileBytes = ROWS * kTileM * 4;
  static constexpr int kXsOffset = TMA ? 2 * kTileBytes : 0;
  static constexpr int kZsOffset = kXsOffset + kChunkD * ROWS * 4;
  static constexpr int kBarOffset = kZsOffset + kChunkD * kTileM * 4;
  static constexpr int kAlign = 128;
  // dynamic shared memory is only 16-byte aligned: room to round its base up
  static constexpr int kBytes = kBarOffset + 2 * 8 + kAlign;
};

// Blocks of 256 threads each SM should keep resident, which caps the
// registers a thread may take (__launch_bounds__): left free, the compiler
// takes 96-128 and fits 2. Three 64-row blocks are what the TMA path's
// 72 KB of shared memory allows.
template <int ROWS>
constexpr int kMinBlocksPerSm = ROWS == 64 ? 3 : 4;

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 127) & ~uintptr_t(127));
}

// Row-major tiles of rows x kTileM over [n, m] (n, m >= 1), indexed in
// int64 (n * m may pass 2^31).
struct TileGrid {
  int64_t tiles;
  int tiles_m;
  __device__ TileGrid(int n, int m, int rows)
      : tiles(static_cast<int64_t>((n - 1) / rows + 1) * ((m - 1) / kTileM + 1)), tiles_m((m - 1) / kTileM + 1) {}
  __device__ int row0(int64_t t, int rows) const { return static_cast<int>(t / tiles_m) * rows; }
  __device__ int col0(int64_t t) const { return static_cast<int>(t % tiles_m) * kTileM; }
};

// ---------------------------------------------------------------------------
// PTX of the asynchronous proxy (sm_90).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA) reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int col, int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(src))
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed bulk stores still have to
// read their shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Waits until every committed bulk store of this thread is complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Loads the [rows][kTileM] box at (row, col) into dst; the mbarrier's phase
// completes when its bytes have landed. Elements past the tensor's edge
// arrive as zeros.
__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map, void* dst, uint64_t* bar, int col, int row,
                                            uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// Spins until the mbarrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// Staging. Four dimensions k0 + 4h .. k0 + 4h + 3 of one point, upcast to f32.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// dst[kk][i] = src[p0 + i, k0 + kk] for i < COUNT points and kk < kChunkD,
// zero past `count` points or d dimensions. Thread tid handles points
// tid % COUNT (consecutive threads on consecutive points: conflict-free
// stores); with vec it loads four dimensions at once, which needs d % 4 == 0
// and a base aligned to four elements (the host checks both).
template <int COUNT, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int count, int d, int p0, int k0, bool vec,
                                      float* __restrict__ dst, int tid) {
  if (vec) {
    constexpr int kVecs = COUNT * (kChunkD / 4);
    for (int i = tid; i < kVecs; i += kThreads) {
      const int p = i % COUNT;
      const int h = i / COUNT;
      const int gk = k0 + 4 * h;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p0 + p < count && gk < d) v = load4(src + static_cast<int64_t>(p0 + p) * d + gk);
      dst[(4 * h + 0) * COUNT + p] = v.x;
      dst[(4 * h + 1) * COUNT + p] = v.y;
      dst[(4 * h + 2) * COUNT + p] = v.z;
      dst[(4 * h + 3) * COUNT + p] = v.w;
    }
  } else {
    for (int i = tid; i < COUNT * kChunkD; i += kThreads) {
      const int p = i % COUNT;
      const int kk = i / COUNT;
      const int gk = k0 + kk;
      dst[kk * COUNT + p] =
          (p0 + p < count && gk < d) ? to_float(src[static_cast<int64_t>(p0 + p) * d + gk]) : 0.0f;
    }
  }
}

// acc[r][c] = d2 between row row0 + ty + 8 r of xs and column
// col0 + 4 tx + c of zs (both [*, d] row-major), summed over the dimensions
// in order; points past n and m get the distance of zero-filled points.
// Called by all threads of the block: it synchronises before reading what it
// staged, but not after, so the caller must synchronise before the next
// call. `xs_row0` is the row strip whose Xs the buffer holds (-1: none); with
// d <= kChunkD a block that stays on that strip restages only Zs. Xs is read
// one dimension of a row at a time (a warp-wide broadcast): staged
// point-major and read as float4s, it took 2-4% off K1 but made K2's 64- and
// 32-row TMA variants spill and 4-11% slower (H100 80GB HBM3, 700 W).
template <int ROWS, typename T>
__device__ __forceinline__ void tile_d2(const T* __restrict__ xs, const T* __restrict__ zs, int n, int m, int d,
                                        int row0, int col0, bool vec, float* __restrict__ xs_s,
                                        float* __restrict__ zs_s, int& xs_row0,
                                        float (&acc)[ROWS / kThreadsY][kColsPerThread]) {
  constexpr int R = ROWS / kThreadsY;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;

#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kChunkD) {
    if (k0 > 0) __syncthreads();  // every thread is done with the previous chunk
    if (d > kChunkD || row0 != xs_row0) stage<ROWS>(xs, n, d, row0, k0, vec, xs_s, tid);
    stage<kTileM>(zs, m, d, col0, k0, vec, zs_s, tid);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kChunkD; ++kk) {
      float xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = xs_s[kk * ROWS + ty + r * kThreadsY];
      const float4 z = *reinterpret_cast<const float4*>(zs_s + kk * kTileM + kColsPerThread * tx);
      const float zv[kColsPerThread] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const float diff = xv[r] - zv[c];
          acc[r][c] = fmaf(diff, diff, acc[r][c]);
        }
      }
    }
  }
  xs_row0 = d > kChunkD ? -1 : row0;
}

}  // namespace gpflow_stationary

// ---------------------------------------------------------------------------
// Host side: the tensor map of an [n, m] row-major f32 matrix cut in
// [rows][kTileM] boxes, and the occupancy of a kernel.
namespace gpflow_stationary_host {

using gpflow_stationary::kTensorMapError;
using gpflow_stationary::kTileM;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime has already loaded it, looked up
// once, so the library links against no libcuda and builds with the
// package's plain nvcc flags.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiledFn>(p)
                                                                          : nullptr;
  }();
  return fn;
}

// 0, or kTensorMapError - CUresult.
inline int make_tile_map(CUtensorMap* map, void* base, int n, int m, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError - static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kTileM), static_cast<cuuint32_t>(rows)};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box, element_strides,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError - static_cast<int>(res);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (over 48 KB only
// by request) and writes the SMs of the current device and the blocks of
// `kernel` one SM keeps resident.
inline int occupancy(const void* kernel, int smem, int* sms, int* ctas_per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, gpflow_stationary::kThreads, smem);
  }
  return static_cast<int>(err);
}

}  // namespace gpflow_stationary_host
