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
// Layout: a block of 32 x 8 threads owns a 64-row x 128-column output tile;
// each thread owns 8 rows x 4 columns, with consecutive threads of a warp on
// consecutive columns so that every store instruction of a warp writes 128
// contiguous bytes. The block stages its Xs and Zs rows in shared memory,
// eight dimensions at a time, and accumulates d2 in registers. No padding:
// each block masks the ragged edge of N and M itself, and zero-fills missing
// dimensions of the last chunk, which adds exactly 0 to d2.
//
// Accuracy: d2 is taken directly as a sum of squared differences with fp32
// FMAs, not by the norm expansion |x|^2 - 2 x.z + |z|^2 that the TPU kernel
// and the plain version use. Every term is non-negative, so d2 carries a
// relative error of at most about (D + 1) * 2^-24 and never goes negative;
// the expansion instead carries an absolute error of about
// 2^-24 * (|x|^2 + |z|^2), which near x = z swamps d2 itself and must be
// clamped. The direct form also gives d2 = 0 exactly on the diagonal of
// K(Z, Z) and an exactly symmetric Kuu. No tensor-core (TF32) arithmetic is
// used: rounding the cross term to 10 mantissa bits is what makes Kuu
// indefinite (pallas_distance.py:128-131).
//
// var and alpha are read from device memory, so the launch needs no host
// synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

// h(d2) of gpflow_tpu/ops/pallas_distance.py::_tail_value, with the same
// 1e-36 clip under the square root of the r-based families.
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

template <int FAMILY, typename T>
__global__ void __launch_bounds__(kThreads)
stationary_k1_kernel(const T* __restrict__ xs, const T* __restrict__ zs,
                     const float* __restrict__ var_ptr, const float* __restrict__ alpha_ptr,
                     float* __restrict__ out, int n, int m, int d) {
  __shared__ float xs_s[kChunkD][kTileN];
  __shared__ float zs_s[kChunkD][kTileM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int col0 = blockIdx.x * kTileM;
  const int row0 = blockIdx.y * kTileN;

  float acc[kRowsPerThread][kColsPerThread];
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
