// Fused row RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps)
// * w, the mean-square in fp32, y in x's dtype (bf16 or fp32), w fp32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm /
// _rmsnorm_kernel), which fuses the same math into one VMEM pass per
// [block_rows, d] tile; the reference's models normalise through the jnp
// models/layers.py::rmsnorm, the same function.
//
// What bounds it on the H100: ~4 flops per element against 2 * sizeof(x)
// bytes (read x, write y), far below the ~295 flop/byte ridge, so it is
// bound by bytes: rows * d * 2 * sizeof(x) + 4 * d over 3.35 TB/s.  At
// serving's decode shapes (8 rows) the launch itself dominates.
//
// Design:
//  * one block of 256 threads per row (any row count; no padding to a
//    block multiple as on the TPU); the grid walks rows;
//  * the row is read from device memory once, with 16-byte loads where
//    d, the row stride and the pointers allow it (8 bf16 or 4 fp32 a
//    load) and element loads otherwise, and kept in shared memory as
//    fp32 (d floats of dynamic shared memory, 16 KB at d = 4096);
//  * each thread sums the squares of its elements in fp32, warps reduce
//    by shuffles and the 8 warp sums meet in shared memory;
//  * rsqrtf(sum / d + eps), then y = (x * r) * w in the order of the
//    plain version, rounded once to x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int d, long long x_rs, long long y_rs,
               float eps, int vec) {
  extern __shared__ float row[];
  __shared__ float wsum[NW];
  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte load
  const T* xr = x + blockIdx.x * x_rs;
  T* yr = y + blockIdx.x * y_rs;
  const int tid = threadIdx.x;

  float ss = 0.f;
  if (vec) {
    for (int i = tid * V; i < d; i += NT * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        row[i + j] = f;
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = tid; i < d; i += NT) {
      const float f = to_f(xr[i]);
      row[i] = f;
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) wsum[tid >> 5] = ss;
  __syncthreads();  // also orders every row[] write before the reads
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) total += wsum[i];
  const float r = rsqrtf(total / (float)d + eps);

  if (vec) {
    for (int i = tid * V; i < d; i += NT * V) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) from_f(row[i + j] * r * w[i + j], e + j);
      *reinterpret_cast<uint4*>(yr + i) = raw;
    }
  } else {
    for (int i = tid; i < d; i += NT) from_f(row[i] * r * w[i], yr + i);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int d,
           long long x_rs, long long y_rs, float eps, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = d % V == 0 && x_rs % V == 0 && y_rs % V == 0 &&
                  (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  rmsnorm_kernel<T><<<rows, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (T*)y, d, x_rs, y_rs, eps, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [rows, d] with row stride x_rs elements (last axis contiguous), bf16
// (is_bf16 = 1) or fp32; w: [d] fp32, contiguous; y: [rows, d] in x's
// dtype with row stride y_rs.  Returns the launch's cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int rows,
                           int d, long long x_rs, long long y_rs, float eps,
                           int is_bf16, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, y, rows, d, x_rs, y_rs, eps, stream);
  return launch<float>(x, w, y, rows, d, x_rs, y_rs, eps, stream);
}
