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
// serving's decode shapes (8 rows) that is tens of nanoseconds, so the
// time is the launch and the memory round trips.
//
// Design: the row lives in registers, never in shared memory.  A thread
// holds at most K * EPT elements of x (EPT = 8, K = 1, 2 or 4, the least
// that covers the row) and, at K = 1, the matching 8 of w; thread t of a
// row's `nthr` takes the 16-byte vectors t, t + nthr, ... (8 bf16 or 4
// fp32 a vector; single elements where d, the row stride or a pointer do
// not allow vectors).  x (and w) are loaded before any reduction, so a
// row costs one memory round trip, then the sum of squares,
// rsqrtf(sum / d + eps), and y = (x * r) * w in the plain version's
// order, rounded once to x's dtype.  At these sizes the time is latency,
// and the shorter each thread's chain of loads and stores, the sooner a
// row is done, so the host (rmsnorm.rmsnorm_plan) gives a row one thread
// per K * 8 elements: one CTA per row (up to 1024 threads, so K = 1 for
// d <= 8192 and d <= 32768 in all), on a grid sized to the SMs that walks
// the rows (at K = 1 each thread's slice of w is loaded once and reused
// across its rows; at K > 1, where 64 registers a thread must hold K * 8
// elements of x, w is read again a row, from L2, as the row is written);
// warp sums meet in shared memory, double-buffered by row parity, so one
// __syncthreads a row.  (A thread-block cluster per row, which would
// spread a decode row over more SMs, measured slower on the H100 than
// one CTA at every served width, 2560 to 4096, so it is not used.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EPT = 8;            // elements of x a thread holds at K = 1
constexpr int MAX_K = 4;          // most EPT groups a thread holds
constexpr int MAX_THREADS = 1024;

// V consecutive elements of x as fp32, and back
template <typename T, int V>
struct Vec;

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    uint4 raw;
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    f[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    *p = __float2bfloat16(f[0]);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    f[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *p = f[0];
  }
};

// w's elements of vector vi (fp32, 16-byte aligned on the vector path)
template <int V>
__device__ __forceinline__ void load_w(const float* w, int vi, float* f) {
  if constexpr (V == 1) {
    f[0] = w[vi];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + vi * V + i);
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One row's slice of this thread, at most K * EPT elements: load x (and,
// at K = 1, once, w) into registers, and the sum of squares of x.
template <typename T, int V, int K>
struct Slice {
  static constexpr int NV = K * EPT / V;
  static constexpr bool HOLD_W = K == 1;
  float x[NV][V];
  float w[HOLD_W ? NV : 1][V];

  __device__ __forceinline__ void load_weight(const float* wp, int t,
                                              int nthr, int nvec) {
    if constexpr (HOLD_W) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int vi = t + k * nthr;
        if (vi < nvec) load_w<V>(wp, vi, w[k]);
      }
    }
  }
  __device__ __forceinline__ float load_x(const T* xr, int t, int nthr,
                                          int nvec) {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int vi = t + k * nthr;
      if (vi < nvec) {
        Vec<T, V>::load(xr + vi * V, x[k]);
#pragma unroll
        for (int i = 0; i < V; ++i) ss = fmaf(x[k][i], x[k][i], ss);
      }
    }
    return ss;
  }
  __device__ __forceinline__ void store(T* yr, const float* wp, float r,
                                        int t, int nthr, int nvec) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int vi = t + k * nthr;
      if (vi < nvec) {
        float wk[V];
        if constexpr (HOLD_W) {
#pragma unroll
          for (int i = 0; i < V; ++i) wk[i] = w[k][i];
        } else {
          load_w<V>(wp, vi, wk);
        }
        float f[V];
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = x[k][i] * r * wk[i];
        Vec<T, V>::store(yr + vi * V, f);
      }
    }
  }
};

// one CTA per row at a time, rows strided by the grid
template <typename T, int V, int K>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int rows, int d, long long x_rs,
               long long y_rs, float eps) {
  __shared__ float wsum[2][MAX_THREADS / 32];
  const int nthr = blockDim.x, t = threadIdx.x, nvec = d / V;
  const int nwarps = nthr >> 5;
  Slice<T, V, K> sl;
  sl.load_weight(w, t, nthr, nvec);
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const float ss = warp_sum(sl.load_x(x + row * x_rs, t, nthr, nvec));
    if ((t & 31) == 0) wsum[parity][t >> 5] = ss;
    __syncthreads();
    float total = 0.f;
    for (int i = 0; i < nwarps; ++i) total += wsum[parity][i];
    sl.store(y + row * y_rs, w, rsqrtf(total / (float)d + eps), t, nthr,
             nvec);
  }
}

template <typename T, int V, int K>
int launch(const void* x, const void* w, void* y, int rows, int d,
           long long x_rs, long long y_rs, float eps, int threads, int grid,
           cudaStream_t stream) {
  rmsnorm_kernel<T, V, K><<<grid, threads, 0, stream>>>(
      (const T*)x, (const float*)w, (T*)y, rows, d, x_rs, y_rs, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int by_k(int k, const void* x, const void* w, void* y, int rows, int d,
         long long x_rs, long long y_rs, float eps, int threads, int grid,
         cudaStream_t stream) {
  if (k == 1)
    return launch<T, V, 1>(x, w, y, rows, d, x_rs, y_rs, eps, threads, grid,
                           stream);
  if (k == 2)
    return launch<T, V, 2>(x, w, y, rows, d, x_rs, y_rs, eps, threads, grid,
                           stream);
  return launch<T, V, 4>(x, w, y, rows, d, x_rs, y_rs, eps, threads, grid,
                         stream);
}

template <typename T>
int dispatch(int k, const void* x, const void* w, void* y, int rows, int d,
             long long x_rs, long long y_rs, float eps, int threads,
             int grid, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);  // elements in one 16-byte load
  const bool vec = d % V == 0 && x_rs % V == 0 && y_rs % V == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  if (vec)
    return by_k<T, V>(k, x, w, y, rows, d, x_rs, y_rs, eps, threads, grid,
                      stream);
  return by_k<T, 1>(k, x, w, y, rows, d, x_rs, y_rs, eps, threads, grid,
                    stream);
}

}  // namespace

// x: [rows, d] with row stride x_rs elements (last axis contiguous), bf16
// (is_bf16 = 1) or fp32; w: [d] fp32, contiguous; y: [rows, d] in x's
// dtype with row stride y_rs.  The launch shape (rmsnorm.rmsnorm_plan):
// `grid` CTAs of `threads` threads walk the rows, one CTA a row at a
// time; threads * EPT * MAX_K >= d, and a thread holds K * EPT elements,
// K the least of 1, 2, 4 with threads * EPT * K >= d.  Returns the
// launch's cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int rows,
                           int d, long long x_rs, long long y_rs, float eps,
                           int is_bf16, int threads, int grid,
                           void* stream) {
  if (rows <= 0 || d <= 0 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || (long long)threads * EPT * MAX_K < d || grid < 1)
    return (int)cudaErrorInvalidValue;
  int k = 1;
  while ((long long)threads * EPT * k < d) k *= 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(k, x, w, y, rows, d, x_rs, y_rs, eps,
                                   threads, grid, st);
  return dispatch<float>(k, x, w, y, rows, d, x_rs, y_rs, eps, threads,
                         grid, st);
}
