// Mamba1 selective scan for Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py (mamba1_scan /
// _mamba1_kernel), which the reference reaches through
// ops.mamba1_scan_op from models/ssm.mamba1_forward (falcon-mamba).  Per
// channel c and state s it runs the diagonal recurrence
//     h[c, s] <- exp(dt[t, c] * A[c, s]) * h[c, s] + dt[t, c] * x[t, c] * B[t, s]
//     y[t, c]  = sum_s h[c, s] * C[t, s]
// from h0, and returns y and the last h.  The D skip and the silu gate
// stay in PyTorch, as in the reference's adapter.
//
// What bounds it on the H100: each (t, c) element costs ds exps and
// about 3 ds FMAs against 12 bytes of x, dt and y, so at falcon-mamba's
// ds = 16 it is bound by bytes (x, dt and y; B and C are shared by all
// channels of a row) and, nearly as much, by its exps: the special
// function units give 16 a clock per SM, and B*S*di*ds exps at 1.98 GHz
// take 0.90 of the bytes' time at ds = 16.
//
// Design:
//  * the TPU kernel walks chunks of time over a sequential grid axis with
//    the [di, ds] state in VMEM; here P lanes of a warp share a channel,
//    each owning ds / P of its states (and their row of A) in registers,
//    and a loop over time inside the thread takes the place of that axis.
//    y is summed over the P lanes with __shfl_xor_sync in a fixed
//    butterfly, so reruns give equal bits.  P = 2 or 4 comes from the
//    host (mamba_scan.mamba1_plan): at batch 1 one lane per channel would
//    give di / 32 warps, half of falcon-mamba's 132 SMs' worth;
//  * a block of NT threads takes NT / P channels of one batch row.  It
//    stages x and dt for a tile of TT = 16 P steps (2048 floats of each)
//    in shared memory with 16-byte cp.async copies of 4 channels (the
//    host hands di in multiples of 4 and x, dt and y on 16-byte
//    boundaries), double-buffered: the next tile is in flight while the
//    current tile's recurrence runs, so no global load sits on the
//    recurrence's chain.  B[b, t, :] and C[b, t, :], the same
//    for every channel of a row, are staged with them and read as
//    broadcasts.  y goes out through shared memory in coalesced rows.
//    The recurrence takes U = 8 steps at a time: their loads, then the
//    steps, then the lane sums, then y's stores, since a store to shared
//    memory between one step's loads and the next would keep the
//    compiler from issuing the next step's loads early;
//  * each exponential is one ex2.approx: A is prescaled by log2(e) once
//    per thread and exp(dt a) is computed as 2^(dt a log2 e);
//  * the loop is bounded by S itself.  The reference pads S to its chunk
//    with dt = 0 and x = 0, which leaves h unchanged, so stopping at S is
//    exact;
//  * B and C are addressed by strides (they are slices of one
//    projection in the model), with their last axis contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads a block
constexpr int TILE = 2048;       // x (and dt) floats a staged tile holds
constexpr int U = 8;             // steps whose loads go ahead together
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 or 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DS, int P>
struct Tiles {
  static constexpr int CPB = NT / P;        // channels a block
  static constexpr int TT = TILE / CPB;     // steps a tile
  float x[2][TT * CPB];
  float dt[2][TT * CPB];
  float b[2][TT * DS];
  float c[2][TT * DS];
  float y[TT * CPB];
};

template <int DS, int P>
__global__ void __launch_bounds__(NT)
mamba1_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ h0,
                   float* __restrict__ y, float* __restrict__ h_last,
                   int S, int di, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss) {
  using T = Tiles<DS, P>;
  constexpr int CPB = T::CPB, TT = T::TT, SP = DS / P;
  constexpr int G = CPB / 4;                  // 16-byte groups of channels
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T& sm = *reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.y;
  const int cb = blockIdx.x * CPB;            // the block's first channel
  const int tid = threadIdx.x;
  const int cl = tid / P;                     // channel within the block
  const int p = tid % P;                      // lane within the channel
  const int c = cb + cl;
  const bool ok = c < di;

  float h[SP], a2[SP];
#pragma unroll
  for (int j = 0; j < SP; ++j) {
    const long long s = (long long)p * SP + j;
    h[j] = ok ? h0[((long long)b * di + c) * DS + s] : 0.f;
    a2[j] = ok ? A[(long long)c * DS + s] * LOG2E : 0.f;
  }

  const long long row = (long long)b * S * di;
  const float* bb = Bm + b * b_sb;
  const float* cbm = Cm + b * c_sb;

  // tile t0's x, dt, B and C into buffer `buf` (one cp.async group);
  // its steps from nt up to a whole group of U are zero: dt = 0 leaves h
  // as it is, and their y is not stored
  auto stage = [&](int t0, int buf) {
    const int nt = min(TT, S - t0);
    const int ntp = (nt + U - 1) / U * U;
    for (int idx = tid; idx < ntp * G; idx += NT) {
      const int t = idx / G;
      const int q = (idx % G) * 4;
      const long long off = row + (long long)(t0 + t) * di + cb + q;
      const bool v = t < nt && cb + q < di;
      cp_async16(&sm.x[buf][t * CPB + q], v ? x + off : x, v);
      cp_async16(&sm.dt[buf][t * CPB + q], v ? dt + off : dt, v);
    }
    for (int idx = tid; idx < ntp * DS; idx += NT) {
      const int t = idx / DS;
      const int s = idx % DS;
      const bool v = t < nt;
      cp_async4(&sm.b[buf][idx], v ? bb + (long long)(t0 + t) * b_ss + s : bb,
                v);
      cp_async4(&sm.c[buf][idx], v ? cbm + (long long)(t0 + t) * c_ss + s : cbm,
                v);
    }
    cp_async_commit();
  };

  stage(0, 0);
  for (int t0 = 0, buf = 0; t0 < S; t0 += TT, buf ^= 1) {
    const int nt = min(TT, S - t0);
    cp_async_wait_all();
    __syncthreads();   // this tile landed; the last tile's y is stored
    if (t0 + TT < S) stage(t0 + TT, buf ^ 1);

    const float* xs = sm.x[buf];
    const float* dts = sm.dt[buf];
    const float* bs = sm.b[buf] + p * SP;
    const float* cs = sm.c[buf] + p * SP;
    // U steps at a time: their loads first, then the recurrence, then the
    // sums over the lanes, then the stores of y, so that no store stands
    // between a step's loads and the next step's
    for (int t1 = 0; t1 < nt; t1 += U) {
      float d[U], dx[U], acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        d[u] = dts[(t1 + u) * CPB + cl];
        dx[u] = d[u] * xs[(t1 + u) * CPB + cl];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float* bt = bs + (t1 + u) * DS;
        const float* ct = cs + (t1 + u) * DS;
        acc[u] = 0.f;
#pragma unroll
        for (int j = 0; j < SP; ++j) {
          h[j] = fmaf(ex2(d[u] * a2[j]), h[j], dx[u] * bt[j]);
          acc[u] = fmaf(h[j], ct[j], acc[u]);
        }
      }
#pragma unroll
      for (int off = 1; off < P; off <<= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      if (p == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) sm.y[(t1 + u) * CPB + cl] = acc[u];
      }
    }
    __syncthreads();   // the tile's y is complete

    for (int idx = tid; idx < nt * G; idx += NT) {
      const int t = idx / G;
      const int q = (idx % G) * 4;
      if (cb + q < di)
        *reinterpret_cast<float4*>(y + row + (long long)(t0 + t) * di + cb +
                                   q) =
            *reinterpret_cast<const float4*>(&sm.y[t * CPB + q]);
    }
  }
  if (ok) {
#pragma unroll
    for (int j = 0; j < SP; ++j)
      h_last[((long long)b * di + c) * DS + (long long)p * SP + j] = h[j];
  }
}

template <int DS, int P>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           const void* A, const void* h0, void* y, void* h_last, int B,
           int S, int di, long long b_sb, long long b_ss, long long c_sb,
           long long c_ss, cudaStream_t stream) {
  const int bytes = (int)sizeof(Tiles<DS, P>);
  cudaError_t err = cudaFuncSetAttribute(
      mamba1_scan_kernel<DS, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int CPB = Tiles<DS, P>::CPB;
  dim3 grid((di + CPB - 1) / CPB, B);
  mamba1_scan_kernel<DS, P><<<grid, NT, bytes, stream>>>(
      (const float*)x, (const float*)dt, (const float*)Bm, (const float*)Cm,
      (const float*)A, (const float*)h0, (float*)y, (float*)h_last, S, di,
      b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt, y: [B, S, di] contiguous; Bm, Cm: [B, S, ds] with element
// strides for the batch and time axes (last axis contiguous); A: [di, ds];
// h0, h_last: [B, di, ds] contiguous; all fp32.  di must be a multiple
// of 4 and x, dt and y on 16-byte boundaries (else
// cudaErrorMisalignedAddress), ds 8 or 16 and `lanes` (the lanes a
// channel, mamba_scan.mamba1_plan) 2 or 4.  Returns the cudaError_t of
// the launch.
extern "C" int mamba1_scan_fp32(
    const void* x, const void* dt, const void* Bm, const void* Cm,
    const void* A, const void* h0, void* y, void* h_last,
    int B, int S, int di, int ds, int lanes,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // x, dt and y move in 16-byte copies of 4 channels
  if (di % 4 != 0 ||
      ((uintptr_t)x | (uintptr_t)dt | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
#define MAMBA1_LAUNCH(DSV, PV)                                             \
  if (ds == DSV && lanes == PV)                                            \
  return launch<DSV, PV>(x, dt, Bm, Cm, A, h0, y, h_last, B, S, di, b_sb,  \
                         b_ss, c_sb, c_ss, st)
  MAMBA1_LAUNCH(16, 2);
  MAMBA1_LAUNCH(16, 4);
  MAMBA1_LAUNCH(8, 2);
  MAMBA1_LAUNCH(8, 4);
#undef MAMBA1_LAUNCH
  return (int)cudaErrorInvalidValue;
}
