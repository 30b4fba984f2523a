// Blocked int8 matrix product with per-tile absmax scales for Hopper
// (sm_90a): out[M, N] fp32 = sum over K blocks kb of
//   (xq[i-block, kb] . wq[kb, j-block], exact in int32) * (xs[i, kb] * ws[kb, j]).
//
// Replaces the TPU kernel src/repro/kernels/quantized.py
// (int8_matmul_blocked / _int8_matmul_kernel), which the reference's
// ops.int8_matmul calls after padding and quantizing both operands.
//
// Layouts: xq [M, K] int8 (K contiguous), xs [M/bm, K/bk] fp32, wq [K, N]
// int8 (N contiguous), ws [K/bk, N/bn] fp32, out [M, N] fp32.  M, N, K
// are multiples of their block sizes, and bm, bk, bn are multiples of 32
// up to 128 (the wrapper checks both).
//
// What bounds it on the H100: 2*M*N*K int8 operations against M*K + K*N
// bytes in and 4*M*N bytes out.  At gpt2m's MLP widths (8192 tokens,
// 1024 <-> 4096) the fp32 output alone is 134 MB (40 us at 3.35 TB/s)
// against 69 GOP (35 us at 1979 TOP/s), so the up projection is bound by
// bytes and the down projection (K = 4096) by operations.
//
// Design (simple and right first; wgmma, TMA and a deeper pipeline are
// later work):
//  * one block of 8 warps per 128x128 output tile; each warp owns a
//    64x32 slice as 4x4 mma.sync.m16n8k32 s8 tiles with int32
//    accumulators, plus an fp32 accumulator of the same shape;
//  * K advances 32 at a time through two shared-memory stages: the x
//    tile (K contiguous, what the .row A operand wants) is copied with
//    cp.async; the w tile is N contiguous, but the .col B operand wants
//    4 consecutive k of one n in a register, so each thread loads a 4x4
//    byte block, transposes it with __byte_perm and stores it n-major;
//  * bm, bn, bk are multiples of 32, so each 32-row half of a warp's
//    slice and its 32 columns sit in one scale tile: at every bk
//    boundary the warp turns its int32 partials into fp32 (exact: at
//    most 127*127*128 < 2^24) and adds partial * (xs * ws), the scale
//    product first as in the reference, then clears the partials;
//  * rows of 48 bytes (32 + 16 of padding) in shared memory keep the
//    fragment loads free of bank conflicts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;         // output rows per block
constexpr int TN = 128;         // output columns per block
constexpr int KS = 32;          // k per stage (one mma k step)
constexpr int ROW = 48;         // bytes per shared-memory row
constexpr int NT = 256;         // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;          // rows per warp
constexpr int WN = 32;          // columns per warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NT)
int8_matmul_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ xs,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ ws,
                   float* __restrict__ out,
                   int M, int N, int K, int bm, int bk, int bn) {
  __shared__ __align__(16) int8_t sA[2][TM * ROW];
  __shared__ __align__(16) int8_t sB[2][TN * ROW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int wm0 = (warp >> 2) * WM, wn0 = (warp & 3) * WN;
  const int nk = K / bk;
  const int ksteps = K / KS;

  // x staging: one 16-byte copy per thread (row tid/2, half tid%2)
  const int a_row = tid >> 1, a_half = tid & 1;
  const bool a_ok = m0 + a_row < M;
  const int8_t* a_src = xq + (long long)(a_ok ? m0 + a_row : 0) * K
                        + a_half * 16;
  // w staging: a 4x4 byte block per thread (k quad kq, n quad nq)
  const int kq = tid & 7, nq = tid >> 3;
  const bool b_ok = n0 + 4 * nq < N;
  const int8_t* b_src = wq + (long long)(4 * kq) * N + n0 + 4 * nq;

  uint32_t breg[4];
  auto load_b = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      breg[r] = b_ok ? *reinterpret_cast<const uint32_t*>(
                           b_src + (long long)(k0 + r) * N)
                     : 0u;
  };
  auto store_b = [&](int stage) {
    // breg[r] holds n = 4nq..4nq+3 at k = 4kq + r; column j of the block
    // is n = 4nq + j at k = 4kq..4kq+3
    const uint32_t t0 = __byte_perm(breg[0], breg[1], 0x5140);
    const uint32_t t1 = __byte_perm(breg[2], breg[3], 0x5140);
    const uint32_t t2 = __byte_perm(breg[0], breg[1], 0x7362);
    const uint32_t t3 = __byte_perm(breg[2], breg[3], 0x7362);
    int8_t* dst = sB[stage] + (4 * nq) * ROW + 4 * kq;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + ROW) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * ROW) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * ROW) = __byte_perm(t2, t3, 0x7632);
  };

  int iacc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[mi][ni][e] = 0;
        facc[mi][ni][e] = 0.f;
      }

  // the scale tiles of this warp's two 32-row halves and its 32 columns
  // (rows or columns past M or N read no scale: they hold zeros and are
  // not stored)
  const int r_half0 = m0 + wm0, r_half1 = m0 + wm0 + 32;
  const int col = n0 + wn0;
  const bool h0_ok = r_half0 < M, h1_ok = r_half1 < M, c_ok = col < N;
  const float* xs0 = xs + (long long)(h0_ok ? r_half0 / bm : 0) * nk;
  const float* xs1 = xs + (long long)(h1_ok ? r_half1 / bm : 0) * nk;
  const float* wsc = ws + (c_ok ? col / bn : 0);
  const int nn = N / bn;

  cp_async16(sA[0] + a_row * ROW + a_half * 16, a_src, a_ok);
  asm volatile("cp.async.commit_group;\n" ::);
  load_b(0);
  store_b(0);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int ks = 0; ks < ksteps; ++ks) {
    const int cur = ks & 1;
    const bool more = ks + 1 < ksteps;
    if (more) {
      cp_async16(sA[cur ^ 1] + a_row * ROW + a_half * 16,
                 a_src + (ks + 1) * KS, a_ok);
      asm volatile("cp.async.commit_group;\n" ::);
      load_b((ks + 1) * KS);
    }

    const int8_t* A = sA[cur];
    const int8_t* B = sB[cur];
    uint32_t bf[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = B + (wn0 + ni * 8 + g) * ROW + tig * 4;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* p = A + (wm0 + mi * 16 + g) * ROW + tig * 4;
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(p);
      af[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW);
      af[2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW + 16);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8(iacc[mi][ni], af, bf[ni][0], bf[ni][1]);
    }

    // end of a K block: dequantize this block's exact partials
    if (((ks + 1) * KS) % bk == 0) {
      const int kb = ((ks + 1) * KS) / bk - 1;
      const float wscale = c_ok ? wsc[(long long)kb * nn] : 0.f;
      const float s0 = (h0_ok ? xs0[kb] : 0.f) * wscale;
      const float s1 = (h1_ok ? xs1[kb] : 0.f) * wscale;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float s = mi < 2 ? s0 : s1;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[mi][ni][e] += (float)iacc[mi][ni][e] * s;
            iacc[mi][ni][e] = 0;
          }
      }
    }

    if (more) {
      store_b(cur ^ 1);
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
  }

  // c0, c1 at (row g, cols 2tig, 2tig+1); c2, c3 eight rows below
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int r = m0 + wm0 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + wn0 + ni * 8 + 2 * tig;
      if (c >= N) continue;
      if (r < M)
        *reinterpret_cast<float2*>(out + (long long)r * N + c) =
            make_float2(facc[mi][ni][0], facc[mi][ni][1]);
      if (r + 8 < M)
        *reinterpret_cast<float2*>(out + (long long)(r + 8) * N + c) =
            make_float2(facc[mi][ni][2], facc[mi][ni][3]);
    }
  }
}

}  // namespace

// xq [M, K] int8, xs [M/bm, K/bk] fp32, wq [K, N] int8, ws [K/bk, N/bn]
// fp32, out [M, N] fp32, all contiguous; bm, bk, bn multiples of 32 up
// to 128 dividing M, K, N.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for shapes or blocks it does not take).
extern "C" int int8_matmul_s8(const void* xq, const void* xs,
                              const void* wq, const void* ws, void* out,
                              int M, int N, int K, int bm, int bk, int bn,
                              void* stream) {
  const int blocks[3] = {bm, bk, bn};
  for (int b : blocks)
    if (b < 32 || b > 128 || b % 32) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K <= 0 || M % bm || N % bn || K % bk)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  int8_matmul_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const float*)xs, (const int8_t*)wq,
      (const float*)ws, (float*)out, M, N, K, bm, bk, bn);
  return (int)cudaGetLastError();
}
