// Flash attention backward for Hopper (sm_90a), bf16 in and out, fp32
// accumulation: dQ, dK, dV of kernel A (flash_attn_fwd.cu), recomputed
// from the forward's per-row logsumexp.
//
// Replaces the gradient of the TPU kernel
// src/repro/kernels/flash_attention.py (flash_attention_bhsd), which has
// no backward: the reference trains through its jnp rendering
// models/attention.chunked_attention, and XLA derives the gradient from
// that.  The math is the same:
//   P  = exp(S * scale - lse)        (S = Q K^T, the forward's masks)
//   dV = P^T dO
//   dS = P * (dO V^T - D),           D = rowsum(dO * O)
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// with the group's query heads summed into dK and dV of their KV head.
//
// What bounds it on the H100: at gpt2m's training shape (B=8, S=1024, 16
// heads of 64, causal) the backward does about five causal S x S x D
// products per head, ~2.5 times the forward's work, against a few bytes
// per element of q, k, v, o, dO and the three gradients, so it is bound by
// operations.  Like the forward, this first version does them on the fp32
// FMA pipes (67 TFLOP/s peak) and not the tensor cores, and recomputes S
// and dO V^T in both the dK/dV and the dQ pass (seven products in all),
// so its floor is ~40x the bf16 tensor-core bound; mma/wgmma is later
// work.
//
// Design (three launches, no atomics, so the gradients are the same from
// run to run):
//  1. delta: D = rowsum(dO * O) in fp32, one warp per (b, i, h) row.
//  2. dK/dV: one block per (key tile of 64, KV head, batch), looping over
//     the group's query heads and over the query tiles the causal mask
//     and window let see the tile.  Two threads per key: the even one
//     holds k and accumulates dK, the odd one holds v and accumulates dV.
//     Each query row is read from shared memory (q * scale by the even
//     thread, dO by the odd one, at addresses 16 floats apart in bank
//     terms, so the pair reads two banks' groups with no conflict); one
//     shuffle swaps the two dot products, so both have s and dO.v, then
//     p and dS, and each adds its coefficient times its row.
//  3. dQ: one block per (query tile of 64, head, batch), looping over
//     the key tiles the row may see.  Two threads per query row: the even
//     one holds q * scale, the odd one dO; one shuffle gives both s and
//     dO.v, and the pair splits dQ += dS k over alternate float4 groups
//     of the head dim.
//  Rows and keys past the sequence load zeros and are masked; p is set
//  to 0 where masked (never exp of a masked score), so a row with no
//  live key cannot give inf or nan.  The dot products run over the head
//  dim in the forward's order, so S is bit-equal to the forward's.
//  Operands are addressed by strides ([B, S, heads, D], last axis
//  contiguous); the head dim is a template parameter (64 and 80).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NT = 128;         // two threads per key or query row
constexpr int PAD = 16;         // floats between the two staged tiles

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sk, int causal,
                                        int window) {
  if (kp >= Sk) return false;
  if (!causal) return true;
  return kp <= qp && (window <= 0 || qp - kp < window);
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one warp per row,
// rows ordered (b, i, h) so neighbouring warps read neighbouring memory.
template <int HD>
__global__ void __launch_bounds__(NT)
bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int H, int Sq, long long rows,
                 long long o_sb, long long o_ss, long long o_sh,
                 long long d_sb, long long d_ss, long long d_sh) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = (int)(row % H);
  const int i = (int)((row / H) % Sq);
  const long long b = row / ((long long)H * Sq);
  const bf16* op = o + b * o_sb + (long long)i * o_ss + h * o_sh;
  const bf16* dp = dout + b * d_sb + (long long)i * d_ss + h * d_sh;
  float acc = 0.f;
  for (int d = 2 * lane; d < HD; d += 64) {
    const float2 a = load2(op + d);
    const float2 c = load2(dp + d);
    acc = fmaf(a.x, c.x, acc);
    acc = fmaf(a.y, c.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(b * H + h) * Sq + i] = acc;
}

template <int HD>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv,
                int H, int group, int Sq, int Sk,
                long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh,
                long long d_sb, long long d_ss, long long d_sh,
                long long dk_sb, long long dk_ss, long long dk_sh,
                long long dv_sb, long long dv_ss, long long dv_sh,
                float scale, int causal, int window) {
  // q * scale rows, then dO rows PAD floats further on
  __shared__ __align__(16) float sm[2 * BQ * HD + PAD];
  __shared__ float lse_s[BQ];
  __shared__ float dl_s[BQ];
  float* qs = sm;
  float* dos = sm + BQ * HD + PAD;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int j = tid >> 1;
  const int odd = tid & 1;        // 0: k and dK; 1: v and dV
  const int kp = k0 + j;
  const bool key_ok = kp < Sk;

  float w[HD];                    // this key's k (even) or v (odd) row
  float acc[HD];                  // its dK (even) or dV (odd) row
  {
    const bf16* src = odd ? v + b * v_sb + kvh * v_sh
                          : k + b * k_sb + kvh * k_sh;
    const long long ss = odd ? v_ss : k_ss;
#pragma unroll
    for (int d = 0; d < HD; d += 2) {
      float2 f = make_float2(0.f, 0.f);
      if (key_ok) f = load2(src + (long long)kp * ss + d);
      w[d] = f.x;
      w[d + 1] = f.y;
      acc[d] = 0.f;
      acc[d + 1] = 0.f;
    }
  }

  int q_lo = 0;
  int q_hi = Sq;
  if (causal) {
    q_lo = k0;                    // earlier rows see none of these keys
    if (window > 0) q_hi = min(Sq, k0 + BK - 1 + window);
  }
  q_lo = (q_lo / BQ) * BQ;
  const float* rows_of = odd ? dos : qs;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const bf16* qb = q + b * q_sb + h * q_sh;
    const bf16* db = dout + b * d_sb + h * d_sh;
    const float* lb = lse + (b * H + h) * Sq;
    const float* deb = delta + (b * H + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();            // the previous tile's readers are done
      for (int idx = tid; idx < BQ * HD / 2; idx += NT) {
        const int r = idx / (HD / 2);
        const int d = (idx % (HD / 2)) * 2;
        const int qp = q0 + r;
        float2 qf = make_float2(0.f, 0.f);
        float2 df = make_float2(0.f, 0.f);
        if (qp < Sq) {
          qf = load2(qb + (long long)qp * q_ss + d);
          df = load2(db + (long long)qp * d_ss + d);
        }
        qs[r * HD + d] = qf.x * scale;
        qs[r * HD + d + 1] = qf.y * scale;
        dos[r * HD + d] = df.x;
        dos[r * HD + d + 1] = df.y;
      }
      for (int r = tid; r < BQ; r += NT) {
        const int qp = q0 + r;
        lse_s[r] = qp < Sq ? lb[qp] : 0.f;
        dl_s[r] = qp < Sq ? deb[qp] : 0.f;
      }
      __syncthreads();
      const int rows = min(BQ, Sq - q0);
      for (int r = 0; r < rows; ++r) {
        const float* x = rows_of + r * HD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(x + d);
          dot = fmaf(x4.x, w[d], dot);
          dot = fmaf(x4.y, w[d + 1], dot);
          dot = fmaf(x4.z, w[d + 2], dot);
          dot = fmaf(x4.w, w[d + 3], dot);
        }
        const float other = __shfl_xor_sync(0xffffffffu, dot, 1);
        const float s = odd ? other : dot;        // (q * scale) . k
        const float dpv = odd ? dot : other;      // dO . v
        const float p = visible(q0 + r, kp, Sk, causal, window)
                            ? expf(s - lse_s[r]) : 0.f;
        const float coef = odd ? p : p * (dpv - dl_s[r]);
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(x + d);
          acc[d] = fmaf(coef, x4.x, acc[d]);
          acc[d + 1] = fmaf(coef, x4.y, acc[d + 1]);
          acc[d + 2] = fmaf(coef, x4.z, acc[d + 2]);
          acc[d + 3] = fmaf(coef, x4.w, acc[d + 3]);
        }
      }
    }
  }

  if (key_ok) {
    bf16* dst = odd ? dv + b * dv_sb + (long long)kp * dv_ss + kvh * dv_sh
                    : dk + b * dk_sb + (long long)kp * dk_ss + kvh * dk_sh;
#pragma unroll
    for (int d = 0; d < HD; d += 2) store2(dst + d, acc[d], acc[d + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dq,
              int group, int Sq, int Sk,
              long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh,
              long long d_sb, long long d_ss, long long d_sh,
              long long dq_sb, long long dq_ss, long long dq_sh,
              float scale, int causal, int window) {
  constexpr int MY = HD / 8;      // float4 groups of dQ per thread
  // K rows, then V rows PAD floats further on
  __shared__ __align__(16) float sm[2 * BK * HD + PAD];
  float* ks = sm;
  float* vs = sm + BK * HD + PAD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int odd = tid & 1;        // 0: q * scale; 1: dO
  const int qp = q0 + (tid >> 1);
  const bool row_ok = qp < Sq;
  const int qr = row_ok ? qp : Sq - 1;

  float w[HD];
  {
    const bf16* src = odd ? dout + b * d_sb + (long long)qr * d_ss + h * d_sh
                          : q + b * q_sb + (long long)qr * q_ss + h * q_sh;
    const float mul = odd ? 1.f : scale;
#pragma unroll
    for (int d = 0; d < HD; d += 2) {
      const float2 f = load2(src + d);
      w[d] = f.x * mul;
      w[d + 1] = f.y * mul;
    }
  }
  const long long row_at = ((long long)b * gridDim.y + h) * Sq + qr;
  const float lse_r = lse[row_at];
  const float dl_r = delta[row_at];
  float acc[4 * MY];              // dQ at float4 groups 2c + odd
#pragma unroll
  for (int i = 0; i < 4 * MY; ++i) acc[i] = 0.f;

  int k_hi = Sk;
  int k_lo = 0;
  if (causal) {
    k_hi = min(Sk, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / BK) * BK;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  const float* cols_of = odd ? vs : ks;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD / 2; idx += NT) {
      const int jj = idx / (HD / 2);
      const int d = (idx % (HD / 2)) * 2;
      const int kp = k0 + jj;
      float2 kf = make_float2(0.f, 0.f);
      float2 vf = make_float2(0.f, 0.f);
      if (kp < Sk) {
        kf = load2(kb + (long long)kp * k_ss + d);
        vf = load2(vb + (long long)kp * v_ss + d);
      }
      ks[jj * HD + d] = kf.x;
      ks[jj * HD + d + 1] = kf.y;
      vs[jj * HD + d] = vf.x;
      vs[jj * HD + d + 1] = vf.y;
    }
    __syncthreads();
    const int keys = min(BK, k_hi - k0);
    for (int jj = 0; jj < keys; ++jj) {
      const float* y = cols_of + jj * HD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 y4 = *reinterpret_cast<const float4*>(y + d);
        dot = fmaf(w[d], y4.x, dot);
        dot = fmaf(w[d + 1], y4.y, dot);
        dot = fmaf(w[d + 2], y4.z, dot);
        dot = fmaf(w[d + 3], y4.w, dot);
      }
      const float other = __shfl_xor_sync(0xffffffffu, dot, 1);
      const float s = odd ? other : dot;
      const float dpv = odd ? dot : other;
      const float p = row_ok && visible(qp, k0 + jj, Sk, causal, window)
                          ? expf(s - lse_r) : 0.f;
      const float ds = p * (dpv - dl_r);
      const float* kr = ks + jj * HD + 4 * odd;
#pragma unroll
      for (int c = 0; c < MY; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + 8 * c);
        acc[4 * c] = fmaf(ds, k4.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(ds, k4.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(ds, k4.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(ds, k4.w, acc[4 * c + 3]);
      }
    }
  }

  if (row_ok) {
    bf16* dst = dq + b * dq_sb + (long long)qp * dq_ss + h * dq_sh + 4 * odd;
#pragma unroll
    for (int c = 0; c < MY; ++c) {
      store2(dst + 8 * c, acc[4 * c] * scale, acc[4 * c + 1] * scale);
      store2(dst + 8 * c + 2, acc[4 * c + 2] * scale,
             acc[4 * c + 3] * scale);
    }
  }
}

template <int HD>
int launch_all(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
               const bf16* dout, const float* lse, float* delta, bf16* dq,
               bf16* dk, bf16* dv, int B, int H, int KV, int Sq, int Sk,
               const long long* st, float scale, int causal, int window,
               cudaStream_t stream) {
  // st: q, k, v, o, dO, dq, dk, dv strides, three each
  const long long rows = (long long)B * Sq * H;
  bwd_delta_kernel<HD><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                         0, stream>>>(o, dout, delta, H, Sq, rows, st[9],
                                      st[10], st[11], st[12], st[13],
                                      st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int group = H / KV;
  bwd_dkdv_kernel<HD><<<dim3((Sk + BK - 1) / BK, KV, B), NT, 0, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, group, Sq, Sk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13],
      st[14], st[18], st[19], st[20], st[21], st[22], st[23], scale, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<HD><<<dim3((Sq + BQ - 1) / BQ, H, B), NT, 0, stream>>>(
      q, k, v, dout, lse, delta, dq, group, Sq, Sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14],
      st[15], st[16], st[17], scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dO, dq: [B, Sq, H, D]; k, v, dk, dv: [B, Sk, KV, D]; bf16 with
// element strides for the batch, sequence and head axes (last axis
// contiguous); lse (the forward's) and delta (scratch): fp32 [B, H, Sq]
// contiguous.  D = head_dim is 64 or 80.  Returns the first nonzero
// cudaError_t of the three launches (cudaErrorInvalidValue for any other
// head dim or a bad shape).
extern "C" int flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int KV, int Sq, int Sk, int head_dim,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long d_sb, long long d_ss, long long d_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const long long st[24] = {q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                            v_sb,  v_ss,  v_sh,  o_sb,  o_ss,  o_sh,
                            d_sb,  d_ss,  d_sh,  dq_sb, dq_ss, dq_sh,
                            dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
#define BWD_LAUNCH(HDV)                                                      \
  launch_all<HDV>((const bf16*)q, (const bf16*)k, (const bf16*)v,            \
                  (const bf16*)o, (const bf16*)dout, lse, delta, (bf16*)dq,  \
                  (bf16*)dk, (bf16*)dv, B, H, KV, Sq, Sk, st, scale, causal, \
                  window, (cudaStream_t)stream)
  if (head_dim == 64) return BWD_LAUNCH(64);
  if (head_dim == 80) return BWD_LAUNCH(80);
#undef BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
