// One-token (decode) attention over an int8 KV cache for Hopper
// (sm_90a): bf16 query, int8 keys and values with one fp32 absmax scale
// per (token, kv-head), dequantized in registers, and a [B, Sk] validity
// mask that carries the ring cache's fill state.
//
// Replaces the TPU kernel src/repro/kernels/quantized.py
// (flash_attention_int8kv_bhsd / _int8kv_flash_kernel), which the
// reference's int8-KV decode calls with causal=False and block_q=8.
//
// What bounds it on the H100: with one query row per head it does
// ~4*D flops per key against 2*D + 8 bytes of cache, ~2 flop/byte, far
// below the ~295 flop/byte ridge, so it is bound by bytes: the least
// time is B*Sk*KV*(2*D + 2*4) bytes (plus the mask) over 3.35 TB/s.
//
// Design:
//  * built for Sq = 1 (no block_q padding of the TPU version): one block
//    of 4 warps per (head, batch row); the warps take interleaved
//    32-key chunks and each keeps its own online softmax (max, sum and
//    a D/32-dim slice of the accumulator per lane), merged through
//    shared memory at the end;
//  * the head dim D is a template parameter, instantiated for 64 (GPT-2)
//    and 128 (llama3.2-3b, phi3.5-MoE);
//  * scores: a lane owns one key and reads its D-byte int8 row with D/16
//    16-byte loads (four at 64, eight at 128), so every byte fetched is
//    used; the per-token scale multiplies the int8 dot product once;
//  * P.V: the warp walks its chunk's 32 keys, each lane reading D/32
//    int8 values of the row (the warp reads the whole row at once) and
//    the key's probability and scale by shuffle;
//  * masked keys score NEG_INF = -1e30 as in the reference, so a row
//    with no live key averages the values as a plain softmax does; the
//    output divides by max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;
constexpr int NT = NW * 32;
constexpr float NEG_INF = -1e30f;

template <int HD>
__global__ void __launch_bounds__(NT)
int8kv_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const int8_t* __restrict__ kq,
                     const float* __restrict__ kscale,
                     const int8_t* __restrict__ vq,
                     const float* __restrict__ vscale,
                     const uint8_t* __restrict__ valid,
                     __nv_bfloat16* __restrict__ o,
                     int group, int KV, int Sk,
                     long long q_sb, long long q_sh,
                     long long o_sb, long long o_sh, float scale) {
  constexpr int DPL = HD / 32;  // accumulator dims per lane
  __shared__ float sm_m[NW];
  __shared__ float sm_l[NW];
  __shared__ float sm_acc[NW][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qr[HD];
  {
    const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
#pragma unroll
    for (int d = 0; d < HD; d += 2) {
      float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qp + d));
      qr[d] = f.x * scale;
      qr[d + 1] = f.y * scale;
    }
  }

  // token j of this (batch row, kv head): element offset of its row
  const long long row0 = (long long)b * Sk * KV + kvh;
  float m = NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int c0 = warp * 32; c0 < Sk; c0 += NW * 32) {
    const int j = c0 + lane;
    const bool in_range = j < Sk;
    float s = NEG_INF;
    float vsc = 0.f;
    if (in_range) {
      const long long tok = row0 + (long long)j * KV;
      const int4* kr = reinterpret_cast<const int4*>(kq + tok * HD);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < HD / 16; ++t) {
        const int4 w = kr[t];
        const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float kv = (float)(int8_t)((words[u] >> (8 * e)) & 0xff);
            dot = fmaf(qr[t * 16 + u * 4 + e], kv, dot);
          }
        }
      }
      vsc = vscale[tok];
      if (valid[(long long)b * Sk + j]) s = dot * kscale[tok];
    }
    float cmax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    const float m_new = fmaxf(m, cmax);
    const float p = in_range ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;

    const int n_keys = min(32, Sk - c0);
    for (int jj = 0; jj < n_keys; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float sj = __shfl_sync(0xffffffffu, vsc, jj);
      const long long tok = row0 + (long long)(c0 + jj) * KV;
      const int8_t* vr = vq + tok * HD + DPL * lane;
      if constexpr (DPL == 2) {
        const char2 vv = *reinterpret_cast<const char2*>(vr);
        acc[0] = fmaf(pj, (float)vv.x * sj, acc[0]);
        acc[1] = fmaf(pj, (float)vv.y * sj, acc[1]);
      } else {
        const char4 vv = *reinterpret_cast<const char4*>(vr);
        acc[0] = fmaf(pj, (float)vv.x * sj, acc[0]);
        acc[1] = fmaf(pj, (float)vv.y * sj, acc[1]);
        acc[2] = fmaf(pj, (float)vv.z * sj, acc[2]);
        acc[3] = fmaf(pj, (float)vv.w * sj, acc[3]);
      }
    }
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][DPL * lane + i] = acc[i];
  __syncthreads();
  if (warp == 0) {
    float mt = sm_m[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) mt = fmaxf(mt, sm_m[w]);
    float lt = 0.f, a[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) a[i] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w] - mt);
      lt += sm_l[w] * f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[i] += sm_acc[w][DPL * lane + i] * f;
    }
    const float den = fmaxf(lt, 1e-30f);
    __nv_bfloat16* op = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      op[DPL * lane + i] = __float2bfloat16(a[i] / den);
  }
}

}  // namespace

// q: [B, 1, H, D] bf16 (batch and head strides given); kq/vq:
// [B, Sk, KV, D] int8 and ks/vs: [B, Sk, KV] fp32, contiguous; valid:
// [B, Sk] bool; o: [B, 1, H, D] bf16; D = head_dim is 64 or 128.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for any other
// head dim).
extern "C" int int8kv_decode_bf16(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* valid, void* o,
    int B, int H, int KV, int Sk, int head_dim,
    long long q_sb, long long q_sh, long long o_sb, long long o_sh,
    float scale, void* stream) {
  if (B <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(H, B);
#define INT8KV_LAUNCH(HDV)                                                  \
  int8kv_decode_kernel<HDV><<<grid, NT, 0, (cudaStream_t)stream>>>(         \
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const float*)ks,         \
      (const int8_t*)vq, (const float*)vs, (const uint8_t*)valid,           \
      (__nv_bfloat16*)o, H / KV, KV, Sk, q_sb, q_sh, o_sb, o_sh, scale)
  if (head_dim == 64)
    INT8KV_LAUNCH(64);
  else if (head_dim == 128)
    INT8KV_LAUNCH(128);
  else
    return (int)cudaErrorInvalidValue;
#undef INT8KV_LAUNCH
  return (int)cudaGetLastError();
}
