// Flash attention forward for Hopper (sm_90a), bf16 in and out, fp32
// online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd / _flash_kernel), which the reference serves
// through its jnp rendering models/attention.chunked_attention.
//
// What bounds it on the H100: at the serving path's prefill shapes
// (gpt2m at head_dim 64, zamba2's shared attention at head_dim 80, S up
// to 1024) attention does 4*S*S*D/2 flops per
// head against 4*S*D*2 bytes, far above the card's ~295 flop/byte bf16
// ridge, so it is bound by operations.  This first version does them on
// the fp32 FMA pipes (67 TFLOP/s peak) rather than the tensor cores, so
// its floor is ~15x the bf16 tensor-core bound; mma/wgmma is later work.
//
// Design:
//  * one block per (q-tile of 64 rows, head, batch); a loop over key
//    tiles of 64 replaces the TPU's sequential grid axis, with the
//    running max m, denominator l and accumulator in registers;
//  * 128 threads, two per query row: the pair splits the tile's keys
//    (key 2i+half) for the scores and the head dims (dim 2i+half) for
//    P.V, swapping probabilities with one shuffle, so no [64, 64]
//    probability tile goes through shared memory;
//  * K and V tiles are staged once per block in shared memory as fp32
//    (K rows padded to 65 floats), read as broadcasts without bank
//    conflicts by the interleaved key/dim assignment;
//  * causal key tiles past the q tile's last row, and tiles wholly
//    before a sliding window, are skipped: every row keeps at least one
//    live key, so the skipped all-masked tiles would add exp(-1e30 - m)
//    = 0.  Masking uses NEG_INF = -1e30 and the output divides by
//    max(l, 1e-30), as the reference does;
//  * q, k, v and o are addressed by strides, so the model's [B, S, H, D]
//    layout is read and written in place with no transpose;
//  * the head dim is a template parameter, instantiated for 64 (GPT-2)
//    and 80 (zamba2); the entry point refuses any other;
//  * for training, an optional fp32 lse [B, H, Sq] receives each row's
//    logsumexp m + log(max(l, 1e-30)) of the scaled scores, which the
//    backward kernels (flash_attn_bwd.cu) recompute P from; serving
//    passes null and writes nothing more than before.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 2 * BQ;      // two threads per query row
constexpr float NEG_INF = -1e30f;

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int group, int Sq, int Sk,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale, int causal, int window,
                 float* __restrict__ lse) {
  constexpr int KSTR = HD + 1;  // padded K row stride in shared memory
  __shared__ float ks[BK * KSTR];
  __shared__ float vs[BK * HD];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int qpos = q0 + r;
  const bool row_ok = qpos < Sq;

  float qr[HD];
  {
    const __nv_bfloat16* qp =
        q + b * q_sb + (long long)(row_ok ? qpos : Sq - 1) * q_ss + h * q_sh;
#pragma unroll
    for (int d = 0; d < HD; d += 2) {
      float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qp + d));
      qr[d] = f.x * scale;
      qr[d + 1] = f.y * scale;
    }
  }

  int k_hi = Sk;
  int k_lo = 0;
  if (causal) {
    k_hi = min(Sk, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / BK) * BK;

  float m = NEG_INF;
  float l = 0.f;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * HD / 2; idx += NT) {
      const int j = idx / (HD / 2);
      const int d = (idx % (HD / 2)) * 2;
      const int kp = k0 + j;
      float2 kf = make_float2(0.f, 0.f);
      float2 vf = make_float2(0.f, 0.f);
      if (kp < Sk) {
        kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            kb + (long long)kp * k_ss + d));
        vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            vb + (long long)kp * v_ss + d));
      }
      ks[j * KSTR + d] = kf.x;
      ks[j * KSTR + d + 1] = kf.y;
      vs[j * HD + d] = vf.x;
      vs[j * HD + d + 1] = vf.y;
    }
    __syncthreads();

    // scores of this thread's keys j = 2i + half
    float s[BK / 2];
    float tmax = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int j = 2 * i + half;
      const int kp = k0 + j;
      const float* kr = ks + j * KSTR;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      bool ok = kp < Sk;
      if (causal) {
        ok = ok && kp <= qpos;
        if (window > 0) ok = ok && (qpos - kp) < window;
      }
      s[i] = ok ? dot : NEG_INF;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = expf(s[i] - m_new);
      psum += s[i];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr;

    // P.V over this thread's dims 2*dd + half; the partner holds the
    // probabilities of the other parity of keys
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p_me = s[i];
      const float p_other = __shfl_xor_sync(0xffffffffu, s[i], 1);
      const float* v_me = vs + (2 * i + half) * HD + half;
      const float* v_other = vs + (2 * i + 1 - half) * HD + half;
#pragma unroll
      for (int dd = 0; dd < HD / 2; ++dd) {
        acc[dd] = fmaf(p_me, v_me[2 * dd], acc[dd]);
        acc[dd] = fmaf(p_other, v_other[2 * dd], acc[dd]);
      }
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
    __nv_bfloat16* op = o + b * o_sb + (long long)qpos * o_ss + h * o_sh;
#pragma unroll
    for (int dd = 0; dd < HD / 2; ++dd)
      op[2 * dd + half] = __float2bfloat16(acc[dd] / den);
    if (lse != nullptr && half == 0)
      lse[((long long)b * gridDim.y + h) * Sq + qpos] = m + logf(den);
  }
}

}  // namespace

// q: [B, Sq, H, D], k/v: [B, Sk, KV, D], o: [B, Sq, H, D], bf16, with
// element strides for the batch, sequence and head axes (last axis
// contiguous); D = head_dim is 64 or 80.  lse is null (serving) or an
// fp32 [B, H, Sq] contiguous buffer for each row's logsumexp (training).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for any
// other head dim).
extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int KV, int Sq, int Sk, int head_dim,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, float* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
#define FLASH_LAUNCH(HDV)                                                   \
  flash_fwd_kernel<HDV><<<grid, NT, 0, (cudaStream_t)stream>>>(             \
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                     \
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H / KV, Sq, Sk,           \
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,                 \
      o_sb, o_ss, o_sh, scale, causal, window, lse)
  if (head_dim == 64)
    FLASH_LAUNCH(64);
  else if (head_dim == 80)
    FLASH_LAUNCH(80);
  else
    return (int)cudaErrorInvalidValue;
#undef FLASH_LAUNCH
  return (int)cudaGetLastError();
}
