// Flash attention forward for Hopper (sm_90a), bf16 in and out, fp32
// online softmax, on the tensor cores, at head_dim 64 (GPT-2), 80
// (zamba2's shared attention), 96 (phi-3-vision) and 128 (llama3.2-3b,
// phi3.5-MoE, phi4-mini), and at Multi-head Latent Attention's split head
// dims, q and k of DK over v of DV: (96, 64) for MiniCPM3 and (192, 128)
// for DeepSeek-V2 (nope + rope dims over the value dims).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd / _flash_kernel), which the reference serves
// through its jnp rendering models/attention.chunked_attention.
//
// What bounds it on the H100: at the path's shapes (gpt2m at head_dim 64,
// zamba2's shared attention at 80, llama3.2-3b and phi3.5-MoE at 128, S
// up to 1024) attention does 2*(DK+DV)*S*S/2 flops per head against
// 2*S*(DK+DV)*2 bytes, far above the card's ~295 flop/byte bf16 ridge:
// it is bound by operations, so both products run as bf16 mma.sync with
// fp32 accumulators (an FA2-class design; wgmma and TMA are later work).
//
// Design:
//  * one block of 4 warps per (q tile of 64 rows, head, batch); each warp
//    owns 16 query rows.  A loop over key tiles of 64 replaces the TPU's
//    sequential grid axis, with the running max m, the denominator l and
//    the output accumulator in registers;
//  * Q is copied to shared memory once.  At DK <= 128 it is held for the
//    whole loop as ldmatrix A fragments in registers (unscaled bf16, DK/4
//    words a thread); at DK = 192 those 48 words on top of the DV/2 = 64
//    accumulators and 32 scores would spill, so each key tile reads Q's
//    fragments from shared memory a 16-wide chunk at a time (4 words),
//    one more ldmatrix beside each chunk's K fragments;
//  * K and V tiles are double-buffered in shared memory by 16-byte
//    cp.async: tile t+1 is in flight while tile t is computed.  Rows are
//    padded by 16 bytes, so ldmatrix reads them without bank conflicts
//    at 64, 80, 96, 128 and 192 (flash_attn_mma.cuh).  V keeps its own
//    width DV: nothing is padded to DK;
//  * S = Q K^T: K's B fragments by ldmatrix; O += P V: P's A fragments
//    are S's accumulators packed to bf16 in registers (no P tile goes
//    through shared memory), V's B fragments by ldmatrix.trans.  P goes
//    in as a bf16 hi + lo pair (two mma, ~16 bits of P): with one bf16
//    rounding of P the output strayed up to 1.6e-2 from the fp32 plain
//    version on the card tests' random inputs (3.9e-3 with the pair),
//    enough to carry reduced phi3.5-MoE's logits past the kernel path's
//    0.05 gate; the pair cost 1.16x the time at gpt2m's training shape
//    on an H100;
//  * the softmax is per row in fp32 on the raw scores: row max and sum
//    over the quad of lanes that share a row (two __shfl_xor_sync; the
//    sum once, at the end), and the scale folded into the exponent as
//    exp2f((s - m) * scale * log2e), subtracting first so that a row that
//    has seen only masked keys gets exp2(0), never exp2 of a rounding
//    residual of 1e30;
//  * masks (causal, a sliding window under causal, keys past Sk) are
//    applied only in tiles that cross one, with NEG_INF = -1e30; causal
//    key tiles past the q tile's last row, and tiles wholly before a
//    window, are skipped: every row keeps at least one live key, so the
//    skipped all-masked tiles would add exp(-1e30 - m) = 0.  The output
//    divides by max(l, 1e-30), as the reference does;
//  * q tiles are launched heaviest first (the grid's slowest axis runs
//    from the last q tile down), so the causal diagonal's long blocks do
//    not form the tail;
//  * q, k, v and o are addressed by strides (multiples of 8 elements,
//    16-byte aligned), so the model's [B, S, H, D] layout, and views of a
//    fused [B, S, 3, H, D] projection, are read in place; GQA through
//    h / group.  O (DV wide) is staged through the warp's own Q rows (DK
//    >= DV wide) and written 16 bytes a lane;
//  * for training, an optional fp32 lse [B, H, Sq] receives each row's
//    logsumexp m * scale + log(max(l, 1e-30)) of the scaled scores (scale
//    = 1/sqrt(DK)), which the backward kernels (flash_attn_bwd.cu)
//    recompute P from, and an optional fp32 o32 [B, Sq, H, DV] receives
//    O before its bf16 rounding (float2 stores from the accumulators),
//    whose rowsum with dO is the backward's D; serving passes null for
//    both and nothing more is written.
// Shared memory: Q (64 rows) and two stages of K (64 rows each) of DK + 8
// bf16, two stages of V of DV + 8: 46,080 bytes at (64, 64), 56,320 at
// (80, 80), 66,560 at (96, 96), 87,040 at (128, 128), 58,368 at (96, 64)
// and 111,616 at (192, 128), dynamic, the limit raised once per
// instantiation.  Registers hold DK/4 Q fragment words (DK <= 128), 32
// scores and DV/2 accumulators a thread: ptxas gives 168 and 175
// registers at 64 and 80, 185 at (96, 64), and at 128 and (192, 128) all
// 255 with 16 bytes of spills each; (96, 96) holds 24 Q words and 48
// accumulators, between (80, 80) and (128, 128) (chip_smoke.py prints
// every instantiation's count from the build's ptxas log).
#include "flash_attn_mma.cuh"

namespace {

constexpr int FWD_BQ = 64;            // query rows per block, 16 a warp
constexpr int FWD_BK = 64;            // keys per tile
constexpr int FWD_NT = 128;           // 4 warps

template <int DK, int DV>
constexpr int fwd_smem_bytes() {
  return ((FWD_BQ + 2 * FWD_BK) * (DK + 8) + 2 * FWD_BK * (DV + 8)) *
         (int)sizeof(bf16);
}

template <int DK, int DV>
__global__ void __launch_bounds__(FWD_NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int group, int Sq, int Sk,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale, int causal, int window,
                 float* __restrict__ lse, float* __restrict__ o32) {
  constexpr int LDK = DK + 8;
  constexpr int LDV = DV + 8;
  constexpr int KC = DK / 16;         // 16-wide chunks of q's and k's dim
  constexpr int DN = DV / 8;          // 8-wide output tiles
  constexpr int NJ = FWD_BK / 8;      // 8-key score tiles
  constexpr bool Q_REGS = DK <= 128;  // Q's fragments held in registers
  static_assert(DV <= DK, "O is staged in the warp's Q rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // [BQ][LDK]
  bf16* ks = qs + FWD_BQ * LDK;                     // [2][BK][LDK]
  bf16* vs = ks + 2 * FWD_BK * LDK;                 // [2][BK][LDV]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FWD_BQ;   // heaviest first
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g;               // this thread's rows
  const int row_b = row_a + 8;

  int k_hi = Sk;
  int k_lo = 0;
  if (causal) {
    k_hi = min(Sk, q0 + FWD_BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / FWD_BK) * FWD_BK;
  const int n_tiles = (k_hi - k_lo + FWD_BK - 1) / FWD_BK;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  load_tile<DK, FWD_BQ, FWD_NT>(qs, qb, q_ss, q0, Sq, tid);
  load_tile<DK, FWD_BK, FWD_NT>(ks, kb, k_ss, k_lo, Sk, tid);
  load_tile<DV, FWD_BK, FWD_NT>(vs, vb, v_ss, k_lo, Sk, tid);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  uint32_t qf[Q_REGS ? KC : 1][4];
  // this lane's ldmatrix row of the warp's 16 Q rows
  const bf16* qrow = qs + (warp * 16 + (lane & 15)) * LDK + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * FWD_BK;
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<DK, FWD_BK, FWD_NT>(ks + (cur ^ 1) * FWD_BK * LDK, kb, k_ss,
                                    k0 + FWD_BK, Sk, tid);
      load_tile<DV, FWD_BK, FWD_NT>(vs + (cur ^ 1) * FWD_BK * LDV, vb, v_ss,
                                    k0 + FWD_BK, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Q_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) ldsm_x4(qf[kc], qrow + kc * 16);
      }
    }
    const bf16* kt = ks + cur * FWD_BK * LDK;
    const bf16* vt = vs + cur * FWD_BK * LDV;

    // S = Q K^T, 16 rows x 64 keys a warp
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      // matrices (keys 16jp..+7 | +8..+15) x (dims lo | hi of the chunk)
      const bf16* p = kt + ((lane & 7) + ((lane >> 4) << 3)) * LDK +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qa[4];
        if constexpr (Q_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kc][e];
        } else {
          ldsm_x4(qa, qrow + kc * 16);
        }
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t bfr[4];
          ldsm_x4(bfr, p + 16 * jp * LDK + 16 * kc);
          mma_bf16(s[2 * jp], qa, bfr[0], bfr[1]);
          mma_bf16(s[2 * jp + 1], qa, bfr[2], bfr[3]);
        }
      }
    }

    const bool edge =
        k0 + FWD_BK > Sk ||
        (causal && (k0 + FWD_BK - 1 > q0 ||
                    (window > 0 && q0 + FWD_BQ - 1 - k0 >= window)));
    if (edge) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = e < 2 ? row_a : row_b;
          if (!visible(qp, kp, Sq, Sk, causal, window)) s[j][e] = NEG_INF;
        }
    }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[r] = exp2f((m[r] - mx[r]) * sl2);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - mx[e >> 1]) * sl2);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P V: P from the score accumulators, V by ldmatrix.trans
    {
      // matrices (keys lo | hi of the chunk) x (dims 16dp..+7 | +8..+15)
      const bf16* p = vt + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDV +
                      ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < FWD_BK / 16; ++kk) {
        uint32_t pa[4], pl[4];
        c_to_a_split(pa, pl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < DN / 2; ++dp) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, p + 16 * kk * LDV + 16 * dp);
          mma_bf16(acc[2 * dp], pa, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
          mma_bf16(acc[2 * dp], pl, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dp + 1], pl, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();      // this stage's readers are done before its reload
  }
  if (n_tiles <= 0) {     // no key to see (Sk short of a causal window):
    cp_async_wait<0>();   // let the copies land before the Q rows are reused
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den_a = fmaxf(l[0], 1e-30f);
  const float den_b = fmaxf(l[1], 1e-30f);
  const float inv_a = 1.f / den_a, inv_b = 1.f / den_b;
  // the warp's own 16 Q rows are free (its last reads of them are
  // behind the loop's final __syncthreads), and hold its 16 O rows
  store_rows16<DV>(qs + warp * 16 * LDK, acc, inv_a, inv_b,
                   o + b * o_sb + h * o_sh, o_ss, q0 + warp * 16, Sq, lane);
  if (lse != nullptr && t == 0) {
    float* lp = lse + ((long long)b * gridDim.x + h) * Sq;
    if (row_a < Sq) lp[row_a] = m[0] * scale + logf(den_a);
    if (row_b < Sq) lp[row_b] = m[1] * scale + logf(den_b);
  }
  if (o32 != nullptr) {   // O in fp32 too, contiguous [B, Sq, H, DV]
    const long long at = ((long long)b * Sq * gridDim.x + h) * DV + 2 * t;
    const long long row_stride = (long long)gridDim.x * DV;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      if (row_a < Sq)
        *reinterpret_cast<float2*>(o32 + at + row_a * row_stride + 8 * dn) =
            make_float2(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
      if (row_b < Sq)
        *reinterpret_cast<float2*>(o32 + at + row_b * row_stride + 8 * dn) =
            make_float2(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
    }
  }
}

template <int DK, int DV>
int launch(cudaStream_t stream, const void* q, const void* k, const void* v,
           void* o, int B, int H, int group, int Sq, int Sk,
           long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh,
           long long o_sb, long long o_ss, long long o_sh,
           float scale, int causal, int window, float* lse, float* o32) {
  static bool limit_set = false;
  if (!limit_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_smem_bytes<DK, DV>());
    if (e != cudaSuccess) return (int)e;
    limit_set = true;
  }
  dim3 grid(H, B, (Sq + FWD_BQ - 1) / FWD_BQ);
  flash_fwd_kernel<DK, DV>
      <<<grid, FWD_NT, fwd_smem_bytes<DK, DV>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, group, Sq,
      Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh, scale, causal, window, lse, o32);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Sq, H, DK], k: [B, Sk, KV, DK], v: [B, Sk, KV, DV], o: [B, Sq,
// H, DV], bf16, with element strides for the batch, sequence and head
// axes (multiples of 8; last axis contiguous; 16-byte aligned); (DK, DV)
// = (head_dim, head_dim_v) is (64, 64), (80, 80), (96, 96), (128, 128),
// (96, 64) or (192, 128).  lse is null (serving) or an fp32 [B, H, Sq]
// contiguous buffer for each row's logsumexp (training); o32 is null or
// an fp32 [B, Sq, H, DV] contiguous buffer for O before its bf16
// rounding (training: the backward's rowsum(dO * O)).  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for any other pair
// of head dims or a bad shape).
extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int KV, int Sq, int Sk, int head_dim, int head_dim_v,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, float* lse, float* o32,
    void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (Sq + FWD_BQ - 1) / FWD_BQ > 65535)
    return (int)cudaErrorInvalidValue;
#define FLASH_LAUNCH(DKV, DVV)                                              \
  if (head_dim == DKV && head_dim_v == DVV)                                 \
    return launch<DKV, DVV>((cudaStream_t)stream, q, k, v, o, B, H, H / KV, \
                            Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,     \
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale,      \
                            causal, window, lse, o32);
  FLASH_LAUNCH(64, 64)
  FLASH_LAUNCH(80, 80)
  FLASH_LAUNCH(96, 96)
  FLASH_LAUNCH(128, 128)
  FLASH_LAUNCH(96, 64)
  FLASH_LAUNCH(192, 128)
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}
