// Flash attention backward for Hopper (sm_90a), bf16 in and out, fp32
// accumulation, on the tensor cores: dQ, dK, dV of kernel A
// (flash_attn_fwd.cu), recomputed from the forward's per-row logsumexp.
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
// heads of 64, causal) the backward does five causal S x S x D products
// per head against a few bytes per element of q, k, v, o, dO and the
// three gradients, so it is bound by operations.  Every product runs as
// bf16 mma.sync.m16n8k16 with fp32 accumulators (flash_attn_mma.cuh);
// the dQ pass recomputes S and dO V^T, seven products in all.
//
// Design (three launches, no atomics, so the gradients are the same from
// run to run):
//  1. delta: D = rowsum(dO * O) in fp32, one warp per (b, i, h) row, from
//     the forward's output in fp32 (the training forward writes it beside
//     the bf16 one for non-causal attention: FlashAttention in
//     kernels/flash_attention.py) or in bf16.  D stands for
//     sum_j P_ij dP_ij, and each row of dS = P * (dP - D) sums to 0 only
//     with D that close: the part common to every key then cancels out of
//     dQ.  Where the keys and values are an encoder's output, whose rows
//     attention has averaged towards one vector (whisper's
//     cross-attention), that part is large, and D from the bf16-rounded O
//     puts 2^-9 of it into dQ (whisper-small at full size on the H100:
//     1 - cos 0.022 for the gradient of the norm before the
//     cross-attention against the fp32 path, the bf16 plain path's
//     0.0009).
//  2. dK/dV: one block of 4 warps per (key tile of 64, KV head, batch),
//     each warp owning 16 keys, looping over the group's query heads and
//     over the query tiles the causal mask and window let see the tile.
//     The warp holds its K and V rows as A fragments and computes the
//     transposed scores S^T = K Q^T and dP^T = V dO^T directly (keys as
//     rows, 32 queries a pass), with Q and dO's B fragments by ldmatrix;
//     P^T and dS^T are then already in the accumulator layout that the
//     A operand of dV += P^T dO and dK += dS^T Q takes after a bf16 pack
//     (dO and Q by ldmatrix.trans), so neither goes through shared
//     memory.  dS^T enters dK's product as a bf16 hi + lo pair (two
//     mma): the key bias's gradient, the sum of dK over keys, is
//     sum_i q_i * sum_j dS_ij, zero in exact arithmetic, and one bf16
//     rounding of each dS (2^-9) leaves that sum far from zero.
//     Q and dO tiles are double-buffered by cp.async; lse and D of the
//     next tile are read into registers a tile ahead.
//  3. dQ: one block of 4 warps per (query tile of 64, head, batch), each
//     warp owning 16 rows with Q and dO as A fragments, looping over the
//     key tiles the rows may see (heaviest q tiles first): S = Q K^T and
//     dP = dO V^T, dS in registers, dQ += dS K with K by ldmatrix.trans.
//     K and V tiles are double-buffered by cp.async.
//  P = exp2((s * scale - lse) * log2e) where the key is visible and 0
//  where masked (never exp of a masked score), so a row with no live key
//  cannot give inf or nan; rows and keys past the sequence load zeros and
//  are masked.  The recomputed S is not bit-equal to the forward's (other
//  product order); P is held to the plain version through lse.
//  Operands are addressed by strides ([B, S, heads, D], multiples of 8
//  elements, 16-byte aligned); the head dim is a template parameter (64
//  and 80).  The gradients are staged through the warp's own rows of
//  shared memory and written 16 bytes a lane.
#include "flash_attn_mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NT = 128;         // 4 warps of 16 rows (keys or queries)
constexpr int QC = 32;          // queries per pass of the dK/dV kernel

template <int HD>
constexpr int dkdv_smem_bytes() {
  // K, V; two stages of Q and dO; two stages of lse and D
  return (2 * BK + 4 * BQ) * (HD + 8) * (int)sizeof(bf16) +
         4 * BQ * (int)sizeof(float);
}

template <int HD>
constexpr int dq_smem_bytes() {
  // Q, dO; two stages of K and V
  return (2 * BQ + 4 * BK) * (HD + 8) * (int)sizeof(bf16);
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one warp per row,
// rows ordered (b, i, h) so neighbouring warps read neighbouring memory.
__device__ __forceinline__ float2 pair_of(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 pair_of(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <int HD, typename OT>
__global__ void __launch_bounds__(NT)
bwd_delta_kernel(const OT* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int H, int Sq, long long rows,
                 long long o_sb, long long o_ss, long long o_sh,
                 long long d_sb, long long d_ss, long long d_sh) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = (int)(row % H);
  const int i = (int)((row / H) % Sq);
  const long long b = row / ((long long)H * Sq);
  const OT* op = o + b * o_sb + (long long)i * o_ss + h * o_sh;
  const bf16* dp = dout + b * d_sb + (long long)i * d_ss + h * d_sh;
  float acc = 0.f;
  for (int d = 2 * lane; d < HD; d += 64) {
    const float2 a = pair_of(op + d);
    const float2 c = pair_of(dp + d);
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
  constexpr int LD = HD + 8;
  constexpr int KC = HD / 16;
  constexpr int DN = HD / 8;
  constexpr int NJ = QC / 8;          // 8-query score tiles a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD]
  bf16* vs = ks + BK * LD;                         // [BK][LD]
  bf16* qs = vs + BK * LD;                         // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;                    // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                 // [2][BQ]

  const int kvh = blockIdx.x;
  const long long b = blockIdx.y;
  const int k0 = blockIdx.z * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_a = k0 + warp * 16 + g;          // this thread's keys
  const int key_b = key_a + 8;

  int q_lo = 0;
  int q_hi = Sq;
  if (causal) {
    q_lo = k0;                    // earlier rows see none of these keys
    if (window > 0) q_hi = min(Sq, k0 + BK - 1 + window);
  }
  q_lo = (q_lo / BQ) * BQ;
  const int n_qt = max(0, (q_hi - q_lo + BQ - 1) / BQ);
  const int n_it = group * n_qt;

  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  // the (head, q tile) of step i, and its lse / D row (thread tid < 64
  // carries lse of query tid, the others D of query tid - 64)
  auto head_of = [&](int i) { return kvh * group + i / n_qt; };
  auto q0_of = [&](int i) { return q_lo + (i % n_qt) * BQ; };
  auto prefetch = [&](int i, int stage) {
    const int h = head_of(i);
    const int q0 = q0_of(i);
    load_tile<HD, BQ, NT>(qs + stage * BQ * LD, q + b * q_sb + h * q_sh,
                          q_ss, q0, Sq, tid);
    load_tile<HD, BQ, NT>(dos + stage * BQ * LD, dout + b * d_sb + h * d_sh,
                          d_ss, q0, Sq, tid);
  };
  auto row_stat = [&](int i) {
    const int qp = q0_of(i) + (tid & (BQ - 1));
    const float* src = (tid < BQ ? lse : delta) + (b * H + head_of(i)) * Sq;
    return qp < Sq ? src[qp] : 0.f;
  };

  load_tile<HD, BK, NT>(ks, kb, k_ss, k0, Sk, tid);
  load_tile<HD, BK, NT>(vs, vb, v_ss, k0, Sk, tid);
  if (n_it > 0) {
    prefetch(0, 0);
    (tid < BQ ? lse_s : dl_s)[tid & (BQ - 1)] = row_stat(0);
  }
  cp_async_commit();

  const float l2s = scale * LOG2E;
  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[dn][e] = 0.f;
      dva[dn][e] = 0.f;
    }
  uint32_t kf[KC][4], vf[KC][4];

  for (int it = 0; it < n_it; ++it) {
    const int cur = it & 1;
    const int q0 = q0_of(it);
    const bool more = it + 1 < n_it;
    float stat_next = 0.f;
    if (more) {
      prefetch(it + 1, cur ^ 1);
      cp_async_commit();
      stat_next = row_stat(it + 1);   // lands while this tile computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      const int off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ldsm_x4(kf[kc], ks + off + kc * 16);
        ldsm_x4(vf[kc], vs + off + kc * 16);
      }
    }
    const bf16* qt = qs + cur * BQ * LD;
    const bf16* dt = dos + cur * BQ * LD;
    const float* ls = lse_s + cur * BQ;
    const float* ds_ = dl_s + cur * BQ;
    const bool edge =
        q0 + BQ > Sq || k0 + BK > Sk ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - k0 >= window)));

#pragma unroll
    for (int c = 0; c < BQ / QC; ++c) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
      float st[NJ][4], dpt[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.f;
          dpt[j][e] = 0.f;
        }
      {
        // matrices (queries 16jp..+7 | +8..+15) x (dims lo | hi)
        const int off = (QC * c + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int jp = 0; jp < NJ / 2; ++jp) {
            uint32_t bq[4], bd[4];
            ldsm_x4(bq, qt + off + 16 * jp * LD + 16 * kc);
            ldsm_x4(bd, dt + off + 16 * jp * LD + 16 * kc);
            mma_bf16(st[2 * jp], kf[kc], bq[0], bq[1]);
            mma_bf16(st[2 * jp + 1], kf[kc], bq[2], bq[3]);
            mma_bf16(dpt[2 * jp], vf[kc], bd[0], bd[1]);
            mma_bf16(dpt[2 * jp + 1], vf[kc], bd[2], bd[3]);
          }
      }
      // P^T into st, dS^T into dpt (rows keys, columns queries)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = QC * c + 8 * j + 2 * t + (e & 1);
          const int kp = e < 2 ? key_a : key_b;
          const bool ok =
              !edge || visible(q0 + col, kp, Sq, Sk, causal, window);
          const float p =
              ok ? exp2f(st[j][e] * l2s - ls[col] * LOG2E) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ds_[col]);
        }
      // dV += P^T dO and dK += dS^T Q: dO and Q by ldmatrix.trans
      {
        // matrices (queries lo | hi of the chunk) x (dims 16dp..+7 | +8..)
        const int off =
            (QC * c + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
            ((lane >> 4) << 3);
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk) {
          uint32_t pa[4], sa[4], sl[4];
          c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
          c_to_a_split(sa, sl, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int dp = 0; dp < DN / 2; ++dp) {
            uint32_t bd[4], bq[4];
            ldsm_x4_t(bd, dt + off + 16 * kk * LD + 16 * dp);
            ldsm_x4_t(bq, qt + off + 16 * kk * LD + 16 * dp);
            mma_bf16(dva[2 * dp], pa, bd[0], bd[1]);
            mma_bf16(dva[2 * dp + 1], pa, bd[2], bd[3]);
            mma_bf16(dka[2 * dp], sa, bq[0], bq[1]);
            mma_bf16(dka[2 * dp + 1], sa, bq[2], bq[3]);
            mma_bf16(dka[2 * dp], sl, bq[0], bq[1]);
            mma_bf16(dka[2 * dp + 1], sl, bq[2], bq[3]);
          }
        }
      }
    }
    if (more) (tid < BQ ? lse_s : dl_s)[(cur ^ 1) * BQ + (tid & (BQ - 1))] =
        stat_next;
    __syncthreads();      // this stage's readers are done before its reload
  }
  if (n_it <= 0) {        // no query sees these keys: dK = dV = 0
    cp_async_wait<0>();
    __syncthreads();
  }

  // the warp's own 16 rows of the K and V tiles are free: their fragments
  // are in registers
  store_rows16<HD>(ks + warp * 16 * LD, dka, scale, scale,
                   dk + b * dk_sb + kvh * dk_sh, dk_ss, k0 + warp * 16, Sk,
                   lane);
  store_rows16<HD>(vs + warp * 16 * LD, dva, 1.f, 1.f,
                   dv + b * dv_sb + kvh * dv_sh, dv_ss, k0 + warp * 16, Sk,
                   lane);
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
  constexpr int LD = HD + 8;
  constexpr int KC = HD / 16;
  constexpr int DN = HD / 8;
  constexpr int NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* dos = qs + BQ * LD;                        // [BQ][LD]
  bf16* ks = dos + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  int k_hi = Sk;
  int k_lo = 0;
  if (causal) {
    k_hi = min(Sk, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / BK) * BK;
  const int n_tiles = max(0, (k_hi - k_lo + BK - 1) / BK);

  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  load_tile<HD, BQ, NT>(qs, q + b * q_sb + h * q_sh, q_ss, q0, Sq, tid);
  load_tile<HD, BQ, NT>(dos, dout + b * d_sb + h * d_sh, d_ss, q0, Sq, tid);
  if (n_tiles > 0) {
    load_tile<HD, BK, NT>(ks, kb, k_ss, k_lo, Sk, tid);
    load_tile<HD, BK, NT>(vs, vb, v_ss, k_lo, Sk, tid);
  }
  cp_async_commit();

  const long long row_at = ((long long)b * gridDim.x + h) * Sq;
  const float lse_a = row_a < Sq ? lse[row_at + row_a] * LOG2E : 0.f;
  const float lse_b = row_b < Sq ? lse[row_at + row_b] * LOG2E : 0.f;
  const float dl_a = row_a < Sq ? delta[row_at + row_a] : 0.f;
  const float dl_b = row_b < Sq ? delta[row_at + row_b] : 0.f;
  const float l2s = scale * LOG2E;

  float dqa[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dn][e] = 0.f;
  uint32_t qf[KC][4], df[KC][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = k_lo + it * BK;
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<HD, BK, NT>(ks + (cur ^ 1) * BK * LD, kb, k_ss, kt0 + BK, Sk,
                            tid);
      load_tile<HD, BK, NT>(vs + (cur ^ 1) * BK * LD, vb, v_ss, kt0 + BK, Sk,
                            tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      const int off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ldsm_x4(qf[kc], qs + off + kc * 16);
        ldsm_x4(df[kc], dos + off + kc * 16);
      }
    }
    const bf16* kt = ks + cur * BK * LD;
    const bf16* vt = vs + cur * BK * LD;

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys a warp
    float s[NJ][4], dpr[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dpr[j][e] = 0.f;
      }
    {
      const int off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t bk_[4], bv[4];
          ldsm_x4(bk_, kt + off + 16 * jp * LD + 16 * kc);
          ldsm_x4(bv, vt + off + 16 * jp * LD + 16 * kc);
          mma_bf16(s[2 * jp], qf[kc], bk_[0], bk_[1]);
          mma_bf16(s[2 * jp + 1], qf[kc], bk_[2], bk_[3]);
          mma_bf16(dpr[2 * jp], df[kc], bv[0], bv[1]);
          mma_bf16(dpr[2 * jp + 1], df[kc], bv[2], bv[3]);
        }
    }
    const bool edge =
        kt0 + BK > Sk ||
        (causal && (kt0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - kt0 >= window)));
    // dS into dpr
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kt0 + 8 * j + 2 * t + (e & 1);
        const bool hi = e >= 2;
        const bool ok = (hi ? row_b : row_a) < Sq &&
                        (!edge || visible(hi ? row_b : row_a, kp, Sq, Sk,
                                          causal, window));
        const float p =
            ok ? exp2f(s[j][e] * l2s - (hi ? lse_b : lse_a)) : 0.f;
        dpr[j][e] = p * (dpr[j][e] - (hi ? dl_b : dl_a));
      }
    // dQ += dS K, K by ldmatrix.trans
    {
      // matrices (keys lo | hi of the chunk) x (dims 16dp..+7 | +8..+15)
      const int off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                      ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t sa[4];
        c_to_a(sa, dpr[2 * kk], dpr[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < DN / 2; ++dp) {
          uint32_t bk_[4];
          ldsm_x4_t(bk_, kt + off + 16 * kk * LD + 16 * dp);
          mma_bf16(dqa[2 * dp], sa, bk_[0], bk_[1]);
          mma_bf16(dqa[2 * dp + 1], sa, bk_[2], bk_[3]);
        }
      }
    }
    __syncthreads();      // this stage's readers are done before its reload
  }
  if (n_tiles <= 0) {
    cp_async_wait<0>();
    __syncthreads();
  }

  // the warp's own 16 Q rows are free: their fragments are in registers
  store_rows16<HD>(qs + warp * 16 * LD, dqa, scale, scale,
                   dq + b * dq_sb + h * dq_sh, dq_ss, q0 + warp * 16, Sq,
                   lane);
}

template <typename K>
cudaError_t raise_smem_limit(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD, typename OT>
int launch_all(const bf16* q, const bf16* k, const bf16* v, const OT* o,
               const bf16* dout, const float* lse, float* delta, bf16* dq,
               bf16* dk, bf16* dv, int B, int H, int KV, int Sq, int Sk,
               const long long* st, float scale, int causal, int window,
               cudaStream_t stream) {
  // st: q, k, v, o, dO, dq, dk, dv strides, three each
  static bool limits_set = false;
  if (!limits_set) {
    cudaError_t e = raise_smem_limit(bwd_dkdv_kernel<HD>,
                                     dkdv_smem_bytes<HD>());
    if (e == cudaSuccess)
      e = raise_smem_limit(bwd_dq_kernel<HD>, dq_smem_bytes<HD>());
    if (e != cudaSuccess) return (int)e;
    limits_set = true;
  }
  const long long rows = (long long)B * Sq * H;
  bwd_delta_kernel<HD, OT>
      <<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
          o, dout, delta, H, Sq, rows, st[9], st[10], st[11], st[12], st[13],
          st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int group = H / KV;
  bwd_dkdv_kernel<HD><<<dim3(KV, B, (Sk + BK - 1) / BK), NT,
                        dkdv_smem_bytes<HD>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, group, Sq, Sk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13],
      st[14], st[18], st[19], st[20], st[21], st[22], st[23], scale, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<HD><<<dim3(H, B, (Sq + BQ - 1) / BQ), NT,
                      dq_smem_bytes<HD>(), stream>>>(
      q, k, v, dout, lse, delta, dq, group, Sq, Sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14],
      st[15], st[16], st[17], scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dO, dq: [B, Sq, H, D]; k, v, dk, dv: [B, Sk, KV, D]; bf16 with
// element strides for the batch, sequence and head axes (multiples of 8;
// last axis contiguous; 16-byte aligned), but o, which is fp32 where
// o_fp32 is nonzero (its strides in its own elements, even); lse (the
// forward's) and delta (scratch): fp32 [B, H, Sq] contiguous.  D =
// head_dim is 64 or 80.
// Returns the first nonzero cudaError_t of the three launches
// (cudaErrorInvalidValue for any other head dim or a bad shape).
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
    float scale, int causal, int window, int o_fp32, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (Sq + BQ - 1) / BQ > 65535 || (Sk + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[24] = {q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                            v_sb,  v_ss,  v_sh,  o_sb,  o_ss,  o_sh,
                            d_sb,  d_ss,  d_sh,  dq_sb, dq_ss, dq_sh,
                            dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
#define BWD_LAUNCH(HDV, OT)                                                  \
  launch_all<HDV, OT>((const bf16*)q, (const bf16*)k, (const bf16*)v,        \
                      (const OT*)o, (const bf16*)dout, lse, delta,           \
                      (bf16*)dq, (bf16*)dk, (bf16*)dv, B, H, KV, Sq, Sk, st, \
                      scale, causal, window, (cudaStream_t)stream)
  if (head_dim == 64)
    return o_fp32 ? BWD_LAUNCH(64, float) : BWD_LAUNCH(64, bf16);
  if (head_dim == 80)
    return o_fp32 ? BWD_LAUNCH(80, float) : BWD_LAUNCH(80, bf16);
#undef BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
