// One-token (decode) attention over an int8 KV cache for Hopper
// (sm_90a): bf16 query, int8 keys and values with one fp32 absmax scale
// per (token, kv-head), dequantized on the fly, and a [B, Sk] validity
// mask that carries the ring cache's fill state (any pattern, not only a
// prefix).
//
// Replaces the TPU kernel src/repro/kernels/quantized.py
// (flash_attention_int8kv_bhsd / _int8kv_flash_kernel), which the
// reference's int8-KV decode calls with causal=False and block_q=8.
//
// What bounds it on the H100: with one query row per head it does
// ~4*D flops per (key, head) against 2*D + 8 bytes of cache per key and
// kv head, far below the ~295 flop/byte ridge, so it is bound by bytes:
// the least time is the live keys' K, V and scales (plus the mask, q and
// the output) over 3.35 TB/s.  At decode sizes that is under a
// microsecond, so what the design fights is latency: too few blocks,
// dependent loads, and bytes of dead slots.
//
// Design (flash-decoding over whole GQA groups):
//  * one CTA of 8 warps per (kv head, batch row, split of Sk); it
//    computes all `group` query heads of its kv head (up to GMAX = 4; a
//    larger group takes several CTAs), so each cache byte is read once a
//    step.  The host picks the splits (quantized.int8kv_splits): whole
//    64-key tiles, at least 8 a split, up to one CTA per SM.  With dead
//    tiles skipped, a partly filled cache under 1024 slots is fastest
//    whole: a split's merge costs more than the few live tiles it spreads;
//  * the CTA first reads its split's mask bytes, two warp ballots a
//    tile, and keeps each tile's 64 live-key bits in shared memory.  A
//    tile with no live key is skipped before any of its K, V or scales
//    is read.
//    If the split has no live key the CTA reads the rest of the row's
//    mask: a row with no live key at all is processed in full (every key
//    scores NEG_INF, so the softmax averages V as the plain version
//    does); otherwise the split contributes weight 0;
//  * the tiles to process (the live ones, or all of a dead row) are
//    listed in order by one ballot and popc; they are staged into shared
//    memory with 16-byte cp.async (K and V rows; the scales with 4-byte
//    copies) through a ring of NSTAGE = 2 slots: the next tile's copies
//    are in flight while one is computed (a ring of 4 measured no faster
//    on the H100: per-tile compute, not the copies, sets the pace);
//  * int8 to fp32 by a byte permute and an add (s8x4), not I2F (an SM
//    converts 16 integers a clock): 7% off a full 1024-slot cache in
//    one split on the H100;
//  * scores: thread (key, quarter) converts its quarter of the key's
//    int8 row once and dots it with every head's fp32 q (pre-scaled by
//    1/sqrt(D) * log2e); two shuffles finish the sum; the per-token k
//    scale multiplies each score once; exp2f throughout.  A quarter is
//    D/4 bytes: one or two 16-byte chunks at D = 64 and 128, three
//    8-byte chunks at D = 96, whose 24-byte quarters start on 8-byte
//    boundaries only (the thread map below says why it is this one);
//  * softmax: warp h keeps head h's running max and sum, two keys a
//    lane; p is written with the per-token v scale folded in;
//  * P.V: thread (4 dims, key phase) runs an unrolled loop over its keys
//    of the tile from shared memory, for every head, with no global load
//    inside; the key phases meet in shared memory at the end.  D/4 dim
//    quads take NT / (D/4) phases: 16 at 64, 8 at 128; at 96 the 24
//    quads take 10 phases on 240 of the 256 threads (the other 16 sit
//    P.V out), phase p the keys p, p + 10, ... of the tile (7 or 6 of
//    its 64).  Other maps at 96 would cost more: 6 dims a thread (16
//    phases) reads int8 rows on 2-byte boundaries, 12 dims (32 phases)
//    needs 48 KB of shared memory to meet the phases, and rows padded to
//    128 with zero q lanes would read or stage a third more bytes, where
//    the kernel is bound by bytes; this map reads 96 bytes a row, as the
//    cache holds them;
//  * with one split the CTA writes o = acc / max(l, 1e-30); with more,
//    each split writes (m, l, acc[D]) per head in fp32 to a workspace
//    and int8kv_combine_kernel merges them in split order,
//    o = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30).
//    (The last CTA of a group merging through an atomic counter saved
//    the launch but measured slower in the traced decode.)  No atomics
//    at all, so reruns are bit-equal;
//  * on request each (row, head)'s log-sum-exp of its live scores, in
//    natural-log units, (m + log2 l) ln 2, goes to an fp32 [B, H] output
//    (a serving plan merges the blocks of a ring cut over ranks by it):
//    from the main kernel with one split, from the merge with more; a
//    row with no live key gets -inf (its scores are all NEG_INF, which
//    no live score reaches).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;             // warps a CTA
constexpr int NT = NW * 32;
constexpr int TILE = 64;          // keys a tile: 4 threads a key (scores)
constexpr int KPL = TILE / 32;    // keys a lane in the softmax
constexpr int GMAX = 4;           // query heads a CTA: one softmax warp each
constexpr int MAX_TILES = 32;     // tiles a split: 2048 keys
constexpr int NSTAGE = 2;         // tiles in the cp.async ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The four int8 values of w as fp32, exactly, without I2F (an SM
// converts 16 integers to float a clock, against 64 byte permutes and
// 128 fp32 adds): each byte, offset to unsigned, goes under the exponent
// of 2^23 by a byte permute, and one subtraction of 2^23 + 128 leaves it.
__device__ __forceinline__ void s8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

template <int HD>
struct Layout {
  static_assert(HD == 64 || HD == 96 || HD == 128, "head_dim 64, 96, 128");
  // K and V rows in shared memory: at HD = 128 padded to 144 bytes, so
  // the two keys of a scores quarter-warp fall on distinct banks; at 64
  // the rows are adjacent (two rows fill the 32 banks); at 96 too: the
  // 8-byte reads of a half-warp (4 keys x 4 quarters, 96-byte rows,
  // 24-byte quarters) fall on 32 distinct banks
  static constexpr int RS = HD == 128 ? HD + 16 : HD;
  // q as fp32, 16-float chunks padded to 20: the four quarters' chunks
  // of one head fall on distinct banks
  static constexpr int QS = HD / 16 * 20;
  static constexpr int NQ = HD / 4;        // dim quads (P.V)
  static constexpr int NP = NT / NQ;       // key phases (P.V): 16, 10, 8
  static constexpr int KPP = (TILE + NP - 1) / NP;  // keys a phase: 4, 7, 8
  // a scores thread's quarter of a row: CPT chunks of CW bytes
  static constexpr int CW = HD % 64 == 0 ? 16 : 8;
  static constexpr int CPT = HD / 4 / CW;  // 1, 3 or 2
};

// Offset in sm.q of q's dim d: 16-float chunks padded to 20
__device__ __forceinline__ int q_at(int d) { return (d >> 4) * 20 + (d & 15); }

template <int HD>
struct Smem {
  using Lo = Layout<HD>;
  union {
    struct {
      int8_t k[NSTAGE][TILE * Lo::RS];
      int8_t v[NSTAGE][TILE * Lo::RS];
    } kv;
    float red[Lo::NP][GMAX][HD];           // the key phases' accumulators
  } u;
  float ks[NSTAGE][TILE];
  float vs[NSTAGE][TILE];
  float q[GMAX * Lo::QS];
  float s[GMAX][TILE];                     // scores, log2 units
  float p[GMAX][TILE];                     // probabilities x v scale
  float corr[GMAX];
  float m[GMAX];
  float l[GMAX];
  uint64_t live[MAX_TILES];                // live-key bits of each tile
  int list[MAX_TILES];                     // the tiles to process, in order
  int n_list;
};

template <int HD>
__global__ void __launch_bounds__(NT)
int8kv_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const int8_t* __restrict__ kq,
                     const float* __restrict__ kscale,
                     const int8_t* __restrict__ vq,
                     const float* __restrict__ vscale,
                     const uint8_t* __restrict__ valid,
                     __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse,
                     float* __restrict__ ws_ml,
                     float* __restrict__ ws_acc,
                     int H, int KV, int group, int Sk, int kps, int splits,
                     long long q_sb, long long q_sh,
                     long long o_sb, long long o_sh, float scale) {
  using Lo = Layout<HD>;
  __shared__ __align__(16) Smem<HD> sm;

  const int split = blockIdx.x;
  const int chunks = (group + GMAX - 1) / GMAX;
  const int kvh = blockIdx.y / chunks;
  const int hc = (blockIdx.y % chunks) * GMAX;
  const int h0 = kvh * group + hc;         // first query head of the CTA
  const int ng = min(GMAX, group - hc);    // heads of the CTA
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int start = split * kps;
  const int end = min(Sk, start + kps);
  const int ntiles = (end - start + TILE - 1) / TILE;
  const uint8_t* vrow = valid + (long long)b * Sk;

  // this split's live-key words, one ballot a tile
  bool any = false;
  for (int t = warp; t < ntiles; t += NW) {
    uint64_t word = 0;
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      const int j = start + t * TILE + 32 * c + lane;
      word |= (uint64_t)__ballot_sync(0xffffffffu, j < end && vrow[j])
              << (32 * c);
    }
    if (lane == 0) sm.live[t] = word;
    any |= word != 0;
  }
  for (int i = tid; i < GMAX * HD; i += NT) {
    const int h = i / HD, d = i % HD;
    const float f =
        h < ng ? __bfloat162float(q[b * q_sb + (h0 + h) * q_sh + d]) *
                     (scale * LOG2E)
               : 0.f;
    sm.q[h * Lo::QS + q_at(d)] = f;
  }
  const bool split_live = __syncthreads_or(any);
  bool row_dead = false;
  if (!split_live) {
    bool other = false;
    for (int j = tid; j < Sk; j += NT)
      if (j < start || j >= end) other |= vrow[j] != 0;
    row_dead = !__syncthreads_or(other);
  }
  // the tiles to process, in order: the live ones, or all of a dead row
  if (warp == 0) {
    int base = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const bool take = t < ntiles && (row_dead || sm.live[t] != 0);
      const uint32_t bal = __ballot_sync(0xffffffffu, take);
      if (take) sm.list[base + __popc(bal & ((1u << lane) - 1u))] = t;
      base += __popc(bal);
    }
    if (lane == 0) sm.n_list = base;
  }
  __syncthreads();
  const int n_list = sm.n_list;

  // cp.async of tile t's K and V rows and scales into ring slot `slot`
  auto stage = [&](int slot, int t) {
    const int j0 = start + t * TILE;
    for (int i = tid; i < TILE * (HD / 16); i += NT) {
      const int r = i / (HD / 16), c = i % (HD / 16);
      if (j0 + r < end) {
        const long long off =
            (((long long)b * Sk + j0 + r) * KV + kvh) * HD + c * 16;
        cp_async16(&sm.u.kv.k[slot][r * Lo::RS + c * 16], kq + off);
        cp_async16(&sm.u.kv.v[slot][r * Lo::RS + c * 16], vq + off);
      }
    }
    if (tid < TILE && j0 + tid < end) {
      const long long off = ((long long)b * Sk + j0 + tid) * KV + kvh;
      cp_async4(&sm.ks[slot][tid], kscale + off);
      cp_async4(&sm.vs[slot][tid], vscale + off);
    }
  };

  // scores: key kj, quarter sub of its dims; P.V: dim quad dq, phase kp
  const int kj = tid >> 2, sub = tid & 3;
  const int dq = tid % Lo::NQ, kp = tid / Lo::NQ;
  float m_run = -INFINITY, l_run = 0.f;    // head `warp`'s, in its warp
  float acc[GMAX][4];
#pragma unroll
  for (int h = 0; h < GMAX; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;

  // a ring of NSTAGE slots: NSTAGE - 1 tiles in flight ahead of the one
  // computed (one commit group per tile, empty past the end)
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < n_list) stage(i, sm.list[i]);
    cp_async_commit();
  }
  for (int i = 0; i < n_list; ++i) {
    const int slot = i % NSTAGE;
    if (i + NSTAGE - 1 < n_list)
      stage((i + NSTAGE - 1) % NSTAGE, sm.list[i + NSTAGE - 1]);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const int t = sm.list[i];
    const uint64_t word = row_dead ? 0 : sm.live[t];
    const int j0 = start + t * TILE;

    {  // scores of the tile's keys for every head
      constexpr int WPC = Lo::CW / 4;      // int8x4 words a chunk
      float kf[HD / 4];
#pragma unroll
      for (int u = 0; u < Lo::CPT; ++u) {
        const int8_t* row =
            &sm.u.kv.k[slot][kj * Lo::RS + sub * (HD / 4) + u * Lo::CW];
        uint32_t ws[WPC];
        if constexpr (Lo::CW == 16) {
          const int4 w = *reinterpret_cast<const int4*>(row);
          ws[0] = (uint32_t)w.x;
          ws[1] = (uint32_t)w.y;
          ws[2] = (uint32_t)w.z;
          ws[3] = (uint32_t)w.w;
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(row);
          ws[0] = w.x;
          ws[1] = w.y;
        }
#pragma unroll
        for (int x = 0; x < WPC; ++x) s8x4(ws[x], &kf[u * Lo::CW + x * 4]);
      }
      float dot[GMAX];
#pragma unroll
      for (int h = 0; h < GMAX; ++h) {
        dot[h] = 0.f;
        if (h < ng) {
#pragma unroll
          for (int u = 0; u < Lo::CPT; ++u)
#pragma unroll
            for (int x = 0; x < WPC; ++x) {
              const int d = sub * (HD / 4) + u * Lo::CW + x * 4;
              const float4 qv = *reinterpret_cast<const float4*>(
                  &sm.q[h * Lo::QS + q_at(d)]);
              const float* kk = &kf[u * Lo::CW + x * 4];
              dot[h] = fmaf(qv.x, kk[0], dot[h]);
              dot[h] = fmaf(qv.y, kk[1], dot[h]);
              dot[h] = fmaf(qv.z, kk[2], dot[h]);
              dot[h] = fmaf(qv.w, kk[3], dot[h]);
            }
        }
        dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], 1);
        dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], 2);
      }
      // quarter h writes head h's score
      if (sub < ng) {
        float d = dot[0];
#pragma unroll
        for (int h = 1; h < GMAX; ++h)
          if (sub == h) d = dot[h];
        float s = -INFINITY;               // past the end of the split
        if (j0 + kj < end)
          s = (word >> kj) & 1 ? d * sm.ks[slot][kj] : NEG_INF;
        sm.s[sub][kj] = s;
      }
    }
    __syncthreads();

    if (warp < ng) {  // online softmax of head `warp`, KPL keys a lane
      float s[KPL], tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        s[c] = sm.s[warp][32 * c + lane];
        tmax = fmaxf(tmax, s[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // a tile holds at least one key of the split, so m_new >= NEG_INF
      const float m_new = fmaxf(m_run, tmax);
      const float corr = exp2f(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int j = 32 * c + lane;
        const float p = exp2f(s[c] - m_new);
        psum += p;
        sm.p[warp][j] = j0 + j < end ? p * sm.vs[slot][j] : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run = l_run * corr + psum;
      m_run = m_new;
      if (lane == 0) sm.corr[warp] = corr;
    }
    __syncthreads();

    // P.V: this thread's 4 dims over its keys of the tile, every head
    // (at 96, the threads past the last phase hold no dims)
#pragma unroll
    for (int h = 0; h < GMAX; ++h) {
      if (h < ng) {
        const float c = sm.corr[h];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][e] *= c;
      }
    }
    if (NT % Lo::NQ == 0 || kp < Lo::NP) {
#pragma unroll
      for (int k = 0; k < Lo::KPP; ++k) {
        const int j = kp + Lo::NP * k;
        if (TILE % Lo::NP != 0 && j >= TILE) break;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            &sm.u.kv.v[slot][j * Lo::RS + 4 * dq]);
        float v[4];
        s8x4(w, v);
#pragma unroll
        for (int h = 0; h < GMAX; ++h) {
          if (h < ng) {
            const float p = sm.p[h][j];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(p, v[e], acc[h][e]);
          }
        }
      }
    }
    __syncthreads();
  }

  // the key phases meet (the ring is free after the last sync); a split
  // with no tile to process (its row's live keys lie in other splits)
  // writes m = -inf, l = 0, acc = 0: weight 0 in the merge
  if (warp < ng && lane == 0) {
    sm.m[warp] = m_run;
    sm.l[warp] = l_run;
  }
#pragma unroll
  for (int h = 0; h < GMAX; ++h)
    if (h < ng && kp < Lo::NP)
      *reinterpret_cast<float4*>(&sm.u.red[kp][h][4 * dq]) =
          make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  __syncthreads();
  for (int i = tid; i < ng * HD; i += NT) {
    const int h = i / HD, d = i % HD;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < Lo::NP; ++r) a += sm.u.red[r][h][d];
    if (splits == 1) {
      o[b * o_sb + (h0 + h) * o_sh + d] =
          __float2bfloat16(a / fmaxf(sm.l[h], 1e-30f));
      if (lse != nullptr && d == 0)
        lse[(long long)b * H + h0 + h] =
            row_dead ? -INFINITY : (sm.m[h] + log2f(sm.l[h])) * LN2;
    } else {
      const long long hs = ((long long)b * H + h0 + h) * splits + split;
      ws_acc[hs * HD + d] = a;
      if (d == 0) {
        ws_ml[2 * hs] = sm.m[h];
        ws_ml[2 * hs + 1] = sm.l[h];
      }
    }
  }
}

// Merge the splits of one (batch row, head): thread d of HD, splits in
// order, so the result does not depend on which CTA finished first;
// thread 0 writes the row's log-sum-exp when asked (a dead row's splits
// all hold m = NEG_INF).
template <int HD>
__global__ void __launch_bounds__(HD)
int8kv_combine_kernel(const float* __restrict__ ws_ml,
                      const float* __restrict__ ws_acc,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int splits, long long o_sb, long long o_sh) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, d = threadIdx.x;
  const float* ml = ws_ml + (long long)bh * splits * 2;
  const float* acc = ws_acc + (long long)bh * splits * HD + d;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float m = ml[2 * s];
    const float w = m == -INFINITY ? 0.f : exp2f(m - M);
    L = fmaf(w, ml[2 * s + 1], L);
    a = fmaf(w, acc[(long long)s * HD], a);
  }
  o[b * o_sb + h * o_sh + d] = __float2bfloat16(a / fmaxf(L, 1e-30f));
  if (lse != nullptr && d == 0)
    lse[bh] = M <= NEG_INF ? -INFINITY : (M + log2f(L)) * LN2;
}

template <int HD>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* valid, void* o, void* lse,
           void* ws_ml, void* ws_acc, int B, int H, int KV, int Sk,
           int splits, int kps,
           long long q_sb, long long q_sh, long long o_sb, long long o_sh,
           float scale, cudaStream_t stream) {
  const int group = H / KV;
  const int chunks = (group + GMAX - 1) / GMAX;
  dim3 grid(splits, KV * chunks, B);
  int8kv_decode_kernel<HD><<<grid, NT, 0, stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const float*)ks,
      (const int8_t*)vq, (const float*)vs, (const uint8_t*)valid,
      (__nv_bfloat16*)o, (float*)lse, (float*)ws_ml, (float*)ws_acc, H, KV,
      group, Sk, kps, splits, q_sb, q_sh, o_sb, o_sh, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  int8kv_combine_kernel<HD><<<B * H, HD, 0, stream>>>(
      (const float*)ws_ml, (const float*)ws_acc, (__nv_bfloat16*)o,
      (float*)lse, H, splits, o_sb, o_sh);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, 1, H, D] bf16 (batch and head strides given); kq/vq:
// [B, Sk, KV, D] int8, 16-byte aligned, and ks/vs: [B, Sk, KV] fp32,
// contiguous; valid: [B, Sk] bool; o: [B, 1, H, D] bf16; lse: null, or
// an fp32 [B, H] for each (row, head)'s log-sum-exp; D = head_dim is 64,
// 96 or 128.  Sk is cut into `splits` ranges of `kps` keys (a multiple of
// 64, at most 2048; the last range may be shorter).  With splits > 1,
// ws_ml [B, H, splits, 2] and ws_acc [B, H, splits, D] are fp32 scratch
// and a second launch merges them.  Returns the first launch error
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int int8kv_decode_bf16(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* valid, void* o, void* lse, void* ws_ml,
    void* ws_acc, int B, int H, int KV, int Sk, int head_dim, int splits,
    int kps, long long q_sb, long long q_sh, long long o_sb, long long o_sh,
    float scale, void* stream) {
  if (B <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || splits <= 0 ||
      kps <= 0 || kps % TILE != 0 || kps / TILE > MAX_TILES ||
      (long long)(splits - 1) * kps >= Sk || (long long)splits * kps < Sk ||
      (splits > 1 && (ws_ml == nullptr || ws_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (head_dim == 64)
    return launch<64>(q, kq, ks, vq, vs, valid, o, lse, ws_ml, ws_acc, B, H,
                      KV, Sk, splits, kps, q_sb, q_sh, o_sb, o_sh, scale, st);
  if (head_dim == 96)
    return launch<96>(q, kq, ks, vq, vs, valid, o, lse, ws_ml, ws_acc, B, H,
                      KV, Sk, splits, kps, q_sb, q_sh, o_sb, o_sh, scale, st);
  if (head_dim == 128)
    return launch<128>(q, kq, ks, vq, vs, valid, o, lse, ws_ml, ws_acc, B, H,
                       KV, Sk, splits, kps, q_sb, q_sh, o_sb, o_sh, scale, st);
  return (int)cudaErrorInvalidValue;
}
