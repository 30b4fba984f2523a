// Mamba2 / SSD chunked scan for Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py (ssd_scan /
// _ssd_kernel), which the reference reaches through ops.ssd_scan_op from
// models/ssm.mamba2_forward (zamba2).  For one (batch row, head) and each
// chunk of K steps, with s the in-chunk cumulative sum of dt * a (a < 0):
//     M[i, j] = exp(s_i - s_j) * dt_j * (C_i . B_j)   for j <= i, else 0
//     y_i     = sum_j M[i, j] x_j + exp(s_i) * (C_i . h)       (h: [hd, ds])
//     h      <- exp(s_last) h + sum_j exp(s_last - s_j) dt_j x_j (x) B_j
// from h0, returning y and the last h.  The D skip, the gate and the
// norm stay in PyTorch, as in the reference.
//
// What bounds it on the H100: at zamba2's widths (hd = ds = K = 64) a
// chunk of a head is four products of 64 x 64 x 64 or their causal
// halves: the scores C B^T (shared by every head of a row), M X,
// diag(exp s) C h^T and X^T diag(w) B.  In fp32 outside the tensor cores
// (67 TFLOP/s) they would bound it; on the tensor cores in 3xTF32 (three
// products at 495 TFLOP/s) they take about a sixth of the time the bytes
// do (x, y, and the state h0 and h_last, which at a prompt of one chunk
// are as many bytes as x and y), so it is bound by bytes.
//
// Design:
//  * the four products run on the tensor cores as mma.sync m16n8k8 in
//    TF32 with fp32 accumulators, three of them a product: each fp32
//    operand is split into hi = tf32(v) and lo = tf32(v - hi), and
//    lo hi + hi lo + hi hi keeps about fp32's accuracy, which the plain
//    version's tolerance (1e-4 + 1e-3 |y|) needs: one TF32 product keeps
//    ten bits, and sums of 64 such terms of O(1) miss it.  The split is
//    two integer ops and a subtraction: cvt.rna.tf32 is not full rate;
//  * the scores C B^T do not depend on the head.  A first launch
//    (ssd_scores_kernel, a block per 16-row tile of a chunk of a batch
//    row) writes them to an fp32 scratch [B, n_chunks, 64, 64] that the
//    wrapper allocates; the head blocks read them from L2.  They are
//    launched as its programmatic dependents: they stage their other
//    inputs while it runs and wait for it only before the scores.  (One
//    block taking several heads would share them too, but cuts the
//    blocks at batch 1, where the card is already short of them.)
//  * the TPU grid (batch, heads, chunks) runs chunks on a sequential
//    axis with h in VMEM scratch; here one block of 8 warps per (head,
//    batch row) loops over the chunks itself.  The 8 warps split the
//    head into 4 tiles of 16 columns d times 2 halves of the 64 states:
//    with one warp a sub-partition every phase of a chunk waits on its
//    own latencies (a clock64 trace of 4-warp blocks showed it), so the
//    block is wide.  At batch 1 zamba2's 80 heads are 80 blocks on 132
//    SMs.  Blocks taking a slice of 32 or 16 of a head's columns would
//    fill the card, but each slice repeats the block's scan of dt, its M
//    and its loads of B, C and the scores: on an H100 at batch 1 and 16
//    to 257 tokens whole heads took 0.0118 to 0.0446 ms, slices of 32
//    columns 0.0124 to 0.0469 and of 16 0.0155 to 0.0613;
//  * h stays in the warps' mma accumulators across the chunk loop (16
//    columns by 32 states a warp), scaled by exp(s_last) in place.  Its
//    accumulator layout is used as the B operand of C h^T as it is, by
//    numbering the k slots of that product's state tiles (2t, 2t+1)
//    instead of (t, t+4): C is read as float2 pairs;
//  * a warp that owns a part of the states forms y's partial sums over
//    them (C h^T) and over a share of M X's causal k tiles; the parts
//    meet in shared memory (over the chunk's C and M, no longer needed)
//    and are summed in a fixed order, so reruns give equal bits; no
//    atomics;
//  * each chunk's rows of x, B, C and the scores are staged by 16-byte
//    cp.async (the wrapper hands rows on 16-byte boundaries) into tiles
//    whose rows are padded against bank conflicts and zero past the
//    chunk; dt by 4-byte cp.async.  With two stages chunk c+1 is in
//    flight while chunk c updates the state and finishes y: its copies,
//    ~2.7K cycles of a block's issue a chunk, slowed M and M X where
//    they were issued before them.  (Bulk copies of single rows, one
//    cp.async.bulk a row from one warp, took ~20K cycles a chunk.)
//    Two stages take 140 KB, one block an SM, so the host asks for them
//    only where the grid fits in one block an SM anyway;
//  * s is summed and differenced in fp64.  At large dt |A| it reaches
//    thousands within a chunk, where fp32 spacing is ~1e-4, and an fp32
//    cumsum carries that error into every exp(s_i - s_j); in fp64 the
//    exponents stay as exact as the sequential recurrence's dt * a.
//    Each exp is one ex2.approx of the exponent times log2(e), rounded
//    to fp32 (relative error ~1e-6 where the result is above 2^-126);
//  * mask before the exponential: for j > i, s_i - s_j is positive and
//    with zamba2's A (up to -16) a chunk's sum reaches hundreds, so exp
//    overflows to inf, and inf * 0 would be NaN.  M is set to 0 there
//    without evaluating exp, as the reference's jnp.where selects;
//  * the last partial chunk runs its valid rows only (rounded up to the
//    mma's 16 and 8, with zero rows): the reference pads with dt = 0 and
//    x = 0, whose rows add nothing and leave s unchanged;
//  * x [B, S, nh, hd], dt [B, S, nh], B and C [B, S, ds] are read in the
//    model's layout through strides, with no transpose.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;          // warps a scan block
constexpr int NT = 32 * NW;
constexpr int NT_SC = 128;     // threads a scores block: 4 warps
constexpr int KMAX = 64;       // largest chunk
constexpr int HD = 64;         // head_dim (zamba2)
constexpr int DS = 64;         // d_state (zamba2)
// row strides (floats) of the staged tiles: a fragment load by (row
// g or t, column t or g) then hits 32 distinct banks
constexpr int LDX = HD + 4;    // x: [j][d]
constexpr int LDB = DS + 4;    // B: [j][s]
constexpr int LDC = DS + 8;    // C: [i][s], read as float2 at column 2t
constexpr int LDG = KMAX + 4;  // scores, then M: [i][j]
constexpr int SQ = NW / (HD / 16);   // parts of the states: warps a
                                     // tile of 16 columns
constexpr int SPW = DS / SQ;   // states a warp owns
constexpr int NS = SPW / 8;    // their n8 tiles
// a stage's tiles (floats)
constexpr int X_OFF = 0;
constexpr int B_OFF = X_OFF + KMAX * LDX;
constexpr int C_OFF = B_OFF + KMAX * LDB;
constexpr int G_OFF = C_OFF + KMAX * LDC;
constexpr int DT_OFF = G_OFF + KMAX * LDG;
constexpr int STAGE = DT_OFF + KMAX;
// y's partial sums, ex[warp][n][row][8], over C and M once both are read
static_assert(NW * 2 * KMAX * 8 <= KMAX * (LDC + LDG),
              "partial sums overflow C and M");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

// rows [0, valid) of COLS floats at src (row stride ld_src, 16-byte
// aligned) into dst (row stride ld_dst) by a block of NTH threads; rows
// [valid, rows) zero
template <int COLS, int NTH>
__device__ __forceinline__ void stage_rows(float* dst, int ld_dst,
                                           const float* src,
                                           long long ld_src, int valid,
                                           int rows) {
  constexpr int Q = COLS / 4;
  for (int idx = threadIdx.x; idx < rows * Q; idx += NTH) {
    const int r = idx / Q;
    const int c = (idx % Q) * 4;
    const bool v = r < valid;
    cp_async16(dst + r * ld_dst + c, v ? src + r * ld_src + c : src, v);
  }
}

constexpr double LOG2E = 1.4426950408889634;

// 2^v in one ex2.approx (flushing results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32 (10 stored bits): hi rounded to nearest by
// integer ops (full rate, where cvt.rna.tf32 is not), lo truncated
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

struct FragA {          // a 16 x 8 A operand, split
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

struct FragB {          // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// The scores G[i, j] = C_i . B_j of one chunk of one batch row, for the
// 16 rows i of tile mi and the 8-column tiles at or below the diagonal
// (i, j < kc), into the scratch; warp w takes the column tiles w and
// w + 4.  Mma fragments (g = lane / 4, t = lane % 4): A (16 x 8, row)
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B (8 x 8, col) b0
// (t, g), b1 (t+4, g); C (16 x 8) c0, c1 (g, 2t, 2t+1), c2, c3 (g+8, ...).
__global__ void __launch_bounds__(NT_SC)
ssd_scores_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ G, int S, int K, int n_chunks,
                  long long b_sb, long long b_ss, long long c_sb,
                  long long c_ss) {
  // the scan's blocks may start now: they stage everything but the
  // scores, then wait for this grid (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ __align__(16) float bs[KMAX * LDB];
  __shared__ __align__(16) float cs[16 * LDB];
  const int ch = blockIdx.x >> 2;
  const int mi = blockIdx.x & 3;
  const int b = blockIdx.y;
  const int c0 = ch * K;
  const int kc = min(K, S - c0);
  const int i0 = 16 * mi;
  if (i0 >= kc) return;
  stage_rows<DS, NT_SC>(bs, LDB, Bm + b * b_sb + c0 * b_ss, b_ss, kc,
                        i0 + 16);
  stage_rows<DS, NT_SC>(cs, LDB, Cm + b * c_sb + (c0 + i0) * c_ss, c_ss,
                        kc - i0, 16);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nn = min(2 * mi + 2, (kc + 7) >> 3);   // column tiles
  float acc[2][4] = {};
#pragma unroll
  for (int kt = 0; kt < DS / 8; ++kt) {
    const int k = 8 * kt + t;
    FragA a;
    a.set(cs[g * LDB + k], cs[(g + 8) * LDB + k], cs[g * LDB + k + 4],
          cs[(g + 8) * LDB + k + 4]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jt = w + 4 * u;
      if (jt < nn) {
        FragB f;
        f.set(bs[(8 * jt + g) * LDB + k], bs[(8 * jt + g) * LDB + k + 4]);
        mma3(acc[u], a, f);
      }
    }
  }
  float* Gc = G + ((long long)b * n_chunks + ch) * KMAX * KMAX;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int jt = w + 4 * u;
    if (jt < nn) {
      const int j = 8 * jt + 2 * t;
      *reinterpret_cast<float2*>(Gc + (i0 + g) * KMAX + j) =
          make_float2(acc[u][0], acc[u][1]);
      *reinterpret_cast<float2*>(Gc + (i0 + g + 8) * KMAX + j) =
          make_float2(acc[u][2], acc[u][3]);
    }
  }
}

// two blocks an SM (at most 128 registers a thread): at batch 8 the
// grid is 640 blocks, and one block an SM left the Engine prefill 30%
// slower
__global__ void __launch_bounds__(NT, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ a_heads,
                const float* __restrict__ h0, const float* __restrict__ G,
                float* __restrict__ y, float* __restrict__ h_last, int S,
                int nh, int K, int n_chunks, int stages,
                long long x_sb, long long x_ss, long long x_sh,
                long long d_sb, long long d_ss, long long d_sh,
                long long b_sb, long long b_ss,
                long long c_sb, long long c_ss) {
  extern __shared__ __align__(16) float smem[];
  double* s_sm = reinterpret_cast<double*>(smem + stages * STAGE);
  float* es = reinterpret_cast<float*>(s_sm + KMAX);    // exp(s_i)
  float* wv = es + KMAX;                // exp(s_last - s_j) dt_j
  float* decay_sm = wv + KMAX;          // exp(s_last)

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = w % SQ;                 // the warp's part of the states
  const int dw = 16 * (w / SQ);         // its 16 columns
  const int sq0 = q * SPW;
  const float a = a_heads[hh];

  // h[dw + r, sq0 + s] as accumulators: h[n] = rows g, g+8 of states
  // sq0 + 8n + 2t, 2t+1
  const long long hbase = ((long long)(b * nh + hh) * HD + dw) * DS;
  float h[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int s = sq0 + 8 * n + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(h0 + hbase + g * DS + s);
    const float2 hi =
        *reinterpret_cast<const float2*>(h0 + hbase + (g + 8) * DS + s);
    h[n][0] = lo.x;
    h[n][1] = lo.y;
    h[n][2] = hi.x;
    h[n][3] = hi.y;
  }

  const float* xb = x + b * x_sb + hh * x_sh;
  const float* db = dt + b * d_sb + hh * d_sh;
  const float* bb = Bm + b * b_sb;
  const float* cb = Cm + b * c_sb;
  const float* gb = G + (long long)b * n_chunks * KMAX * KMAX;
  float* yb = y + ((long long)b * S * nh + hh) * HD;
  const long long y_ss = (long long)nh * HD;

  // chunk ch's x, B, C and dt (and its scores unless !with_g)
  // into stage st: one cp.async group
  auto stage = [&](int ch, int st, bool with_g) {
    float* base = smem + st * STAGE;
    const int c0 = ch * K;
    const int kc = min(K, S - c0);
    const int kp = (kc + 15) & ~15;
    stage_rows<HD, NT>(base + X_OFF, LDX, xb + c0 * x_ss, x_ss, kc, kp);
    stage_rows<DS, NT>(base + B_OFF, LDB, bb + c0 * b_ss, b_ss, kc, kp);
    stage_rows<DS, NT>(base + C_OFF, LDC, cb + c0 * c_ss, c_ss, kc, kp);
    if (with_g)
      stage_rows<KMAX, NT>(base + G_OFF, LDG,
                           gb + (long long)ch * KMAX * KMAX, KMAX, kc, kc);
    for (int j = tid; j < kp; j += NT)
      cp_async4(base + DT_OFF + j, j < kc ? db + (c0 + j) * d_ss : db,
                j < kc);
    cp_async_commit();
  };

  // chunk 0's inputs go out while the scores kernel runs; its scores once
  // that grid is done (a no-op where this launch does not overlap it)
  stage(0, 0, false);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  stage_rows<KMAX, NT>(smem + G_OFF, LDG, gb, KMAX, min(K, S), min(K, S));
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = stages == 2 ? ch & 1 : 0;
    const int c0 = ch * K;
    const int kc = min(K, S - c0);
    const int kp = (kc + 15) & ~15;
    const int nkt = (kc + 7) >> 3;      // k tiles of 8 rows
    const int nmt = kp >> 4;            // m tiles of 16 rows
    cp_async_wait_all();
    __syncthreads();    // chunk ch landed; chunk ch-1 is done everywhere
    float* base = smem + st * STAGE;
    const float* xs = base + X_OFF;
    const float* bs = base + B_OFF;
    const float* cs = base + C_OFF;
    float* ms = base + G_OFF;           // scores, then M in place
    float* ex = base + C_OFF;           // then y's partial sums over C, M
    const float* dts = base + DT_OFF;

    // s = inclusive cumsum of dt * a over the chunk (fp64): warp 0, two
    // halves; then exp(s_i), the state update's weights and decay
    if (w == 0) {
      double lo = lane < kc ? (double)(dts[lane] * a) : 0.0;
      double hi = lane + 32 < kc ? (double)(dts[lane + 32] * a) : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double l = __shfl_up_sync(0xffffffffu, lo, off);
        const double r = __shfl_up_sync(0xffffffffu, hi, off);
        if (lane >= off) {
          lo += l;
          hi += r;
        }
      }
      hi += __shfl_sync(0xffffffffu, lo, 31);
      const double s_last =
          __shfl_sync(0xffffffffu, kc - 1 < 32 ? lo : hi, (kc - 1) & 31);
      s_sm[lane] = lo;
      s_sm[lane + 32] = hi;
      es[lane] = lane < kc ? ex2((float)(lo * LOG2E)) : 0.f;
      es[lane + 32] = lane + 32 < kc ? ex2((float)(hi * LOG2E)) : 0.f;
      wv[lane] = lane < kc ? ex2((float)((s_last - lo) * LOG2E)) * dts[lane]
                           : 0.f;
      wv[lane + 32] = lane + 32 < kc
                          ? ex2((float)((s_last - hi) * LOG2E)) * dts[lane + 32]
                          : 0.f;
      if (lane == 0) *decay_sm = ex2((float)(s_last * LOG2E));
    }
    __syncthreads();

    // M[i, j], masked before the exponential, over the scores in place:
    // warp w takes rows w, w+8, ..., a lane columns lane and lane+32; all
    // of a thread's loads go ahead of its stores
    {
      constexpr int R = KMAX / NW;
      float v[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = w + NW * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          v[r][c] = 0.f;
          if (j <= i && i < kc)
            v[r][c] = ex2((float)(s_sm[i] - s_sm[j]) * (float)LOG2E) *
                      dts[j] * ms[i * LDG + j];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (w + NW * r < kp && lane + 32 * c < kp)
            ms[(w + NW * r) * LDG + lane + 32 * c] = v[r][c];
    }
    __syncthreads();

    // y's partial sums for rows i of the chunk, columns dw + 8n + (2t,
    // 2t+1): C h^T over the warp's states, its rows scaled by exp(s_i),
    // then M X over the k tiles kt = q (mod SQ)
    float yacc[4][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < NS; ++ks) {
      // k slots t and t+4 of this state tile are states 2t and 2t+1, so
      // h's accumulators are the B fragments as they stand
      FragB fh[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) fh[n].set(h[ks][2 * n], h[ks][2 * n + 1]);
      const int s = sq0 + 8 * ks + 2 * t;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mi < nmt) {
          const int i = 16 * mi + g;
          const float2 c0v = *reinterpret_cast<const float2*>(cs + i * LDC + s);
          const float2 c1v =
              *reinterpret_cast<const float2*>(cs + (i + 8) * LDC + s);
          FragA fc;
          fc.set(c0v.x, c1v.x, c0v.y, c1v.y);
          mma3(yacc[mi][0], fc, fh[0]);
          mma3(yacc[mi][1], fc, fh[1]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float e0 = es[16 * mi + g], e1 = es[16 * mi + g + 8];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        yacc[mi][n][0] *= e0;
        yacc[mi][n][1] *= e0;
        yacc[mi][n][2] *= e1;
        yacc[mi][n][3] *= e1;
      }
    }
    for (int kt = q; kt < nkt; kt += SQ) {
      const int j = 8 * kt + t;
      FragB fx[2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        fx[n].set(xs[j * LDX + dw + 8 * n + g],
                  xs[(j + 4) * LDX + dw + 8 * n + g]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mi >= (kt >> 1) && mi < nmt) {       // at or below the diagonal
          const float* m0 = ms + (16 * mi + g) * LDG + j;
          FragA fm;
          fm.set(m0[0], m0[8 * LDG], m0[4], m0[8 * LDG + 4]);
          mma3(yacc[mi][0], fm, fx[0]);
          mma3(yacc[mi][1], fm, fx[1]);
        }
      }
    }

    // the next chunk goes out into the other stage now, not at the top:
    // its copies would slow the shared-memory traffic of M and M X
    if (stages == 2 && ch + 1 < n_chunks) stage(ch + 1, st ^ 1, true);

    // h <- exp(s_last) h + (X^T diag(w)) B over the warp's states: m = the
    // warp's 16 columns d, n = states, k = the chunk's rows j
    const float decay = *decay_sm;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) h[n][r] *= decay;
    for (int kt = 0; kt < nkt; ++kt) {
      const int j = 8 * kt + t;
      const float w0 = wv[j], w1 = wv[j + 4];
      const float* x0 = xs + j * LDX + dw + g;
      FragA fa;
      fa.set(x0[0] * w0, x0[8] * w0, x0[4 * LDX] * w1, x0[4 * LDX + 8] * w1);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* b0 = bs + j * LDB + sq0 + 8 * n + g;
        FragB fb;
        fb.set(b0[0], b0[4 * LDB]);
        mma3(h[n], fa, fb);
      }
    }

    __syncthreads();   // every warp is done with C and M: their space
                       // takes the partial sums, ex[w][n][row][8]
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mi < nmt) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float* e = ex + ((w * 2 + n) * KMAX + 16 * mi + g) * 8 + 2 * t;
          *reinterpret_cast<float2*>(e) =
              make_float2(yacc[mi][n][0], yacc[mi][n][1]);
          *reinterpret_cast<float2*>(e + 64) =
              make_float2(yacc[mi][n][2], yacc[mi][n][3]);
        }
      }
    }
    __syncthreads();
    // the warp finishes the (m tile, column tile) pairs u = q (mod SQ) of
    // its 16 columns: the SQ parts summed in order
    const int w0 = (w / SQ) * SQ;
    for (int u = q; u < 2 * nmt; u += SQ) {
      const int mi = u >> 1, n = u & 1;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * mi + g + 8 * half;
        float2 sum = make_float2(0.f, 0.f);
#pragma unroll
        for (int p = 0; p < SQ; ++p) {
          const float2 v = *reinterpret_cast<const float2*>(
              ex + (((w0 + p) * 2 + n) * KMAX + i) * 8 + 2 * t);
          sum.x += v.x;
          sum.y += v.y;
        }
        if (i < kc)
          *reinterpret_cast<float2*>(yb + (c0 + i) * y_ss + dw + 8 * n +
                                     2 * t) = sum;
      }
    }
    if (stages == 1 && ch + 1 < n_chunks) {
      __syncthreads();   // the one stage is free
      stage(ch + 1, 0, true);
    }
  }

#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int s = sq0 + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(h_last + hbase + g * DS + s) =
        make_float2(h[n][0], h[n][1]);
    *reinterpret_cast<float2*>(h_last + hbase + (g + 8) * DS + s) =
        make_float2(h[n][2], h[n][3]);
  }
}
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           const void* a, const void* h0, const void* G, void* y,
           void* h_last, int B, int S, int nh, int K, int n_chunks,
           int stages, long long x_sb, long long x_ss, long long x_sh,
           long long d_sb, long long d_ss, long long d_sh, long long b_sb,
           long long b_ss, long long c_sb, long long c_ss,
           cudaStream_t stream) {
  // stages, s (fp64), exp(s_i), w and the decay
  const int bytes =
      (stages * STAGE + 2 * KMAX + 2 * KMAX + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: the scan's blocks start while the
  // scores kernel runs and wait for it before they read the scores
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nh, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, ssd_scan_kernel, (const float*)x, (const float*)dt,
      (const float*)Bm, (const float*)Cm, (const float*)a, (const float*)h0,
      (const float*)G, (float*)y, (float*)h_last, S, nh, K, n_chunks, stages,
      x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, c_sb, c_ss);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, long long s0, long long s1, long long s2) {
  return (uintptr_t)p % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
         s2 % 4 == 0;
}

}  // namespace

// x: [B, S, nh, hd] with element strides for batch, time and head (last
// axis contiguous); dt: [B, S, nh] with strides; Bm, Cm: [B, S, ds] with
// batch and time strides (last axis contiguous); a: [nh]; h0, h_last:
// [B, nh, hd, ds] contiguous; y: [B, S, nh, hd] contiguous; G: fp32
// scratch of [B, ceil(S / K), 64, 64]; all fp32; x, Bm, Cm and G on
// 16-byte boundaries with their strides multiples of 4 elements (else
// cudaErrorMisalignedAddress).  (hd, ds) must be zamba2's (64, 64);
// 1 <= K <= 64; stages (from mamba_scan.ssd_plan) 1 or 2.  Launches the
// scores kernel, then the scan (a block a head and batch row), on
// `stream`.  Returns the cudaError_t of the launches.
extern "C" int ssd_scan_fp32(
    const void* x, const void* dt, const void* Bm, const void* Cm,
    const void* a, const void* h0, void* G, void* y, void* h_last,
    int B, int S, int nh, int hd, int ds, int K, int stages,
    long long x_sb, long long x_ss, long long x_sh,
    long long d_sb, long long d_ss, long long d_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || K < 1 || K > KMAX || hd != HD ||
      ds != DS || (stages != 1 && stages != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (S + K - 1) / K;
  if (n_chunks == 1) stages = 1;
  // rows of x, B, C and the scores move as 16-byte copies
  if (!aligned16(x, x_sb, x_ss, x_sh) || !aligned16(Bm, b_sb, b_ss, 0) ||
      !aligned16(Cm, c_sb, c_ss, 0) || !aligned16(G, 0, 0, 0))
    return (int)cudaErrorMisalignedAddress;
  ssd_scores_kernel<<<dim3(n_chunks * 4, B), NT_SC, 0, st>>>(
      (const float*)Bm, (const float*)Cm, (float*)G, S, K, n_chunks, b_sb,
      b_ss, c_sb, c_ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch(x, dt, Bm, Cm, a, h0, G, y, h_last, B, S, nh, K, n_chunks,
                stages, x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, c_sb,
                c_ss, st);
}
