// Blocked int8 matrix product with per-tile absmax scales for Hopper
// (sm_90a): out[M, N] fp32 = sum over K blocks kb, in K order, of
//   float(xq[i-block, kb] . wq[kb, j-block], exact in int32)
//     * (xs[i, kb] * ws[kb, j]).
//
// Replaces the TPU kernel src/repro/kernels/quantized.py
// (int8_matmul_blocked / _int8_matmul_kernel), which the reference's
// ops.int8_matmul calls after padding and quantizing both operands.
//
// Layouts: xq [M, K] int8 (K contiguous), xs [M/bm, K/bk] fp32, wq [K, N]
// int8 (N contiguous), ws [K/bk, N/bn] fp32, out [M, N] fp32, and a
// scratch wt [N, K] int8.  M, N, K are multiples of their block sizes,
// and bm, bk, bn are 32, 64, 96 or 128 (the wrapper checks both).
//
// What bounds it on the H100 (132 SMs, 1.98 GHz), at 4096^3:
//  * the tensor cores: 2*M*N*K = 137 G int8 operations, 0.0694 ms at
//    1979 TOP/s;
//  * bytes: 16.8 MB of x and of w, 67.1 MB of fp32 output, 0.030 ms at
//    3.35 TB/s (w's transposed copy adds 33.5 MB of traffic, 0.010 ms);
//  * the promotion of every K block's int32 partial into the fp32 sum,
//    M*N*K/bk of them: 1.074 G at blocks of 64, 0.537 G at 128.  Each is
//    one integer add, one fp32 add and one FMA: 2 fp32 instructions at
//    128 a clock an SM (0.064 ms at blocks 64, 0.032 at 128), and three
//    issue slots at four warp instructions a clock an SM (0.096, 0.048);
//  * operand traffic from L2: each 128 x 128 tile reads its K x 128 rows
//    of x and columns of w, M*N*K*(1/128 + 1/128) = 1.07 GB at 4096^3.
// Measured (edited copies, not kept): the products alone take 0.09 ms
// at blocks 64, the promotion alone 0.11, and the two add up, also
// between warpgroups and also in ping-pong: the card does not run one
// warpgroup's promotion under the other's products.  Loading x's tile
// once for a 2 x 2 cluster of blocks (TMA multicast) did not help.  A
// wider tile (64 x 256 a warpgroup) would hold 128 int32 partials and
// 128 fp32 sums a thread, more than the 232 registers a consumer has.
//
// Design:
//  * 8-bit wgmma reads both operands K-major, and wq is N contiguous, so
//    the kernel first writes w transposed into wt, once (phase 1): every
//    block takes 128 x 128 tiles of w by TMA, turns them with byte
//    permutes and stores them as rows of wt; a cooperative launch lets
//    the whole grid sync before phase 2 reads wt.  Transposing w stage by
//    stage in shared memory instead would repeat the work for every
//    128-row tile of M and take shared memory from the ring; PyTorch's
//    int8 transpose (wq.t().contiguous()) takes longer than phase 1;
//  * phase 2: persistent blocks (one an SM) walk 128x128 output tiles;
//    each block is a producer warpgroup and two consumer warpgroups, each
//    consumer on 64 rows of the tile with wgmma.mma_async m64n128k32
//    .s32.s8.s8, both operands read from shared memory through 128-byte
//    swizzled, K-major descriptors; setmaxnreg gives the consumers 232
//    registers and the producer 40;
//  * K goes through a ring of 6 stages of 128 bytes of K.  One producer
//    thread keeps the TMA loads of x and wt in flight, with mbarrier full
//    and empty barriers per stage.  The tensor maps are encoded on the
//    host by cuTensorMapEncodeTiled, taken from the driver with
//    cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda,
//    and passed as __grid_constant__ parameters.  TMA fills rows, columns
//    and k beyond M, N and K with zeros, which add nothing, so no tile
//    has an edge path of its own;
//  * each consumer thread loads its own scales, xs of its rows' block and
//    ws of its four 32-column groups' blocks, one K block ahead, and forms
//    their products (first, as in the reference).  Threads that staged
//    them in shared memory for the whole ring made every stage wait for
//    them, and halved the ring's rate;
//  * promotion is exact and off the converter: every partial is an
//    integer with |v| <= 127*127*128 < 2^22, so
//    __int_as_float(v + 0x4B400000) - 12582912.0f is v as fp32 exactly
//    (one integer add, one fp32 add), then one FMA with the scale
//    product, in K order;
//  * each consumer keeps two sets of partials: K block kb + 1's products
//    run into one while kb's, in the other, are promoted
//    (wgmma.wait_group 1).  A K block's bk / 32 products are unrolled at
//    compile time, one copy of the loop for each block size: inside a
//    loop, ptxas fences every wgmma, which halved their rate.  The steady
//    state takes K blocks in pairs with no branch, so that ptxas can see
//    which set is in flight (it serializes every wgmma otherwise).  The
//    first product of a block has scale-d 0, so no instruction clears the
//    partials;
//  * the fp32 tile is stored from registers, 8-byte stores that fill
//    32-byte sectors.  No split-K and no atomics: a rerun is bit-equal.
#include <cooperative_groups.h>
#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;              // output rows a tile
constexpr int TN = 128;              // output columns a tile (wgmma n)
constexpr int KST = 128;             // k a stage: one 128-byte swizzle row
constexpr int STAGES = 6;
constexpr int THREADS = 384;         // producer + two consumer warpgroups
constexpr int TILE_BYTES = TM * KST; // an x or w stage: 16 KB
constexpr int SMEM_BYTES = 2 * STAGES * TILE_BYTES + (2 * STAGES + 1) * 8 +
                           1024;
constexpr int W_BUFS = 2 * STAGES;   // phase 1's w tiles a round
// k32 steps a K block, as a type: one copy of the consumer loop each
template <int N> struct Steps { static constexpr int value = N; };
constexpr int MAGIC_I = 0x4B400000;  // the bits of 1.5 * 2^23
constexpr float MAGIC_F = 12582912.0f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// one arrival that also expects ``bytes`` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
               "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// a K-major operand of 128-byte rows, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the layout TMA's SWIZZLE_128B writes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the accumulators are redefined here for the compiler, so that no read
// of them moves above the wgmma.wait_group before it
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64x128, int32] (scale_d ? d : 0) + A[64x32] . B[32x128], s8 in
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// facc += float(d) * scale, d exact through the integer-add identity
__device__ __forceinline__ void promote(const int (&d)[64], const float (&sc)[4],
                                        float (&facc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float v = __fsub_rn(__int_as_float(d[i] + MAGIC_I), MAGIC_F);
    facc[i] = __fmaf_rn(v, sc[i >> 4], facc[i]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_wt,
                   int8_t* __restrict__ wt,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   float* __restrict__ out, int M, int N, int K, int bm,
                   int bk, int bn) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // stage 0 of x and of w; barrier 0 of each kind, 8 bytes apart
  const uint32_t sa = base, sb = base + STAGES * TILE_BYTES;
  const uint32_t full = base + 2 * STAGES * TILE_BYTES,
                 empty = full + 8 * STAGES, pre = empty + 8 * STAGES;
  const int nkb = K / bk, nn = N / bn;
  const int tiles_m = (M + TM - 1) / TM;
  const int nst = (K + KST - 1) / KST;         // stages a tile
  const int ntiles = tiles_m * ((N + TN - 1) / TN);
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int total = my_tiles * nst;   // stages this block consumes
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);         // the loads
      mbar_init(empty + 8 * s, 256);      // every consumer thread
    }
    mbar_init(pre, 1);                    // phase 1's w loads
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&map_x)
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&map_w)
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&map_wt)
                 : "memory");
  }
  __syncthreads();

  // ---------------- phase 1: w transposed once, into wt ----------------
  // Each block takes 128 x 128 tiles of w (k x n) in turn, TMA-loaded in
  // rounds of up to W_BUFS into the stage buffers (unused until phase
  // 2), and writes each as 128 rows of wt (n x k).  A tile is loaded as
  // the 3-D box (n, k / 16, k % 16), so its shared rows run k%16-major
  // and the 128-byte swizzle turns on k / 16: (n, k) sits at row
  // 8 (k % 16) + k / 16, chunk (n / 16) ^ (k / 16).  Warp w < 8 takes
  // the 16 columns 16w..; lane (kc = lane % 8, ng = lane / 8) the 4
  // columns 4ng.. of them at k = 16kc .. 16kc+15: 16 conflict-free
  // 4-byte loads, byte permutes, and for each column 16 bytes of k, so
  // that a warp's store fills 4 rows' 128 bytes.  The generic writes are
  // made visible to phase 2's TMA reads, then the whole grid syncs.
  {
    const int tk = (K + 127) / 128, tn = (N + 127) / 128;
    const int mine = (tk * tn - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int kc = lane & 7, ng = lane >> 3;
    for (int r0 = 0; r0 < mine; r0 += W_BUFS) {
      const int nr = mine - r0 < W_BUFS ? mine - r0 : W_BUFS;
      if (tid == 0) {
        mbar_expect_tx(pre, nr * TILE_BYTES);
        for (int i = 0; i < nr; ++i) {
          const int t = blockIdx.x + (r0 + i) * gridDim.x;
          tma_3d(base + i * TILE_BYTES, &map_w, pre, (t % tn) * 128,
                 (t / tn) * 8, 0);
        }
      }
      mbar_wait(pre, (r0 / W_BUFS) & 1);
      for (int i = 0; warp < 8 && i < nr; ++i) {
        const int t = blockIdx.x + (r0 + i) * gridDim.x;
        const int n0 = (t % tn) * 128 + 16 * warp + 4 * ng;
        const int k0 = (t / tn) * 128 + 16 * kc;
        if (n0 >= N || k0 >= K) continue;
        const uint32_t src = base + i * TILE_BYTES + kc * 128 +
                             ((warp ^ kc) << 4) + 4 * ng;
        uint32_t w[16];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          asm volatile("ld.shared.b32 %0, [%1];"
                       : "=r"(w[k]) : "r"(src + 8 * 128 * k));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t o[4];              // column n0+j, k = k0+4g .. k0+4g+3
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const uint32_t a = __byte_perm(w[4 * g], w[4 * g + 1],
                                           j < 2 ? 0x5140 : 0x7362);
            const uint32_t b = __byte_perm(w[4 * g + 2], w[4 * g + 3],
                                           j < 2 ? 0x5140 : 0x7362);
            o[g] = __byte_perm(a, b, (j & 1) ? 0x7632 : 0x5410);
          }
          *reinterpret_cast<uint4*>(wt + (long long)(n0 + j) * K + k0) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
      __syncthreads();                 // the buffers are reloaded next round
    }
    asm volatile("fence.proxy.async;" ::: "memory");
    cooperative_groups::this_grid().sync();
  }

  if (tid < 128) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    // one thread keeps the TMA loads of up to STAGES stages in flight.
    // Stage c of this block: tile blockIdx.x + (c / nst) * gridDim.x, K
    // stage c % nst; its slot c % STAGES is free once the consumers have
    // released stage c - STAGES
    if (tid == 0)
      for (int c = 0; c < total; ++c) {
        const int slot = c % STAGES;
        if (c >= STAGES) mbar_wait(empty + 8 * slot, ((c / STAGES) & 1) ^ 1);
        const int tile = blockIdx.x + (c / nst) * gridDim.x;
        const int k0 = (c % nst) * KST;
        mbar_expect_tx(full + 8 * slot, 2 * TILE_BYTES);
        tma_2d(sa + slot * TILE_BYTES, &map_x, full + 8 * slot, k0,
               (tile % tiles_m) * TM);
        tma_2d(sb + slot * TILE_BYTES, &map_wt, full + 8 * slot, k0,
               (tile / tiles_m) * TN);
      }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = (tid >> 7) - 1;               // 64-row half of the tile
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    int acc0[64], acc1[64];
    float facc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
    // a K block's SPB k32 steps are unrolled, so that its products issue
    // back to back (a loop around them makes ptxas fence each one)
    auto consume = [&](auto spb_c) {
      constexpr int SPB = decltype(spb_c)::value;
      int c_base = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * TM, n0 = (tile / tiles_m) * TN;
        const int row = m0 + 64 * wg + 16 * warp + g;
#pragma unroll
        for (int i = 0; i < 64; ++i) facc[i] = 0.f;
        int released = 0;
        // this thread's scales: its rows' block of xs and its four
        // 32-column groups' blocks of ws, one K block ahead (clamped to
        // the last row and column: past M or N the products are 0)
        const float* xrow = xs + (long long)(min(row, M - 1) / bm) * nkb;
        int cb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) cb[q] = min(n0 + 32 * q, N - 1) / bn;
        float xn = __ldg(xrow), wn[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wn[q] = __ldg(ws + cb[q]);
        // K block kb's products into acc, once the stages its steps
        // begin have landed
        auto issue = [&](int kb, int (&acc)[64]) {
          const int s0 = kb * SPB;
#pragma unroll
          for (int j = 0; j < SPB; ++j)
            if (((s0 + j) & 3) == 0) {
              const int st = c_base + ((s0 + j) >> 2);
              mbar_wait(full + 8 * (st % STAGES), (st / STAGES) & 1);
            }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < SPB; ++j) {
            const int s = s0 + j, st = c_base + (s >> 2);
            const uint32_t off = (st % STAGES) * TILE_BYTES + (s & 3) * 32;
            wgmma_s8(acc, sw128_desc(sa + off + wg * 64 * KST),
                     sw128_desc(sb + off), j > 0);
          }
          wgmma_commit();
        };
        // K block kb's partials, landed: free the stages it finished and
        // promote them with its scale products
        auto finish = [&](int kb, int (&acc)[64]) {
          fence_acc(acc);
          float sc[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[q] = xn * wn[q];
          {
            const int kn = min(kb + 1, nkb - 1);
            xn = __ldg(xrow + kn);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              wn[q] = __ldg(ws + (long long)kn * nn + cb[q]);
          }
          for (; (released + 1) * 4 <= (kb + 1) * SPB; ++released)
            mbar_arrive(empty + 8 * ((c_base + released) % STAGES));
          promote(acc, sc, facc);
        };
        issue(0, acc0);
        int kb = 0;
        for (; kb + 2 < nkb; kb += 2) {   // one set in flight, one landed
          issue(kb + 1, acc1);
          wgmma_wait<1>();
          finish(kb, acc0);
          issue(kb + 2, acc0);
          wgmma_wait<1>();
          finish(kb + 1, acc1);
        }
        if (kb + 1 < nkb) {
          issue(kb + 1, acc1);
          wgmma_wait<1>();
          finish(kb, acc0);
          wgmma_wait<0>();
          finish(kb + 1, acc1);
        } else {
          wgmma_wait<0>();
          finish(kb, acc0);
        }
        for (; released < nst; ++released)
          mbar_arrive(empty + 8 * ((c_base + released) % STAGES));
        c_base += nst;

        // d[4i + e]: row (16 warp + g) + 8 (e / 2), column 8i + 2tig + e % 2
        if (row < M) {
          float* o0 = out + (long long)row * N + n0 + 2 * tig;
          float* o8 = o0 + 8LL * N;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            if (n0 + 8 * i >= N) break;
            *reinterpret_cast<float2*>(o0 + 8 * i) =
                make_float2(facc[4 * i], facc[4 * i + 1]);
            *reinterpret_cast<float2*>(o8 + 8 * i) =
                make_float2(facc[4 * i + 2], facc[4 * i + 3]);
          }
        }
      }
    };
    switch (bk) {
      case 32: consume(Steps<1>()); break;
      case 64: consume(Steps<2>()); break;
      case 96: consume(Steps<3>()); break;
      default: consume(Steps<4>()); break;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

}  // namespace

// xq [M, K] int8, xs [M/bm, K/bk] fp32, wq [K, N] int8, ws [K/bk, N/bn]
// fp32, wt [N, K] int8 scratch (w transposed, written by the kernel), out
// [M, N] fp32, all contiguous, xq, wq and wt 16-byte aligned; bm, bk, bn
// in {32, 64, 96, 128} dividing M, K, N; n_sm the device's SMs.  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for shapes or
// blocks it does not take), or 1000 + the CUresult of a tensor map that
// cuTensorMapEncodeTiled refused.
extern "C" int int8_matmul_s8(const void* xq, const void* xs,
                              const void* wq, const void* ws, void* wt,
                              void* out, int M, int N, int K, int bm, int bk,
                              int bn, int n_sm, void* stream) {
  const int blocks[3] = {bm, bk, bn};
  for (int b : blocks)
    if (b < 32 || b > 128 || b % 32) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K <= 0 || M % bm || N % bn || K % bk ||
      n_sm <= 0 || ((uintptr_t)xq | (uintptr_t)wq | (uintptr_t)wt) % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;

  // x (k, m) and wt (k, n) in 128 x 128 boxes swizzled for wgmma; w as
  // (n, k / 16, k % 16) in 128 x 8 x 16 boxes for phase 1
  CUtensorMap map_x, map_w, map_wt;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M},
                   wt_dims[2] = {(cuuint64_t)K, (cuuint64_t)N},
                   w_dims[3] = {(cuuint64_t)N, (cuuint64_t)(K / 16), 16};
  const cuuint64_t k_stride[1] = {(cuuint64_t)K},
                   w_strides[2] = {16 * (cuuint64_t)N, (cuuint64_t)N};
  const cuuint32_t box[2] = {KST, 128}, w_box[3] = {128, 8, 16};
  const CUresult res[3] = {
      encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(xq),
             x_dims, k_stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE),
      encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(wq),
             w_dims, w_strides, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE),
      encode(&map_wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wt, wt_dims,
             k_stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)};
  for (CUresult r : res)
    if (r != CUDA_SUCCESS) return 1000 + (int)r;

  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // one block an SM at most, all resident at once (phase 1 ends in a
  // grid-wide sync): a cooperative launch
  const int ntiles = ((M + TM - 1) / TM) * ((N + TN - 1) / TN);
  const int grid = ntiles < n_sm ? ntiles : n_sm;
  int8_t* wt8 = (int8_t*)wt;
  const float *xs_f = (const float*)xs, *ws_f = (const float*)ws;
  float* out_f = (float*)out;
  void* args[] = {&map_x, &map_w, &map_wt, &wt8, &xs_f, &ws_f, &out_f,
                  &M, &N, &K, &bm, &bk, &bn};
  err = cudaLaunchCooperativeKernel((const void*)int8_matmul_kernel,
                                    dim3(grid), dim3(THREADS), args,
                                    SMEM_BYTES, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
