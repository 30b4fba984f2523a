// Tensor-core building blocks shared by kernel A's forward
// (flash_attn_fwd.cu) and backward (flash_attn_bwd.cu): 16-byte
// cp.async tile copies, ldmatrix fragment loads and the bf16
// mma.sync.m16n8k16 with fp32 accumulators, for sm_80 and later.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same);
//   B (16 x 8, col):  b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9);
//   C (16 x 8, fp32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// C's tiles j and j+1 of one 16-column chunk hold, packed to bf16, that
// chunk as an A fragment of the next product (a0 = c0 c1 of tile j,
// a1 = c2 c3 of j, a2 = c0 c1 of j+1, a3 = c2 c3 of j+1), so scores and
// their gradients feed the next mma from registers.
//
// Tiles live in shared memory as rows of HD bf16 padded by 8 (16 bytes):
// the row strides 144, 176, 208, 272 and 400 bytes (HD = 64, 80, 96, 128,
// 192) put the 8 rows an ldmatrix phase reads on 8 distinct groups of 4
// banks.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, whose fragment lands in r[i]
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed: the B fragment of a row-major
// [k][n] tile
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// C tiles 2c and 2c+1 as the A fragment of 16-column chunk c
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&x)[4],
                                       const float (&y)[4]) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(y[0], y[1]);
  a[3] = pack_bf16(y[2], y[3]);
}

// The same as a hi + lo pair of A fragments, hi = bf16(x) and lo =
// bf16(x - hi): two products against one B keep ~16 bits of x, where
// one keeps 8.
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&x)[4],
                                             const float (&y)[4]) {
  const float v[8] = {x[0], x[1], x[2], x[3], y[0], y[1], y[2], y[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<uint32_t*>(&h);
    lo[i] = pack_bf16(v[2 * i] - hf.x, v[2 * i + 1] - hf.y);
  }
}

// Copy rows [r0, r0 + ROWS) of a [rows, HD] bf16 operand (row stride ss
// elements, last axis contiguous) into a padded shared tile, 16 bytes a
// thread per step; rows at or past n_rows are zero-filled.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int n_rows,
                                          int tid) {
  constexpr int CPR = HD / 8;              // 16-byte chunks a row
  constexpr int LD = HD + 8;
  static_assert((ROWS * CPR) % NT == 0, "tile chunks split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + r * LD + col,
               src + (long long)(ok ? r0 + r : 0) * ss + col, ok);
  }
}

// A warp's 16 x HD fp32 accumulator tile (acc[n-tile][c]), times mul, as
// bf16 into rows [row0, row0 + 16) of a [rows, HD] operand (row stride ss,
// rows at or past n_rows skipped): staged in the warp's own 16 rows of a
// padded shared tile, then written 16 bytes a lane.
template <int HD>
__device__ __forceinline__ void store_rows16(bf16* stage,
                                             const float (&acc)[HD / 8][4],
                                             float mul_lo, float mul_hi,
                                             bf16* dst, long long ss,
                                             int row0, int n_rows, int lane) {
  constexpr int CPR = HD / 8;
  constexpr int LD = HD + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * dn + 2 * t) =
        pack_bf16(acc[dn][0] * mul_lo, acc[dn][1] * mul_lo);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * dn + 2 * t) =
        pack_bf16(acc[dn][2] * mul_hi, acc[dn][3] * mul_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < (16 * CPR + 31) / 32; ++i) {
    const int c = lane + 32 * i;
    if (c >= 16 * CPR) break;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * ss + col) =
          *reinterpret_cast<const uint4*>(stage + r * LD + col);
  }
}

// Row qp may see key kp: inside both sequences and, under causal, at or
// before the row and within the sliding window.
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk,
                                        int causal, int window) {
  if (qp >= Sq || kp >= Sk) return false;
  if (!causal) return true;
  return kp <= qp && (window <= 0 || qp - kp < window);
}

}  // namespace
