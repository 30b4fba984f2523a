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
// What bounds it on the H100: at zamba2's widths (hd = ds = K = 64) the
// function needs about 2.5 K*hd*ds FMAs per head and chunk (M X, C.h
// and the state update; the C.B scores are shared by all heads) against
// K*hd inputs, K*hd outputs and the hd*ds state in and out, some 20
// flop/byte at a prompt of one chunk: right at the fp32 ridge of ~20
// (67 TFLOP/s without tensor cores over 3.35 TB/s), so the FMA pipes and
// HBM bound it about equally.  This first version reads its operands
// from shared memory for every FMA, forms the C.B scores once per head
// rather than once per row, and multiplies w_j x_j inside the state
// update's ds loop, so shared-memory bandwidth, not the FMA rate, is its
// practical floor; mma.sync in TF32 is later work.
//
// Design:
//  * the TPU grid (batch, heads, chunks) runs chunks on a sequential
//    axis with h in VMEM scratch; here one block per (head, batch row)
//    loops over the chunks itself and keeps h in shared memory;
//  * per chunk it stages x [K, hd], dt [K], B and C [K, ds] in shared
//    memory (rows padded by one float against bank conflicts), forms s
//    with a warp scan, then builds M, y and the new h in three passes in
//    which consecutive threads take consecutive columns;
//  * mask before the exponential: for j > i, s_i - s_j is positive and
//    with zamba2's A (up to -16) a chunk's sum reaches hundreds, so
//    exp overflows to inf, and inf * 0 would be NaN.  M is set to 0
//    there without evaluating exp, as the reference's jnp.where selects;
//  * s is summed and differenced in fp64.  At large dt |A| it reaches
//    thousands within a chunk, where fp32 spacing is ~1e-4, and an fp32
//    cumsum carries that error into every exp(s_i - s_j); in fp64 the
//    exponents stay as exact as the sequential recurrence's dt * a.  It
//    costs 64 fp64 adds a chunk and one fp64 subtraction per exp;
//  * the last partial chunk runs its valid rows only: the reference pads
//    with dt = 0 and x = 0, whose rows add nothing and leave s unchanged;
//  * x [B, S, nh, hd], dt [B, S, nh], B and C [B, S, ds] are read in the
//    model's layout through strides, with no transpose.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int KMAX = 64;   // largest chunk

template <int HD, int DS>
struct Smem {
  double s[KMAX];
  float x[KMAX * HD];
  float b[KMAX * (DS + 1)];
  float c[KMAX * (DS + 1)];
  float m[KMAX * (KMAX + 1)];
  float h[HD * (DS + 1)];
  float dt[KMAX];
  float w[KMAX];
};

template <int HD, int DS>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ a_heads,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int S, int nh, int K,
                long long x_sb, long long x_ss, long long x_sh,
                long long d_sb, long long d_ss, long long d_sh,
                long long b_sb, long long b_ss,
                long long c_sb, long long c_ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD, DS>& sm = *reinterpret_cast<Smem<HD, DS>*>(smem_raw);
  constexpr int BS = DS + 1;   // padded row strides
  constexpr int MS = KMAX + 1;

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = a_heads[hh];
  const long long hbase = ((long long)b * nh + hh) * HD * DS;

  for (int idx = tid; idx < HD * DS; idx += NT)
    sm.h[(idx / DS) * BS + idx % DS] = h0[hbase + idx];

  const float* xb = x + b * x_sb + hh * x_sh;
  const float* db = dt + b * d_sb + hh * d_sh;
  const float* bb = Bm + b * b_sb;
  const float* cb = Cm + b * c_sb;
  float* yb = y + ((long long)b * S * nh + hh) * HD;   // [B, S, nh, HD]

  for (int c0 = 0; c0 < S; c0 += K) {
    const int kc = min(K, S - c0);   // valid rows of this chunk
    __syncthreads();  // the previous chunk's readers of x, b, s are done
    for (int idx = tid; idx < kc * HD; idx += NT) {
      const int i = idx / HD;
      sm.x[idx] = xb[(long long)(c0 + i) * x_ss + idx % HD];
    }
    for (int idx = tid; idx < kc * DS; idx += NT) {
      const int i = idx / DS;
      const int s = idx % DS;
      sm.b[i * BS + s] = bb[(long long)(c0 + i) * b_ss + s];
      sm.c[i * BS + s] = cb[(long long)(c0 + i) * c_ss + s];
    }
    if (tid < kc) sm.dt[tid] = db[(long long)(c0 + tid) * d_ss];
    __syncthreads();

    // s = inclusive cumsum of dt * a over the chunk (fp64): warp 0, two
    // halves
    if (tid < 32) {
      double lo = tid < kc ? (double)(sm.dt[tid] * a) : 0.0;
      double hi = tid + 32 < kc ? (double)(sm.dt[tid + 32] * a) : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double l = __shfl_up_sync(0xffffffffu, lo, off);
        const double r = __shfl_up_sync(0xffffffffu, hi, off);
        if (tid >= off) {
          lo += l;
          hi += r;
        }
      }
      hi += __shfl_sync(0xffffffffu, lo, 31);
      if (tid < kc) sm.s[tid] = lo;
      if (tid + 32 < kc) sm.s[tid + 32] = hi;
    }
    __syncthreads();

    // M[i, j], masked before the exponential
    for (int idx = tid; idx < kc * kc; idx += NT) {
      const int i = idx / kc;
      const int j = idx % kc;
      float v = 0.f;
      if (j <= i) {
        const float* ci = sm.c + i * BS;
        const float* bj = sm.b + j * BS;
        float dot = 0.f;
#pragma unroll 16
        for (int s = 0; s < DS; ++s) dot = fmaf(ci[s], bj[s], dot);
        v = expf((float)(sm.s[i] - sm.s[j])) * sm.dt[j] * dot;
      }
      sm.m[i * MS + j] = v;
    }
    __syncthreads();

    // y_i = sum_{j <= i} M[i, j] x_j + exp(s_i) C_i . h  (h still the
    // carry into this chunk)
    for (int idx = tid; idx < kc * HD; idx += NT) {
      const int i = idx / HD;
      const int d = idx % HD;
      const float* mi = sm.m + i * MS;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(mi[j], sm.x[j * HD + d], intra);
      const float* ci = sm.c + i * BS;
      const float* hd_row = sm.h + d * BS;
      float inter = 0.f;
#pragma unroll 16
      for (int s = 0; s < DS; ++s) inter = fmaf(ci[s], hd_row[s], inter);
      yb[(long long)(c0 + i) * nh * HD + d] =
          intra + expf((float)sm.s[i]) * inter;
    }
    const double s_last = sm.s[kc - 1];
    if (tid < kc) sm.w[tid] = expf((float)(s_last - sm.s[tid])) * sm.dt[tid];
    __syncthreads();   // y has read h; w is ready

    // h <- exp(s_last) h + sum_j w_j x_j (x) B_j
    const float decay = expf((float)s_last);
    for (int idx = tid; idx < HD * DS; idx += NT) {
      const int d = idx / DS;
      const int s = idx % DS;
      float acc = 0.f;
      for (int j = 0; j < kc; ++j)
        acc = fmaf(sm.w[j] * sm.x[j * HD + d], sm.b[j * BS + s], acc);
      sm.h[d * BS + s] = decay * sm.h[d * BS + s] + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < HD * DS; idx += NT)
    h_last[hbase + idx] = sm.h[(idx / DS) * BS + idx % DS];
}

template <int HD, int DS>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           const void* a, const void* h0, void* y, void* h_last, int B,
           int S, int nh, int K, long long x_sb, long long x_ss,
           long long x_sh, long long d_sb, long long d_ss, long long d_sh,
           long long b_sb, long long b_ss, long long c_sb, long long c_ss,
           cudaStream_t stream) {
  const int bytes = (int)sizeof(Smem<HD, DS>);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<HD, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nh, B);
  ssd_scan_kernel<HD, DS><<<grid, NT, bytes, stream>>>(
      (const float*)x, (const float*)dt, (const float*)Bm, (const float*)Cm,
      (const float*)a, (const float*)h0, (float*)y, (float*)h_last, S, nh,
      K, x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, S, nh, hd] with element strides for batch, time and head (last
// axis contiguous); dt: [B, S, nh] with strides; Bm, Cm: [B, S, ds] with
// batch and time strides (last axis contiguous); a: [nh]; h0, h_last:
// [B, nh, hd, ds] contiguous; y: [B, S, nh, hd] contiguous; all fp32.
// (hd, ds) must be zamba2's (64, 64); 1 <= K <= 64.  Returns the
// cudaError_t of the launch.
extern "C" int ssd_scan_fp32(
    const void* x, const void* dt, const void* Bm, const void* Cm,
    const void* a, const void* h0, void* y, void* h_last,
    int B, int S, int nh, int hd, int ds, int K,
    long long x_sb, long long x_ss, long long x_sh,
    long long d_sb, long long d_ss, long long d_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || K < 1 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64 && ds == 64)
    return launch<64, 64>(x, dt, Bm, Cm, a, h0, y, h_last, B, S, nh, K,
                          x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss,
                          c_sb, c_ss, st);
  return (int)cudaErrorInvalidValue;
}
