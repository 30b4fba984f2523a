// Mamba1 selective scan for Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py (mamba1_scan /
// _mamba1_kernel), which the reference reaches through
// ops.mamba1_scan_op from models/ssm.mamba1_forward (falcon-mamba).  Per
// channel c and state s it runs the diagonal recurrence
//     h[c, s] <- exp(dt[t, c] * A[c, s]) * h[c, s] + dt[t, c] * x[t, c] * B[t, s]
//     y[t, c]  = sum_s h[c, s] * C[t, s]
// from h0, and returns y and the last h.  The D skip and the silu gate
// stay in PyTorch, as in the reference's adapter.
//
// What bounds it on the H100: each (t, c) element costs ds exps and
// about 3 ds FMAs against 12 bytes of x, dt and y, so at falcon-mamba's
// ds = 16 it sits near 7 flop/byte, far under the fp32 ridge of ~20
// (67 TFLOP/s over 3.35 TB/s): it is bound by bytes, and the bytes are
// x, dt and y (B and C are shared by all channels of a row).
//
// Design:
//  * the TPU kernel walks chunks of time over a sequential grid axis with
//    the [di, ds] state in VMEM; here one thread owns one (batch row,
//    channel) and keeps its ds states and its row of A in registers, and
//    a loop over time inside the thread takes the place of that axis;
//  * x[b, t, c] and dt[b, t, c] are read with the channel as the
//    contiguous axis, so a warp reads 128 contiguous bytes of each per
//    step, and y is written the same way;
//  * B[b, t, :] and C[b, t, :] are the same for every channel of a row:
//    a block stages a tile of TT steps of both in shared memory once and
//    all its threads read them as broadcasts;
//  * the loop is bounded by S itself.  The reference pads S to its chunk
//    with dt = 0 and x = 0, which leaves h unchanged, so stopping at S is
//    exact;
//  * B and C are addressed by strides (they are slices of one
//    projection in the model), with their last axis contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // channels per block
constexpr int TT = 64;    // time steps of B and C staged per tile

template <int DS>
__global__ void __launch_bounds__(NT)
mamba1_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ h0,
                   float* __restrict__ y, float* __restrict__ h_last,
                   int S, int di, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss) {
  __shared__ float bs[TT * DS];
  __shared__ float cs[TT * DS];

  const int b = blockIdx.y;
  const int c = blockIdx.x * NT + threadIdx.x;
  const bool ok = c < di;

  float h[DS], a[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = ok ? h0[((long long)b * di + c) * DS + s] : 0.f;
    a[s] = ok ? A[(long long)c * DS + s] : 0.f;
  }

  const long long row = (long long)b * S * di;
  const float* bb = Bm + b * b_sb;
  const float* cb = Cm + b * c_sb;
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < nt * DS; idx += NT) {
      const int t = idx / DS;
      const int s = idx % DS;
      bs[idx] = bb[(long long)(t0 + t) * b_ss + s];
      cs[idx] = cb[(long long)(t0 + t) * c_ss + s];
    }
    __syncthreads();
    if (ok) {
      for (int t = 0; t < nt; ++t) {
        const long long off = row + (long long)(t0 + t) * di + c;
        const float d = dt[off];
        const float dx = d * x[off];
        const float* bt = bs + t * DS;
        const float* ct = cs + t * DS;
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          h[s] = expf(d * a[s]) * h[s] + dx * bt[s];
          acc = fmaf(h[s], ct[s], acc);
        }
        y[off] = acc;
      }
    }
  }
  if (ok) {
#pragma unroll
    for (int s = 0; s < DS; ++s)
      h_last[((long long)b * di + c) * DS + s] = h[s];
  }
}

}  // namespace

// x, dt, y: [B, S, di] contiguous; Bm, Cm: [B, S, ds] with element
// strides for the batch and time axes (last axis contiguous); A: [di, ds];
// h0, h_last: [B, di, ds] contiguous; all fp32.  ds must be 8 or 16.
// Returns the cudaError_t of the launch.
extern "C" int mamba1_scan_fp32(
    const void* x, const void* dt, const void* Bm, const void* Cm,
    const void* A, const void* h0, void* y, void* h_last,
    int B, int S, int di, int ds,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((di + NT - 1) / NT, B);
  cudaStream_t st = (cudaStream_t)stream;
#define MAMBA1_LAUNCH(DSV)                                                  \
  mamba1_scan_kernel<DSV><<<grid, NT, 0, st>>>(                             \
      (const float*)x, (const float*)dt, (const float*)Bm, (const float*)Cm, \
      (const float*)A, (const float*)h0, (float*)y, (float*)h_last, S, di,   \
      b_sb, b_ss, c_sb, c_ss)
  if (ds == 16)
    MAMBA1_LAUNCH(16);
  else if (ds == 8)
    MAMBA1_LAUNCH(8);
  else
    return (int)cudaErrorInvalidValue;
#undef MAMBA1_LAUNCH
  return (int)cudaGetLastError();
}
