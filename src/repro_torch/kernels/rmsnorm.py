"""Kernel 6: the fused row RMSNorm.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py`` (``rmsnorm``,
``pallas_call`` at line 44), which computes the same function as the
jnp ``models/layers.py::rmsnorm`` that the reference's models run.  Two
versions of one function over ``[..., d]``:

  * ``rmsnorm_plain`` — PyTorch: fp32 mean of squares, ``rsqrt``, times
    the fp32 weight, cast to x's dtype.  It is the port's
    ``models/layers.rmsnorm``; the CPU runs it, and ``chip_smoke.py``
    holds the kernel against it on the card.
  * ``rmsnorm_cuda`` — the CUDA C++ kernel in ``csrc/rmsnorm.cu`` (the
    row in registers, x and w loaded together; a CTA per row on a grid
    sized to the SMs; x bf16 or fp32, weight fp32; rows of up to
    ``MAX_D`` = 32768, so llama3-405b's 16384 too).
    ``rmsnorm_plan`` picks the launch shape.  The source
    says what bounds it (bytes) and how its design answers that.

The kernel has no backward: ``ops.rmsnorm`` refuses a gradient on the
card (ROADMAP queue 2, item 7).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# the launch shape (EPT, MAX_K and MAX_THREADS in csrc/rmsnorm.cu): a row
# takes one thread per K * EPT elements (K = 1: one bf16 vector, two fp32
# ones), held in registers, so that each thread's chain of loads and
# stores is short; a CTA, one row at a time, has at most MAX_THREADS
# threads, and K, the least of 1, 2, 4 that lets them hold the row, is 1
# for every d <= EPT * MAX_THREADS
EPT, MAX_K, MAX_THREADS = 8, 4, 1024
MAX_D = EPT * MAX_K * MAX_THREADS
# the grid holds this many threads an SM; its CTAs walk the rows
ROWS_THREADS_PER_SM = 2048


class RmsPlan(NamedTuple):
    threads: int     # threads a CTA, a multiple of 32
    grid: int        # CTAs that walk the rows


def rmsnorm_groups(d: int) -> int:
    """K: the EPT groups of a row that a thread holds, the least of 1, 2
    and 4 for which ``MAX_THREADS`` threads hold ``d``."""
    k = 1
    while EPT * k * MAX_THREADS < d:
        k *= 2
    return k


def rmsnorm_plan(rows: int, d: int, n_sm: int) -> RmsPlan:
    """Kernel 6's launch shape for ``rows`` rows of ``d`` on a card of
    ``n_sm`` SMs: one CTA per row at a time, thread t taking the row's
    vectors t, t + threads, ... (at most ``rmsnorm_groups(d) * EPT``
    elements)."""
    if not (rows > 0 and 0 < d <= MAX_D and n_sm > 0):
        raise ValueError(f"rmsnorm_plan: rows={rows}, d={d}, n_sm={n_sm} "
                         f"(need rows, n_sm > 0 and 0 < d <= {MAX_D})")
    threads = 32 * -(-d // (32 * EPT * rmsnorm_groups(d)))
    per_sm = max(1, ROWS_THREADS_PER_SM // threads)
    return RmsPlan(threads, min(rows, n_sm * per_sm))


def rmsnorm_plain(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _lib():
    lib = _build.library("rmsnorm")
    fn = lib.rmsnorm_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, I, I, L, L, ctypes.c_float, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def rmsnorm_cuda(x, weight, *, eps: float = 1e-5):
    """Launch kernel 6.  x: [..., d] bf16 or fp32 CUDA tensor whose
    leading axes flatten to rows with one stride and whose last axis is
    contiguous; weight: [d] fp32, contiguous, on the same card.  Returns
    y with x's shape and dtype, contiguous.  On meta tensors (the dry
    run's) it allocates what it would and launches nothing."""
    if x.device.type not in ("cuda", "meta") or weight.device != x.device:
        raise ValueError(f"x and weight must be CUDA tensors on one card "
                         f"(or meta tensors), got {x.device} and "
                         f"{weight.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    d = x.shape[-1]
    if weight.dtype != torch.float32 or tuple(weight.shape) != (d,) \
            or not weight.is_contiguous():
        raise ValueError(f"weight must be a contiguous fp32 [{d}], got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    if not 0 < d <= MAX_D or x.stride(-1) != 1:
        raise ValueError(f"x must have 0 < d <= {MAX_D} and a contiguous "
                         f"last axis, got {tuple(x.shape)} {x.stride()}")
    rows = x.numel() // d
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    try:
        x2 = x.view(rows, d)       # one row stride, no copy
    except RuntimeError:
        raise ValueError(f"x's leading axes do not flatten to rows of one "
                         f"stride: {tuple(x.shape)} {x.stride()}") from None
    plan = rmsnorm_plan(rows, d, _build.sm_count(x.device))
    if x.is_meta:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x2.data_ptr(), weight.data_ptr(), y.data_ptr(), rows, d,
                 x2.stride(0), d, float(eps),
                 int(x.dtype == torch.bfloat16), *plan, stream)
    _build.check(err, "rmsnorm_fwd")
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0
