"""Kernels 3 and 4: the Mamba2/SSD chunked scan and the Mamba1 selective
scan (prefill and full-sequence forward of the SSM and hybrid families).

Replace the TPU kernels of ``src/repro/kernels/mamba_scan.py``:
``ssd_scan`` (``pallas_call`` at line 84) and ``mamba1_scan`` (line 153).
Two versions of each function, in the model's layout, both starting
from a given state ``h0`` (the reference's adapters assume zero, so a
prefill continuing from a filled state had no kernel there):

  * ``ssd_scan_plain`` / ``mamba1_scan_plain`` — PyTorch: the sequential
    per-token recurrences of ``kernels/ref.py``, which never form
    ``exp`` of a positive sum.  The CPU runs them, and ``chip_smoke.py``
    holds the kernels against them on the card.
  * ``ssd_scan_cuda`` / ``mamba1_scan_cuda`` — the CUDA C++ kernels in
    ``csrc/ssd_scan.cu`` (the chunk's four products on the tensor cores
    in 3xTF32, the state in registers, the head-independent scores
    C B^T once per batch row and chunk) and ``csrc/mamba1_scan.cu``
    (several lanes a channel, x and dt staged with cp.async, one ex2 an
    exponential), fp32 in and out.  ``mamba1_plan`` picks kernel 4's
    lanes a channel so that batch 1 fills the card, ``ssd_plan`` kernel
    3's stages of staged chunks.  The sources say what bounds them on
    the H100 and how their designs answer that.

Neither kernel has a backward: ``ops.ssd_scan`` and ``ops.mamba1_scan``
refuse a gradient on the card (ROADMAP queue 2, item 7).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

MAMBA1_STATES = (8, 16)              # d_state: reduced, falcon-mamba
SSD_SHAPES = ((64, 64),)             # (head_dim, d_state): zamba2
SSD_MAX_CHUNK = 64

# kernel 4's lanes a channel (csrc/mamba1_scan.cu): each of a channel's
# lanes owns d_state / lanes states; a block of 128 threads takes 128 /
# lanes channels and stages 16 * lanes steps at a time.  The planner takes
# the fewer lanes unless that leaves the grid under MAMBA1_WARPS_PER_SM
# warps an SM: on an H100, falcon-mamba's Engine prefill (8 x 64) ran in
# 0.0414 ms at 2 lanes, 0.0498 at 4 and 0.0531 at one lane a channel; at
# batch 1 and S = 256 in 0.0290 ms at 4 lanes, 0.0377 at 2 and 0.0527 at
# 8, which no served width would pick (it would take B * di < 6336)
MAMBA1_LANES = (2, 4)
MAMBA1_WARPS_PER_SM = 6


def mamba1_plan(B: int, di: int, ds: int, n_sm: int) -> int:
    """Kernel 4's lanes a channel for B rows of di channels of ds states
    on a card of n_sm SMs: 2, or 4 where 2 would leave the grid under
    ``MAMBA1_WARPS_PER_SM`` warps an SM."""
    if not (B > 0 and di > 0 and ds in MAMBA1_STATES and n_sm > 0):
        raise ValueError(f"mamba1_plan: B={B}, di={di}, ds={ds}, "
                         f"n_sm={n_sm}")
    lo, hi = MAMBA1_LANES
    return lo if B * di * lo >= 32 * MAMBA1_WARPS_PER_SM * n_sm else hi


def ssd_plan(B: int, nh: int, n_sm: int, n_chunks: int) -> int:
    """Kernel 3's stages for B rows of nh heads (a block a head) over
    ``n_chunks`` chunks on a card of n_sm SMs: 2, chunk c+1 staged while
    chunk c computes, where there is a next chunk and the grid fits in one
    block an SM (two stages take ~140 KB of shared memory, one ~70 KB,
    which fits two blocks an SM); else 1."""
    if not (B > 0 and nh > 0 and n_sm > 0 and n_chunks > 0):
        raise ValueError(f"ssd_plan: B={B}, nh={nh}, n_sm={n_sm}, "
                         f"n_chunks={n_chunks}")
    return 2 if n_chunks > 1 and B * nh <= n_sm else 1


def mamba1_scan_plain(x, dt, b_s, c_s, A, h0):
    """x/dt: [B, S, di]; b_s/c_s: [B, S, ds]; A: [di, ds]; h0:
    [B, di, ds].  Returns (y [B, S, di] fp32, h_last [B, di, ds] fp32)."""
    return ref.mamba1_ref(x, dt, b_s, c_s, A.float(), h0)


def ssd_scan_plain(xh, dt, b_s, c_s, a, h0):
    """xh: [B, S, nh, hd]; dt: [B, S, nh]; b_s/c_s: [B, S, ds]; a: [nh];
    h0: [B, nh, hd, ds].  Returns (y [B, S, nh, hd] fp32, h_last
    [B, nh, hd, ds] fp32)."""
    y, h = ref.ssd_ref(xh.transpose(1, 2), dt.transpose(1, 2), b_s, c_s,
                       a.float(), h0)
    return y.transpose(1, 2), h


def _fn(stem: str, name: str, argtypes):
    fn = getattr(_build.library(stem), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check(name: str, t: torch.Tensor, shape, *, contiguous: bool = True):
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} must be a CUDA tensor (or meta), got "
                         f"{t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last axis, got strides "
                         f"{t.stride()}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Rows of ``t`` (an fp32 view with a contiguous last axis) all start
    on 16-byte boundaries."""
    return t.data_ptr() % 16 == 0 and all(st % 4 == 0
                                          for st in t.stride()[:-1])


def mamba1_scan_cuda(x, dt, b_s, c_s, A, h0):
    """Launch kernel 4.  x/dt: [B, S, di] and A: [di, ds] contiguous
    (x and dt are copied first unless they start on 16-byte boundaries);
    b_s/c_s: [B, S, ds] with a contiguous last axis; h0: [B, di, ds]
    contiguous; all fp32 CUDA tensors, di a multiple of 4 and ds in
    ``MAMBA1_STATES``.  Returns (y [B, S, di], h_last [B, di, ds]) fp32.
    On meta tensors (the dry run's) it allocates what it would and
    launches nothing (a meta tensor has no address: no copy for one)."""
    B, S, di = x.shape
    ds = b_s.shape[-1]
    if ds not in MAMBA1_STATES:
        raise ValueError(f"mamba1_scan_cuda takes d_state in "
                         f"{MAMBA1_STATES}, got {ds}")
    if di % 4:
        raise ValueError(f"mamba1_scan_cuda takes d_inner in multiples of "
                         f"4 (rows of 16 bytes), got {di}")
    for name, t, shape, contig in (
            ("x", x, (B, S, di), True), ("dt", dt, (B, S, di), True),
            ("b_s", b_s, (B, S, ds), False), ("c_s", c_s, (B, S, ds), False),
            ("A", A, (di, ds), True), ("h0", h0, (B, di, ds), True)):
        _check(name, t, shape, contiguous=contig)
    # the kernel moves x, dt and y in 16-byte copies
    x, dt = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dt))
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    lanes = mamba1_plan(B, di, ds, _build.sm_count(x.device))
    if x.is_meta:
        return y, h_last
    fn = _fn("mamba1_scan", "mamba1_scan_fp32",
             [_P] * 8 + [_I] * 5 + [_L] * 4 + [_P])
    err = fn(x.data_ptr(), dt.data_ptr(), b_s.data_ptr(), c_s.data_ptr(),
             A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
             B, S, di, ds, lanes, b_s.stride(0), b_s.stride(1),
             c_s.stride(0), c_s.stride(1),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mamba1_scan_fp32")
    mamba1_scan_cuda.launches += 1
    return y, h_last


mamba1_scan_cuda.launches = 0


def ssd_scan_cuda(xh, dt, b_s, c_s, a, h0, *, chunk: int):
    """Launch kernel 3 (its scores kernel, then the scan).  xh: [B, S,
    nh, hd], dt: [B, S, nh] and b_s/c_s: [B, S, ds], read through their
    strides (last axis contiguous; xh, b_s and c_s are copied first
    unless their rows start on 16-byte boundaries); a:
    [nh]; h0: [B, nh, hd, ds] contiguous; all fp32 CUDA tensors, (hd, ds)
    in ``SSD_SHAPES`` and 1 <= chunk <= 64.  Returns (y [B, S, nh, hd],
    h_last [B, nh, hd, ds]) fp32.  On meta tensors (the dry run's) it
    allocates what it would and launches nothing (a meta tensor has no
    address: its rows count as aligned when its strides are)."""
    B, S, nh, hd = xh.shape
    ds = b_s.shape[-1]
    if (hd, ds) not in SSD_SHAPES:
        raise ValueError(f"ssd_scan_cuda takes (head_dim, d_state) in "
                         f"{SSD_SHAPES}, got {(hd, ds)}")
    if not 1 <= chunk <= SSD_MAX_CHUNK:
        raise ValueError(f"ssd_scan_cuda takes a chunk in [1, "
                         f"{SSD_MAX_CHUNK}], got {chunk}")
    for name, t, shape, contig in (
            ("xh", xh, (B, S, nh, hd), False), ("b_s", b_s, (B, S, ds), False),
            ("c_s", c_s, (B, S, ds), False), ("a", a, (nh,), True),
            ("h0", h0, (B, nh, hd, ds), True)):
        _check(name, t, shape, contiguous=contig)
    if dt.device.type not in ("cuda", "meta") or dt.dtype != torch.float32 \
            or tuple(dt.shape) != (B, S, nh):
        raise ValueError(f"dt must be a float32 CUDA tensor (or meta) of "
                         f"shape {(B, S, nh)}, got {dt.dtype} "
                         f"{tuple(dt.shape)}")
    if h0.data_ptr() % 16:
        raise ValueError("h0 must start on a 16-byte boundary")
    # the kernel moves rows of x, B and C as 16-byte bulk copies: a view
    # off those boundaries is copied first
    xh, b_s, c_s = (t if _rows_aligned(t) else
                    t.clone(memory_format=torch.contiguous_format)
                    for t in (xh, b_s, c_s))
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=xh.device)
    h_last = torch.empty_like(h0)
    n_chunks = -(-S // chunk)
    # the scores C B^T of each (batch row, chunk), shared by the heads
    scores = torch.empty((B, n_chunks, SSD_MAX_CHUNK, SSD_MAX_CHUNK),
                         dtype=torch.float32, device=xh.device)
    stages = ssd_plan(B, nh, _build.sm_count(xh.device), n_chunks)
    if xh.is_meta:
        return y, h_last
    fn = _fn("ssd_scan", "ssd_scan_fp32",
             [_P] * 9 + [_I] * 7 + [_L] * 10 + [_P])
    err = fn(xh.data_ptr(), dt.data_ptr(), b_s.data_ptr(), c_s.data_ptr(),
             a.data_ptr(), h0.data_ptr(), scores.data_ptr(), y.data_ptr(),
             h_last.data_ptr(), B, S, nh, hd, ds, chunk, stages,
             *xh.stride()[:3], *dt.stride(),
             *b_s.stride()[:2], *c_s.stride()[:2],
             torch.cuda.current_stream(xh.device).cuda_stream)
    _build.check(err, "ssd_scan_fp32")
    ssd_scan_cuda.launches += 1
    return y, h_last


ssd_scan_cuda.launches = 0
