"""Model-layout wrappers over the port's kernels.

Each wrapper takes the model's layout (``[B, S, heads, D]`` for
attention, ``[B, S, channels]`` and ``[B, S, heads, hd]`` for the scans,
plain ``[M, K] x [K, N]`` for the int8 matmul, ``[..., d]`` for the
RMSNorm).
A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel or raises; a meta tensor (the
dry run's, ``launch/dryrun.py``) takes the kernel's shape rule: the
CUDA function's checks and the tensors it allocates (outputs, what the
training forward saves, scratch at the H100's launch plan), and no
launch, so that the dry run prices what the card runs and not the plain
version.  There is no fallback between the three: the wrapper decides by
the device of its input alone, and a meta tensor computes nothing, so no
real run reaches a shape rule.
The reference's padding (head_dim to 128, S to the chunk, both TPU tile
artifacts) is gone: the kernels take the shapes as they are.  Unlike the
reference's scan adapters, both scans take the initial state ``h0``.

Attention that needs a gradient goes through ``FlashAttention``, the
autograd Function over kernel A's forward (with its logsumexp) and its
backward kernel, which counts its own launches; without a gradient
(serving, ``torch.no_grad``) the forward kernel runs alone and writes no
logsumexp.

Only kernel A has a backward kernel.  On a CUDA tensor every other
wrapper (kernels B, 3, 4, 5 and 6) refuses to run when a gradient is
being taken of any of its inputs: its output is a fresh tensor with no
``grad_fn``, so autograd would treat it as a constant and quietly give
every parameter before it no gradient through it.  The error names the
ROADMAP item that brings the backward.  On the CPU the plain versions
stay differentiable by autograd.

``launch_counts`` reads how often each kernel was launched, and
``reset_launch_counts`` sets the counts to 0, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import quantized as _q
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels.quantized import dequantize, quantize

KERNELS = {
    "flash_attn_fwd": _fa.flash_attention_cuda,
    "flash_attn_bwd": _fa.flash_attention_bwd_cuda,
    "int8kv_decode": _q.int8kv_attention_cuda,
    "ssd_scan": _ms.ssd_scan_cuda,
    "mamba1_scan": _ms.mamba1_scan_cuda,
    "int8_matmul": _q.int8_matmul_cuda,
    "rmsnorm": _rn.rmsnorm_cuda,
}


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernel: True on the card (and on the meta
    device, where the kernel's function allocates and launches nothing),
    False on the CPU (the plain version)."""
    if x.device.type in ("cuda", "meta"):
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _refuse_grad(name: str, *tensors) -> None:
    """On the card (and on meta): raise when a gradient is being taken of
    any input of a kernel that has no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and its output would "
            f"carry no gradient to its inputs; run it under torch.no_grad(),"
            f" or take the plain path (use_kernels=False) to train through "
            f"it until the backward kernel lands ({_fa.NO_BACKWARD_AT})")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal / windowed GQA attention by index.  q: [B, Sq, H, Dk];
    k: [B, Sk, KV, Dk]; v: [B, Sk, KV, Dv] (Dv = Dk but for MLA's split
    head dims); scores scaled by 1/sqrt(Dk).  Returns [B, Sq, H, Dv] in
    q.dtype, differentiable through kernel A's backward where it is built
    (head dims 64 and 80; elsewhere the card refuses a gradient)."""
    on_card = _on_card(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _fa.FlashAttention.apply(q, k, v, causal, window)
    if on_card:
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)


def flash_attention_int8kv(q, k_q, k_scale, v_q, v_scale, valid, *,
                           with_lse: bool = False):
    """Non-causal attention over an int8 KV cache with a [B, Sk] key
    validity mask (the ring fill state).  q: [B, Sq, H, D] (Sq = 1 on
    the card).  Returns [B, Sq, H, D] in q.dtype; ``with_lse`` (Sq = 1)
    also the fp32 [B, H] log-sum-exp of each (row, head)'s live scores,
    -inf for a row with none."""
    if _on_card(q):
        _refuse_grad("flash_attention_int8kv", q, k_q, k_scale, v_q, v_scale)
        return _q.int8kv_attention_cuda(q, k_q, k_scale, v_q, v_scale,
                                        valid, with_lse=with_lse)
    return _q.int8kv_attention_plain(q, k_q, k_scale, v_q, v_scale, valid,
                                     with_lse=with_lse)


def mamba1_scan(x, dt, b_s, c_s, A, h0):
    """Mamba1 selective scan from ``h0``.  x/dt: [B, S, di]; b_s/c_s:
    [B, S, ds]; A: [di, ds]; h0: [B, di, ds]; fp32.  Returns (y
    [B, S, di], h_last [B, di, ds]) fp32."""
    if _on_card(x):
        _refuse_grad("mamba1_scan", x, dt, b_s, c_s, A, h0)
        return _ms.mamba1_scan_cuda(x, dt, b_s, c_s, A, h0)
    return _ms.mamba1_scan_plain(x, dt, b_s, c_s, A, h0)


def ssd_scan(xh, dt, b_s, c_s, a, h0, *, chunk: int):
    """Mamba2/SSD scan from ``h0``.  xh: [B, S, nh, hd]; dt: [B, S, nh];
    b_s/c_s: [B, S, ds]; a: [nh]; h0: [B, nh, hd, ds]; fp32.  Returns
    (y [B, S, nh, hd], h_last [B, nh, hd, ds]) fp32."""
    if _on_card(xh):
        _refuse_grad("ssd_scan", xh, dt, b_s, c_s, a, h0)
        return _ms.ssd_scan_cuda(xh, dt, b_s, c_s, a, h0, chunk=chunk)
    return _ms.ssd_scan_plain(xh, dt, b_s, c_s, a, h0)


def _pad_axis(x, mult: int, axis: int):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis % x.dim()) + 1] = pad
    return torch.nn.functional.pad(x, widths)


def int8_operands(x, w, *, block_m: int, block_k: int, block_n: int):
    """Pad fp x [M, K] and w [K, N] to block multiples (zero pads quantize
    to 0 with scale 1.0 and add nothing) and quantize each per tile.
    Returns (xq, xs, wq, ws), the operands of kernel 5."""
    _q.check_blocks(block_m, block_k, block_n)
    xp = _pad_axis(_pad_axis(x, block_m, 0), block_k, 1)
    wp = _pad_axis(_pad_axis(w, block_k, 0), block_n, 1)
    return (*_q.quantize_blocks(xp, block_m, block_k),
            *_q.quantize_blocks(wp, block_k, block_n))


def int8_matmul(x, w, *, block_m: int = 128, block_k: int = 128,
                block_n: int = 128):
    """Quantize fp x [M, K] and w [K, N] into per-tile int8 and multiply
    (int32 partials per K block, dequantized into fp32), then unpad.
    Returns fp32 [M, N]."""
    M, N = x.shape[0], w.shape[1]
    blocks = dict(block_m=block_m, block_k=block_k, block_n=block_n)
    on_card = _on_card(x)
    if on_card:
        _refuse_grad("int8_matmul", x, w)
    xq, xs, wq, ws = int8_operands(x, w, **blocks)
    if on_card:
        out = _q.int8_matmul_cuda(xq, xs, wq, ws, **blocks)
    else:
        out = _q.int8_matmul_plain(xq, xs, wq, ws, **blocks)
    return out[:M, :N]


def rmsnorm(x, weight, *, eps: float = 1e-5):
    """Row RMSNorm over the last axis: fp32 mean of squares, rsqrt, times
    the fp32 weight [d], in x's dtype.  Kernel 6 on a CUDA tensor."""
    if _on_card(x):
        _refuse_grad("rmsnorm", x, weight)
        return _rn.rmsnorm_cuda(x, weight, eps=eps)
    return _rn.rmsnorm_plain(x, weight, eps)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "dequantize", "flash_attention",
           "flash_attention_int8kv", "int8_matmul", "launch_counts",
           "mamba1_scan", "quantize", "reset_launch_counts", "rmsnorm",
           "ssd_scan"]
