"""Model-layout wrappers over the port's kernels.

Each wrapper takes the model's layout (``[B, S, heads, D]`` for
attention, ``[B, S, channels]`` and ``[B, S, heads, hd]`` for the scans).
A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel or raises.  There is no fallback
between the two: the wrapper decides by the device of its input alone.
The reference's padding (head_dim to 128, S to the chunk, both TPU tile
artifacts) is gone: the kernels take the shapes as they are.  Unlike the
reference's scan adapters, both scans take the initial state ``h0``.

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
from repro_torch.kernels.quantized import dequantize, quantize

KERNELS = {
    "flash_attn_fwd": _fa.flash_attention_cuda,
    "int8kv_decode": _q.int8kv_attention_cuda,
    "ssd_scan": _ms.ssd_scan_cuda,
    "mamba1_scan": _ms.mamba1_scan_cuda,
}


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal / windowed GQA attention by index.  q: [B, Sq, H, D];
    k/v: [B, Sk, KV, D].  Returns [B, Sq, H, D] in q.dtype."""
    if _on_card(q):
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)


def flash_attention_int8kv(q, k_q, k_scale, v_q, v_scale, valid):
    """Non-causal attention over an int8 KV cache with a [B, Sk] key
    validity mask (the ring fill state).  q: [B, Sq, H, D] (Sq = 1 on
    the card).  Returns [B, Sq, H, D] in q.dtype."""
    if _on_card(q):
        return _q.int8kv_attention_cuda(q, k_q, k_scale, v_q, v_scale,
                                        valid)
    return _q.int8kv_attention_plain(q, k_q, k_scale, v_q, v_scale, valid)


def mamba1_scan(x, dt, b_s, c_s, A, h0):
    """Mamba1 selective scan from ``h0``.  x/dt: [B, S, di]; b_s/c_s:
    [B, S, ds]; A: [di, ds]; h0: [B, di, ds]; fp32.  Returns (y
    [B, S, di], h_last [B, di, ds]) fp32."""
    if _on_card(x):
        return _ms.mamba1_scan_cuda(x, dt, b_s, c_s, A, h0)
    return _ms.mamba1_scan_plain(x, dt, b_s, c_s, A, h0)


def ssd_scan(xh, dt, b_s, c_s, a, h0, *, chunk: int):
    """Mamba2/SSD scan from ``h0``.  xh: [B, S, nh, hd]; dt: [B, S, nh];
    b_s/c_s: [B, S, ds]; a: [nh]; h0: [B, nh, hd, ds]; fp32.  Returns
    (y [B, S, nh, hd], h_last [B, nh, hd, ds]) fp32."""
    if _on_card(xh):
        return _ms.ssd_scan_cuda(xh, dt, b_s, c_s, a, h0, chunk=chunk)
    return _ms.ssd_scan_plain(xh, dt, b_s, c_s, a, h0)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "dequantize", "flash_attention",
           "flash_attention_int8kv", "launch_counts", "mamba1_scan",
           "quantize", "reset_launch_counts", "ssd_scan"]
