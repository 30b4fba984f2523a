"""Int8 KV: absmax quantization and kernel B, one-token attention over
an int8 KV cache (serving decode).

``quantize`` / ``dequantize`` port ``repro.kernels.ops.quantize`` /
``dequantize`` exactly (jnp code in the reference, not Pallas):
``scale = absmax / 127`` per block, all-zero blocks take scale 1.0,
``q = clip(round(x / scale), -127, 127)`` with half-to-even rounding.

Kernel B replaces the TPU kernel ``src/repro/kernels/quantized.py``
(``flash_attention_int8kv_bhsd``, ``pallas_call`` at line 168).  Two
versions of one function, in the model's layout:

  * ``int8kv_attention_plain`` — PyTorch: dequantize K/V by their
    per-(token, kv-head) fp32 scales, mask keys whose ``valid`` entry is
    not set with ``NEG_INF`` = -1e30, fp32 softmax (non-causal, as the
    reference's decode calls it).  The CPU runs it, and
    ``chip_smoke.py`` holds the kernel against it on the card.
  * ``int8kv_attention_cuda`` — the CUDA C++ kernel in
    ``csrc/int8kv_attn.cu``, built for one query row (Sq = 1), bf16 q,
    head_dim 64.  The source says what bounds it (bytes) and how its
    design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIM = 64


def quantize(x, *, block: int = 128, axis: int = -1):
    """Symmetric per-block absmax int8 quantization along ``axis``.
    Returns (q int8 of x.shape, scale fp32 with ``axis`` shrunk to
    ceil(n / block))."""
    axis = axis % x.dim()
    n = x.shape[axis]
    xm = torch.movedim(x, axis, -1).float()
    pad = (-n) % block
    if pad:
        xm = torch.nn.functional.pad(xm, (0, pad))
    nb = xm.shape[-1] // block
    t = xm.reshape(*xm.shape[:-1], nb, block)
    absmax = t.abs().amax(dim=-1)
    # XLA folds the reference's absmax / 127 into a product with the
    # fp32 reciprocal; the same product keeps the scales bit-equal
    scale = torch.where(absmax > 0, absmax * (1.0 / 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(t / scale[..., None]), -127, 127)
    q = q.to(torch.int8).reshape(xm.shape)[..., :n]
    return torch.movedim(q, -1, axis), torch.movedim(scale, -1, axis)


def dequantize(q, scale, *, block: int = 128, axis: int = -1):
    """Inverse of ``quantize``: q int8 * per-block scale -> fp32."""
    axis = axis % q.dim()
    n = q.shape[axis]
    qm = torch.movedim(q, axis, -1).float()
    sm = torch.repeat_interleave(torch.movedim(scale, axis, -1), block,
                                 dim=-1)[..., :n]
    return torch.movedim(qm * sm, -1, axis)


def int8kv_attention_plain(q, k_q, k_scale, v_q, v_scale, valid):
    """q: [B, Sq, H, Dk] fp; k_q/v_q: [B, Sk, KV, D*] int8; k_scale/
    v_scale: [B, Sk, KV] fp32; valid: [B, Sk] (nonzero = key live).
    Non-causal.  Returns [B, Sq, H, Dv] in q.dtype."""
    B, Sq, H, Dk = q.shape
    KV = k_q.shape[2]
    group = H // KV
    k = k_q.float() * k_scale[..., None]
    v = v_q.float() * v_scale[..., None]
    qf = (q.float() * (1.0 / (Dk ** 0.5))).reshape(B, Sq, KV, group, Dk)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, k)
    s = s.masked_fill(~valid.bool()[:, None, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bqkgd", w, v)
    return o.reshape(B, Sq, H, -1).to(q.dtype)


def _lib():
    lib = _build.library("int8kv_attn")
    fn = lib.int8kv_decode_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 7 + [I] * 4 + [L] * 4 + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def int8kv_attention_cuda(q, k_q, k_scale, v_q, v_scale, valid):
    """Launch kernel B.  q: [B, 1, H, 64] bf16; k_q/v_q: [B, Sk, KV, 64]
    int8, k_scale/v_scale: [B, Sk, KV] fp32 and valid: [B, Sk] bool, all
    contiguous CUDA tensors.  Returns [B, 1, H, 64] bf16."""
    tensors = (("q", q), ("k_q", k_q), ("k_scale", k_scale), ("v_q", v_q),
               ("v_scale", v_scale), ("valid", valid))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if q.dtype != torch.bfloat16 or q.dim() != 4 or q.shape[1] != 1 \
            or q.shape[-1] != HEAD_DIM or q.stride(-1) != 1 \
            or q.stride(0) % 2 or q.stride(2) % 2:
        raise ValueError(f"q must be bf16 [B, 1, H, {HEAD_DIM}] with a "
                         f"contiguous, even-aligned last axis; got "
                         f"{q.dtype} {tuple(q.shape)} {q.stride()}")
    B, _, H, _ = q.shape
    Sk, KV = k_q.shape[1], k_q.shape[2]
    want = {"k_q": ((B, Sk, KV, HEAD_DIM), torch.int8),
            "v_q": ((B, Sk, KV, HEAD_DIM), torch.int8),
            "k_scale": ((B, Sk, KV), torch.float32),
            "v_scale": ((B, Sk, KV), torch.float32),
            "valid": ((B, Sk), torch.bool)}
    for name, t in tensors[1:]:
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if H % KV or k_q.data_ptr() % 16 or v_q.data_ptr() % 2:
        raise ValueError("H must be a multiple of KV and the int8 caches "
                         "16-byte aligned")
    o = torch.empty((B, 1, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
                 v_q.data_ptr(), v_scale.data_ptr(), valid.data_ptr(),
                 o.data_ptr(), B, H, KV, Sk, q.stride(0), q.stride(2),
                 o.stride(0), o.stride(2), 1.0 / (HEAD_DIM ** 0.5), stream)
    _build.check(err, "int8kv_decode_bf16")
    int8kv_attention_cuda.launches += 1
    return o


int8kv_attention_cuda.launches = 0
