"""Kernel A: causal GQA flash attention forward (prefill).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_bhsd``, ``pallas_call`` at line 102), whose jnp
rendering ``repro.models.attention.chunked_attention`` is what the
reference's prefill runs.  Two versions of one function, in the model's
``[B, S, H, D]`` layout:

  * ``flash_attention_plain`` — PyTorch, a port of ``chunked_attention``:
    fp32 online softmax over q and k chunks with the reference's
    position masks (causal, sliding window under causal, and
    ``NEG_INF`` = -1e30 with a ``max(l, 1e-30)`` guard).  The CPU runs
    it, and ``chip_smoke.py`` holds the kernel against it on the card.
  * ``flash_attention_cuda`` — the CUDA C++ kernel in
    ``csrc/flash_attn_fwd.cu`` (bf16, head_dim 64 or 80, masks by index,
    which is what arange positions give).  The source says what bounds it on
    the H100 and how its design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 80)     # the kernel's instantiations: GPT-2, zamba2


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_positions=None, kv_positions=None,
                          q_chunk: int = 512, k_chunk: int = 1024):
    """q: [B, Sq, H, Dk]; k: [B, Sk, KV, Dk]; v: [B, Sk, KV, Dv];
    H % KV == 0.  Returns [B, Sq, H, Dv] in q.dtype."""
    B, Sq, H, Dk = q.shape
    Sk, KV, Dv = v.shape[1], v.shape[2], v.shape[3]
    group = H // KV
    scale = 1.0 / (Dk ** 0.5)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=dev)[None]
    if kv_positions is None:
        kv_positions = torch.arange(Sk, dtype=torch.int32, device=dev)[None]
    qpos = q_positions.expand(B, Sq)
    kpos = kv_positions.expand(B, Sk)

    outs = []
    for qs in range(0, Sq, q_chunk):
        qi = q[:, qs:qs + q_chunk]
        cq = qi.shape[1]
        qpi = qpos[:, qs:qs + q_chunk]
        qf = (qi.float() * scale).reshape(B, cq, KV, group, Dk)
        m = torch.full((B, KV, group, cq), NEG_INF, device=dev)
        l = torch.zeros((B, KV, group, cq), device=dev)
        o = torch.zeros((B, KV, group, cq, Dv), device=dev)
        for ks in range(0, Sk, k_chunk):
            kj = k[:, ks:ks + k_chunk].float()
            vj = v[:, ks:ks + k_chunk].float()
            kpj = kpos[:, ks:ks + k_chunk]
            s = torch.einsum("bqkgd,bjkd->bkgqj", qf, kj)
            if causal:
                mask = qpi[:, :, None] >= kpj[:, None, :]
                if window:
                    mask &= (qpi[:, :, None] - kpj[:, None, :]) < window
                s = s.masked_fill(~mask[:, None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bkgqj,bjkd->bkgqd",
                                                   p, vj)
            m = m_new
        out = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, Dv))
    return torch.cat(outs, dim=1).to(q.dtype)


def _lib():
    lib = _build.library("flash_attn_fwd")
    fn = lib.flash_attn_fwd_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I] + [L] * 12 + [
            ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check_operand(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] not in HEAD_DIMS or t.stride(-1) != 1:
        raise ValueError(f"{name} must be [B, S, heads, D] with D in "
                         f"{HEAD_DIMS} and a contiguous last axis, got "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if any(s % 2 for s in t.stride()[:3]) or t.data_ptr() % 4:
        raise ValueError(f"{name} needs even strides and 4-byte alignment "
                         f"for bf16x2 loads")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch kernel A.  q: [B, Sq, H, D]; k/v: [B, Sk, KV, D], bf16
    CUDA tensors, D = 64 or 80; masks by index.  Returns [B, Sq, H, D]
    bf16."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[-1] != D or H % KV:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *o.stride()[:3],
                 1.0 / (D ** 0.5), int(causal), int(window), stream)
    _build.check(err, "flash_attn_fwd_bf16")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
