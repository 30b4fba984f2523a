"""Kernel A: causal GQA flash attention, forward (prefill and training)
and backward (training).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_bhsd``, ``pallas_call`` at line 102), whose jnp
rendering ``repro.models.attention.chunked_attention`` is what the
reference's prefill runs and what its training differentiates (the
Pallas kernel has no backward).  Each direction has two versions of one
function, in the model's ``[B, S, H, D]`` layout:

  * ``flash_attention_plain`` — PyTorch, a port of ``chunked_attention``:
    fp32 online softmax over q and k chunks with the reference's
    position masks (causal, sliding window under causal, and
    ``NEG_INF`` = -1e30 with a ``max(l, 1e-30)`` guard); with
    ``return_lse`` also each row's logsumexp.  The CPU runs it, and
    ``chip_smoke.py`` holds the kernel against it on the card.
  * ``flash_attention_cuda`` — the CUDA C++ kernel in
    ``csrc/flash_attn_fwd.cu`` (bf16, head_dim 64 or 80, masks by index,
    which is what arange positions give; the logsumexp on request).
  * ``flash_attention_bwd_plain`` — the recompute backward in PyTorch:
    ``P = exp(S * scale - lse)``, ``dV = P^T dO``, ``dS = P * (dO V^T -
    D)`` with ``D = rowsum(dO * O)``, ``dQ = dS K * scale``, ``dK = dS^T
    Q * scale``, the group's heads summed into ``dK``/``dV``.
  * ``flash_attention_bwd_cuda`` — the same in ``csrc/flash_attn_bwd.cu``.

``FlashAttention`` is the ``torch.autograd.Function`` over them: its
forward keeps the logsumexp and its backward recomputes from it, by the
kernels on a CUDA tensor and by the plain versions on a CPU one.  The
sources say what bounds each kernel on the H100 and how its design
answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 80)     # the kernel's instantiations: GPT-2, zamba2


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_positions=None, kv_positions=None,
                          q_chunk: int = 512, k_chunk: int = 1024,
                          return_lse: bool = False):
    """q: [B, Sq, H, Dk]; k: [B, Sk, KV, Dk]; v: [B, Sk, KV, Dv];
    H % KV == 0.  Returns [B, Sq, H, Dv] in q.dtype, and with
    ``return_lse`` also the fp32 logsumexp [B, H, Sq] of each row's
    scaled scores, ``m + log(max(l, 1e-30))``."""
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

    outs, lses = [], []
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
        den = torch.clamp(l, min=1e-30)
        out = o / den[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, Dv))
        lses.append((m + torch.log(den)).reshape(B, H, cq))
    out = torch.cat(outs, dim=1).to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=2)
    return out


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0, q_chunk: int = 512):
    """Gradients of ``flash_attention_plain`` (index masks) recomputed from
    its logsumexp, in fp32 over q chunks.  q/o/do: [B, Sq, H, D]; k/v:
    [B, Sk, KV, D]; lse: [B, H, Sq] fp32.  Returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    B, Sq, H, Dk = q.shape
    Sk, KV, Dv = v.shape[1], v.shape[2], v.shape[3]
    group = H // KV
    scale = 1.0 / (Dk ** 0.5)
    dev = q.device
    kf, vf = k.float(), v.float()
    delta = (do.float() * o.float()).sum(dim=-1)           # [B, Sq, H]
    kpos = torch.arange(Sk, device=dev)
    dk = torch.zeros((B, Sk, KV, Dk), device=dev)
    dv = torch.zeros((B, Sk, KV, Dv), device=dev)
    dqs = []
    for qs in range(0, Sq, q_chunk):
        cq = min(q_chunk, Sq - qs)
        qf = (q[:, qs:qs + cq].float() * scale).reshape(B, cq, KV, group, Dk)
        dof = do[:, qs:qs + cq].float().reshape(B, cq, KV, group, Dv)
        s = torch.einsum("bqkgd,bjkd->bkgqj", qf, kf)
        qpos = torch.arange(qs, qs + cq, device=dev)
        mask = torch.ones((cq, Sk), dtype=torch.bool, device=dev)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
            if window:
                mask &= (qpos[:, None] - kpos[None, :]) < window
        lse_c = lse[:, :, qs:qs + cq].reshape(B, KV, group, cq, 1)
        # where, not a product: a row with no live key has lse ~ -1e30,
        # and exp(masked - lse) would be 1 there
        p = torch.where(mask, torch.exp(s - lse_c), 0.0)
        dv += torch.einsum("bkgqj,bqkgd->bjkd", p, dof)
        dp = torch.einsum("bqkgd,bjkd->bkgqj", dof, vf)
        dl = delta[:, qs:qs + cq].reshape(B, cq, KV, group)
        ds = p * (dp - dl.permute(0, 2, 3, 1)[..., None])
        dqs.append((torch.einsum("bkgqj,bjkd->bqkgd", ds, kf) * scale)
                   .reshape(B, cq, H, Dk))
        dk += torch.einsum("bkgqj,bqkgd->bjkd", ds, qf)   # qf holds scale
    return (torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _lib():
    lib = _build.library("flash_attn_fwd")
    fn = lib.flash_attn_fwd_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I] + [L] * 12 + [
            ctypes.c_float, I, I, P, P]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.library("flash_attn_bwd")
    fn = lib.flash_attn_bwd_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 10 + [I] * 6 + [L] * 24 + [
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


def _check_qkv(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t)
    B, _, H, D = q.shape
    KV = k.shape[2]
    if v.shape != k.shape or k.shape[0] != B or k.shape[-1] != D or H % KV:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """Launch kernel A.  q: [B, Sq, H, D]; k/v: [B, Sk, KV, D], bf16
    CUDA tensors, D = 64 or 80; masks by index.  Returns [B, Sq, H, D]
    bf16, and with ``return_lse`` also the fp32 logsumexp [B, H, Sq]
    (serving asks for none, and the kernel then writes none)."""
    _check_qkv(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *o.stride()[:3],
                 1.0 / (D ** 0.5), int(causal), int(window),
                 None if lse is None else lse.data_ptr(), stream)
    _build.check(err, "flash_attn_fwd_bf16")
    flash_attention_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0):
    """Launch kernel A's backward (three kernels: rowsum(dO * O), dK/dV,
    dQ).  q/o/do: [B, Sq, H, D]; k/v: [B, Sk, KV, D], bf16 CUDA tensors,
    D = 64 or 80; lse: the forward's fp32 [B, H, Sq].  Returns (dq, dk,
    dv) bf16, contiguous."""
    _check_qkv(q, k, v)
    for name, t in (("o", o), ("do", do)):
        _check_operand(name, t)
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or lse.device != q.device \
            or lse.shape != (B, H, Sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [B, H, Sq] = "
                         f"{(B, H, Sq)} tensor on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Sk, KV, D), dtype=v.dtype, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    err = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     B, H, KV, Sq, Sk, D, *strides, 1.0 / (D ** 0.5),
                     int(causal), int(window), stream)
    _build.check(err, "flash_attn_bwd_bf16")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention by index masks with a recompute backward: the forward
    keeps (q, k, v, o, lse), the backward recomputes P from lse.  Both
    directions launch the kernels on CUDA tensors and run the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        fwd = flash_attention_cuda if q.is_cuda else flash_attention_plain
        o, lse = fwd(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if do.is_cuda \
            else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse,
                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
