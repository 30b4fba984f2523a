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
    ``csrc/flash_attn_fwd.cu`` (bf16 on the tensor cores; head_dim 64,
    80, 96 (phi-3-vision) or 128, and Multi-head Latent Attention's
    split head dims, q and k of Dk over v of Dv, (96, 64) and (192, 128);
    masks by index, which is what arange positions give; the logsumexp
    on request).
  * ``flash_attention_bwd_plain`` — the recompute backward in PyTorch:
    ``P = exp(S * scale - lse)``, ``dV = P^T dO``, ``dS = P * (dO V^T -
    D)`` with ``D = rowsum(dO * O)``, ``dQ = dS K * scale``, ``dK = dS^T
    Q * scale``, the group's heads summed into ``dK``/``dV``.
  * ``flash_attention_bwd_cuda`` — the same in ``csrc/flash_attn_bwd.cu``
    (bf16 on the tensor cores, no atomics; head_dim 64 or 80; 128,
    which llama3.2-3b and phi3.5-MoE need, and the split head dims are
    refused until ROADMAP queue 2, item 7 brings them).

``FlashAttention`` is the ``torch.autograd.Function`` over them: its
forward keeps the logsumexp and the output, and its backward recomputes
from them, by the kernels on a CUDA tensor and by the plain versions on
a CPU one.  The backward's ``D = rowsum(dO * O)`` stands for ``sum_j
P_ij dP_ij``, and the part of the keys common to every key cancels out
of dQ only where D is that close: from the bf16-rounded output, 2^-9 of
that part stays in dQ, which is large where the keys and values are an
encoder's output that attention has averaged towards one vector
(whisper's cross-attention; ``csrc/flash_attn_bwd.cu``).  So where the
attention is not causal (the encoder-decoder's) the forward keeps its
output in fp32 for D.  Causal attention keeps D from the output in its
own dtype, as before the encoder-decoder came: the fp32 output moves a
bf16 run's gradients by bf16 noise only there (~1% of a leaf, either
way against the reference's) and would move every causal training
run's bits.  The
sources say what bounds each kernel on the H100 and how its design
answers that.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# the kernels' instantiations, (Dk, Dv) of q/k and of v: GPT-2, zamba2
# and, forward only, llama3.2, phi3.5-MoE and phi4-mini at 128,
# phi-3-vision at 96, MiniCPM3 at (96, 64) and DeepSeek-V2 at (192, 128)
FWD_HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (96, 96), (96, 64),
                 (192, 128))
BWD_HEAD_DIMS = (64, 80)
NO_BACKWARD_AT = "ROADMAP queue 2, item 7"


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_positions=None, kv_positions=None,
                          q_chunk: int = 512, k_chunk: int = 1024,
                          return_lse: bool = False, out_dtype=None):
    """q: [B, Sq, H, Dk]; k: [B, Sk, KV, Dk]; v: [B, Sk, KV, Dv];
    H % KV == 0.  Returns [B, Sq, H, Dv] in ``out_dtype`` (default
    q.dtype), and with ``return_lse`` also the fp32 logsumexp [B, H, Sq]
    of each row's scaled scores, ``m + log(max(l, 1e-30))``."""
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
    out = torch.cat(outs, dim=1).to(out_dtype or q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=2)
    return out


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0, q_chunk: int = 512):
    """Gradients of ``flash_attention_plain`` (index masks) recomputed from
    its logsumexp, in fp32 over q chunks.  q/o/do: [B, Sq, H, D] (o, the
    forward's output, in fp32 or q's dtype); k/v: [B, Sk, KV, D]; lse:
    [B, H, Sq] fp32.  Returns (dq, dk, dv) in the dtypes of q, k and
    v."""
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
    fn = _build.library("flash_attn_fwd").flash_attn_fwd_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P] + [I] * 7 + [L] * 12 + [
            ctypes.c_float, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.library("flash_attn_bwd")
    fn = lib.flash_attn_bwd_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 10 + [I] * 6 + [L] * 24 + [
            ctypes.c_float, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def check_backward_head_dim(D: int, Dv: Optional[int] = None) -> None:
    """Raise for head dims the backward kernel was not built for: q/k's
    ``D`` and v's ``Dv`` (default ``D``)."""
    Dv = D if Dv is None else Dv
    if D != Dv or D not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"kernel A's backward is built for head_dim in {BWD_HEAD_DIMS} "
            f"(q, k and v alike), not (Dk, Dv) = ({D}, {Dv}): training at "
            f"these head dims waits for {NO_BACKWARD_AT} (use_kernels=False"
            f" trains through the plain attention)")


def _check_operand(name: str, t: torch.Tensor,
                   dtypes=(torch.bfloat16,)) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be "
                        f"{' or '.join(str(d)[6:] for d in dtypes)}, got "
                        f"{t.dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be [B, S, heads, D] with a "
                         f"contiguous last axis, got {tuple(t.shape)} "
                         f"strides {t.stride()}")
    if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs strides in multiples of 8 elements "
                         f"and 16-byte alignment for 16-byte row copies, "
                         f"got strides {t.stride()}")


def _check_qkv(q, k, v):
    """q [B, Sq, H, Dk], k [B, Sk, KV, Dk], v [B, Sk, KV, Dv] with (Dk,
    Dv) one of ``FWD_HEAD_DIMS``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t)
    B, _, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    if v.shape[:3] != k.shape[:3] or k.shape[0] != B or k.shape[-1] != Dk \
            or H % KV:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if (Dk, Dv) not in FWD_HEAD_DIMS:
        raise ValueError(
            f"kernel A is built for (Dk, Dv) in {FWD_HEAD_DIMS} (q and k "
            f"of Dk, v of Dv; D in 64, 80, 96, 128 where they are equal), "
            f"got ({Dk}, {Dv})")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         return_lse: bool = False, o32=None):
    """Launch kernel A.  q: [B, Sq, H, Dk]; k: [B, Sk, KV, Dk]; v: [B, Sk,
    KV, Dv], bf16 CUDA tensors, (Dk, Dv) one of ``FWD_HEAD_DIMS``; masks
    by index; scores scaled by 1/sqrt(Dk).  Returns [B, Sq, H, Dv] bf16,
    and with ``return_lse`` also the fp32 logsumexp [B, H, Sq] (serving
    asks for none, and the kernel then writes none).  ``o32``: a
    contiguous fp32 [B, Sq, H, Dv] tensor on q's device that receives
    the output before its bf16 rounding (training's backward reads it)."""
    _check_qkv(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if o32 is not None and (o32.dtype != torch.float32
                            or o32.device != q.device
                            or o32.shape != (B, Sq, H, Dv)
                            or not o32.is_contiguous()):
        raise ValueError(f"o32 must be a contiguous fp32 {(B, Sq, H, Dv)} "
                         f"tensor on {q.device}, got {o32.dtype} "
                         f"{tuple(o32.shape)} on {o32.device}")
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, Sq, Sk, D, Dv, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *o.stride()[:3],
                 1.0 / (D ** 0.5), int(causal), int(window),
                 None if lse is None else lse.data_ptr(),
                 None if o32 is None else o32.data_ptr(), stream)
    _build.check(err, "flash_attn_fwd_bf16")
    flash_attention_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0):
    """Launch kernel A's backward (three kernels: rowsum(dO * O), dK/dV,
    dQ).  q/o/do: [B, Sq, H, D]; k/v: [B, Sk, KV, D], bf16 CUDA tensors,
    but o, the forward's output, in fp32 (``flash_attention_cuda``'s
    ``o32``, for an exact rowsum) or bf16; D = 64 or 80; lse: the
    forward's fp32 [B, H, Sq].  Returns (dq, dk, dv) bf16, contiguous."""
    _check_qkv(q, k, v)
    check_backward_head_dim(q.shape[-1], v.shape[-1])
    _check_operand("o", o, (torch.bfloat16, torch.float32))
    _check_operand("do", do)
    for name, t in (("o", o), ("do", do)):
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
                     int(causal), int(window),
                     int(o.dtype == torch.float32), stream)
    _build.check(err, "flash_attn_bwd_bf16")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention by index masks with a recompute backward: the forward
    keeps (q, k, v, the output, lse), the output in fp32 where the
    attention is not causal (the module's docstring says why), and the
    backward recomputes P from lse.  Both directions launch the kernels
    on CUDA tensors and run the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if q.is_cuda:     # refuse before the forward, not in the backward
            check_backward_head_dim(q.shape[-1], v.shape[-1])
            o32 = None if causal else torch.empty(
                q.shape[:3] + v.shape[3:], dtype=torch.float32,
                device=q.device)
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, return_lse=True,
                                          o32=o32)
            kept = o if o32 is None else o32
        else:
            kept, lse = flash_attention_plain(
                q, k, v, causal=causal, window=window, return_lse=True,
                out_dtype=None if causal else torch.float32)
            o = kept.to(q.dtype)
        ctx.save_for_backward(q, k, v, kept, lse)
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
