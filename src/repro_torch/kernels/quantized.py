"""Int8 kernels: absmax quantization, kernel B (one-token attention over
an int8 KV cache, serving decode) and kernel 5 (the blocked int8 matrix
product the calibration micro-bench times).

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
    head_dim 64 (GPT-2), 96 (phi-3-vision) or 128 (llama3.2-3b,
    phi3.5-MoE): one CTA per
    (kv head, batch row, split of Sk) over the whole GQA group, tiles
    with no live key skipped, the splits merged in order by a second
    small kernel.  ``int8kv_splits`` picks the splits.  The source says
    what bounds it (bytes) and how its design answers that.

Kernel 5 replaces the TPU kernel ``src/repro/kernels/quantized.py``
(``int8_matmul_blocked``, ``pallas_call`` at line 81).  ``quantize_blocks``
ports the reference's per-2-D-tile quantization bit for bit; then two
versions of one function on operands already padded to block multiples:

  * ``int8_matmul_plain`` — PyTorch: per K block the exact partial
    product of the int8 tiles (in fp32, exact below 2^24), times the
    tile's scale product ``xs * ws``, added to an fp32 accumulator in K
    order, as the reference's kernel does.  The CPU runs it, and
    ``chip_smoke.py`` holds the kernel against it on the card.
  * ``int8_matmul_cuda`` — the CUDA C++ kernel in
    ``csrc/int8_matmul.cu`` (``mma.sync`` m16n8k32 on int8, int32
    partials dequantized at every K-block boundary).  Block sizes are
    multiples of 32 up to 128.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)    # kernel B's instantiations


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


def int8kv_attention_plain(q, k_q, k_scale, v_q, v_scale, valid, *,
                           with_lse: bool = False):
    """q: [B, Sq, H, Dk] fp; k_q/v_q: [B, Sk, KV, D*] int8; k_scale/
    v_scale: [B, Sk, KV] fp32; valid: [B, Sk] (nonzero = key live).
    Non-causal.  Returns [B, Sq, H, Dv] in q.dtype; ``with_lse`` (Sq =
    1) also each (row, head)'s log-sum-exp of its live scores, fp32
    [B, H] in natural-log units, -inf for a row with no live key
    (``live_lse``)."""
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
    o = o.reshape(B, Sq, H, -1).to(q.dtype)
    if not with_lse:
        return o
    return o, live_lse(s[:, :, :, 0].reshape(B, H, -1), valid)


def live_lse(s, valid):
    """[B, H] log-sum-exp of masked scores ``s`` [B, H, Sk] (fp32, keys
    not ``valid`` [B, Sk] at ``NEG_INF``), -inf for a row with no live
    key: the weight of a block that holds none in a merge of blocks."""
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(valid.bool().any(-1)[:, None], lse,
                       torch.full_like(lse, float("-inf")))


# kernel B's split of Sk (TILE and MAX_TILES in csrc/int8kv_attn.cu):
# whole tiles of KEY_TILE keys, at most MAX_SPLIT_TILES a split; up to
# one CTA per SM where Sk allows, but at least MIN_SPLIT_TILES tiles a
# split.  Measured on an H100 (tools/kernel_times.py --group decode
# --sweep): a 64-key tile costs ~1.7 us of one CTA's time and a split 1.5
# to 3.6 us (the merge's launch, more CTAs); with dead tiles skipped, a
# partly filled cache (17 to 290 live keys of 296 or 1024) is done
# fastest in one split, a full 1024-slot cache in 2 to 4 (0.0269 ms at 2
# against 0.0368 at 1, D = 128).  The split cannot see the fill, so a
# cache of fewer than 16 tiles (1024 keys) is not split, and the floor
# keeps a split at 8 tiles or more.
KEY_TILE = 64
MAX_SPLIT_TILES = 32
MIN_SPLIT_TILES = 8


def int8kv_splits(B: int, KV: int, Sk: int, n_sm: int):
    """(splits, keys_per_split) of kernel B for a [B, Sk, KV, D] cache
    on a card of ``n_sm`` SMs.  Split s takes keys [s * keys_per_split,
    min((s + 1) * keys_per_split, Sk)); every split holds at least one
    key, and keys_per_split is a whole number of tiles."""
    if min(B, KV, Sk, n_sm) <= 0:
        raise ValueError(f"int8kv_splits: B={B}, KV={KV}, Sk={Sk}, "
                         f"n_sm={n_sm} must be positive")
    tiles = -(-Sk // KEY_TILE)
    want = min(-(-n_sm // (B * KV)), tiles // MIN_SPLIT_TILES)
    splits = max(1, -(-tiles // MAX_SPLIT_TILES), want)
    per = -(-tiles // splits)
    return -(-tiles // per), per * KEY_TILE


def _lib():
    lib = _build.library("int8kv_attn")
    fn = lib.int8kv_decode_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 10 + [I] * 7 + [L] * 4 + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def int8kv_attention_cuda(q, k_q, k_scale, v_q, v_scale, valid, *,
                          with_lse: bool = False):
    """Launch kernel B.  q: [B, 1, H, D] bf16; k_q/v_q: [B, Sk, KV, D]
    int8, k_scale/v_scale: [B, Sk, KV] fp32 and valid: [B, Sk] bool, all
    contiguous CUDA tensors; D = 64, 96 or 128.  Returns [B, 1, H, D] bf16;
    ``with_lse`` also the fp32 [B, H] log-sum-exp of each (row, head)'s
    live scores, natural-log units (-inf for a row with no live key),
    as ``int8kv_attention_plain`` gives it.  On meta tensors (the dry
    run's) it allocates what it would, at the H100's split count, and
    launches nothing."""
    tensors = (("q", q), ("k_q", k_q), ("k_scale", k_scale), ("v_q", v_q),
               ("v_scale", v_scale), ("valid", valid))
    for name, t in tensors:
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"{name} must be a CUDA tensor (or meta), got "
                             f"{t.device}")
    if q.dtype != torch.bfloat16 or q.dim() != 4 or q.shape[1] != 1 \
            or q.shape[-1] not in HEAD_DIMS or q.stride(-1) != 1 \
            or q.stride(0) % 2 or q.stride(2) % 2:
        raise ValueError(f"q must be bf16 [B, 1, H, D] with D in "
                         f"{HEAD_DIMS} and a contiguous, even-aligned last "
                         f"axis; got {q.dtype} {tuple(q.shape)} "
                         f"{q.stride()}")
    B, _, H, D = q.shape
    Sk, KV = k_q.shape[1], k_q.shape[2]
    want = {"k_q": ((B, Sk, KV, D), torch.int8),
            "v_q": ((B, Sk, KV, D), torch.int8),
            "k_scale": ((B, Sk, KV), torch.float32),
            "v_scale": ((B, Sk, KV), torch.float32),
            "valid": ((B, Sk), torch.bool)}
    for name, t in tensors[1:]:
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if H % KV or k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("H must be a multiple of KV, and k_q and v_q "
                         "16-byte aligned")
    splits, kps = int8kv_splits(B, KV, Sk, _build.sm_count(q.device))
    o = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if with_lse else None
    scratch = ()
    if splits > 1:       # each split's (max, sum) and accumulator, fp32
        scratch = (torch.empty((B, H, splits, 2), dtype=torch.float32,
                               device=q.device),
                   torch.empty((B, H, splits, D), dtype=torch.float32,
                               device=q.device))
    if q.is_meta:
        return (o, lse) if with_lse else o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in scratch] or [None] * 2
    err = _lib()(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
                 v_q.data_ptr(), v_scale.data_ptr(), valid.data_ptr(),
                 o.data_ptr(), None if lse is None else lse.data_ptr(),
                 *ptrs, B, H, KV, Sk, D, splits, kps,
                 q.stride(0), q.stride(2), o.stride(0), o.stride(2),
                 1.0 / (D ** 0.5), stream)
    _build.check(err, "int8kv_decode_bf16")
    int8kv_attention_cuda.launches += 1
    return (o, lse) if with_lse else o


int8kv_attention_cuda.launches = 0


# ------------------------------------------------------------------ #
# kernel 5: blocked int8 matmul with per-tile absmax scales

BLOCKS = (32, 64, 96, 128)


def check_blocks(block_m: int, block_k: int, block_n: int) -> None:
    for name, b in (("block_m", block_m), ("block_k", block_k),
                    ("block_n", block_n)):
        if b not in BLOCKS:
            raise ValueError(f"{name}={b}: the int8 matmul takes blocks "
                             f"in {BLOCKS}")


def quantize_blocks(x, block_rows: int, block_cols: int):
    """Per-2-D-tile absmax int8 quantization of a [M, K] fp tensor (M, K
    already padded to block multiples).  Returns (q int8 [M, K], scale
    fp32 [M // block_rows, K // block_cols])."""
    M, K = x.shape
    nm, nk = M // block_rows, K // block_cols
    t = x.float().reshape(nm, block_rows, nk, block_cols)
    absmax = t.abs().amax(dim=(1, 3))                          # [nm, nk]
    # the reference divides eagerly, and a lone division is not folded
    # into a reciprocal product, so the division keeps it bit-equal
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(t / scale[:, None, :, None]), -127, 127)
    return q.to(torch.int8).reshape(M, K), scale


def int8_matmul_plain(xq, xs, wq, ws, *, block_m: int, block_k: int,
                      block_n: int):
    """xq: [M, K] int8 with xs: [M/bm, K/bk] fp32; wq: [K, N] int8 with
    ws: [K/bk, N/bn] fp32; block multiples.  Returns fp32 [M, N]."""
    M, K = xq.shape
    N = wq.shape[1]
    xf, wf = xq.float(), wq.float()
    xs_rows = torch.repeat_interleave(xs, block_m, dim=0)      # [M, nk]
    ws_cols = torch.repeat_interleave(ws, block_n, dim=1)      # [nk, N]
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    for kb in range(K // block_k):
        ks = slice(kb * block_k, (kb + 1) * block_k)
        # |partial| <= 127 * 127 * 128 < 2^24: every fp32 sum is exact
        partial = xf[:, ks] @ wf[ks, :]
        acc = acc + partial * (xs_rows[:, kb, None] * ws_cols[None, kb, :])
    return acc


def _mm_lib():
    lib = _build.library("int8_matmul")
    fn = lib.int8_matmul_s8
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 7 + [P]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul_cuda(xq, xs, wq, ws, *, block_m: int, block_k: int,
                     block_n: int):
    """Launch kernel 5.  xq: [M, K] int8, xs: [M/bm, K/bk] fp32, wq:
    [K, N] int8, ws: [K/bk, N/bn] fp32, contiguous CUDA tensors whose
    shapes are block multiples.  Returns fp32 [M, N].  The kernel first
    writes w transposed into a scratch this allocates (K * N bytes), then
    runs the products; a rerun gives the same bits.  Only calibration
    runs it, so a meta tensor (the dry run's) has no shape rule here."""
    if xq.is_meta:
        raise NotImplementedError("kernel 5 runs in calibration only: the "
                                  "dry run has no shape rule for it")
    check_blocks(block_m, block_k, block_n)
    M, K = xq.shape
    N = wq.shape[1]
    want = {"xq": ((M, K), torch.int8),
            "xs": ((M // block_m, K // block_k), torch.float32),
            "wq": ((K, N), torch.int8),
            "ws": ((K // block_k, N // block_n), torch.float32)}
    for name, t in (("xq", xq), ("xs", xs), ("wq", wq), ("ws", ws)):
        shape, dtype = want[name]
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if M % block_m or K % block_k or N % block_n:
        raise ValueError(f"[{M}, {K}] x [{K}, {N}] is not a multiple of "
                         f"the blocks ({block_m}, {block_k}, {block_n})")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must be 16-byte aligned (TMA)")
    # the kernel writes w transposed here first: 8-bit wgmma reads both
    # operands K-major
    wt = torch.empty((N, K), dtype=torch.int8, device=xq.device)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = _mm_lib()(xq.data_ptr(), xs.data_ptr(), wq.data_ptr(),
                    ws.data_ptr(), wt.data_ptr(), out.data_ptr(), M, N, K,
                    block_m, block_k, block_n, _build.sm_count(xq.device),
                    stream)
    _build.check(err, "int8_matmul_s8")
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0
