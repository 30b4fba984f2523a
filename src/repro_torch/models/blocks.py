"""Per-layer blocks (port of ``repro/models/blocks.py``): init, forward,
prefill and decode for the dense pre-norm block, the MoE block
(phi3.5-MoE, DeepSeek-V2: attention, then the routed experts in place of
the MLP), the Mamba1 block (falcon-mamba), the Mamba2 block (zamba2,
whose shared attention block is a dense block), and whisper's decoder
block (self-attention, cross-attention over the encoder's output, MLP)
and encoder block (bidirectional self-attention, MLP).  The dense and MoE blocks attend by Multi-head
Latent Attention (leaf ``mla``) where the config has an ``MLAConfig``
(MiniCPM3, DeepSeek-V2), by GQA (leaf ``attn``) otherwise.
``use_kernels`` reaches every norm (kernel 6 for RMSNorm on the card),
attention and scan.

Every ``init_*`` makes its leaves with a leading ``lead`` shape, so
``lead=(n_layers,)`` gives the stacked ``[L, ...]`` layout the reference
builds with ``vmap`` (``(G, k)`` for the hybrid's groups); the other
functions take one layer's slice and ignore the keyword arguments of
the other families.  Prefill and decode write a layer's new recurrent
state into its cache slice in place, as attention writes its k/v.  The
MoE block's forward returns ``(x, aux)``, its load-balance loss; its
prefill and decode drop the aux, as serving ignores it.

Under a plan every block function takes ``model_axis`` (the plan's cut
over the ``model`` axis, ``core.sharding.ModelAxis``) and the MoE block
its ``dispatch`` (``moe.Dispatch``); both are None on one device.  The
prefill and decode of the blocks with attention also take the ring's
``blocks`` (``attention.RingBlocks``) of a serving plan; whisper's
decoder block reads where its block of the frames lies off its cross
cache (``frame_blocks``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding import copy_to_model
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp, apply_norm, init_mlp, init_norm,
)


def _init_attention(generator, cfg: ModelConfig, **kw):
    """{"mla": ...} for an MLA config, else {"attn": ...}."""
    if cfg.mla is not None:
        return {"mla": attn.init_mla(generator, cfg, **kw)}
    return {"attn": attn.init_attention(generator, cfg, **kw)}


def _attention_forward(h, p, cfg: ModelConfig, *, positions, window,
                       use_kernels, model_axis):
    if cfg.mla is not None:
        return attn.mla_forward(h, p["mla"], cfg, positions=positions,
                                window=window, use_kernels=use_kernels,
                                model_axis=model_axis)
    return attn.attention_forward(h, p["attn"], cfg, positions=positions,
                                  window=window, use_kernels=use_kernels,
                                  model_axis=model_axis)


def _attention_prefill(h, p, cfg: ModelConfig, *, positions, cache, window,
                       use_kernels, model_axis, blocks):
    if cfg.mla is not None:
        return attn.mla_prefill(h, p["mla"], cfg, positions=positions,
                                cache=cache, window=window,
                                use_kernels=use_kernels,
                                model_axis=model_axis, blocks=blocks)
    return attn.attention_prefill(h, p["attn"], cfg, positions=positions,
                                  cache=cache, window=window,
                                  use_kernels=use_kernels,
                                  model_axis=model_axis, blocks=blocks)


def _attention_decode(h, p, cfg: ModelConfig, *, cache, window, use_kernels,
                      model_axis, blocks):
    if cfg.mla is not None:
        return attn.mla_decode(h, p["mla"], cfg, cache=cache, window=window,
                               use_kernels=use_kernels,
                               model_axis=model_axis, blocks=blocks)
    return attn.attention_decode(h, p["attn"], cfg, cache=cache,
                                 window=window, use_kernels=use_kernels,
                                 model_axis=model_axis, blocks=blocks)


def init_dense_block(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    kw = dict(lead=lead, device=device)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, **kw),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                        **kw),
        **_init_attention(generator, cfg, **kw),
    }


def _norm(x, p, cfg: ModelConfig, use_kernels: bool):
    return apply_norm(x, p, cfg.norm, cfg.norm_eps, use_kernels=use_kernels)


def _heads_axis(model_axis):
    """The model axis where the plan cuts the heads, else None (whisper's
    cross-attention is cut as its self-attention: its kv heads are its
    heads, and every attention leaf has their shape)."""
    return model_axis if model_axis is not None and model_axis.heads \
        else None


def _mlp_axis(model_axis):
    return model_axis if model_axis is not None and model_axis.mlp else None


def _mlp_residual(x, p, cfg: ModelConfig, use_kernels: bool,
                  model_axis=None):
    h = _norm(x, p["norm2"], cfg, use_kernels)
    return x + apply_mlp(h, p["mlp"], cfg.activation, _mlp_axis(model_axis))


def dense_block_forward(x, p, cfg: ModelConfig, *, positions=None,
                        window: int = 0, use_kernels: bool = True,
                        model_axis=None):
    """``model_axis`` (``core.sharding.ModelAxis``): the plan's cut of
    the heads and the MLP over the ``model`` axis, None on one device."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    x = x + _attention_forward(h, p, cfg, positions=positions, window=window,
                               use_kernels=use_kernels, model_axis=model_axis)
    return _mlp_residual(x, p, cfg, use_kernels, model_axis)


def dense_block_prefill(x, p, cfg: ModelConfig, *, positions=None, cache,
                        window: int = 0, use_kernels: bool = True,
                        model_axis=None, blocks=attn.WHOLE_RING):
    """Under a serving plan ``model_axis`` cuts the heads and the MLP as
    in ``dense_block_forward``, and ``blocks`` (``attention.RingBlocks``)
    says which ring slots this rank's cache holds."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, cache = _attention_prefill(h, p, cfg, positions=positions, cache=cache,
                                  window=window, use_kernels=use_kernels,
                                  model_axis=model_axis, blocks=blocks)
    return _mlp_residual(x + a, p, cfg, use_kernels, model_axis), cache


def dense_block_decode(x, p, cfg: ModelConfig, *, cache, window: int = 0,
                       use_kernels: bool = True, model_axis=None,
                       blocks=attn.WHOLE_RING):
    """``model_axis`` and ``blocks``: as ``dense_block_prefill``'s."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, cache = _attention_decode(h, p, cfg, cache=cache, window=window,
                                 use_kernels=use_kernels,
                                 model_axis=model_axis, blocks=blocks)
    return _mlp_residual(x + a, p, cfg, use_kernels, model_axis), cache


# --------------------------------------------------------------------- #
# MoE (phi3.5-moe, deepseek-v2: norm -> attention -> residual, norm ->
# experts -> residual)
# --------------------------------------------------------------------- #

def init_moe_block(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    kw = dict(lead=lead, device=device)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, **kw),
        "moe": moe_mod.init_moe(generator, cfg, **kw),
        **_init_attention(generator, cfg, **kw),
    }


def _moe_residual(x, p, cfg: ModelConfig, use_kernels: bool,
                  model_axis=None, dispatch=None):
    h = _norm(x, p["norm2"], cfg, use_kernels)
    m, aux = moe_mod.moe_forward(h, p["moe"], cfg, dispatch=dispatch,
                                 model_axis=model_axis)
    return x + m, aux


def moe_block_forward(x, p, cfg: ModelConfig, *, positions=None,
                      window: int = 0, use_kernels: bool = True,
                      model_axis=None, dispatch=None):
    """Returns (x, aux)."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    x = x + _attention_forward(h, p, cfg, positions=positions, window=window,
                               use_kernels=use_kernels, model_axis=model_axis)
    return _moe_residual(x, p, cfg, use_kernels, model_axis, dispatch)


def moe_block_prefill(x, p, cfg: ModelConfig, *, positions=None, cache,
                      window: int = 0, use_kernels: bool = True,
                      model_axis=None, blocks=attn.WHOLE_RING,
                      dispatch=None):
    """``model_axis`` and ``blocks``: as ``dense_block_prefill``'s;
    ``dispatch``: as ``moe_block_forward``'s."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, cache = _attention_prefill(h, p, cfg, positions=positions, cache=cache,
                                  window=window, use_kernels=use_kernels,
                                  model_axis=model_axis, blocks=blocks)
    return _moe_residual(x + a, p, cfg, use_kernels, model_axis,
                         dispatch)[0], cache


def moe_block_decode(x, p, cfg: ModelConfig, *, cache, window: int = 0,
                     use_kernels: bool = True, model_axis=None,
                     blocks=attn.WHOLE_RING, dispatch=None):
    """As ``moe_block_prefill``, for one token."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, cache = _attention_decode(h, p, cfg, cache=cache, window=window,
                                 use_kernels=use_kernels,
                                 model_axis=model_axis, blocks=blocks)
    return _moe_residual(x + a, p, cfg, use_kernels, model_axis,
                         dispatch)[0], cache


def _store(cache: ssm_mod.SSMState, new: ssm_mod.SSMState):
    """Write a layer's new state into its cache slice (in place); returns
    the slice."""
    cache.conv.copy_(new.conv)
    cache.h.copy_(new.h)
    return cache


# --------------------------------------------------------------------- #
# SSM (falcon-mamba: norm -> mamba1 -> residual)
# --------------------------------------------------------------------- #

def init_ssm_block(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    return {
        "norm": init_norm(cfg.d_model, cfg.norm, lead=lead, device=device),
        "mamba": ssm_mod.init_mamba1(generator, cfg, lead=lead,
                                     device=device),
    }


def ssm_block_forward(x, p, cfg: ModelConfig, *, use_kernels: bool = True,
                      model_axis=None, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, _ = ssm_mod.mamba1_forward(h, p["mamba"], cfg, use_kernels=use_kernels,
                                  model_axis=model_axis)
    return x + y


def ssm_block_prefill(x, p, cfg: ModelConfig, *, cache,
                      use_kernels: bool = True, model_axis=None, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, new = ssm_mod.mamba1_forward(h, p["mamba"], cfg, state=cache,
                                    use_kernels=use_kernels,
                                    model_axis=model_axis)
    return x + y, _store(cache, new)


def ssm_block_decode(x, p, cfg: ModelConfig, *, cache,
                     use_kernels: bool = True, model_axis=None, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, new = ssm_mod.mamba1_decode(h, p["mamba"], cfg, state=cache,
                                   model_axis=model_axis)
    return x + y, _store(cache, new)


# --------------------------------------------------------------------- #
# hybrid (zamba2: groups of mamba2 layers + one shared attention block)
# --------------------------------------------------------------------- #

def init_mamba2_block(generator, cfg: ModelConfig, *, lead=(),
                      device="cpu"):
    return {
        "norm": init_norm(cfg.d_model, cfg.norm, lead=lead, device=device),
        "mamba": ssm_mod.init_mamba2(generator, cfg, lead=lead,
                                     device=device),
    }


def mamba2_block_forward(x, p, cfg: ModelConfig, *,
                         use_kernels: bool = True, model_axis=None, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, _ = ssm_mod.mamba2_forward(h, p["mamba"], cfg, use_kernels=use_kernels,
                                  model_axis=model_axis)
    return x + y


def mamba2_block_prefill(x, p, cfg: ModelConfig, *, cache,
                         use_kernels: bool = True, model_axis=None, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, new = ssm_mod.mamba2_forward(h, p["mamba"], cfg, state=cache,
                                    use_kernels=use_kernels,
                                    model_axis=model_axis)
    return x + y, _store(cache, new)


def mamba2_block_decode(x, p, cfg: ModelConfig, *, cache,
                        use_kernels: bool = True, model_axis=None, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, new = ssm_mod.mamba2_decode(h, p["mamba"], cfg, state=cache,
                                   model_axis=model_axis)
    return x + y, _store(cache, new)


# --------------------------------------------------------------------- #
# whisper decoder block (self-attn + cross-attn + mlp); every
# full-sequence attention goes through ``attention.chunked_attention``:
# the self-attention causal, the cross-attention over ``enc_out`` not
# --------------------------------------------------------------------- #

def init_encdec_block(generator, cfg: ModelConfig, *, lead=(),
                      device="cpu"):
    kw = dict(lead=lead, device=device)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, **kw),
        "self_attn": attn.init_attention(generator, cfg, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, **kw),
        "cross_attn": attn.init_attention(generator, cfg, **kw),
        "norm3": init_norm(cfg.d_model, cfg.norm, **kw),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                        **kw),
    }


def _cross_kv(enc_out, p):
    """The cross-attention's k and v [B, F, KV, D] of the encoder's
    output (of this rank's heads where the plan cuts them: ``enc_out``
    has then entered the layers through f once,
    ``Model.encoder_output``)."""
    dt = enc_out.dtype
    return (attn._proj(enc_out, p["wk"]) + p["bk"].to(dt),
            attn._proj(enc_out, p["wv"]) + p["bv"].to(dt))


def _cross_q(h, p, axis=None):
    if axis is not None:
        h = copy_to_model(h, axis)
    return attn._proj(h, p["wq"]) + p["bq"].to(h.dtype)


def _cross_attention(h, p, k, v, use_kernels: bool, axis=None):
    """Non-causal attention of the decoder's queries over every frame:
    kernel A at Sq = the text length, Sk = the frames; under ``axis`` a
    rank's heads, the output projection's partial sums added over the
    axis before ``bo``."""
    o = attn.chunked_attention(_cross_q(h, p, axis), k, v, causal=False,
                               use_kernels=use_kernels)
    return attn._out(o, p, axis)


def frame_blocks(cache_k, cfg: ModelConfig, model_axis):
    """Where a rank's frames of the cross cache lie (``RingBlocks``): a
    layer's ``cross_k`` [B, c, H, D] holds frames ``[rank c, (rank + 1)
    c)`` of the ``enc_seq_len`` frames, cut over the ``model`` axis as
    ``Plan.cache_spec`` cuts the dim after the batch (on an axis of one,
    one block, whose merge is exact); all of them on one device, or
    where the axis does not divide them (``WHOLE_RING``)."""
    n = cfg.enc_seq_len // cache_k.shape[1]
    if model_axis is not None and n == model_axis.size:
        return attn.RingBlocks(model_axis.group, n, model_axis.rank)
    if n == 1:
        return attn.WHOLE_RING
    raise ValueError(f"a cross cache of {cache_k.shape[1]} of "
                     f"{cfg.enc_seq_len} frames needs a model axis of {n}")


def _cross_attention_cached(h, p, k, v, cfg: ModelConfig, model_axis=None):
    """Decode-time cross attention against the cached k and v of the
    frames (plain PyTorch, as the reference's jnp ``decode_attention``).
    Under a serving plan each rank projects its heads' q and the ranks
    gather every head's; each attends with every head over its block
    of the frames (``frame_blocks``), the partials merge by their
    log-sum-exp (``merge_blocks``) and a rank keeps its heads for
    ``wo``, as ``attention.attention_decode`` does over the ring."""
    axis = _heads_axis(model_axis)
    q = _cross_q(h, p, axis)
    h_local = q.shape[2]
    if axis is not None:
        (q,) = attn._gather_heads([q], axis)
    blocks = frame_blocks(k, cfg, model_axis)
    valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    lse = blocks.group is not None
    o = attn.decode_attention(q, k, v, valid, with_lse=lse)
    if lse:
        o = attn.merge_blocks(*o, blocks)
    if axis is not None:
        o = o[:, :, axis.rank * h_local:(axis.rank + 1) * h_local]
    return attn._out(o, p, axis)


def _cross_mlp(x, p, cfg: ModelConfig, k, v, use_kernels: bool,
               model_axis=None):
    """The block after its self-attention: cross-attention, then MLP,
    each behind its norm and residual."""
    h = _norm(x, p["norm2"], cfg, use_kernels)
    x = x + _cross_attention(h, p["cross_attn"], k, v, use_kernels,
                             _heads_axis(model_axis))
    h = _norm(x, p["norm3"], cfg, use_kernels)
    return x + apply_mlp(h, p["mlp"], cfg.activation, _mlp_axis(model_axis))


def encdec_block_forward(x, p, cfg: ModelConfig, *, enc_out, positions=None,
                         use_kernels: bool = True, model_axis=None, **_):
    """``model_axis``: the plan's cut of the heads (self- and
    cross-attention) and the MLP, None on one device."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    x = x + attn.attention_forward(h, p["self_attn"], cfg,
                                   positions=positions, causal=True,
                                   use_kernels=use_kernels,
                                   model_axis=model_axis)
    k, v = _cross_kv(enc_out, p["cross_attn"])
    return _cross_mlp(x, p, cfg, k, v, use_kernels, model_axis)


def encdec_block_prefill(x, p, cfg: ModelConfig, *, enc_out, cache,
                         positions=None, use_kernels: bool = True,
                         model_axis=None, blocks=attn.WHOLE_RING, **_):
    """Fills the layer's cache in place: ``self`` with the prompt's k/v,
    ``cross_k`` and ``cross_v`` with the frames' (the k and v the
    cross-attention attends over).  Under a serving plan the attentions
    run over this rank's heads, ``self`` takes ``blocks`` of the ring,
    and the cross k and v of every head (one all-gather of the heads
    where the plan cuts them) fill this rank's block of the frames
    (``frame_blocks``)."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, self_cache = attn.attention_prefill(h, p["self_attn"], cfg,
                                           positions=positions,
                                           cache=cache["self"],
                                           use_kernels=use_kernels,
                                           model_axis=model_axis,
                                           blocks=blocks)
    axis = _heads_axis(model_axis)
    k, v = _cross_kv(enc_out, p["cross_attn"])
    kk, vv = (k, v) if axis is None else attn._gather_heads([k, v], axis)
    fb = frame_blocks(cache["cross_k"], cfg, model_axis)
    c = cache["cross_k"].shape[1]
    cache["cross_k"].copy_(kk[:, fb.rank * c:(fb.rank + 1) * c])
    cache["cross_v"].copy_(vv[:, fb.rank * c:(fb.rank + 1) * c])
    x = _cross_mlp(x + a, p, cfg, k, v, use_kernels, model_axis)
    return x, dict(cache, self=self_cache)


def encdec_block_decode(x, p, cfg: ModelConfig, *, cache,
                        use_kernels: bool = True, model_axis=None,
                        blocks=attn.WHOLE_RING, **_):
    """``model_axis`` and ``blocks``: as ``encdec_block_prefill``'s."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, self_cache = attn.attention_decode(h, p["self_attn"], cfg,
                                          cache=cache["self"],
                                          use_kernels=use_kernels,
                                          model_axis=model_axis,
                                          blocks=blocks)
    x = x + a
    h = _norm(x, p["norm2"], cfg, use_kernels)
    x = x + _cross_attention_cached(h, p["cross_attn"], cache["cross_k"],
                                    cache["cross_v"], cfg, model_axis)
    h = _norm(x, p["norm3"], cfg, use_kernels)
    x = x + apply_mlp(h, p["mlp"], cfg.activation, _mlp_axis(model_axis))
    return x, dict(cache, self=self_cache)


# whisper encoder block: bidirectional self-attn + mlp
def init_encoder_block(generator, cfg: ModelConfig, *, lead=(),
                       device="cpu"):
    kw = dict(lead=lead, device=device)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, **kw),
        "attn": attn.init_attention(generator, cfg, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, **kw),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                        **kw),
    }


def encoder_block_forward(x, p, cfg: ModelConfig, *,
                          use_kernels: bool = True, model_axis=None):
    """``model_axis``: as ``encdec_block_forward``'s."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    x = x + attn.attention_forward(h, p["attn"], cfg, causal=False,
                                   use_kernels=use_kernels,
                                   model_axis=model_axis)
    return _mlp_residual(x, p, cfg, use_kernels, model_axis)
