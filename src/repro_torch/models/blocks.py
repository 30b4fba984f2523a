"""Per-layer blocks (port of the dense, MoE, SSM and hybrid parts of
``repro/models/blocks.py``): init, forward, prefill and decode for the
dense pre-norm block, the MoE block (phi3.5-MoE: attention, then the
routed experts in place of the MLP), the Mamba1 block (falcon-mamba) and
the Mamba2 block (zamba2, whose shared attention block is a dense
block).  ``use_kernels`` reaches every norm (kernel 6 for RMSNorm on the
card), attention and scan.

Every ``init_*`` makes its leaves with a leading ``lead`` shape, so
``lead=(n_layers,)`` gives the stacked ``[L, ...]`` layout the reference
builds with ``vmap`` (``(G, k)`` for the hybrid's groups); the other
functions take one layer's slice and ignore the keyword arguments of
the other families.  Prefill and decode write a layer's new recurrent
state into its cache slice in place, as attention writes its k/v.  The
MoE block's forward returns ``(x, aux)``, its load-balance loss; its
prefill and decode drop the aux, as serving ignores it.

Under a plan the forward functions take ``model_axis`` (the plan's cut
over the ``model`` axis, ``core.sharding.ModelAxis``) and the MoE block
its ``dispatch`` (``moe.Dispatch``); both are None on one device.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp, apply_norm, init_mlp, init_norm,
)


def init_dense_block(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    kw = dict(lead=lead, device=device)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, **kw),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                        **kw),
        "attn": attn.init_attention(generator, cfg, **kw),
    }


def _norm(x, p, cfg: ModelConfig, use_kernels: bool):
    return apply_norm(x, p, cfg.norm, cfg.norm_eps, use_kernels=use_kernels)


def _mlp_residual(x, p, cfg: ModelConfig, use_kernels: bool,
                  model_axis=None):
    h = _norm(x, p["norm2"], cfg, use_kernels)
    if model_axis is not None and not model_axis.mlp:
        model_axis = None
    return x + apply_mlp(h, p["mlp"], cfg.activation, model_axis)


def dense_block_forward(x, p, cfg: ModelConfig, *, positions=None,
                        window: int = 0, use_kernels: bool = True,
                        model_axis=None):
    """``model_axis`` (``core.sharding.ModelAxis``): the plan's cut of
    the heads and the MLP over the ``model`` axis, None on one device."""
    h = _norm(x, p["norm1"], cfg, use_kernels)
    x = x + attn.attention_forward(h, p["attn"], cfg, positions=positions,
                                   window=window, use_kernels=use_kernels,
                                   model_axis=model_axis)
    return _mlp_residual(x, p, cfg, use_kernels, model_axis)


def dense_block_prefill(x, p, cfg: ModelConfig, *, positions=None, cache,
                        window: int = 0, use_kernels: bool = True):
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, cache = attn.attention_prefill(h, p["attn"], cfg, positions=positions,
                                      cache=cache, window=window,
                                      use_kernels=use_kernels)
    return _mlp_residual(x + a, p, cfg, use_kernels), cache


def dense_block_decode(x, p, cfg: ModelConfig, *, cache, window: int = 0,
                       use_kernels: bool = True):
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, cache = attn.attention_decode(h, p["attn"], cfg, cache=cache,
                                     window=window, use_kernels=use_kernels)
    return _mlp_residual(x + a, p, cfg, use_kernels), cache


# --------------------------------------------------------------------- #
# MoE (phi3.5-moe: norm -> attention -> residual, norm -> experts ->
# residual)
# --------------------------------------------------------------------- #

def init_moe_block(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    kw = dict(lead=lead, device=device)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, **kw),
        "moe": moe_mod.init_moe(generator, cfg, **kw),
        "attn": attn.init_attention(generator, cfg, **kw),
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
    x = x + attn.attention_forward(h, p["attn"], cfg, positions=positions,
                                   window=window, use_kernels=use_kernels,
                                   model_axis=model_axis)
    return _moe_residual(x, p, cfg, use_kernels, model_axis, dispatch)


def moe_block_prefill(x, p, cfg: ModelConfig, *, positions=None, cache,
                      window: int = 0, use_kernels: bool = True):
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, cache = attn.attention_prefill(h, p["attn"], cfg, positions=positions,
                                      cache=cache, window=window,
                                      use_kernels=use_kernels)
    return _moe_residual(x + a, p, cfg, use_kernels)[0], cache


def moe_block_decode(x, p, cfg: ModelConfig, *, cache, window: int = 0,
                     use_kernels: bool = True):
    h = _norm(x, p["norm1"], cfg, use_kernels)
    a, cache = attn.attention_decode(h, p["attn"], cfg, cache=cache,
                                     window=window, use_kernels=use_kernels)
    return _moe_residual(x + a, p, cfg, use_kernels)[0], cache


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
                      use_kernels: bool = True, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, new = ssm_mod.mamba1_forward(h, p["mamba"], cfg, state=cache,
                                    use_kernels=use_kernels)
    return x + y, _store(cache, new)


def ssm_block_decode(x, p, cfg: ModelConfig, *, cache,
                     use_kernels: bool = True, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, new = ssm_mod.mamba1_decode(h, p["mamba"], cfg, state=cache)
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
                         use_kernels: bool = True, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, new = ssm_mod.mamba2_forward(h, p["mamba"], cfg, state=cache,
                                    use_kernels=use_kernels)
    return x + y, _store(cache, new)


def mamba2_block_decode(x, p, cfg: ModelConfig, *, cache,
                        use_kernels: bool = True, **_):
    h = _norm(x, p["norm"], cfg, use_kernels)
    y, new = ssm_mod.mamba2_decode(h, p["mamba"], cfg, state=cache)
    return x + y, _store(cache, new)
