"""Model + input-spec registry (port of ``repro/models/registry.py``):
builds ``Model`` objects and the batch dicts (concrete, or meta tensors
with no storage) for every (arch, input-shape) combination."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import _DTYPES, Model


def build_model(arch_or_cfg, *, use_kernels: bool = True,
                device="cuda") -> Model:
    cfg = arch_or_cfg if isinstance(arch_or_cfg, ModelConfig) \
        else get_config(arch_or_cfg)
    return Model(cfg, device=device, use_kernels=use_kernels)


def abstractify(tree) -> Any:
    """Meta-tensor skeleton of a tree (nested dicts, lists, tuples and
    NamedTuples) of tensors: every leaf a ``torch.empty`` on the meta
    device with the leaf's shape and dtype, no storage; other leaves
    (ints, None) pass through unchanged."""
    if isinstance(tree, dict):
        return {k: abstractify(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(abstractify(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(abstractify(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                abstract: bool = True, rng: np.random.Generator = None,
                device="cuda") -> Dict[str, Any]:
    """Batch dict for a (model, input-shape) pair.

    ``abstract=True`` returns meta tensors (the dry run's inputs, no
    allocation); otherwise concrete random tensors on ``device``, drawn
    from ``rng`` by the reference's calls in the reference's order, so
    the values are the reference's.  Train/prefill shapes give the
    full-sequence batch; decode shapes give the single-token batch (the
    cache comes from ``Model.init_cache``).

    For the stub-frontend families the modality encoder is not built:
    ``patch_embeds`` / ``frames`` are precomputed embeddings of the
    documented shape, and a vision-language model's text is the
    sequence less its ``n_patches``.
    """
    B, S = shape.global_batch, shape.seq_len
    dt = _DTYPES[cfg.dtype]
    if abstract:
        def mk_i(s):
            return torch.empty(s, dtype=torch.int32, device="meta")

        def mk_f(s):
            return torch.empty(s, dtype=dt, device="meta")
    else:
        def mk_i(s):
            return torch.as_tensor(rng.integers(0, min(cfg.vocab_size, 1000),
                                                s), dtype=torch.int32,
                                   device=device)

        def mk_f(s):
            # the reference's float64 draw rounds to fp32 first, as a
            # jnp.asarray of it does with 64-bit floats off
            return torch.as_tensor(
                (rng.standard_normal(s) * 0.02).astype(np.float32),
                device=device).to(dt)

    if shape.kind == "decode":
        return {"tokens": mk_i((B, 1))}

    batch = {}
    s_text = S
    if cfg.family == "vlm":
        s_text = S - cfg.n_patches
        batch["patch_embeds"] = mk_f((B, cfg.n_patches, cfg.vision_dim))
    if cfg.family == "encdec":
        batch["frames"] = mk_f((B, cfg.enc_seq_len, cfg.d_model))
    batch["tokens"] = mk_i((B, s_text))
    if shape.kind == "train":
        batch["labels"] = mk_i((B, s_text))
    return batch
