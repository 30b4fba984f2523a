"""Held-out evaluation (port of ``repro/train/evaluate.py``): perplexity
over a packed dataset, and the mean-pooled hidden-state embeddings that
the paper's vector databases would store (§I)."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.models.model import Model


@torch.no_grad()
def evaluate_perplexity(model: Model, params, loader, *,
                        max_batches: int = 0) -> Dict[str, float]:
    """Token-level NLL and perplexity over (up to) one epoch."""
    total_nll = 0.0
    total_tokens = 0.0
    n = loader.batches_per_epoch if not max_batches \
        else min(max_batches, loader.batches_per_epoch)
    for i in range(n):
        _, metrics = model.loss(params, loader.batch_at(i), remat=False)
        total_nll += float(metrics["ce"]) * float(metrics["tokens"])
        total_tokens += float(metrics["tokens"])
    nll = total_nll / max(total_tokens, 1.0)
    return {"nll": nll, "perplexity": math.exp(min(nll, 30.0)),
            "tokens": total_tokens}


@torch.no_grad()
def embed_texts(model: Model, params, token_batches) -> np.ndarray:
    """Mean-pooled final hidden states (before the final norm) over the
    non-pad tokens.  token_batches: iterable of [B, S] int arrays."""
    outs = []
    for tokens in token_batches:
        h = model.hidden(params, {"tokens": tokens}).float()
        mask = (model._tokens(tokens) > 0).float()[..., None]
        outs.append((torch.sum(h * mask, dim=1)
                     / torch.clamp(torch.sum(mask, dim=1), min=1.0))
                    .cpu().numpy())
    return np.concatenate(outs, axis=0)
