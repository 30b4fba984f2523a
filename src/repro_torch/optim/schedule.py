"""Learning-rate schedules (port of ``repro/optim/schedule.py``): pure
functions of the step counter, in fp32 tensors as the reference's are, so
the cosine and the products round as they do there."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def lr_at(step, cfg: TrainConfig) -> torch.Tensor:
    s = torch.as_tensor(step).float()
    warm = torch.clamp((s + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    elif cfg.schedule == "linear":
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        decay = 1.0 - 0.9 * frac
    else:  # cosine to 10%
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        decay = 0.1 + 0.45 * (1 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * decay
