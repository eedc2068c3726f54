"""Learning-rate schedules over communication rounds.

Computed with float32 tensor ops in the JAX package's order, so the lr
bits match its ``core/schedules.py``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import FedConfig


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at_round(fed: FedConfig, round_idx: int) -> torch.Tensor:
    """lr(round) as a 0-dim float32 CPU tensor."""
    r = _f32(round_idx)
    total = max(fed.total_rounds, 1)
    warm = fed.warmup_rounds
    base = fed.lr
    if fed.schedule == "const":
        lr = _f32(base)
    elif fed.schedule == "cosine":
        t = torch.clamp((r - warm) / max(total - warm, 1), 0.0, 1.0)
        # cos in double, rounded to fp32 once (correctly rounded).  XLA's
        # fp32 cos agrees with it almost everywhere, torch's fp32 cos is
        # an ulp off more often; a sweep of 4680 (total, warmup, lr,
        # round) points differed at 2 (cos(1.8151425), one ulp)
        cos = torch.cos((_f32(math.pi) * t).double()).float()
        lr = base * 0.5 * (1.0 + cos)
    elif fed.schedule == "wsd":
        decay_start = total * (1.0 - fed.decay_frac)
        t = torch.clamp((r - decay_start) / max(total * fed.decay_frac, 1),
                        0.0, 1.0)
        lr = base * (1.0 - t * (1.0 - 0.1))      # linear decay to 10%
    else:
        raise ValueError(fed.schedule)
    if warm > 0:
        lr = lr * torch.clamp((r + 1.0) / warm, 0.0, 1.0)
    return lr
