"""Exponential moving average of the parameters and the BN running
statistics (counterpart of yolo_re_tpu/train/ema.py; reference
src/yolo/train/ema.py): decay ramped as decay * (1 - exp(-updates / tau)),
applied to every parameter and every BN running mean and variance.

The state is {"params": {name: tensor}, "stats": {name: tensor},
"updates": int}, updated in place.
"""

from __future__ import annotations

import numpy as np
import torch


def init_ema(params: dict[str, torch.Tensor],
             stats: dict[str, torch.Tensor]) -> dict:
    return {"params": {k: v.detach().clone() for k, v in params.items()},
            "stats": {k: v.detach().clone() for k, v in stats.items()},
            "updates": 0}


def ema_decay(updates: int, decay: float, tau: float) -> float:
    """The ramped decay, in f32 arithmetic as the JAX package computes it."""
    u = np.float32(updates)
    return float(np.float32(decay) * (np.float32(1.0) - np.exp(
        -u / np.float32(tau), dtype=np.float32)))


@torch.no_grad()
def ema_update(ema: dict, params: dict[str, torch.Tensor],
               stats: dict[str, torch.Tensor], decay: float = 0.9999,
               tau: float = 2000.0) -> None:
    """ema = ema * d + (1 - d) * value, for params and stats, in place."""
    ema["updates"] += 1
    d = ema_decay(ema["updates"], decay, tau)
    for key, src in (("params", params), ("stats", stats)):
        names = list(ema[key])
        e = [ema[key][k] for k in names]
        torch._foreach_mul_(e, d)
        torch._foreach_add_(e, [src[k].detach() for k in names], alpha=1 - d)
