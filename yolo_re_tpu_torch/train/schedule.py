"""Warmup + cosine LR/momentum schedule (counterpart of
yolo_re_tpu/train/schedule.py; reference src/yolo/train/scheduler.py:74-121),
as plain math evaluated on the host once per step.

Semantics cloned exactly, including the reference quirk that the first
optimizer step runs at the base LR/momentum (its Trainer calls
`scheduler.step()` after `optimizer.step()`): update k uses schedule(k)
with schedule(0) = base values. The bias group warms from
`warmup_bias_lr`, the others from 0; momentum warms 0.8 -> base.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class WarmupCosineSchedule:
    base_lr: float
    total_steps: int
    warmup_steps: int
    warmup_momentum: float = 0.8
    base_momentum: float = 0.937
    warmup_bias_lr: float = 0.1
    lrf: float = 0.01

    def _cosine(self, step: float) -> float:
        denom = max(self.total_steps - self.warmup_steps, 1)
        progress = min(max((step - self.warmup_steps) / denom, 0.0), 1.0)
        return self.lrf + (1 - self.lrf) * 0.5 * (1 + math.cos(
            math.pi * progress))

    def __call__(self, step: int) -> tuple[float, float, float]:
        """step: 0-based update index -> (lr, bias_lr, momentum)."""
        if step == 0:
            return self.base_lr, self.base_lr, self.base_momentum
        step = float(step)
        if step <= self.warmup_steps and self.warmup_steps > 0:
            xi = step / max(self.warmup_steps, 1)
            return (self.base_lr * xi,
                    self.warmup_bias_lr
                    + (self.base_lr - self.warmup_bias_lr) * xi,
                    self.warmup_momentum
                    + (self.base_momentum - self.warmup_momentum) * xi)
        cos_lr = self.base_lr * self._cosine(step)
        return cos_lr, cos_lr, self.base_momentum


def one_cycle_lr(epoch: float, total_epochs: int, lrf: float = 0.01) -> float:
    """Epoch-based cosine multiplier (reference: scheduler.py:124-138)."""
    return lrf + (1 - lrf) * 0.5 * (1 + math.cos(math.pi * epoch / total_epochs))
