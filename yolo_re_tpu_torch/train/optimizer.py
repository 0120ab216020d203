"""SGD over the three parameter groups, and global-norm clipping
(counterpart of yolo_re_tpu/train/optimizer.py; reference torch.optim.SGD
over the groups of src/yolo/model/model.py:165-203).

    g = grad + wd * p        (coupled weight decay, 'weight' group only)
    buf = momentum * buf + g
    p  -= lr_group * buf     (bias_lr for 'bias', lr otherwise)

Parameters, gradients and buffers are dicts keyed by parameter name; the
groups come from `YOLO.param_labels()`. The updates are in place and use
PyTorch's multi-tensor (`_foreach`) ops, one launch per group and op.
"""

from __future__ import annotations

import torch


def init_sgd_state(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Zero momentum buffers, one per parameter."""
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


@torch.no_grad()
def sgd_step(params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor],
             bufs: dict[str, torch.Tensor], labels: dict[str, str], *,
             lr: float, bias_lr: float, momentum: float,
             weight_decay: float) -> None:
    """One SGD update of `params` and `bufs`, in place."""
    for group in ("weight", "bn", "bias"):
        names = [k for k in params if labels[k] == group]
        if not names:
            continue
        p = [params[k] for k in names]
        g = [grads[k].float() for k in names]
        b = [bufs[k] for k in names]
        if group == "weight":
            g = torch._foreach_add(g, p, alpha=weight_decay)
        torch._foreach_mul_(b, momentum)
        torch._foreach_add_(b, g)
        torch._foreach_add_(p, b, alpha=-(bias_lr if group == "bias" else lr))


@torch.no_grad()
def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """torch.nn.utils.clip_grad_norm_ semantics (the reference's max_norm
    10): scale = min(1, max_norm / (norm + 1e-6)), applied to every
    gradient. Returns (clipped grads, the norm before clipping)."""
    names = list(grads)
    g = [grads[k].float() for k in names]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return dict(zip(names, torch._foreach_mul(g, scale))), norm
