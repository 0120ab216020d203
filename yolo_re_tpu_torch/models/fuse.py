"""Inference re-parameterization: fold BN into convs, merge RepConv
(counterpart of yolo_re_tpu/models/fuse.py).

Only the two re-parameterizations are ported. The JAX package's TPU
post-passes (the marker keys that route layers to Pallas kernels, the
grouped -> dense head expansion) are not: here a fused `Conv` stem and a
fused `ADown` take their CUDA kernels by themselves, and the head's
groups=4 convs stay grouped.
"""

from __future__ import annotations

from torch import nn

from yolo_re_tpu_torch.models.blocks import Conv, RepConv


def fuse_model(model: nn.Module) -> nn.Module:
    """Fuse every RepConv and Conv of `model` in place; returns it."""
    # RepConvs first: each one folds its own two Conv+BN branches
    for m in [m for m in model.modules() if isinstance(m, RepConv)]:
        m.fuse()
    for m in [m for m in model.modules() if isinstance(m, Conv)]:
        m.fuse()
    return model
