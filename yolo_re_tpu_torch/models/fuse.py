"""Inference re-parameterization: fold BN into convs, merge RepConv
(counterpart of yolo_re_tpu/models/fuse.py).

Only the two re-parameterizations are ported. The JAX package's TPU
post-passes (the marker keys that route layers to Pallas kernels, the
grouped -> dense head expansion) are not: here a fused `Conv` stem, a
fused 64-channel 3x3 `Conv` and a fused `ADown` take their CUDA kernels by
themselves, a fused `RepNCSP` stacks its bottlenecks' weights for the
chain kernel, and the head's groups=4 convs stay grouped.
"""

from __future__ import annotations

from torch import nn

from yolo_re_tpu_torch.models.blocks import Conv, RepConv, RepNCSP


def fuse_model(model: nn.Module) -> nn.Module:
    """Fuse every RepConv, Conv and RepNCSP of `model` in place; returns
    it."""
    # RepConvs first: each one folds its own two Conv+BN branches; the
    # RepNCSPs last: they stack their fused bottlenecks' weights
    for kind in (RepConv, Conv, RepNCSP):
        for m in [m for m in model.modules() if isinstance(m, kind)]:
            m.fuse()
    return model
