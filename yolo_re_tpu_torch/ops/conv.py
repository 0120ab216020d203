"""Convolution / pooling / resize primitives (counterpart of
yolo_re_tpu/ops/conv.py).

Tensors are NCHW, normally in `torch.channels_last` memory (NHWC bytes, the
layout the CUDA kernels read); conv weights are OIHW. Plain convolutions go
to `F.conv2d`, as the JAX package leaves them to XLA.

BatchNorm numerics follow the reference (eps=1e-3, not torch's 1e-5). For
inference the BN affine folds into the conv (`fold_conv_bn`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(kernel_size: int, padding: int | None = None,
            dilation: int = 1) -> int:
    """'same' padding rule (reference: src/yolo/blocks/conv.py:12-21)."""
    if dilation > 1:
        kernel_size = dilation * (kernel_size - 1) + 1
    if padding is None:
        padding = kernel_size // 2
    return padding


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


_ACTIVATIONS = {
    "silu": silu,
    "none": lambda x: x,
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation: {name}") from None


def conv_bn_act(x: torch.Tensor, conv: torch.nn.Conv2d,
                bn: torch.nn.BatchNorm2d | None, act: str = "silu"
                ) -> torch.Tensor:
    """Conv -> BatchNorm (eval, running stats) -> activation.

    bn=None: the conv carries the folded bias (`fold_conv_bn`). The BN
    affine is written out as in yolo_re_tpu/ops/conv.py:conv_bn_act
    (y * inv + (bias - mean * inv), inv = rsqrt(var + eps) * scale) so the
    two packages round alike.
    """
    y = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    if bn is not None:
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        shift = bn.bias - bn.running_mean * inv
        y = y * inv.to(y.dtype)[:, None, None] + \
            shift.to(y.dtype)[:, None, None]
    return get_activation(act)(y)


def fold_conv_bn(weight: torch.Tensor, bn: torch.nn.BatchNorm2d
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(w * scale/sqrt(var+eps), bias - mean*scale/sqrt(var+eps)), per
    output channel, in f32 (yolo_re_tpu/ops/conv.py:fold_conv_bn)."""
    inv = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    w = weight.float() * inv[:, None, None, None]
    b = bn.bias.float() - bn.running_mean.float() * inv
    return w, b


def max_pool2d(x: torch.Tensor, kernel: int, stride: int,
               padding: int) -> torch.Tensor:
    """Max pool with -inf padding (torch's and the JAX package's rule)."""
    return F.max_pool2d(x, kernel, stride, padding)


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int,
               padding: int = 0) -> torch.Tensor:
    """Average pool; padding counts in the divisor, as in the JAX package
    (which uses padding=0 only)."""
    return F.avg_pool2d(x, kernel, stride, padding, count_include_pad=True)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour integer upsample."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")
