"""Convolution / pooling / resize primitives (counterpart of
yolo_re_tpu/ops/conv.py).

Tensors are NCHW, normally in `torch.channels_last` memory (NHWC bytes, the
layout the CUDA kernels read); conv weights are OIHW. Plain convolutions go
to `F.conv2d`, as the JAX package leaves them to XLA.

BatchNorm numerics follow the reference (eps=1e-3, not torch's 1e-5). For
inference the BN affine folds into the conv (`fold_conv_bn`). Train-mode BN
is written out (`batch_moments`, `update_running_stats`, `bn_affine`) with
the JAX package's rounding points (yolo_re_tpu/ops/conv.py:conv_bn_act):
bf16 activations take one-pass f32 moments of the bf16 conv output, f32
activations two-pass moments; the running variance gets the unbiased batch
variance.

Compute dtype: parameters stay f32 (the master copy); activations carry
the compute dtype (float32 or bfloat16), and every op casts its weights to
the activation's dtype (`w.to(x.dtype)`, differentiable: the gradient
lands on the f32 parameter). The convolutions accumulate in f32.
"""

from __future__ import annotations

import numpy as np
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


def batch_moments(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel batch (mean, biased var) of a pre-BN (B, C, H, W)
    tensor, f32 and differentiable. bf16: one pass, E[y^2] - E[y]^2
    clamped at 0, over the bf16 values; f32: two passes
    (yolo_re_tpu/ops/conv.py:258-282)."""
    yf = y.float()
    mean = yf.mean(dim=(0, 2, 3))
    if y.dtype == torch.bfloat16:
        var = (yf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0)
    else:
        var = (yf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    return mean, var


@torch.no_grad()
def update_running_stats(bn: torch.nn.BatchNorm2d, mean: torch.Tensor,
                         var: torch.Tensor, n: int) -> None:
    """running = (1 - momentum) * running + momentum * batch, with the
    unbiased batch variance (n samples per channel), in place."""
    unbiased = var * (n / max(n - 1, 1))
    bn.running_mean.copy_((1.0 - BN_MOMENTUM) * bn.running_mean
                          + BN_MOMENTUM * mean)
    bn.running_var.copy_((1.0 - BN_MOMENTUM) * bn.running_var
                         + BN_MOMENTUM * unbiased)
    bn.num_batches_tracked.add_(1)


def bn_affine(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y * inv + (bias - mean * inv), inv = rsqrt(var + eps) * weight,
    computed in f32 and applied in y's dtype, as the JAX package does."""
    inv = torch.rsqrt(var + BN_EPS) * weight
    shift = bias - mean * inv
    return y * inv.to(y.dtype)[:, None, None] + \
        shift.to(y.dtype)[:, None, None]


def batch_norm(y: torch.Tensor, bn: torch.nn.BatchNorm2d) -> torch.Tensor:
    """BN of a pre-BN tensor: batch statistics (and a running-stat update)
    when `bn.training`, else the running statistics."""
    if not bn.training:
        return bn_affine(y, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias)
    mean, var = batch_moments(y)
    update_running_stats(bn, mean, var, y.numel() // y.shape[1])
    return bn_affine(y, mean, var, bn.weight, bn.bias)


def conv_bn_act(x: torch.Tensor, conv: torch.nn.Conv2d,
                bn: torch.nn.BatchNorm2d | None, act: str = "silu"
                ) -> torch.Tensor:
    """Conv -> BatchNorm -> activation, in x's dtype.

    bn=None: the conv carries the folded bias (`fold_conv_bn`). The BN
    affine is written out as in yolo_re_tpu/ops/conv.py:conv_bn_act
    (y * inv + (bias - mean * inv), inv = rsqrt(var + eps) * scale) so the
    two packages round alike; in train mode (`bn.training`) it uses batch
    statistics and updates the running ones.
    """
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    if bn is not None:
        y = batch_norm(y, bn)
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


# (in size, out size, device) -> the source index of each output row
_NEAREST_INDEX: dict[tuple[int, int, str], torch.Tensor] = {}


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    key = (n_in, n_out, str(device))
    if key not in _NEAREST_INDEX:
        idx = np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)
        _NEAREST_INDEX[key] = torch.from_numpy(idx).to(device)
    return _NEAREST_INDEX[key]


def interpolate_nearest(x: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """Nearest resize to (out_h, out_w): source index floor(dst * in / out),
    computed in float64 by numpy as yolo_re_tpu/ops/conv.py:
    interpolate_nearest computes it (F.interpolate's float32 scale can
    pick another row at sizes that do not divide). The index tensors are
    made once per size and device, so a CUDA forward copies nothing from
    the host."""
    h, w = x.shape[2], x.shape[3]
    if (out_h, out_w) == (h, w):
        return x
    return x.index_select(2, _nearest_index(h, out_h, x.device)) \
        .index_select(3, _nearest_index(w, out_w, x.device))
