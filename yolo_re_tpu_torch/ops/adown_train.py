"""Train-mode ADown: the pre-BN block as a `torch.autograd.Function` over
two hand-written kernels (counterpart of yolo_re_tpu/ops/adown_train.py,
`_adown_conv` and `apply_adown_train`).

- forward: `adown_raw` (kernel 5), both branches pre-BN;
- backward: `adown_bwd` (kernel 6): dx through both pooling paths and both
  weight gradients. The Function saves x (not the avgpool output); the
  backward recomputes the avg from it.
- one train BN over the concatenated branch channels, then SiLU; the
  running statistics split back to `conv_stride` and `conv_pool`.

The JAX package folds the avgpool's 1/4 into the weights; the kernels here
apply it to the window sums, so the weights and their gradients are the
raw ones. In JAX the pair is opt-in on the TPU; in the port every
train-mode ADown takes it.

Compute dtype: the Function takes the f32 master weights and x in the
compute dtype. The forward packs the weights for the kernel, cast to x's
dtype, in one launch (`adown_raw`); the backward reads them cast to x's
dtype too, and returns the weight gradients in the weights' dtype.
"""

from __future__ import annotations

import torch

from yolo_re_tpu_torch.ops.conv import (
    batch_count,
    batch_moments,
    bn_affine,
    silu,
    update_running_stats,
)
from yolo_re_tpu_torch.ops.kernels import adown as adown_kernel


class ADownRaw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
        w1, w2 = w1.contiguous(), w2.contiguous()
        ctx.save_for_backward(x, w1, w2)
        return adown_kernel.adown_raw(x, w1, w2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w1, w2 = ctx.saved_tensors
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx, dw1, dw2 = adown_kernel.adown_bwd(x, g, w1.to(x.dtype),
                                              w2.to(x.dtype))
        return dx, dw1.to(w1.dtype), dw2.to(w2.dtype)


def adown_train(x: torch.Tensor, conv_stride, conv_pool) -> torch.Tensor:
    """Train-mode ADown of the two branch `Conv` modules (each with its
    conv and BN): x (B, Cin, H, W) in the compute dtype -> SiLU(BN(pre-BN
    concat)), (B, 2*Co, H//2, W//2), with both BNs' running stats
    updated from their halves of one batch-moment pass."""
    cs, cp = conv_stride, conv_pool
    y = ADownRaw.apply(x.contiguous(memory_format=torch.channels_last),
                       cs.conv.weight, cp.conv.weight)
    half = y.shape[1] // 2
    mean, var = batch_moments(y)
    n = batch_count(y)
    update_running_stats(cs.bn, mean[:half], var[:half], n)
    update_running_stats(cp.bn, mean[half:], var[half:], n)
    y = bn_affine(y, mean, var, torch.cat([cs.bn.weight, cp.bn.weight]),
                  torch.cat([cs.bn.bias, cp.bn.bias]))
    return silu(y)
