"""Train-mode stem1: the pre-BN stem conv as a `torch.autograd.Function`
over two hand-written kernels (counterpart of yolo_re_tpu/ops/stem_train.py,
`_stem1_conv` and its custom VJP).

- forward: `stem_conv_raw` (kernel 2), conv3x3_s2_p1 of the image, no bias;
- backward: `stem_wgrad` (kernel 3), the f32 weight gradient, and NO input
  gradient: stem1 is the network's first layer and the image is never
  differentiated (the JAX VJP returns zeros for it). The Function refuses
  an input that requires grad.

Train BN and SiLU run outside it in plain PyTorch (`ops/conv.py`), on the
plain NCHW layout: the TPU kernel's row-paired output and the packed BN /
stem2 consumer are not ported.

Compute dtype: the Function takes the f32 master weight and x in the
compute dtype; it runs the kernels in x's dtype and returns the weight
gradient in the weight's dtype.
"""

from __future__ import annotations

import torch

from yolo_re_tpu_torch.ops.kernels import stem as stem_kernel


class StemConvRaw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.w_dtype = w.dtype
        return stem_kernel.stem_conv_raw(x, w.to(x.dtype).contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        return None, stem_kernel.stem_wgrad(x, g).to(ctx.w_dtype)


def stem_conv_raw_train(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, 3, H, W) image in the compute dtype (not requiring grad), w
    the (C, 3, 3, 3) conv weight -> pre-BN (B, C, ceil(H/2), ceil(W/2))
    channels_last in x's dtype; gradients flow to w only."""
    if x.requires_grad:
        raise ValueError(
            "stem_conv_raw_train: the stem input must not require grad (the "
            "first layer's backward computes no input gradient)")
    return StemConvRaw.apply(
        x.contiguous(memory_format=torch.channels_last), w)
