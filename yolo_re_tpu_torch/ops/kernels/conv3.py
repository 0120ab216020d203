"""The 3x3 conv + bias + SiLU kernel at 64 channels, stride 1, padding 1:

    y = SiLU(conv3x3_s1_p1(x; w) + b)

Counterpart of the TPU kernel `conv3_silu` of
`yolo_re_tpu/ops/pallas/conv3_kernel.py`; CUDA source
`yolo_re_tpu_torch/csrc/conv3.cu`. It runs every fused 64 -> 64 stride-1
3x3 `Conv` with SiLU: in gelan-c stage1's two block convs (`block1.1`,
`block2.1`, the sites the TPU kernel was written for) and the bottleneck
convs of stage2's and fpn2's RepNCSPs, six per forward.

It takes NCHW tensors in `torch.channels_last` memory. The kernel reads
its weight as a packed image (`pack_weights`, the wgmma operand layout of
csrc/hopper.cuh), which a fused `Conv` makes once; `conv3_silu` takes an
OIHW weight and packs it first, `conv3_silu_packed` takes the image. A
CUDA tensor launches the hand-written kernel; a CPU tensor takes
`conv3_silu_plain`, plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.kernels import build, common

C = 64          # input and output channels of the kernel

launches = 0


def conv3_silu_plain(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 conv + bias + SiLU, cast back to x's dtype."""
    y = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    return F.silu(y).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, 64, 3, 3) -> the kernel's packed image (36864,)."""
    return common.pack_weights(w)


def unpack_weights(packed: torch.Tensor) -> torch.Tensor:
    """The packed image -> OIHW, read at the kernel's index arithmetic."""
    return common.unpack_weights(packed, C)[0]


def _check(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor) -> None:
    common.check_dtype(x, "x")
    common.check_channels_last(x, "x")
    if x.shape[1] != C:
        raise ValueError(f"conv3_silu: x must be (B, {C}, H, W), got "
                         f"{tuple(x.shape)}")
    if tuple(wp.shape) != (9 * C * C,) or tuple(b.shape) != (C,):
        raise ValueError(f"conv3_silu: the packed weight must be "
                         f"({9 * C * C},) and b ({C},), got "
                         f"{tuple(wp.shape)} and {tuple(b.shape)}")
    common.check_same(x, wp, "w")
    common.check_same(x, b, "b")


def conv3_silu(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """x (B, 64, H, W) channels_last; w (64, 64, 3, 3), b (64,) in x's
    dtype (float32 or bfloat16) -> (B, 64, H, W) channels_last."""
    if tuple(w.shape) != (C, C, 3, 3):
        raise ValueError(f"conv3_silu: w must be {(C, C, 3, 3)}, got "
                         f"{tuple(w.shape)}")
    return conv3_silu_packed(x, pack_weights(w), b)


def conv3_silu_packed(x: torch.Tensor, wp: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """conv3_silu with the weight already packed (`pack_weights`)."""
    global launches
    _check(x, wp, b)
    if x.device.type == "cpu":
        return conv3_silu_plain(x, unpack_weights(wp), b)
    common.check_cuda(x)
    bsz, _, h, wd = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    for t, name in ((x, "x"), (wp, "w"), (b, "b"), (y, "y")):
        common.check_aligned(t, name)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_conv3_silu(
            x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h,
            wd, common.dtype_code(x), common.stream(x))
    build.check(err, "conv3_silu")
    launches += 1
    return y
