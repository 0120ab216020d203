"""Stem convolution kernel: SiLU(conv3x3_s2_p1(x) + b), Cin = 3.

Counterpart of the TPU kernel `yolo_re_tpu/ops/pallas/stem_kernel.py`
(`stem_conv`); the CUDA source is `yolo_re_tpu_torch/csrc/stem.cu`.

`stem_conv` takes an NCHW tensor in `torch.channels_last` memory (the
kernel reads NHWC memory) and OIHW weights. A CUDA tensor launches the
hand-written kernel; a CPU tensor takes `stem_conv_plain`, the plain
PyTorch version of the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.kernels import build, common

MAX_C = 256   # csrc/stem.cu keeps the 27 x C weights in shared memory

launches = 0


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 conv + bias + SiLU, cast back to x's dtype."""
    y = F.conv2d(x.float(), w.float(), b.float(), stride=2, padding=1)
    return F.silu(y).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    common.check_dtype(x, "x")
    common.check_channels_last(x, "x")
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"stem_conv: x must be (B, 3, H, W), got "
                         f"{tuple(x.shape)}")
    c = w.shape[0]
    if tuple(w.shape) != (c, 3, 3, 3) or tuple(b.shape) != (c,):
        raise ValueError(f"stem_conv: w must be (C, 3, 3, 3) and b (C,), "
                         f"got {tuple(w.shape)} and {tuple(b.shape)}")
    if c % 16 or c > MAX_C:
        raise ValueError(f"stem_conv: C must be a multiple of 16 and at most "
                         f"{MAX_C}, got {c}")
    for t, name in ((w, "w"), (b, "b")):
        common.check_same(x, t, name)


def stem_conv(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """x (B, 3, H, W) channels_last, w (C, 3, 3, 3), b (C,), all one dtype
    (float32 or bfloat16) -> (B, C, ceil(H/2), ceil(W/2)) channels_last."""
    global launches
    _check(x, w, b)
    if x.device.type == "cpu":
        return stem_conv_plain(x, w, b)
    common.check_cuda(x)
    bsz, _, h, wd = x.shape
    c = w.shape[0]
    y = torch.empty((bsz, c, (h + 1) // 2, (wd + 1) // 2), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_stem_conv(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h,
            wd, c, common.dtype_code(x), common.stream(x))
    build.check(err, "stem_conv")
    launches += 1
    return y
