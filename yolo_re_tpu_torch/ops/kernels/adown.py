"""ADown kernel: the whole inference ADown block in one pass.

Counterpart of the TPU kernel `yolo_re_tpu/ops/pallas/adown_kernel.py`
(`adown_from_packed`); the CUDA source is `yolo_re_tpu_torch/csrc/adown.cu`.

    a = avgpool(2, 1, 0)(x);  a1, a2 = channel halves of a
    y = concat(SiLU(conv3x3_s2_p1(a1; w1) + b1),
               SiLU(conv1x1(maxpool(3, 2, 1)(a2); w2) + b2))

`adown` takes an NCHW tensor in `torch.channels_last` memory and the fused
OIHW weights of the block's two convs. A CUDA tensor launches the
hand-written kernel, which keeps the stride-1 avgpool in shared memory; a
CPU tensor takes `adown_plain`, the plain PyTorch version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.kernels import build, common

launches = 0


def adown_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The plain version, in f32, cast back to x's dtype."""
    a = F.avg_pool2d(x.float(), 2, 1, 0)
    a1, a2 = a.chunk(2, dim=1)
    y1 = F.silu(F.conv2d(a1, w1.float(), b1.float(), stride=2, padding=1))
    m = F.max_pool2d(a2, 3, 2, 1)
    y2 = F.silu(F.conv2d(m, w2.float(), b2.float()))
    return torch.cat([y1, y2], dim=1).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def _check(x, w1, b1, w2, b2) -> None:
    common.check_dtype(x, "x")
    common.check_channels_last(x, "x")
    common.check_aligned(x, "x")
    _, cin, h, w = x.shape
    co = w1.shape[0]
    if cin % 2 or h < 2 or w < 2:
        raise ValueError(f"adown: x must be (B, Cin, H, W) with even Cin "
                         f"and H, W >= 2, got {tuple(x.shape)}")
    shapes = {"w1": (co, cin // 2, 3, 3), "b1": (co,),
              "w2": (co, cin // 2, 1, 1), "b2": (co,)}
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"adown: {name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        common.check_same(x, t, name)


def adown(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, H, W) channels_last; w1 (Co, Cin/2, 3, 3), b1 (Co,),
    w2 (Co, Cin/2, 1, 1), b2 (Co,), all x's dtype (float32 or bfloat16)
    -> (B, 2*Co, H//2, W//2) channels_last."""
    global launches
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return adown_plain(x, w1, b1, w2, b2)
    common.check_cuda(x)
    bsz, cin, h, w = x.shape
    cout = 2 * w1.shape[0]
    y = torch.empty((bsz, cout, h // 2, w // 2), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
    # the kernel reads the weights input-channel major, (Cin/2, 3, 3, Co)
    # and (Cin/2, Co), so that a row of output channels is contiguous
    w1t = w1.permute(1, 2, 3, 0).contiguous()
    w2t = w2.reshape(w2.shape[0], cin // 2).t().contiguous()
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_adown(
            x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), y.data_ptr(), bsz, h, w, cin, cout,
            common.dtype_code(x), common.stream(x))
    build.check(err, "adown")
    launches += 1
    return y
