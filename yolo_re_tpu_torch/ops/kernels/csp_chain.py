"""The RepNCSP bottleneck chain kernel at 32 channels: n fused bottlenecks

    r = m;  for i < n:  r = r + SiLU(conv3x3(SiLU(conv3x3(r; w1[i]) + b1[i]);
                                             w2[i]) + b2[i])

with each conv's output rounded to the working dtype and the residual
added in it. Counterpart of the TPU kernel `bottleneck_chain` of
`yolo_re_tpu/ops/pallas/csp_chain_kernel.py`; CUDA source
`yolo_re_tpu_torch/csrc/csp_chain.cu`, which keeps every intermediate on
chip. In gelan-c it runs the bottlenecks of stage1's two RepNCSPs.

It takes NCHW tensors in `torch.channels_last` memory and the OIHW weights
of the n bottlenecks stacked: w1, w2 (n, 32, 32, 3, 3), b1, b2 (n, 32)
(the fused RepConv and the fused Conv of each). The kernel reads the 2n
convs' weights as one packed image (`pack_weights`, the wgmma operand
layout of csrc/hopper.cuh) and the biases stacked (n, 2, 32), which a fused
`RepNCSP` makes once; `bottleneck_chain` packs the OIHW weights first,
`bottleneck_chain_packed` takes the image. A CUDA tensor launches the
hand-written kernel; a CPU tensor takes `bottleneck_chain_plain`, plain
PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.kernels import build, common

C = 32          # channels of the chain
MAX_N = 4       # bottlenecks per launch (csrc/csp_chain.cu's shared memory)

launches = 0


def bottleneck_chain_plain(m: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor) -> torch.Tensor:
    """The plain version: both convs of each bottleneck in f32, each conv's
    output cast to m's dtype, the residual added in m's dtype (the rounding
    points of csp_chain_kernel.py:206-215)."""
    r = m
    for i in range(w1.shape[0]):
        t = F.silu(F.conv2d(r.float(), w1[i].float(), b1[i].float(),
                            padding=1)).to(m.dtype)
        t = F.silu(F.conv2d(t.float(), w2[i].float(), b2[i].float(),
                            padding=1)).to(m.dtype)
        r = r + t
    return r.contiguous(memory_format=torch.channels_last)


def pack_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The stacked OIHW weights -> (the packed image of the 2n convs,
    conv 2i + j (bottleneck i, conv j) at element 9216 * (2i + j); the
    biases (n, 2, 32))."""
    return (common.pack_weights(torch.stack([w1, w2], 1)),
            torch.stack([b1, b2], 1).contiguous())


def unpack_weights(wp: torch.Tensor, bias: torch.Tensor):
    """The packed image and stacked biases -> w1, b1, w2, b2, the weights
    read at the kernel's index arithmetic."""
    w = common.unpack_weights(wp, C).reshape(-1, 2, C, C, 3, 3)
    return w[:, 0], bias[:, 0], w[:, 1], bias[:, 1]


def _check(m: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor) -> None:
    common.check_dtype(m, "m")
    common.check_channels_last(m, "m")
    if m.shape[1] != C:
        raise ValueError(f"bottleneck_chain: m must be (B, {C}, H, W), got "
                         f"{tuple(m.shape)}")
    n = bias.shape[0] if bias.dim() == 3 else 0
    if not 1 <= n <= MAX_N:
        raise ValueError(f"bottleneck_chain: 1 to {MAX_N} bottlenecks, got "
                         f"{n}")
    for name, t, shape in (("w", wp, (n * 2 * 9 * C * C,)),
                           ("b", bias, (n, 2, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"bottleneck_chain: packed {name} must be "
                             f"{shape}, got {tuple(t.shape)}")
        common.check_same(m, t, name)


def bottleneck_chain(m: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """m (B, 32, H, W) channels_last; w1, w2 (n, 32, 32, 3, 3) and b1, b2
    (n, 32) in m's dtype (float32 or bfloat16), 1 <= n <= 4
    -> (B, 32, H, W) channels_last."""
    n = w1.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"bottleneck_chain: 1 to {MAX_N} bottlenecks, got "
                         f"{n}")
    shapes = {"w1": (n, C, C, 3, 3), "b1": (n, C), "w2": (n, C, C, 3, 3),
              "b2": (n, C)}
    for name, t in zip(shapes, (w1, b1, w2, b2)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"bottleneck_chain: {name} must be "
                             f"{shapes[name]}, got {tuple(t.shape)}")
    return bottleneck_chain_packed(m, *pack_weights(w1, b1, w2, b2))


def bottleneck_chain_packed(m: torch.Tensor, wp: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """bottleneck_chain with the weights already packed (`pack_weights`)."""
    global launches
    _check(m, wp, bias)
    if m.device.type == "cpu":
        return bottleneck_chain_plain(m, *unpack_weights(wp, bias))
    common.check_cuda(m)
    bsz, _, h, w = m.shape
    out = torch.empty_like(m, memory_format=torch.channels_last)
    for t, name in ((m, "m"), (wp, "w"), (bias, "b"), (out, "out")):
        common.check_aligned(t, name)
    lib = build.library()
    with torch.cuda.device(m.device):
        err = lib.yolo_csp_chain(
            m.data_ptr(), wp.data_ptr(), bias.data_ptr(), out.data_ptr(),
            bsz, h, w, bias.shape[0], common.dtype_code(m), common.stream(m))
    build.check(err, "bottleneck_chain")
    launches += 1
    return out
