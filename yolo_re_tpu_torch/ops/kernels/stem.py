"""Stem convolution kernels, Cin = 3, 3x3 stride 2 padding 1.

Counterparts of the TPU kernels in `yolo_re_tpu/ops/pallas/stem_kernel.py`:

- `stem_conv`: SiLU(conv(x) + b), the inference stem (`stem_conv_packed`);
  CUDA source `yolo_re_tpu_torch/csrc/stem.cu`;
- `stem_conv_raw`: conv(x), the pre-BN train forward
  (`stem_conv_packed_raw`); the same source in raw mode;
- `stem_wgrad`: the f32 weight gradient of that conv from x and the
  cotangent g (`stem_wgrad_packed`); `csrc/stem_wgrad.cu`.

They take NCHW tensors in `torch.channels_last` memory (the kernels read
NHWC memory; x 16-byte aligned on a card, as a fresh tensor is) and OIHW
weights. A CUDA tensor launches the hand-written kernel; a CPU tensor
takes the `*_plain` version, plain PyTorch. `stem_conv`, on the serving
path, does so through the custom op `yolo_torch::stem_conv` (so that
`torch.export` keeps the kernel in the graph), whose dispatcher picks the
device's implementation. Each kernel has its own launch counter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.kernels import build, common

MAX_C = 256   # csrc/stem.cu: at most four warp ranges of 64 channels
# partial sums of csrc/stem_wgrad.cu, fixed for a device so that the sums
# run in the same order on every call: a persistent grid of this many CTAs
# per SM (at most one per output row)
WGRAD_CTAS_PER_SM = 2

launches = 0          # stem_conv
raw_launches = 0      # stem_conv_raw
wgrad_launches = 0    # stem_wgrad


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 conv + bias + SiLU, cast back to x's dtype."""
    y = F.conv2d(x.float(), w.float(), b.float(), stride=2, padding=1)
    return F.silu(y).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def stem_conv_raw_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of the raw conv: f32 conv, cast to x's dtype."""
    y = F.conv2d(x.float(), w.float(), None, stride=2, padding=1)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def stem_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain weight gradient: autograd of F.conv2d in f32."""
    w = torch.zeros((g.shape[1], 3, 3, 3), device=x.device,
                    requires_grad=True)
    with torch.enable_grad():
        y = F.conv2d(x.detach().float(), w, None, stride=2, padding=1)
        (dw,) = torch.autograd.grad(y, w, g.float())
    return dw


def _check_x(x: torch.Tensor, what: str) -> None:
    common.check_dtype(x, "x")
    common.check_channels_last(x, "x")
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"{what}: x must be (B, 3, H, W), got "
                         f"{tuple(x.shape)}")


def _check_w(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    c = w.shape[0]
    if tuple(w.shape) != (c, 3, 3, 3):
        raise ValueError(f"{what}: w must be (C, 3, 3, 3), got "
                         f"{tuple(w.shape)}")
    if c % 16 or c > MAX_C:
        raise ValueError(f"{what}: C must be a multiple of 16 and at most "
                         f"{MAX_C}, got {c}")
    common.check_same(x, w, "w")


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    common.check_device(x)
    _check_x(x, "stem_conv")
    if tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"stem_conv: b must be (C,), got {tuple(b.shape)}")
    _check_w(x, w, "stem_conv")
    common.check_same(x, b, "b")


def _out_shape(x: torch.Tensor, c: int) -> tuple[int, int, int, int]:
    bsz, _, h, wd = x.shape
    return (bsz, c, (h + 1) // 2, (wd + 1) // 2)


def stem_conv(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """x (B, 3, H, W) channels_last, w (C, 3, 3, 3), b (C,), all one dtype
    (float32 or bfloat16) -> (B, C, ceil(H/2), ceil(W/2)) channels_last.
    One call of the custom op `yolo_torch::stem_conv`."""
    _check(x, w, b)
    return _op(x, w, b)


@torch.library.custom_op("yolo_torch::stem_conv", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CPU implementation: the plain version."""
    return stem_conv_plain(x, w, b)


@_op.register_kernel("cuda")
def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation: one launch of the kernel. The checks are
    repeated here, where storage is real: an exported graph calls the op
    without the wrapper."""
    global launches
    _check(x, w, b)
    common.check_cuda(x)
    common.check_aligned(x, "x")
    bsz, _, h, wd = x.shape
    c = w.shape[0]
    y = torch.empty(_out_shape(x, c), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_stem_conv(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h,
            wd, c, common.dtype_code(x), common.stream(x))
    build.check(err, "stem_conv")
    launches += 1
    return y


@_op.register_fake
def _fake(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.empty(_out_shape(x, w.shape[0]), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


def stem_conv_raw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The pre-BN train forward: x (B, 3, H, W) channels_last, w
    (C, 3, 3, 3) in x's dtype (float32 or bfloat16) -> conv3x3_s2_p1(x),
    (B, C, ceil(H/2), ceil(W/2)) channels_last in x's dtype, rounded once
    from the f32 accumulator. No bias, no activation."""
    global raw_launches
    _check_x(x, "stem_conv_raw")
    _check_w(x, w, "stem_conv_raw")
    if x.device.type == "cpu":
        return stem_conv_raw_plain(x, w)
    common.check_cuda(x)
    common.check_aligned(x, "x")
    bsz, _, h, wd = x.shape
    c = w.shape[0]
    y = torch.empty(_out_shape(x, c), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_stem_conv_raw(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), bsz, h, wd, c,
            common.dtype_code(x), common.stream(x))
    build.check(err, "stem_conv_raw")
    raw_launches += 1
    return y


def stem_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of `stem_conv_raw`: x (B, 3, H, W) and the cotangent
    g (B, C, ceil(H/2), ceil(W/2)), both channels_last in one dtype
    (float32 or bfloat16) -> dW (C, 3, 3, 3) float32, summed in a fixed
    order (the same result on every run on one device). C must be a
    multiple of 16 (the bf16 kernel's channel tiles), as for `stem_conv`."""
    global wgrad_launches
    _check_x(x, "stem_wgrad")
    common.check_channels_last(g, "g")
    c = g.shape[1]
    if tuple(g.shape) != _out_shape(x, c) or c > MAX_C or c % 16 or \
            g.shape[0] * g.shape[2] * g.shape[3] >= 2 ** 31:
        raise ValueError(f"stem_wgrad: g must be {_out_shape(x, c)} with "
                         f"C a multiple of 16, at most {MAX_C}, and fewer "
                         f"than 2^31 pixels, got {tuple(g.shape)}")
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"stem_wgrad: g must be {x.dtype} on {x.device}, "
                         f"got {g.dtype} on {g.device}")
    if x.device.type == "cpu":
        return stem_wgrad_plain(x, g)
    common.check_cuda(x)
    common.check_aligned(x, "x")
    common.check_aligned(g, "g")
    bsz, _, h, wd = x.shape
    nblk = _wgrad_blocks(bsz, g.shape[2], x.device)
    part = torch.empty((nblk, 27, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((c, 3, 3, 3), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_stem_wgrad(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), bsz,
            h, wd, c, nblk, common.dtype_code(x), common.stream(x))
    build.check(err, "stem_wgrad")
    wgrad_launches += 1
    return dw


def _wgrad_blocks(bsz: int, ho: int, device: torch.device) -> int:
    """The partial sums `stem_wgrad`'s kernel writes: one per CTA of its
    persistent grid, WGRAD_CTAS_PER_SM per SM of the device and at most one
    per output row (B * Ho)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(WGRAD_CTAS_PER_SM * sms, bsz * ho)
