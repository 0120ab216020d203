"""ADown kernels: the whole ADown block, inference and train.

    a = avgpool(2, 1, 0)(x);  a1, a2 = channel halves of a
    y = concat(SiLU(conv3x3_s2_p1(a1; w1) + b1),
               SiLU(conv1x1(maxpool(3, 2, 1)(a2); w2) + b2))

- `adown`: the inference block above (TPU kernel `adown_from_packed` of
  `yolo_re_tpu/ops/pallas/adown_kernel.py`); CUDA source
  `yolo_re_tpu_torch/csrc/adown.cu`;
- `adown_raw`: the pre-BN train forward, both branches without bias and
  SiLU (`adown_from_packed(raw=True)`); the same source in raw mode;
- `adown_bwd`: its backward, dx and both f32 weight gradients
  (`adown_bwd_from_packed` of `adown_train_kernel.py`); `csrc/adown_bwd.cu`.

They take NCHW tensors in `torch.channels_last` memory and OIHW weights.
A CUDA tensor launches the hand-written kernel, which keeps the stride-1
avgpool out of device memory; a CPU tensor takes the `*_plain` version,
plain PyTorch. The maxpool gradient goes to the first maximum of each
window in row-major order (PyTorch's max_pool2d rule, XLA's
select_and_scatter). Each kernel has its own launch counter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.kernels import build, common

launches = 0        # adown
raw_launches = 0    # adown_raw
bwd_launches = 0    # adown_bwd
# output-pixel slabs of the weight-gradient products in csrc/adown_bwd.cu
BWD_SLAB_PIXELS = 4096
BWD_MAX_SLABS = 64


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


def _avg(x: torch.Tensor) -> torch.Tensor:
    """avgpool(2, 1, 0), summed as ((x00 + x01) + (x10 + x11)) / 4: the
    order csrc/adown_bwd.cu uses, so both take the first max among the
    same f32 values."""
    return ((x[:, :, :-1, :-1] + x[:, :, :-1, 1:])
            + (x[:, :, 1:, :-1] + x[:, :, 1:, 1:])) * 0.25


def adown_raw_plain(x: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """The plain pre-BN forward, in f32, cast back to x's dtype."""
    a1, a2 = _avg(x.float()).chunk(2, dim=1)
    y1 = F.conv2d(a1, w1.float(), stride=2, padding=1)
    y2 = F.conv2d(F.max_pool2d(a2, 3, 2, 1), w2.float())
    return torch.cat([y1, y2], dim=1).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def adown_bwd_plain(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor):
    """The plain backward: autograd of `adown_raw_plain` in f32.
    Returns (dx in x's dtype, dW1 f32, dW2 f32)."""
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_()
        w1f = w1.detach().float().requires_grad_()
        w2f = w2.detach().float().requires_grad_()
        y = adown_raw_plain(xf, w1f, w2f)
        dx, dw1, dw2 = torch.autograd.grad(y, (xf, w1f, w2f), g.float())
    return dx.to(x.dtype).contiguous(memory_format=torch.channels_last), \
        dw1, dw2


def _check_x(x: torch.Tensor, what: str) -> None:
    common.check_dtype(x, "x")
    common.check_channels_last(x, "x")
    common.check_aligned(x, "x")
    _, cin, h, w = x.shape
    if cin % 2 or h < 2 or w < 2:
        raise ValueError(f"{what}: x must be (B, Cin, H, W) with even Cin "
                         f"and H, W >= 2, got {tuple(x.shape)}")


def _check_weights(x: torch.Tensor, what: str, same_dtype: bool,
                   **weights: torch.Tensor) -> None:
    cin = x.shape[1]
    co = weights["w1"].shape[0]
    shapes = {"w1": (co, cin // 2, 3, 3), "b1": (co,),
              "w2": (co, cin // 2, 1, 1), "b2": (co,)}
    for name, t in weights.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if same_dtype:
            common.check_same(x, t, name)
        elif t.device != x.device:
            raise ValueError(f"{what}: {name} must be on {x.device}")


def _check(x, w1, b1, w2, b2) -> None:
    _check_x(x, "adown")
    _check_weights(x, "adown", True, w1=w1, b1=b1, w2=w2, b2=b2)


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


def adown_raw(x: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """The pre-BN train forward: x (B, Cin, H, W) channels_last; w1
    (Co, Cin/2, 3, 3), w2 (Co, Cin/2, 1, 1) in x's dtype (float32 or
    bfloat16) -> concat(conv3x3_s2_p1(a1; w1), conv1x1(maxpool(a2); w2)),
    (B, 2*Co, H//2, W//2) channels_last in x's dtype."""
    global raw_launches
    _check_x(x, "adown_raw")
    _check_weights(x, "adown_raw", True, w1=w1, w2=w2)
    if x.device.type == "cpu":
        return adown_raw_plain(x, w1, w2)
    common.check_cuda(x)
    bsz, cin, h, w = x.shape
    cout = 2 * w1.shape[0]
    y = torch.empty((bsz, cout, h // 2, w // 2), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
    # input-channel major weights, as for `adown`
    w1t = w1.permute(1, 2, 3, 0).contiguous()
    w2t = w2.reshape(w2.shape[0], cin // 2).t().contiguous()
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_adown_raw(
            x.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), y.data_ptr(), bsz,
            h, w, cin, cout, common.dtype_code(x), common.stream(x))
    build.check(err, "adown_raw")
    raw_launches += 1
    return y


def adown_bwd(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor):
    """Backward of `adown_raw`: x (B, Cin, H, W) and the cotangent g
    (B, 2*Co, H//2, W//2), channels_last in one dtype (float32 or
    bfloat16); w1 (Co, Cin/2, 3, 3), w2 (Co, Cin/2, 1, 1) of any float
    dtype (the kernel reads them as f32). Returns (dx like x, dW1 f32,
    dW2 f32), summed in a fixed order (the same result on every run)."""
    global bwd_launches
    _check_x(x, "adown_bwd")
    _check_weights(x, "adown_bwd", False, w1=w1, w2=w2)
    bsz, cin, h, w = x.shape
    co = w1.shape[0]
    common.check_channels_last(g, "g")
    common.check_aligned(g, "g")
    if tuple(g.shape) != (bsz, 2 * co, h // 2, w // 2) or \
            g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"adown_bwd: g must be {x.dtype} "
                         f"{(bsz, 2 * co, h // 2, w // 2)} on {x.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    # the kernel indexes x, dx and its scratch (all no larger) in 32 bits
    if x.numel() >= 2 ** 31:
        raise ValueError(f"adown_bwd: x must have fewer than 2^31 elements, "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return adown_bwd_plain(x, g, w1, w2)
    common.check_cuda(x)
    ch, n = cin // 2, bsz * (h // 2) * (w // 2)
    slabs = max(1, min(BWD_MAX_SLABS, -(-n // BWD_SLAB_PIXELS)))
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dw1 = torch.empty((co, ch, 3, 3), **f32)
    dw2 = torch.empty((co, ch, 1, 1), **f32)
    pool_max = torch.empty((n, ch), **f32)
    pool_idx = torch.empty((n, ch), dtype=torch.uint8, device=x.device)
    d_max = torch.empty((n, ch), **f32)
    d_avg1 = torch.empty((bsz, h - 1, w - 1, ch), **f32)
    # the bf16 avg of the tensor-core products (bf16 only)
    avg1 = torch.empty((bsz, h - 1, w - 1, ch), dtype=x.dtype,
                       device=x.device) if x.dtype == torch.bfloat16 else None
    part = torch.empty((slabs, 10, ch, co), **f32)
    # tap-major f32 weights: (9, Co, Ch) and (Co, Ch)
    w1t = w1.float().permute(2, 3, 0, 1).contiguous()
    w2t = w2.float().reshape(co, ch).contiguous()
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_adown_bwd(
            x.data_ptr(), g.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
            dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
            pool_max.data_ptr(), pool_idx.data_ptr(), d_max.data_ptr(),
            d_avg1.data_ptr(), None if avg1 is None else avg1.data_ptr(),
            part.data_ptr(), bsz, h, w, cin, 2 * co,
            slabs, common.dtype_code(x), common.stream(x))
    build.check(err, "adown_bwd")
    bwd_launches += 1
    return dx, dw1, dw2
