"""ADown kernels: the whole ADown block, inference and train.

    a = avgpool(2, 1, 0)(x);  a1, a2 = channel halves of a
    y = concat(SiLU(conv3x3_s2_p1(a1; w1) + b1),
               SiLU(conv1x1(maxpool(3, 2, 1)(a2); w2) + b2))

- `adown_packed`: the inference block above (TPU kernel
  `adown_from_packed` of `yolo_re_tpu/ops/pallas/adown_kernel.py`); CUDA
  source `yolo_re_tpu_torch/csrc/adown.cu`;
- `adown_raw`: the pre-BN train forward, both branches without bias and
  SiLU (`adown_from_packed(raw=True)`); the same source in raw mode;
- `adown_bwd`: its backward, dx and both f32 weight gradients
  (`adown_bwd_from_packed` of `adown_train_kernel.py`); `csrc/adown_bwd.cu`.

They take NCHW tensors in `torch.channels_last` memory. The forward
kernels read the weights of both branches as packed images
(`pack_weights`: the wgmma operand layout of csrc/hopper.cuh, input
channels padded to a multiple of 16, output channels to 128 or a multiple
of 256), which a fused `ADown` makes once; `adown` takes OIHW weights and
packs them first, as `adown_raw` does on every call (the train weights
change every step), in one launch that also casts them to x's dtype
(`pack_launches`). A CUDA tensor launches the hand-written kernels, which
keep the stride-1 avgpool out of device memory; a CPU tensor takes the
`*_plain` versions, plain PyTorch. `adown_packed`, on the serving path,
does so through the custom op `yolo_torch::adown_packed` (so that
`torch.export` keeps the kernel in the graph), whose dispatcher picks the
device's implementation. The maxpool gradient goes to the first
maximum of each window in row-major order (PyTorch's max_pool2d rule,
XLA's select_and_scatter). Each kernel has its own launch counter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.kernels import build, common

launches = 0        # adown_packed (and adown)
raw_launches = 0    # adown_raw
bwd_launches = 0    # adown_bwd
pack_launches = 0   # pack_weights on a CUDA tensor (adown, adown_raw)
# output-pixel slabs of the weight-gradient products in csrc/adown_bwd.cu
BWD_SLAB_PIXELS = 4096
BWD_MAX_SLABS = 64
# the bf16 weight-gradient product (csrc/adown_bwd.cu: dw_bf16): channels
# a block, pixels a K chunk, blocks an SM
BWD_BF16_TILE, BWD_BF16_CHUNK, BWD_BF16_BLOCKS_PER_SM = 128, 64, 2


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


def packed_sizes(ch: int, co: int) -> tuple[int, int]:
    """(k, n) of the packed images of a branch of ch -> co channels: ch
    padded to a multiple of 16 (a wgmma k-step), co to 128 or a multiple of
    256 (the N of csrc/adown.cu's tensor-core kernel: `packed_n`)."""
    return -(-ch // 16) * 16, 128 if co <= 128 else -(-co // 256) * 256


def pack_weights_plain(w1: torch.Tensor, w2: torch.Tensor,
                       dtype: torch.dtype | None = None):
    """The plain version of `pack_weights`."""
    k, n = packed_sizes(w1.shape[1], w1.shape[0])
    dtype = w1.dtype if dtype is None else dtype
    return (common.pack_weights(w1.to(dtype), n, k),
            common.pack_weights(w2.to(dtype), n, k))


def pack_weights(w1: torch.Tensor, w2: torch.Tensor,
                 dtype: torch.dtype | None = None):
    """OIHW w1 (Co, Ch, 3, 3), w2 (Co, Ch, 1, 1), float32 or bfloat16 ->
    the packed images (w1p, w2p) the forward kernels read, in `dtype`
    (default w1's): (9 k n,) and (k n,), (k, n) = `packed_sizes(Ch, Co)`.
    A CUDA tensor takes one launch of the pack kernel (csrc/adown.cu:
    yolo_adown_pack), which also casts; a CPU tensor the plain version."""
    global pack_launches
    co, ch = w1.shape[:2]
    if tuple(w1.shape) != (co, ch, 3, 3) or tuple(w2.shape) != (co, ch, 1, 1):
        raise ValueError(f"adown pack_weights: w1 must be (Co, Ch, 3, 3) and "
                         f"w2 (Co, Ch, 1, 1), got {tuple(w1.shape)} and "
                         f"{tuple(w2.shape)}")
    dtype = w1.dtype if dtype is None else dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adown pack_weights: dtype must be float32 or "
                        f"bfloat16, got {dtype}")
    for t, name in ((w1, "w1"), (w2, "w2")):
        common.check_dtype(t, name)
        if t.device != w1.device or not t.is_contiguous():
            raise ValueError(f"adown pack_weights: {name} must be contiguous "
                             f"on {w1.device}")
    if w1.device.type == "cpu":
        return pack_weights_plain(w1, w2, dtype)
    common.check_cuda(w1)
    k, n = packed_sizes(ch, co)
    w1p = torch.empty(9 * k * n, dtype=dtype, device=w1.device)
    w2p = torch.empty(k * n, dtype=dtype, device=w1.device)
    lib = build.library()
    with torch.cuda.device(w1.device):
        err = lib.yolo_adown_pack(
            w1.data_ptr(), w2.data_ptr(), w1p.data_ptr(), w2p.data_ptr(), co,
            ch, common.dtype_code(w1), common.dtype_code(w1p),
            common.stream(w1))
    build.check(err, "adown pack_weights")
    pack_launches += 1
    return w1p, w2p


def unpack_weights(w1p: torch.Tensor, w2p: torch.Tensor, ch: int, co: int):
    """The packed images -> OIHW (w1, w2), read at the kernels' index
    arithmetic."""
    k, n = packed_sizes(ch, co)
    return (common.unpack_weights(w1p, co, ch, 3, n, k)[0],
            common.unpack_weights(w2p, co, ch, 1, n, k)[0])


def _check_packed(x: torch.Tensor, what: str, w1p: torch.Tensor,
                  w2p: torch.Tensor, co: int) -> None:
    k, n = packed_sizes(x.shape[1] // 2, co)
    for name, t, size in (("w1p", w1p, 9 * k * n), ("w2p", w2p, k * n)):
        if tuple(t.shape) != (size,):
            raise ValueError(f"{what}: {name} must be the packed image "
                             f"({size},), got {tuple(t.shape)}")
        common.check_same(x, t, name)


def _launch(x: torch.Tensor, w1p: torch.Tensor, b1, w2p: torch.Tensor, b2,
            co: int) -> torch.Tensor:
    """One launch of csrc/adown.cu (raw when b1 is None)."""
    common.check_cuda(x)
    bsz, cin, h, w = x.shape
    y = torch.empty((bsz, 2 * co, h // 2, w // 2), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
    for t, name in ((x, "x"), (w1p, "w1p"), (w2p, "w2p"), (y, "y")):
        common.check_aligned(t, name)
    lib = build.library()
    with torch.cuda.device(x.device):
        if b1 is None:
            err = lib.yolo_adown_raw(
                x.data_ptr(), w1p.data_ptr(), w2p.data_ptr(), y.data_ptr(),
                bsz, h, w, cin, 2 * co, common.dtype_code(x),
                common.stream(x))
        else:
            err = lib.yolo_adown(
                x.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
                b2.data_ptr(), y.data_ptr(), bsz, h, w, cin, 2 * co,
                common.dtype_code(x), common.stream(x))
    build.check(err, "adown" if b1 is not None else "adown_raw")
    return y


def adown(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, H, W) channels_last; w1 (Co, Cin/2, 3, 3), b1 (Co,),
    w2 (Co, Cin/2, 1, 1), b2 (Co,), all x's dtype (float32 or bfloat16)
    -> (B, 2*Co, H//2, W//2) channels_last. Packs the weights, then
    `adown_packed`."""
    _check_x(x, "adown")
    _check_weights(x, "adown", True, w1=w1, b1=b1, w2=w2, b2=b2)
    w1p, w2p = pack_weights(w1, w2)
    return adown_packed(x, w1p, b1, w2p, b2)


def adown_packed(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor,
                 w2p: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """`adown` with the weights already packed (`pack_weights`): what a
    fused `ADown` calls, one call of the custom op `yolo_torch::adown_packed`
    (one kernel launch)."""
    _check_packed_call(x, w1p, b1, w2p, b2)
    return _op(x, w1p, b1, w2p, b2)


def _check_packed_call(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor,
                       w2p: torch.Tensor, b2: torch.Tensor) -> None:
    common.check_device(x)
    _check_x(x, "adown")
    co = b1.shape[0] if b1.dim() == 1 else -1
    if tuple(b2.shape) != (co,):
        raise ValueError(f"adown: b1 and b2 must be (Co,), got "
                         f"{tuple(b1.shape)} and {tuple(b2.shape)}")
    _check_packed(x, "adown", w1p, w2p, co)
    common.check_same(x, b1, "b1")
    common.check_same(x, b2, "b2")


@torch.library.custom_op("yolo_torch::adown_packed", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor,
        w2p: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The CPU implementation: the plain version on the unpacked weights."""
    w1, w2 = unpack_weights(w1p, w2p, x.shape[1] // 2, b1.shape[0])
    return adown_plain(x, w1, b1, w2, b2)


@_op.register_kernel("cuda")
def _op_cuda(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor,
             w2p: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation: one launch of the kernel. The checks are
    repeated here, where storage is real: an exported graph calls the op
    without the wrapper."""
    global launches
    _check_packed_call(x, w1p, b1, w2p, b2)
    y = _launch(x, w1p, b1, w2p, b2, b1.shape[0])
    launches += 1
    return y


@_op.register_fake
def _fake(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor,
          w2p: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    bsz, _, h, w = x.shape
    return torch.empty((bsz, 2 * b1.shape[0], h // 2, w // 2),
                       dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def adown_raw(x: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """The pre-BN train forward: x (B, Cin, H, W) channels_last; w1
    (Co, Cin/2, 3, 3), w2 (Co, Cin/2, 1, 1), float32 or bfloat16, used
    rounded to x's dtype -> concat(conv3x3_s2_p1(a1; w1),
    conv1x1(maxpool(a2); w2)), (B, 2*Co, H//2, W//2) channels_last in x's
    dtype. The CUDA path packs (and casts) the weights in one launch, then
    runs the kernel."""
    global raw_launches
    _check_x(x, "adown_raw")
    _check_weights(x, "adown_raw", False, w1=w1, w2=w2)
    if x.device.type == "cpu":
        return adown_raw_plain(x, w1.to(x.dtype), w2.to(x.dtype))
    w1p, w2p = pack_weights(w1, w2, x.dtype)
    y = _launch(x, w1p, None, w2p, None, w1.shape[0])
    raw_launches += 1
    return y


def _bwd_slabs(n: int, ch: int, co: int, device: torch.device) -> int:
    """Slabs of the bf16 weight-gradient product: as many as keep its
    blocks (10 taps x channel tiles a slab) within the whole rounds of
    resident blocks that slabs of BWD_SLAB_PIXELS pixels take, at most
    BWD_MAX_SLABS and one K chunk a slab. On an H100 (264 resident
    blocks): gelan-c's down3 6 slabs, 240 blocks (4 slabs, 160 blocks,
    would leave 104 block slots idle), pan_down1 26 (not 13)."""
    per_slab = 10 * -(-ch // BWD_BF16_TILE) * -(-co // BWD_BF16_TILE)
    resident = BWD_BF16_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count
    slabs = -(-n // BWD_SLAB_PIXELS)
    rounds = -(-slabs * per_slab // resident)
    return max(1, min(max(slabs, rounds * resident // per_slab),
                      BWD_MAX_SLABS, -(-n // BWD_BF16_CHUNK)))


def adown_bwd(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor):
    """Backward of `adown_raw`: x (B, Cin, H, W) and the cotangent g
    (B, 2*Co, H//2, W//2), channels_last in one dtype (float32 or
    bfloat16); w1 (Co, Cin/2, 3, 3), w2 (Co, Cin/2, 1, 1) of any float
    dtype. The kernels read them in bf16 for a bf16 call whose Cin/2 and
    Co are multiples of 8 (products on bf16 mma.sync; exact for the bf16
    weights the train forward used), else in f32. Returns (dx like x, dW1
    f32, dW2 f32), summed in a fixed order (the same result on every
    run)."""
    global bwd_launches
    _check_x(x, "adown_bwd")
    _check_weights(x, "adown_bwd", False, w1=w1, w2=w2)
    bsz, cin, h, w = x.shape
    co = w1.shape[0]
    common.check_channels_last(g, "g")
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
    common.check_aligned(x, "x")
    common.check_aligned(g, "g")
    ch, n = cin // 2, bsz * (h // 2) * (w // 2)
    bf16_products = x.dtype == torch.bfloat16 and ch % 8 == 0 and co % 8 == 0
    slabs = _bwd_slabs(n, ch, co, x.device) if bf16_products else \
        max(1, min(BWD_MAX_SLABS, -(-n // BWD_SLAB_PIXELS)))
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dw1 = torch.empty((co, ch, 3, 3), **f32)
    dw2 = torch.empty((co, ch, 1, 1), **f32)
    # the window max in x's dtype: the f32 max rounded once
    pool_max = torch.empty((n, ch), dtype=x.dtype, device=x.device)
    pool_idx = torch.empty((n, ch), dtype=torch.uint8, device=x.device)
    d_max = torch.empty((n, ch), **f32)
    d_avg1 = torch.empty((bsz, h - 1, w - 1, ch), **f32)
    # the branch-1 avg in x's dtype, which the tensor-core weight-gradient
    # products read
    avg1 = torch.empty((bsz, h - 1, w - 1, ch), dtype=x.dtype,
                       device=x.device)
    part = torch.empty((slabs, 10, ch, co), **f32)
    # tap-major weights, (9, Co, Ch) and (Co, Ch), in the dtype of the
    # products (csrc/adown_bwd.cu: yolo_adown_bwd)
    wdt = torch.bfloat16 if bf16_products else torch.float32
    w1t = w1.to(wdt).permute(2, 3, 0, 1).contiguous()
    w2t = w2.to(wdt).reshape(co, ch).contiguous()
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.yolo_adown_bwd(
            x.data_ptr(), g.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
            dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
            pool_max.data_ptr(), pool_idx.data_ptr(), d_max.data_ptr(),
            d_avg1.data_ptr(), avg1.data_ptr(),
            part.data_ptr(), bsz, h, w, cin, 2 * co,
            slabs, common.dtype_code(x), common.stream(x))
    build.check(err, "adown_bwd")
    bwd_launches += 1
    return dx, dw1, dw2
