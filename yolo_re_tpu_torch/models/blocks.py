"""GELAN / YOLOv9 building blocks as `nn.Module`s (counterpart of
yolo_re_tpu/models/blocks.py).

Submodules carry the reference state-dict names that
`yolo_re_tpu/convert/torch_export.py` emits (`conv`, `bn`, `conv1`,
`bottlenecks.0`, `block1.0`, ...), so JAX weights load with `strict=True`
through `yolo_re_tpu_torch.convert.state_dict_from_jax`.

`nn.Module.train()` / `.eval()` select the BN statistics: train mode
normalizes with batch statistics and updates the running ones in place
(ops/conv.py), eval mode uses the running ones. Each block with BN has a
`fuse()` that folds it in place (BN into the conv, RepConv's 3x3 + 1x1
into one 3x3) for inference. Four blocks run hand-written CUDA kernels on
a CUDA tensor: the Cin=3 stem `Conv` (fused: ops/kernels/stem.py; train:
ops/stem_train.py), the fused 64-channel stride-1 3x3 `Conv`
(ops/kernels/conv3.py), the fused `RepNCSP`'s bottleneck loop at 32
channels (ops/kernels/csp_chain.py) and `ADown` (fused:
ops/kernels/adown.py, on weights packed once by `fuse()`; train:
ops/adown_train.py). The gates are the
kernels' geometry; on a CPU tensor each kernel wrapper takes its plain
version. The JAX package's width-packed layouts are not ported: every
block stays NCHW in channels_last memory.

Constructor arguments are the JAX package's block config fields, so the
plan builder passes the same YAML parameters to both packages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolo_re_tpu_torch.ops.adown_train import adown_train
from yolo_re_tpu_torch.ops.conv import (
    BN_EPS,
    BN_MOMENTUM,
    autopad,
    avg_pool2d,
    batch_norm,
    conv_bn_act,
    fold_conv_bn,
    get_activation,
    interpolate_nearest,
    max_pool2d,
    upsample_nearest,
)
from yolo_re_tpu_torch.ops.kernels import adown as adown_kernel
from yolo_re_tpu_torch.ops.kernels import conv3 as conv3_kernel
from yolo_re_tpu_torch.ops.kernels import csp_chain
from yolo_re_tpu_torch.ops.kernels import stem as stem_kernel
from yolo_re_tpu_torch.ops.stem_train import stem_conv_raw_train


def _biased_conv(like: nn.Conv2d, w: torch.Tensor,
                 b: torch.Tensor) -> nn.Conv2d:
    """A biased Conv2d with `like`'s geometry holding (w, b)."""
    conv = nn.Conv2d(like.in_channels, like.out_channels, like.kernel_size,
                     like.stride, like.padding, like.dilation, like.groups,
                     bias=True, device=w.device, dtype=like.weight.dtype)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    return conv


# ---------------------------------------------------------------------------
# Conv
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    """Conv2d(bias=False) + BN(eps=1e-3, mom=0.03) + activation.

    Reference: src/yolo/blocks/conv.py:55-93. After `fuse()` the conv
    carries the folded bias and `bn` is None.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1,
                 padding: int | None = None, groups: int = 1,
                 dilation: int = 1, activation: str = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              autopad(kernel_size, padding, dilation),
                              dilation=dilation, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS,
                                 momentum=BN_MOMENTUM)
        self.activation = activation
        # the stem geometry the CUDA stem kernels compute (C a multiple of
        # 16, at most stem_kernel.MAX_C: 64 in gelan-c, 80 in gelan-e)
        self.is_stem = (in_channels == 3 and kernel_size == 3 and stride == 2
                        and padding in (None, 1) and groups == 1
                        and dilation == 1 and activation == "silu"
                        and out_channels % 16 == 0
                        and out_channels <= stem_kernel.MAX_C)
        # the geometry of the CUDA conv3 kernel (in gelan-c: stage1's two
        # block convs and the bottleneck convs of stage2's and fpn2's CSPs)
        self.is_conv3 = (in_channels == out_channels == conv3_kernel.C
                         and kernel_size == 3 and stride == 1
                         and padding in (None, 1) and groups == 1
                         and dilation == 1 and activation == "silu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn is None and self.is_stem:
            return stem_kernel.stem_conv(
                x.contiguous(memory_format=torch.channels_last),
                self.conv.weight, self.conv.bias)
        if self.bn is None and self.is_conv3:
            return conv3_kernel.conv3_silu_packed(
                x.contiguous(memory_format=torch.channels_last),
                self.conv3_w, self.conv.bias)
        if self.training and self.is_stem:
            # train stem (ops/stem_train.py): kernel forward + weight-grad
            # kernel backward, then train BN and SiLU
            y = stem_conv_raw_train(x, self.conv.weight)
            return get_activation(self.activation)(batch_norm(y, self.bn))
        return conv_bn_act(x, self.conv, self.bn, self.activation)

    def fuse(self) -> None:
        """Fold BN into the conv; at the conv3 kernel's geometry also pack
        its weight once, as a non-persistent buffer (it follows `.to()`;
        the state dict is unchanged)."""
        if self.bn is None:
            return
        w, b = fold_conv_bn(self.conv.weight, self.bn)
        self.conv = _biased_conv(self.conv, w, b)
        self.bn = None
        if self.is_conv3:
            self.register_buffer(
                "conv3_w", conv3_kernel.pack_weights(self.conv.weight.detach()),
                persistent=False)


# ---------------------------------------------------------------------------
# RepConv
# ---------------------------------------------------------------------------

class RepConv(nn.Module):
    """Parallel 3x3 + 1x1 conv branches summed before the activation.

    Reference: src/yolo/blocks/conv.py:109-145. `fuse()` collapses both
    folded branches into the single 3x3 conv `fused`.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 groups: int = 1, activation: str = "silu"):
        super().__init__()
        if kernel_size != 3 or padding != 1:
            raise ValueError("RepConv only supports 3x3 kernels")
        self.conv1 = Conv(in_channels, out_channels, 3, stride, 1, groups,
                          activation="none")
        self.conv2 = Conv(in_channels, out_channels, 1, stride, 0, groups,
                          activation="none")
        self.fused: nn.Conv2d | None = None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = get_activation(self.activation)
        if self.fused is not None:
            return act(self.fused(x))
        return act(self.conv1(x) + self.conv2(x))

    def fuse(self) -> None:
        if self.fused is not None:
            return
        w1, b1 = fold_conv_bn(self.conv1.conv.weight, self.conv1.bn)
        w2, b2 = fold_conv_bn(self.conv2.conv.weight, self.conv2.bn)
        self.fused = _biased_conv(self.conv1.conv, w1 + F.pad(w2, (1, 1, 1, 1)),
                                  b1 + b2)
        self.conv1 = None
        self.conv2 = None


# ---------------------------------------------------------------------------
# RepNBottleneck / RepNCSP / RepNCSPELAN4
# ---------------------------------------------------------------------------

class RepNBottleneck(nn.Module):
    """RepConv -> Conv with optional residual (reference:
    src/yolo/blocks/bottleneck.py:26-55)."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, groups: int = 1,
                 kernel_sizes: tuple[int, int] = (3, 3),
                 expansion_ratio: float = 0.5):
        super().__init__()
        hidden = int(out_channels * expansion_ratio)
        self.conv1 = RepConv(in_channels, hidden, kernel_sizes[0], 1)
        self.conv2 = Conv(hidden, out_channels, kernel_sizes[1], 1,
                          groups=groups)
        self.residual = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return x + y if self.residual else y


def _is_chain_bottleneck(b: RepNBottleneck) -> bool:
    """A fused, residual bottleneck of the chain kernel's geometry: two
    32 -> 32 stride-1 3x3 convs with SiLU."""
    if not b.residual or b.conv1.fused is None or b.conv2.bn is not None:
        return False
    return b.conv1.activation == b.conv2.activation == "silu" and all(
        c.in_channels == c.out_channels == csp_chain.C
        and c.kernel_size == (3, 3) and c.stride == (1, 1)
        and c.padding == (1, 1) and c.dilation == (1, 1) and c.groups == 1
        for c in (b.conv1.fused, b.conv2.conv))


class RepNCSP(nn.Module):
    """CSP bottleneck with RepNBottleneck inner blocks (reference:
    src/yolo/blocks/csp.py:28-64).

    `fuse()` (after its bottlenecks are fused) packs the bottlenecks'
    weights for the chain kernel (ops/kernels/csp_chain.py) when every
    bottleneck is residual, 32 channels wide and there are at most four;
    the fused forward then runs the whole loop as one kernel call.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 num_repeats: int = 1, shortcut: bool = True,
                 groups: int = 1, expansion_ratio: float = 0.5):
        super().__init__()
        hidden = int(out_channels * expansion_ratio)
        self.conv1 = Conv(in_channels, hidden, 1, 1)
        self.conv2 = Conv(in_channels, hidden, 1, 1)
        self.conv3 = Conv(2 * hidden, out_channels, 1)
        self.bottlenecks = nn.ModuleList(
            RepNBottleneck(hidden, hidden, shortcut, groups,
                           expansion_ratio=1.0)
            for _ in range(num_repeats))
        self.chain = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.conv1(x)
        if self.chain:
            y1 = csp_chain.bottleneck_chain_packed(
                y1.contiguous(memory_format=torch.channels_last),
                self.chain_w, self.chain_b)
        else:
            for b in self.bottlenecks:
                y1 = b(y1)
        return self.conv3(torch.cat([y1, self.conv2(x)], dim=1))

    def fuse(self) -> None:
        """Pack the fused bottlenecks' weights once into the chain kernel's
        image, as non-persistent buffers (they follow `.to()`; the state
        dict is unchanged)."""
        bots = list(self.bottlenecks)
        if self.chain or not 1 <= len(bots) <= csp_chain.MAX_N or \
                not all(_is_chain_bottleneck(b) for b in bots):
            return
        wp, bias = csp_chain.pack_weights(
            *(torch.stack(ts).detach() for ts in (
                [b.conv1.fused.weight for b in bots],
                [b.conv1.fused.bias for b in bots],
                [b.conv2.conv.weight for b in bots],
                [b.conv2.conv.bias for b in bots])))
        self.register_buffer("chain_w", wp, persistent=False)
        self.register_buffer("chain_b", bias, persistent=False)
        self.chain = True


class RepNCSPELAN4(nn.Module):
    """The GELAN workhorse: split, two CSP+conv branches, 4-way concat.

    Reference: src/yolo/blocks/gelan.py:27-66.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, block_channels: int,
                 num_repeats: int = 1):
        super().__init__()
        h, b = hidden_channels, block_channels
        self.conv_in = Conv(in_channels, h, 1, 1)
        self.block1 = nn.Sequential(RepNCSP(h // 2, b, num_repeats),
                                    Conv(b, b, 3, 1))
        self.block2 = nn.Sequential(RepNCSP(b, b, num_repeats),
                                    Conv(b, b, 3, 1))
        self.conv_out = Conv(h + 2 * b, out_channels, 1, 1)
        self.half = h // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_in(x)
        ya, yb = y[:, :self.half], y[:, self.half:]
        y1 = self.block1(yb)
        y2 = self.block2(y1)
        return self.conv_out(torch.cat([ya, yb, y1, y2], dim=1))


# ---------------------------------------------------------------------------
# SPPELAN
# ---------------------------------------------------------------------------

class SPPELAN(nn.Module):
    """Spatial pyramid pooling: 3 chained MaxPool(5,1,2) + 4-way concat.

    Reference: src/yolo/blocks/sppelan.py:24-52.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int):
        super().__init__()
        self.conv_in = Conv(in_channels, hidden_channels, 1, 1)
        self.conv_out = Conv(4 * hidden_channels, out_channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y0 = self.conv_in(x)
        y1 = max_pool2d(y0, 5, 1, 2)
        y2 = max_pool2d(y1, 5, 1, 2)
        y3 = max_pool2d(y2, 5, 1, 2)
        return self.conv_out(torch.cat([y0, y1, y2, y3], dim=1))


# ---------------------------------------------------------------------------
# ADown
# ---------------------------------------------------------------------------

class ADown(nn.Module):
    """Stride-2 downsample: avgpool -> split -> (3x3 s2 conv | maxpool+1x1).

    Reference: src/yolo/blocks/downsample.py:24-50. Once fused, the whole
    block is one call of the ADown kernel (ops/kernels/adown.py) on the
    weights `fuse()` packed; in train mode it is the kernel pair of
    ops/adown_train.py plus one train BN.
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_stride = Conv(in_channels // 2, out_channels // 2, 3, 2, 1)
        self.conv_pool = Conv(in_channels // 2, out_channels // 2, 1, 1, 0)
        self.packed = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.packed:
            return adown_kernel.adown_packed(
                x.contiguous(memory_format=torch.channels_last),
                self.adown_w1, self.conv_stride.conv.bias, self.adown_w2,
                self.conv_pool.conv.bias)
        if self.training:
            return adown_train(x, self.conv_stride, self.conv_pool)
        x = avg_pool2d(x, 2, 1, 0)
        x1, x2 = x.chunk(2, dim=1)
        y1 = self.conv_stride(x1)
        y2 = self.conv_pool(max_pool2d(x2, 3, 2, 1))
        return torch.cat([y1, y2], dim=1)

    def fuse(self) -> None:
        """Fold both branches' BNs, then pack both weights once for the
        ADown kernel, as non-persistent buffers (`adown_w1`, `adown_w2`:
        they follow `.to()`; the state dict is unchanged)."""
        if self.packed:
            return
        self.conv_stride.fuse()
        self.conv_pool.fuse()
        w1p, w2p = adown_kernel.pack_weights(
            self.conv_stride.conv.weight.detach(),
            self.conv_pool.conv.weight.detach())
        self.register_buffer("adown_w1", w1p, persistent=False)
        self.register_buffer("adown_w2", w2p, persistent=False)
        self.packed = True


# ---------------------------------------------------------------------------
# CBLinear / CBFuse (YOLOv9 auxiliary routing)
# ---------------------------------------------------------------------------

class CBLinear(nn.Module):
    """One biased conv projecting to sum(out_channels_list), returned as a
    tuple of channel slices (reference: src/yolo/blocks/auxiliary.py:30-66).

    The bias is added after the conv in the activations' dtype, as the JAX
    package adds it (yolo_re_tpu/models/blocks.py:629). `fuse()` leaves it
    alone: it has no BN.
    """

    def __init__(self, in_channels: int, out_channels_list: tuple[int, ...],
                 kernel_size: int = 1, stride: int = 1,
                 padding: int | None = None, groups: int = 1):
        super().__init__()
        self.out_channels_list = tuple(out_channels_list)
        self.conv = nn.Conv2d(in_channels, sum(self.out_channels_list),
                              kernel_size, stride,
                              autopad(kernel_size, padding), groups=groups,
                              bias=True)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        c = self.conv
        y = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding,
                     c.dilation, c.groups)
        y = y + c.bias.to(y.dtype)[:, None, None]
        return tuple(torch.split(y, self.out_channels_list, dim=1))


class CBFuse(nn.Module):
    """Take the `idx[i]`-th tensor of each CBLinear tuple, resize it to the
    target's (the last input's) size by nearest neighbour and sum with the
    target (reference: src/yolo/blocks/auxiliary.py:76-114)."""

    def __init__(self, idx: tuple[int, ...]):
        super().__init__()
        self.idx = tuple(idx)

    def forward(self, xs: list) -> torch.Tensor:
        *cb_outputs, target = xs
        h, w = target.shape[2], target.shape[3]
        total = target
        for i, cb in enumerate(cb_outputs):
            total = total + interpolate_nearest(cb[self.idx[i]], h, w)
        return total


# ---------------------------------------------------------------------------
# Concat / Silence / Upsample
# ---------------------------------------------------------------------------

class Concat(nn.Module):
    """Channel concat (reference: src/yolo/blocks/common.py:20-37)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dimension = dimension

    def forward(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, dim=self.dimension)


class Silence(nn.Module):
    """Identity tap (reference: src/yolo/blocks/common.py:40-50)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Upsample(nn.Module):
    """Nearest-neighbour integer upsample (reference uses nn.Upsample)."""

    def __init__(self, scale_factor: int = 2, mode: str = "nearest"):
        super().__init__()
        if mode != "nearest":
            raise ValueError(f"unsupported upsample mode {mode}")
        self.scale_factor = int(scale_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(x, self.scale_factor)


BLOCKS: dict[str, type[nn.Module]] = {
    "Conv": Conv,
    "RepConv": RepConv,
    "RepNBottleneck": RepNBottleneck,
    "RepNCSP": RepNCSP,
    "RepNCSPELAN4": RepNCSPELAN4,
    "SPPELAN": SPPELAN,
    "ADown": ADown,
    "CBLinear": CBLinear,
    "CBFuse": CBFuse,
    "Concat": Concat,
    "Silence": Silence,
    "Upsample": Upsample,
}


def get_block_class(name: str) -> type[nn.Module]:
    try:
        return BLOCKS[name]
    except KeyError:
        raise ValueError(
            f"Unknown block type: {name}. Available: {sorted(BLOCKS)}"
        ) from None


def register_block(name: str, cls: type[nn.Module]) -> None:
    """Register a custom block type for the YAML parser. The plan
    (models/builder.py) hands `cls` its layer's YAML parameters as keyword
    arguments, with `in_channels` set and `out_channels` (and the other
    widths and `num_repeats`) scaled by the model's multipliers, as for
    the blocks above; the layer's output channels are its
    `out_channels`."""
    BLOCKS[name] = cls
