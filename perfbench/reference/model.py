"""Plain PyTorch reference of the GELAN / YOLOv9 detectors the benchmark
runs: the network a configuration's layer list describes, written as
functions over a flat dict of tensors keyed by the published state-dict
names (`layers.<layer>.<module path>.<tensor>`).

It follows WongKinYiu/yolov9's blocks (Conv = conv + BN(eps 1e-3) + SiLU,
RepConv, RepNCSP, RepNCSPELAN4, SPPELAN, ADown, CBLinear, CBFuse and the
DFL detect heads), in float32, with no kernels, no BN folding and no
batching tricks: BN is applied as written, in eval mode with the running
statistics and in train mode with the batch's (biased) moments.

`precision="fp8"` is the control of the correctness check, the step
below the bfloat16 the configurations state: the network computed as a
float8 program would, every tensor it stores (each convolution's input,
weight and output, each BN and activation output) rounded to float8 e4m3
under one scale per tensor (amax / 448), the arithmetic in float32.
`precision="bf16"` is a witness of the bfloat16 the configurations state:
the same tensors rounded to bfloat16, and in training each of their
gradients too, the arithmetic in float32. `precision="bf16_affine"` also
applies BN with the rounding points of a bfloat16 program that keeps the
affine form: one-pass moments E[y^2] - E[y]^2 of the rounded y, then
y x scale + shift, each product and sum rounded.

It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
REG_MAX = 16
E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in f32;
    the gradient passes the rounding unchanged (straight through)."""
    with torch.no_grad():
        scale = x.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


class _RoundBF16(torch.autograd.Function):
    """x rounded to bfloat16 and back; its gradient rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return _RoundBF16.apply(x)


STORE = {"f32": lambda x: x, "fp8": fake_fp8, "bf16": round_bf16,
         "bf16_affine": round_bf16}


@dataclass
class Run:
    """What one forward reads: the tensors, train or eval BN, and the
    precision of the convolutions."""

    sd: dict
    train: bool = False
    precision: str = "f32"

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """x as the precision keeps it between operations."""
        return STORE[self.precision](x)

    def conv(self, key: str, x: torch.Tensor, stride: int = 1,
             padding: int = 0, groups: int = 1) -> torch.Tensor:
        w = self.sd[key + ".weight"]
        b = self.sd.get(key + ".bias")
        return self.store(F.conv2d(self.store(x), self.store(w), b, stride,
                                   padding, 1, groups))

    def mark(self, key: str, x, y) -> None:
        """Called with each block's input and output (a Conv, a RepNCSP, a
        layer); the shape counter (lib/flops.py) records them."""

    def bn(self, key: str, y: torch.Tensor) -> torch.Tensor:
        affine = self.precision == "bf16_affine"
        if self.train:
            mean = y.mean(dim=(0, 2, 3))
            var = (y.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(
                min=0) if affine else \
                (y - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        else:
            mean = self.sd[key + ".running_mean"]
            var = self.sd[key + ".running_var"]
        inv = self.sd[key + ".weight"] / torch.sqrt(var + BN_EPS)
        if affine:
            shift = self.sd[key + ".bias"] - mean * inv
            return self.store(self.store(y * self.store(inv)[:, None, None])
                              + self.store(shift)[:, None, None])
        return self.store((y - mean[:, None, None]) * inv[:, None, None]
                          + self.sd[key + ".bias"][:, None, None])


# ---------------------------------------------------------------------------
# the tensors each block holds: (name, shape, kind); kind is "conv" (a
# convolution weight, fan-in from its shape), "bias" (a convolution bias),
# "bn_w", "bn_b", "bn_mean", "bn_var" or "count"
# ---------------------------------------------------------------------------

def _conv_bn_spec(p: str, ci: int, co: int, k: int, g: int = 1) -> list:
    return [(f"{p}.conv.weight", (co, ci // g, k, k), "conv"),
            (f"{p}.bn.weight", (co,), "bn_w"),
            (f"{p}.bn.bias", (co,), "bn_b"),
            (f"{p}.bn.running_mean", (co,), "bn_mean"),
            (f"{p}.bn.running_var", (co,), "bn_var"),
            (f"{p}.bn.num_batches_tracked", (), "count")]


def _conv_bn_act(r: Run, p: str, x, k: int, s: int = 1, g: int = 1,
                 act: bool = True):
    y = r.bn(p + ".bn", r.conv(p + ".conv", x, s, k // 2, g))
    y = r.store(F.silu(y)) if act else y
    r.mark(p, x, y)
    return y


def _repncsp_spec(p, ci, co, n):
    h = co // 2
    spec = (_conv_bn_spec(f"{p}.conv1", ci, h, 1)
            + _conv_bn_spec(f"{p}.conv2", ci, h, 1)
            + _conv_bn_spec(f"{p}.conv3", 2 * h, co, 1))
    for i in range(n):
        q = f"{p}.bottlenecks.{i}"
        spec += (_conv_bn_spec(f"{q}.conv1.conv1", h, h, 3)
                 + _conv_bn_spec(f"{q}.conv1.conv2", h, h, 1)
                 + _conv_bn_spec(f"{q}.conv2", h, h, 3))
    return spec


def _repncsp(r: Run, p: str, x, n: int):
    y1 = _conv_bn_act(r, p + ".conv1", x, 1)
    for i in range(n):
        q = f"{p}.bottlenecks.{i}"
        rep = F.silu(_conv_bn_act(r, q + ".conv1.conv1", y1, 3, act=False)
                     + _conv_bn_act(r, q + ".conv1.conv2", y1, 1, act=False))
        y1 = y1 + _conv_bn_act(r, q + ".conv2", rep, 3)
    y = _conv_bn_act(r, p + ".conv3",
                     torch.cat([y1, _conv_bn_act(r, p + ".conv2", x, 1)], 1),
                     1)
    r.mark(p, x, y)
    return y


def _head_widths(c0: int, nc: int) -> tuple[int, int]:
    c2 = math.ceil(max(c0 // 4, REG_MAX * 4, 16) / 4) * 4
    return c2, max(c0, min(nc * 2, 128))


def _towers_spec(p, chans, nc):
    c2, c3 = _head_widths(chans[0], nc)
    spec = []
    for i, ch in enumerate(chans):
        b, c = f"{p}box_convs.{i}", f"{p}cls_convs.{i}"
        spec += (_conv_bn_spec(f"{b}.0", ch, c2, 3)
                 + _conv_bn_spec(f"{b}.1", c2, c2, 3, 4)
                 + [(f"{b}.2.weight", (4 * REG_MAX, c2 // 4, 1, 1), "conv"),
                    (f"{b}.2.bias", (4 * REG_MAX,), "box_bias")]
                 + _conv_bn_spec(f"{c}.0", ch, c3, 3)
                 + _conv_bn_spec(f"{c}.1", c3, c3, 3)
                 + [(f"{c}.2.weight", (nc, c3, 1, 1), "conv.cls"),
                    (f"{c}.2.bias", (nc,), f"cls_bias.{i}")])
    return spec


def _towers(r: Run, p: str, feats) -> list:
    out = []
    for i, x in enumerate(feats):
        b, c = f"{p}box_convs.{i}", f"{p}cls_convs.{i}"
        yb = _conv_bn_act(r, b + ".1", _conv_bn_act(r, b + ".0", x, 3), 3, g=4)
        yc = _conv_bn_act(r, c + ".1", _conv_bn_act(r, c + ".0", x, 3), 3)
        out.append((r.conv(b + ".2", yb, groups=4), r.conv(c + ".2", yc)))
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

@dataclass
class Node:
    name: str
    type: str
    inputs: tuple
    args: dict
    out_ch: int
    scale: int
    spec: list = field(default_factory=list)


class Network:
    """The network of a configuration's layer list (the YAML schema:
    named layers, `from:` edges, the previous layer by default)."""

    def __init__(self, cfg: dict):
        if cfg.get("depth_multiplier", 1.0) != 1.0 or \
                cfg.get("width_multiplier", 1.0) != 1.0:
            raise ValueError("the reference takes published widths only")
        self.nc = int(cfg["num_classes"])
        self.nodes: list[Node] = []
        ch, sc, prev = {"input": 3}, {"input": 1}, "input"
        for ld in cfg["layers"]:
            ld = dict(ld)
            name, typ = ld.pop("name"), ld.pop("type")
            frm = ld.pop("from", prev)
            ins = tuple(frm) if isinstance(frm, list) else (frm,)
            node = self._node(name, typ, ins, ld, [ch[i] for i in ins],
                              [sc[i] for i in ins])
            self.nodes.append(node)
            ch[name], sc[name], prev = node.out_ch, node.scale, name
        self.head = self.nodes[-1]
        if not self.head.type.endswith("DetectDFL"):
            raise ValueError("the last layer must be the detect head")

    def _node(self, name, typ, ins, a, cin, sin) -> Node:
        p = f"layers.{name}"
        c, s = cin[0], sin[0]
        if typ == "Conv":
            k, st = a.get("kernel_size", 1), a.get("stride", 1)
            co = a["out_channels"]
            return Node(name, typ, ins, {"k": k, "s": st}, co, s * st,
                        _conv_bn_spec(p, c, co, k))
        if typ == "RepNCSPELAN4":
            h, b, n = a["hidden_channels"], a["block_channels"], \
                a.get("num_repeats", 1)
            co = a["out_channels"]
            spec = (_conv_bn_spec(f"{p}.conv_in", c, h, 1)
                    + _repncsp_spec(f"{p}.block1.0", h // 2, b, n)
                    + _conv_bn_spec(f"{p}.block1.1", b, b, 3)
                    + _repncsp_spec(f"{p}.block2.0", b, b, n)
                    + _conv_bn_spec(f"{p}.block2.1", b, b, 3)
                    + _conv_bn_spec(f"{p}.conv_out", h + 2 * b, co, 1))
            return Node(name, typ, ins, {"h": h, "n": n}, co, s, spec)
        if typ == "SPPELAN":
            h, co = a["hidden_channels"], a["out_channels"]
            return Node(name, typ, ins, {}, co, s,
                        _conv_bn_spec(f"{p}.conv_in", c, h, 1)
                        + _conv_bn_spec(f"{p}.conv_out", 4 * h, co, 1))
        if typ == "ADown":
            co = a["out_channels"]
            return Node(name, typ, ins, {}, co, s * 2,
                        _conv_bn_spec(f"{p}.conv_stride", c // 2, co // 2, 3)
                        + _conv_bn_spec(f"{p}.conv_pool", c // 2, co // 2, 1))
        if typ == "CBLinear":
            outs = tuple(a["out_channels_list"])
            return Node(name, typ, ins, {"outs": outs}, outs[-1], s,
                        [(f"{p}.conv.weight", (sum(outs), c, 1, 1), "conv"),
                         (f"{p}.conv.bias", (sum(outs),), "bias")])
        if typ == "CBFuse":
            return Node(name, typ, ins, {"idx": tuple(a["idx"])}, cin[-1],
                        sin[-1])
        if typ == "Concat":
            return Node(name, typ, ins, {}, sum(cin), s)
        if typ == "Upsample":
            f = int(a.get("scale_factor", 2))
            return Node(name, typ, ins, {"f": f}, c, s // f)
        if typ == "Silence":
            return Node(name, typ, ins, {}, c, s)
        if typ == "DetectDFL":
            return Node(name, typ, ins, {"strides": tuple(sin)}, 0, 0,
                        _towers_spec(f"{p}.", cin, self.nc))
        if typ == "DualDetectDFL":
            n = len(cin) // 2
            return Node(name, typ, ins, {"strides": tuple(sin[n:])}, 0, 0,
                        _towers_spec(f"{p}.aux_", cin[:n], self.nc)
                        + _towers_spec(f"{p}.main_", cin[n:], self.nc))
        raise ValueError(f"the reference has no block {typ}")

    @property
    def strides(self) -> tuple:
        return self.head.args["strides"]

    @property
    def dual(self) -> bool:
        return self.head.type == "DualDetectDFL"

    def spec(self) -> list:
        """Every tensor of the network: (name, shape, kind), in order."""
        return [t for node in self.nodes for t in node.spec]

    # -- forward -----------------------------------------------------------

    def head_inputs(self, main_only: bool) -> tuple:
        ins = self.head.inputs
        return ins[len(ins) // 2:] if main_only and self.dual else ins

    def layers_needed(self, main_only: bool) -> set:
        """The layers the head's (main) inputs depend on, and the head."""
        needed = set(self.head_inputs(main_only)) | {self.head.name}
        for node in reversed(self.nodes[:-1]):
            if node.name in needed:
                needed.update(node.inputs)
        return needed

    def features(self, r: Run, x: torch.Tensor, checkpoint: bool = False,
                 main_only: bool = False):
        """The head's input maps (with `main_only`, those of its main
        branch, computing only the layers they need), from (B, 3, H, W)
        images in [0, 1]. `checkpoint` recomputes each layer in the
        backward instead of keeping its activations (train mode at full
        size)."""
        from torch.utils.checkpoint import checkpoint as ckpt

        needed = self.layers_needed(main_only)
        out = {"input": x}
        for node in self.nodes[:-1]:
            if node.name not in needed:
                continue
            ins = [out[i] for i in node.inputs]
            if checkpoint and node.spec:
                y = ckpt(self._layer, r, node, ins, use_reentrant=False)
            else:
                y = self._layer(r, node, ins)
            r.mark(f"layers.{node.name}", ins[0], y)
            out[node.name] = y
        return [out[i] for i in self.head_inputs(main_only)]

    def _layer(self, r: Run, node: Node, ins: list):
        p, a, x = f"layers.{node.name}", node.args, ins[0]
        t = node.type
        if t == "Conv":
            return _conv_bn_act(r, p, x, a["k"], a["s"])
        if t == "RepNCSPELAN4":
            y = _conv_bn_act(r, p + ".conv_in", x, 1)
            ya, yb = y[:, :a["h"] // 2], y[:, a["h"] // 2:]
            y1 = _conv_bn_act(r, p + ".block1.1",
                              _repncsp(r, p + ".block1.0", yb, a["n"]), 3)
            y2 = _conv_bn_act(r, p + ".block2.1",
                              _repncsp(r, p + ".block2.0", y1, a["n"]), 3)
            return _conv_bn_act(r, p + ".conv_out",
                                torch.cat([ya, yb, y1, y2], 1), 1)
        if t == "SPPELAN":
            ys = [_conv_bn_act(r, p + ".conv_in", x, 1)]
            for _ in range(3):
                ys.append(F.max_pool2d(ys[-1], 5, 1, 2))
            return _conv_bn_act(r, p + ".conv_out", torch.cat(ys, 1), 1)
        if t == "ADown":
            x1, x2 = F.avg_pool2d(x, 2, 1, 0).chunk(2, 1)
            return torch.cat([
                _conv_bn_act(r, p + ".conv_stride", x1, 3, 2),
                _conv_bn_act(r, p + ".conv_pool", F.max_pool2d(x2, 3, 2, 1),
                             1)], 1)
        if t == "CBLinear":
            return tuple(torch.split(r.conv(p + ".conv", x), a["outs"], 1))
        if t == "CBFuse":
            *routes, target = ins
            h, w = target.shape[2:]
            dev = target.device
            for i, route in enumerate(routes):
                src = route[a["idx"][i]]
                rows = torch.arange(h, device=dev) * src.shape[2] // h
                cols = torch.arange(w, device=dev) * src.shape[3] // w
                target = target + src[:, :, rows][:, :, :, cols]
            return target
        if t == "Concat":
            return torch.cat(ins, 1)
        if t == "Upsample":
            return x.repeat_interleave(a["f"], 2).repeat_interleave(a["f"], 3)
        return x                                    # Silence

    def head_maps(self, r: Run, feats, main_only: bool = False) -> dict:
        """{"main": [(box logits, class logits)] per level} and, for a
        dual head, "aux" too unless `main_only` (then `feats` are the main
        branch's)."""
        p = f"layers.{self.head.name}."
        if not self.dual:
            return {"main": _towers(r, p, feats)}
        if main_only:
            return {"main": _towers(r, p + "main_", feats)}
        n = len(feats) // 2
        return {"aux": _towers(r, p + "aux_", feats[:n]),
                "main": _towers(r, p + "main_", feats[n:])}

    def train_maps(self, r: Run, x: torch.Tensor, checkpoint: bool = False):
        return self.head_maps(r, self.features(r, x, checkpoint))

    @torch.no_grad()
    def decoded(self, r: Run, x: torch.Tensor) -> torch.Tensor:
        """Eval: the main branch's (B, A, 4 + nc) predictions, boxes xywh
        in input pixels, class scores sigmoided."""
        feats = self.features(r, x, main_only=True)
        return decode(self.head_maps(r, feats, main_only=True)["main"],
                      self.strides)


def anchors(shapes, strides, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres (A, 2) in grid units, row-major per level, and each
    anchor's stride (A, 1)."""
    pts, col = [], []
    for (h, w), s in zip(shapes, strides):
        gy, gx = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                                torch.arange(w, device=device) + 0.5,
                                indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        col.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(col)


def flat(maps: list) -> torch.Tensor:
    """Per-level (B, C, H, W) -> (B, sum H*W, C), row-major per level."""
    return torch.cat([m.permute(0, 2, 3, 1).reshape(m.shape[0], -1,
                                                    m.shape[1])
                      for m in maps], 1)


def dfl_expect(box_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4 * REG_MAX) bin logits -> (..., 4) expected distances."""
    p = box_logits.unflatten(-1, (4, REG_MAX)).softmax(-1)
    return p @ torch.arange(REG_MAX, dtype=p.dtype, device=p.device)


def decode(maps: list, strides) -> torch.Tensor:
    shapes = [tuple(b.shape[2:]) for b, _ in maps]
    pts, col = anchors(shapes, strides, maps[0][0].device)
    d = dfl_expect(flat([b for b, _ in maps]))
    x1y1, x2y2 = pts - d[..., :2], pts + d[..., 2:]
    xywh = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1) * col
    return torch.cat([xywh, flat([c for _, c in maps]).sigmoid()], -1)
