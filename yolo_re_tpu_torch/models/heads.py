"""Detection heads DetectDFL and DualDetectDFL (counterpart of
yolo_re_tpu/models/heads.py).

Strides are static (from the plan builder), so anchors are numpy constants
built once per feature-map geometry. The eval output is
`(decoded (B, A, 4+nc), raw)`: anchors level by level, row-major over
(h, w) within a level (the JAX order, heads.py:127-135); boxes xywh in
input pixels, class scores sigmoided. `raw` is the reference's per-level
(B, 4*reg_max + nc, H, W) maps.

In train mode the output is the JAX package's train output
(yolo_re_tpu/models/heads.py:197-233): a list of per-level (box, cls) pairs,
(B, 4*reg_max, H, W) and (B, nc, H, W), f32 from `_final_conv`.

The dual head (yolov9-c) holds two tower sets, aux and main, on the same
anchors; its output is the JAX package's dict contract: train
{"aux": pairs, "main": pairs}, eval ({"aux": dec, "main": dec},
{"aux": raw, "main": raw}). Called with `main_only=True` (eval) it takes
the main feature maps alone and runs only its main towers, returning what
the full call returns under "main".

`mode="split"` (eval) returns the flat raw streams instead, for
lazy-decode NMS (ops/nms.py: non_max_suppression_raw): box logits
(B, A, 4*reg_max) and class logits (B, A, nc), f32, anchors in the decoded
output's order (yolo_re_tpu/models/heads.py:127-135, 234-236); a dual head
gives its main branch's, running only its main towers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_re_tpu_torch.models.blocks import Conv
from yolo_re_tpu_torch.ops.boxes import dfl_decode, dist2bbox, make_anchors_np


def _make_divisible(x: float, divisor: int) -> int:
    return math.ceil(x / divisor) * divisor


def head_widths(in_ch0: int, num_classes: int,
                reg_max: int = 16) -> tuple[int, int]:
    """Box/cls tower widths (reference: src/yolo/heads/detect.py:45-46)."""
    c2 = _make_divisible(max(in_ch0 // 4, reg_max * 4, 16), 4)
    c3 = max(in_ch0, min(num_classes * 2, 128))
    return c2, c3


def _final_conv(conv: nn.Conv2d, y: torch.Tensor) -> torch.Tensor:
    """The towers' last biased 1x1 conv, accumulated and returned in f32 as
    in the JAX package (whose head outputs are f32 for bf16 inputs)."""
    return F.conv2d(y.float(), conv.weight.float(), conv.bias.float(),
                    groups=conv.groups)


def flatten_levels(maps: list[torch.Tensor], channels: int) -> torch.Tensor:
    """Per-level (B, C, H, W) maps -> (B, sum(H*W), C), anchors row-major
    over (h, w) within each level."""
    b = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, channels)
                      for m in maps], dim=1)


def _decode(levels, num_classes: int, reg_max: int,
            anchors: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """(box, cls) raw maps per level -> (B, A, 4+nc) decoded predictions
    (semantics of reference src/yolo/heads/detect.py:87-109)."""
    anchor_points, stride_col = anchors
    box_logits, cls_logits = split_streams(levels, num_classes, reg_max)
    dist = dfl_decode(box_logits, reg_max)
    dbox = dist2bbox(dist, anchor_points[None], xywh=True) * stride_col[None]
    return torch.cat([dbox, torch.sigmoid(cls_logits.float())], dim=-1)


def split_streams(levels, num_classes: int, reg_max: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-level (box, cls) maps -> flat (box logits (B, A, 4*reg_max),
    class logits (B, A, nc)) (yolo_re_tpu/models/heads.py:flatten_pairs)."""
    return (flatten_levels([yb for yb, _ in levels], 4 * reg_max),
            flatten_levels([yc for _, yc in levels], num_classes))


def _check_mode(mode: str, training: bool) -> None:
    if mode not in ("full", "split"):
        raise ValueError(f"head mode must be 'full' or 'split', got {mode!r}")
    if mode == "split" and training:
        raise ValueError("head mode 'split' is an eval forward")


def _towers(in_channels: tuple[int, ...], num_classes: int, reg_max: int
            ) -> tuple[nn.ModuleList, nn.ModuleList]:
    """One box and one cls tower per level, sized from the first level's
    channels (reference: src/yolo/heads/detect.py:45-56)."""
    c2, c3 = head_widths(in_channels[0], num_classes, reg_max)
    box = nn.ModuleList(
        nn.Sequential(Conv(ch, c2, 3), Conv(c2, c2, 3, groups=4),
                      nn.Conv2d(c2, 4 * reg_max, 1, groups=4))
        for ch in in_channels)
    cls = nn.ModuleList(
        nn.Sequential(Conv(ch, c3, 3), Conv(c3, c3, 3),
                      nn.Conv2d(c3, num_classes, 1))
        for ch in in_channels)
    return box, cls


def _run_towers(feats, box_convs, cls_convs) -> list:
    """Per-level (box, cls) f32 maps."""
    return [(_final_conv(box[2], box[1](box[0](x))),
             _final_conv(cls[2], cls[1](cls[0](x))))
            for x, box, cls in zip(feats, box_convs, cls_convs)]


class _DFLHead(nn.Module):
    """What both heads share: the static strides, the anchors cache and the
    eval output of one tower set."""

    def __init__(self, num_classes: int, in_channels: tuple[int, ...],
                 strides: tuple[float, ...], reg_max: int):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = tuple(in_channels)
        self.strides = tuple(float(s) for s in strides)
        self.reg_max = reg_max
        self._anchors: dict = {}

    def _init_bias(self, box_convs, cls_convs) -> None:
        """Reference detect.py:111-127: box bias 1.0, cls bias
        log(5 / nc / (640 / stride)^2)."""
        with torch.no_grad():
            for box, cls, s in zip(box_convs, cls_convs, self.strides):
                box[2].bias.fill_(1.0)
                cls[2].bias.fill_(
                    math.log(5 / self.num_classes / (640 / s) ** 2))

    def anchors(self, feat_shapes, device) -> tuple[torch.Tensor, torch.Tensor]:
        key = (tuple(feat_shapes), str(device))
        if key not in self._anchors:
            pts, col = make_anchors_np(feat_shapes, self.strides)
            self._anchors[key] = (torch.from_numpy(pts).to(device),
                                  torch.from_numpy(col).to(device))
        return self._anchors[key]

    def _eval_output(self, levels) -> tuple[torch.Tensor, list]:
        """(decoded (B, A, 4+nc), raw per-level maps) of one tower set."""
        raw = [torch.cat([yb, yc], dim=1) for yb, yc in levels]
        feat_shapes = [(yb.shape[2], yb.shape[3]) for yb, _ in levels]
        decoded = _decode(levels, self.num_classes, self.reg_max,
                          self.anchors(feat_shapes, levels[0][0].device))
        return decoded, raw


class DetectDFL(_DFLHead):
    """Single YOLO DFL head (reference: src/yolo/heads/detect.py:22-127)."""

    def __init__(self, num_classes: int, in_channels: tuple[int, ...],
                 strides: tuple[float, ...], reg_max: int = 16):
        super().__init__(num_classes, in_channels, strides, reg_max)
        self.box_convs, self.cls_convs = _towers(self.in_channels,
                                                 num_classes, reg_max)

    def init_bias(self) -> None:
        self._init_bias(self.box_convs, self.cls_convs)

    def forward(self, feats: list[torch.Tensor], main_only: bool = False,
                mode: str = "full"):
        """`main_only` changes nothing: a single head is its own main
        branch. mode "split" (eval): the flat raw streams."""
        _check_mode(mode, self.training)
        levels = _run_towers(feats, self.box_convs, self.cls_convs)
        if self.training:
            return levels
        if mode == "split":
            return split_streams(levels, self.num_classes, self.reg_max)
        return self._eval_output(levels)


class DualDetectDFL(_DFLHead):
    """Dual (aux + main) YOLOv9 head (reference:
    src/yolo/heads/detect.py:130-296; yolo_re_tpu/models/heads.py:245-338).

    `in_channels`: the aux levels' channels, then the main levels'. The aux
    towers are sized from the first aux level, the main towers from the
    first main level; both decode on the main strides' anchors.
    """

    def __init__(self, num_classes: int, in_channels: tuple[int, ...],
                 strides: tuple[float, ...], reg_max: int = 16):
        super().__init__(num_classes, in_channels, strides, reg_max)
        n = self.num_levels = len(self.in_channels) // 2
        self.aux_box_convs, self.aux_cls_convs = _towers(
            self.in_channels[:n], num_classes, reg_max)
        self.main_box_convs, self.main_cls_convs = _towers(
            self.in_channels[n:], num_classes, reg_max)

    def init_bias(self) -> None:
        self._init_bias(self.aux_box_convs, self.aux_cls_convs)
        self._init_bias(self.main_box_convs, self.main_cls_convs)

    def forward(self, feats: list[torch.Tensor], main_only: bool = False,
                mode: str = "full"):
        """feats: the aux maps, then the main maps; with `main_only` (eval)
        the main maps alone, and the output is the full call's "main"
        (decoded, raw). mode "split" (eval): the main branch's flat raw
        streams, from its towers alone."""
        _check_mode(mode, self.training)
        if main_only and self.training:
            raise ValueError("main_only is an eval forward")
        n = self.num_levels
        if main_only or mode == "split":
            main = _run_towers(feats if main_only else feats[n:],
                               self.main_box_convs, self.main_cls_convs)
            if mode == "split":
                return split_streams(main, self.num_classes, self.reg_max)
            return self._eval_output(main)
        aux = _run_towers(feats[:n], self.aux_box_convs, self.aux_cls_convs)
        main = _run_towers(feats[n:], self.main_box_convs,
                           self.main_cls_convs)
        if self.training:
            return {"aux": aux, "main": main}
        (dec_a, raw_a), (dec_m, raw_m) = (self._eval_output(aux),
                                          self._eval_output(main))
        return {"aux": dec_a, "main": dec_m}, {"aux": raw_a, "main": raw_m}


HEADS: dict[str, type[nn.Module]] = {"DetectDFL": DetectDFL,
                                     "DualDetectDFL": DualDetectDFL}
