"""Detection head DetectDFL (counterpart of yolo_re_tpu/models/heads.py).

Strides are static (from the plan builder), so anchors are numpy constants
built once per feature-map geometry. The eval output is
`(decoded (B, A, 4+nc), raw)`: anchors level by level, row-major over
(h, w) within a level (the JAX order, heads.py:127-135); boxes xywh in
input pixels, class scores sigmoided. `raw` is the reference's per-level
(B, 4*reg_max + nc, H, W) maps.

In train mode the output is the JAX package's train output
(yolo_re_tpu/models/heads.py:197-233): a list of per-level (box, cls) pairs,
(B, 4*reg_max, H, W) and (B, nc, H, W), f32 from `_final_conv`.

The dual head (DualDetectDFL) waits for a later slice.
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
    box_logits = flatten_levels([yb for yb, _ in levels], 4 * reg_max)
    cls_logits = flatten_levels([yc for _, yc in levels], num_classes)
    dist = dfl_decode(box_logits, reg_max)
    dbox = dist2bbox(dist, anchor_points[None], xywh=True) * stride_col[None]
    return torch.cat([dbox, torch.sigmoid(cls_logits.float())], dim=-1)


class DetectDFL(nn.Module):
    """Single YOLO DFL head (reference: src/yolo/heads/detect.py:22-127)."""

    def __init__(self, num_classes: int, in_channels: tuple[int, ...],
                 strides: tuple[float, ...], reg_max: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = tuple(in_channels)
        self.strides = tuple(float(s) for s in strides)
        self.reg_max = reg_max
        c2, c3 = head_widths(self.in_channels[0], num_classes, reg_max)
        self.box_convs = nn.ModuleList(
            nn.Sequential(Conv(ch, c2, 3), Conv(c2, c2, 3, groups=4),
                          nn.Conv2d(c2, 4 * reg_max, 1, groups=4))
            for ch in self.in_channels)
        self.cls_convs = nn.ModuleList(
            nn.Sequential(Conv(ch, c3, 3), Conv(c3, c3, 3),
                          nn.Conv2d(c3, num_classes, 1))
            for ch in self.in_channels)
        self._anchors: dict = {}

    def init_bias(self) -> None:
        """Reference detect.py:111-127: box bias 1.0, cls bias
        log(5 / nc / (640 / stride)^2)."""
        with torch.no_grad():
            for box, cls, s in zip(self.box_convs, self.cls_convs,
                                   self.strides):
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

    def forward(self, feats: list[torch.Tensor]):
        levels = []
        for x, box, cls in zip(feats, self.box_convs, self.cls_convs):
            yb = _final_conv(box[2], box[1](box[0](x)))
            yc = _final_conv(cls[2], cls[1](cls[0](x)))
            levels.append((yb, yc))
        if self.training:
            return levels
        raw = [torch.cat([yb, yc], dim=1) for yb, yc in levels]
        feat_shapes = [(yb.shape[2], yb.shape[3]) for yb, _ in levels]
        decoded = _decode(levels, self.num_classes, self.reg_max,
                          self.anchors(feat_shapes, feats[0].device))
        return decoded, raw
