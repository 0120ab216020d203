"""Box geometry: format conversion, anchors, DFL decode, the IoU family
(counterpart of yolo_re_tpu/ops/boxes.py). Anchors are built host-side
(numpy) from static feature shapes."""

from __future__ import annotations

import math

import numpy as np
import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2), last-dim layout."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = True) -> torch.Tensor:
    """ltrb distances -> boxes (reference: src/yolo/heads/anchor.py:43-64)."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor,
              reg_max: int) -> torch.Tensor:
    """xyxy boxes -> ltrb distances, clamped to [0, reg_max - 0.01]
    (reference: src/yolo/loss/bbox.py:34-46)."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    d = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return d.clamp(0.0, reg_max - 0.01)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, *, xywh: bool = False,
             iou_type: str = "iou", eps: float = 1e-7) -> torch.Tensor:
    """Elementwise (broadcasting) IoU / GIoU / DIoU / CIoU on (..., 4)
    boxes -> (..., 1). The JAX package's numerics
    (yolo_re_tpu/ops/boxes.py:bbox_iou; reference src/yolo/loss/iou.py),
    with its eps placement (h + eps in xyxy mode) and the CIoU alpha
    detached."""
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, dim=-1)
        x2, y2, w2, h2 = box2.chunk(4, dim=-1)
        b1_x1, b1_x2 = x1 - w1 / 2, x1 + w1 / 2
        b1_y1, b1_y2 = y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2 = x2 - w2 / 2, x2 + w2 / 2
        b2_y1, b2_y2 = y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, dim=-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, dim=-1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)
             ).clamp(min=0) * \
        (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)
         ).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if iou_type in ("ciou", "diou", "giou"):
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
        if iou_type in ("ciou", "diou"):
            c2 = cw ** 2 + ch ** 2 + eps
            rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                    + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
            if iou_type == "ciou":
                v = (4 / math.pi ** 2) * torch.square(
                    torch.atan(w2 / h2) - torch.atan(w1 / h1))
                alpha = (v / (v - iou + (1 + eps))).detach()
                return iou - (rho2 / c2 + v * alpha)
            return iou - rho2 / c2
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    return iou


def make_anchors_np(
    feat_shapes: list[tuple[int, int]],
    strides: list[int] | list[float],
    grid_cell_offset: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """Anchor grid centers from static feature shapes, host-side.

    Returns (anchor_points (ΣHW, 2) xy, stride_tensor (ΣHW, 1)).
    Semantics of reference src/yolo/heads/anchor.py:10-40.
    """
    points, stride_col = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = np.arange(w, dtype=np.float32) + grid_cell_offset
        sy = np.arange(h, dtype=np.float32) + grid_cell_offset
        gx, gy = np.meshgrid(sx, sy)  # gx varies along columns
        points.append(np.stack([gx, gy], axis=-1).reshape(-1, 2))
        stride_col.append(np.full((h * w, 1), s, dtype=np.float32))
    return np.concatenate(points), np.concatenate(stride_col)


def _dfl_projection(reg_max: int, n_sides: int) -> np.ndarray:
    """Block-diagonal projection: columns [0, n) per-side bin values,
    columns [n, 2n) per-side normalizers."""
    p = np.zeros((n_sides * reg_max, 2 * n_sides), np.float32)
    for g in range(n_sides):
        p[g * reg_max:(g + 1) * reg_max, g] = np.arange(reg_max)
        p[g * reg_max:(g + 1) * reg_max, n_sides + g] = 1.0
    return p


def dfl_decode(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution -> expectation decode (reference:
    src/yolo/heads/dfl.py), in f32: (..., 4*reg_max) -> (..., 4) in
    [0, reg_max-1]. Same arithmetic as the JAX package: one global shift
    per anchor, exp, and a projection matmul giving per-side sums."""
    x = box_logits.float()
    n_sides = x.shape[-1] // reg_max
    u = torch.exp((x - x.amax(dim=-1, keepdim=True)).clamp(min=-60.0))
    p = torch.from_numpy(_dfl_projection(reg_max, n_sides)).to(x.device)
    nd = u @ p
    return nd[..., :n_sides] / nd[..., n_sides:]
