"""Box geometry: format conversion, anchors, DFL decode (counterpart of
yolo_re_tpu/ops/boxes.py). Anchors are built host-side (numpy) from static
feature shapes."""

from __future__ import annotations

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
