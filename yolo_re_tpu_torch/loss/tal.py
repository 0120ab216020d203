"""Task-Aligned Loss, fixed shape (counterpart of yolo_re_tpu/loss/tal.py;
reference src/yolo/loss/tal.py + src/yolo/loss/bbox.py).

Target contract (the JAX package's): `targets` (B, M, 5) as (class, x, y,
w, h) with xywh normalized to [0, 1]; padding rows are all zero (w == h ==
0 marks them invalid). Predictions are the head's train output: a list of
per-level (box (B, 4*reg_max, H, W), cls (B, nc, H, W)) pairs, NCHW; a
dual head's {"aux": pairs, "main": pairs} goes to `forward_dual` (aux
weighted 0.25).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.loss.assigner import TaskAlignedAssigner
from yolo_re_tpu_torch.ops.boxes import (
    bbox2dist,
    bbox_iou,
    dist2bbox,
    make_anchors_np,
    xywh2xyxy,
)


@dataclass
class LossConfig:
    """Reference: src/yolo/loss/tal.py:15-26."""

    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    cls_pw: float = 1.0


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Elementwise BCE-with-logits in f32, the JAX package's softplus form."""
    logits, targets = logits.float(), targets.float()
    log_sig = -F.softplus(-logits)
    log_one_minus = -F.softplus(logits)
    return -(pos_weight * targets * log_sig + (1.0 - targets) * log_one_minus)


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor,
            reg_max_minus1: int) -> torch.Tensor:
    """Distribution Focal Loss (reference: src/yolo/loss/bbox.py:102-124):
    pred_dist (..., 4, reg_max) logits, target (..., 4) in [0, reg_max-1];
    CE against the two nearest bins, linearly weighted, mean over the 4
    sides. The two bins are picked with a dense one-hot weight, as in the
    JAX package."""
    tl = target.long()
    tr = tl + 1
    wl = tr.float() - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist.float(), dim=-1)
    nbins = reg_max_minus1 + 1
    bins = torch.arange(nbins, device=pred_dist.device)
    w = (wl[..., None] * (bins == tl.clamp(0, nbins - 1)[..., None])
         + wr[..., None] * (bins == tr.clamp(0, nbins - 1)[..., None]))
    return -(logp * w).sum(dim=-1).mean(dim=-1)


def _flat(maps: list[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, C, H, W) -> (B, sum(H*W), C) f32, anchors row-major."""
    b = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, m.shape[1])
                      for m in maps], dim=1).float()


class TALoss:
    """CIoU + BCE + DFL with task-aligned assignment.

    __call__(preds, targets) -> (total, items [box, cls, dfl] detached).
    """

    def __init__(self, num_classes: int, reg_max: int, strides,
                 config: LossConfig | None = None):
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.strides = [float(s) for s in strides]
        self.config = config or LossConfig()
        self.assigner = TaskAlignedAssigner(
            topk=self.config.tal_topk, num_classes=num_classes,
            alpha=self.config.tal_alpha, beta=self.config.tal_beta)

    def _anchors(self, feats, device):
        shapes = [(yb.shape[2], yb.shape[3]) for yb, _ in feats]
        anchors, stride_col = make_anchors_np(shapes, self.strides)
        return (torch.from_numpy(anchors).to(device),
                torch.from_numpy(stride_col).to(device))

    def _decode(self, anchor_points, pred_dist):
        """(B, A, 4*reg_max) logits -> (B, A, 4) xyxy in grid units
        (reference: tal.py:315-320)."""
        b, a, c = pred_dist.shape
        p = F.softmax(pred_dist.float().reshape(b, a, 4, c // 4), dim=-1)
        proj = torch.arange(self.reg_max, dtype=torch.float32,
                            device=pred_dist.device)
        return dist2bbox(p @ proj, anchor_points, xywh=False)

    @staticmethod
    def _prepare_targets(targets, img_h, img_w):
        """(B, M, 5) normalized (cls, xywh) -> labels, xyxy px boxes, mask."""
        gt_labels = targets[..., :1]
        scale = torch.tensor([img_w, img_h, img_w, img_h],
                             dtype=torch.float32, device=targets.device)
        gt_bboxes = xywh2xyxy(targets[..., 1:5] * scale)
        mask_gt = (targets[..., 3:4] > 0) & (targets[..., 4:5] > 0)
        return gt_labels, gt_bboxes * mask_gt, mask_gt

    def _branch_losses(self, feats, gt_labels, gt_bboxes, mask_gt,
                       anchor_points, stride_col):
        pred_distri = _flat([yb for yb, _ in feats])
        pred_scores = _flat([yc for _, yc in feats])
        pred_bboxes = self._decode(anchor_points, pred_distri)   # grid units

        target_labels, target_bboxes, target_scores, fg_mask = self.assigner(
            torch.sigmoid(pred_scores.detach()),
            pred_bboxes.detach() * stride_col[None],
            anchor_points * stride_col,
            gt_labels, gt_bboxes, mask_gt)
        target_bboxes = target_bboxes / stride_col[None]
        tss = target_scores.sum().clamp(min=1.0)

        cls_loss = bce_with_logits(pred_scores, target_scores,
                                   self.config.cls_pw).sum() / tss
        weight = target_scores.sum(-1) * fg_mask.float()            # (B, A)
        iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False,
                       iou_type="ciou")[..., 0]
        iou_loss = ((1.0 - iou) * weight).sum() / tss
        target_ltrb = bbox2dist(anchor_points, target_bboxes,
                                self.reg_max - 1)
        b, a, _ = pred_distri.shape
        dfl = df_loss(pred_distri.reshape(b, a, 4, self.reg_max),
                      target_ltrb, self.reg_max - 1)
        dfl_loss = (dfl * weight).sum() / tss
        return iou_loss, cls_loss, dfl_loss

    def __call__(self, preds, targets):
        if isinstance(preds, dict):
            return self.forward_dual(preds, targets)
        return self.forward_single(preds, targets)

    def _setup(self, feats, targets: torch.Tensor):
        """Anchors and targets from the first level of `feats`: (anchor
        points, stride column, gt labels, gt xyxy px boxes, gt mask)."""
        yb0 = feats[0][0]
        img_h = yb0.shape[2] * self.strides[0]
        img_w = yb0.shape[3] * self.strides[0]
        return (*self._anchors(feats, yb0.device),
                *self._prepare_targets(targets.float(), img_h, img_w))

    def _gained(self, iou_l, cls_l, dfl_l) -> torch.Tensor:
        return torch.stack([iou_l * self.config.box_gain,
                            cls_l * self.config.cls_gain,
                            dfl_l * self.config.dfl_gain])

    def forward_single(self, feats, targets: torch.Tensor):
        """feats: per-level (box, cls) NCHW pairs (reference:
        tal.py:135-190). Returns (sum of gained items * batch size, items
        (3,) detached)."""
        anchor_points, stride_col, *gt = self._setup(feats, targets)
        loss = self._gained(*self._branch_losses(feats, *gt, anchor_points,
                                                 stride_col))
        return loss.sum() * feats[0][0].shape[0], loss.detach()

    def forward_dual(self, preds, targets: torch.Tensor):
        """preds: {"aux": pairs, "main": pairs}; anchors and targets from
        the main branch's first level, each item (aux * 0.25 + main) * gain
        (reference: tal.py:192-285; yolo_re_tpu/loss/tal.py:230-252)."""
        feats_main = preds["main"]
        anchor_points, stride_col, *gt = self._setup(feats_main, targets)
        aux, main = (self._branch_losses(preds[k], *gt, anchor_points,
                                         stride_col) for k in ("aux", "main"))
        loss = self._gained(*(a * 0.25 + m for a, m in zip(aux, main)))
        return loss.sum() * feats_main[0][0].shape[0], loss.detach()


def pad_targets(labels_list, max_boxes: int | None = None):
    """Host-side: list of per-image (n, 5) [cls, xywhn] -> (B, M, 5)
    zero-padded numpy float32."""
    import numpy as np

    if max_boxes is None:
        max_boxes = max((len(lab) for lab in labels_list), default=1)
    max_boxes = max(max_boxes, 1)
    out = np.zeros((len(labels_list), max_boxes, 5), np.float32)
    for i, lab in enumerate(labels_list):
        n = min(len(lab), max_boxes)
        if n:
            out[i, :n] = lab[:n]
    return out
