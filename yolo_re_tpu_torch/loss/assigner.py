"""Task-Aligned Assigner, fixed shape (counterpart of
yolo_re_tpu/loss/assigner.py; reference src/yolo/loss/assigner.py, TOOD).

Every step is a masked computation over padded GT (B, M, ...), no
data-dependent branch; the caller runs it under `torch.no_grad()` (the JAX
package stop-gradients its inputs). The top-k candidates per GT come from
k-1 max-and-mask passes that find the k-th largest metric, as in the JAX
package, not from `torch.topk`: ties then resolve the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.boxes import bbox_iou


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """Anchor centers strictly inside GT boxes: xy_centers (A, 2),
    gt_bboxes (B, M, 4) xyxy -> bool (B, M, A)."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:]
    deltas = torch.cat([xy_centers[None, None] - lt,
                        rb - xy_centers[None, None]], dim=-1)
    return deltas.amin(dim=-1) > eps


def select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor):
    """Anchors claimed by several GTs go to the GT of max IoU. Returns
    (target_gt_idx (B, A), fg_mask (B, A), mask_pos (B, M, A))."""
    n_max_boxes = mask_pos.shape[1]
    fg_mask = mask_pos.sum(dim=-2)
    mask_multi = fg_mask[:, None, :] > 1
    max_overlaps_idx = overlaps.argmax(dim=1)               # first on ties
    is_max = F.one_hot(max_overlaps_idx, n_max_boxes).to(overlaps.dtype)
    is_max = is_max.transpose(1, 2)                          # (B, M, A)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=-2)
    target_gt_idx = mask_pos.argmax(dim=-2)
    return target_gt_idx, fg_mask, mask_pos


class TaskAlignedAssigner:
    """Align-metric (score^alpha * IoU^beta) top-k assignment."""

    def __init__(self, topk: int = 10, num_classes: int = 80,
                 alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9):
        self.topk = topk
        self.num_classes = num_classes
        self.bg_idx = num_classes
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    @torch.no_grad()
    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels,
                 gt_bboxes, mask_gt):
        """pd_scores (B, A, nc) sigmoided, pd_bboxes (B, A, 4) xyxy px,
        anc_points (A, 2) px, gt_labels (B, M, 1), gt_bboxes (B, M, 4),
        mask_gt (B, M, 1). Returns (target_labels (B, A), target_bboxes
        (B, A, 4), target_scores (B, A, nc), fg_mask (B, A) bool)."""
        bs, n_anchors, _ = pd_scores.shape
        n_max_boxes = gt_bboxes.shape[1]
        mask_gt_f = mask_gt.float()
        if n_max_boxes == 0:
            return (torch.full((bs, n_anchors), self.bg_idx,
                               dtype=torch.int64, device=pd_scores.device),
                    torch.zeros_like(pd_bboxes), torch.zeros_like(pd_scores),
                    torch.zeros((bs, n_anchors), dtype=torch.bool,
                                device=pd_scores.device))

        mask_pos, align_metric, overlaps = self._get_pos_mask(
            pd_scores, pd_bboxes, gt_labels, gt_bboxes, anc_points, mask_gt_f)
        target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(
            mask_pos, overlaps)
        target_labels, target_bboxes, target_scores = self._get_targets(
            gt_labels, gt_bboxes, target_gt_idx, fg_mask)

        align_metric = align_metric * mask_pos
        pos_align = align_metric.amax(dim=-1, keepdim=True)
        pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
        norm = (align_metric * pos_overlaps / (pos_align + self.eps)
                ).amax(dim=-2)[..., None]
        return target_labels, target_bboxes, target_scores * norm, \
            fg_mask > 0

    def _get_pos_mask(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes,
                      anc_points, mask_gt):
        align_metric, overlaps = self._get_box_metrics(
            pd_scores, pd_bboxes, gt_labels, gt_bboxes)
        mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes).float()
        mask_topk = self._select_topk(align_metric * mask_in_gts,
                                      mask_gt[..., 0])
        return mask_topk * mask_in_gts * mask_gt, align_metric, overlaps

    def _get_box_metrics(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes):
        """align = score[gt class]^alpha * CIoU^beta, (B, M, A) in f32."""
        labels = gt_labels[..., 0].long().clamp(min=0)          # (B, M)
        scores_t = pd_scores.transpose(1, 2)                    # (B, nc, A)
        idx = labels[:, :, None].expand(-1, -1, scores_t.shape[2])
        bbox_scores = torch.gather(scores_t, 1, idx).float()
        overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :],
                            xywh=False, iou_type="ciou")[..., 0]
        overlaps = overlaps.clamp(min=0.0)
        align = bbox_scores.pow(self.alpha) * overlaps.pow(self.beta)
        return align, overlaps

    def _select_topk(self, metrics, valid_gt):
        """{0, 1} (B, M, A): metric >= the k-th largest of its GT row,
        positive, and the GT valid. Each pass removes every entry tied at
        the current max (yolo_re_tpu/loss/assigner.py:134-165)."""
        remaining = metrics
        for _ in range(self.topk - 1):
            m = remaining.amax(dim=-1, keepdim=True)
            remaining = torch.where(remaining >= m, -torch.inf, remaining)
        kth = remaining.amax(dim=-1, keepdim=True)
        mask = (metrics >= kth) & (metrics > 0) & (valid_gt[..., None] > 0)
        return mask.float()

    def _get_targets(self, gt_labels, gt_bboxes, target_gt_idx, fg_mask):
        labels = gt_labels[..., 0].long().clamp(min=0)          # (B, M)
        target_labels = torch.gather(labels, 1, target_gt_idx)
        target_bboxes = torch.gather(
            gt_bboxes, 1, target_gt_idx[..., None].expand(-1, -1, 4))
        one_hot = F.one_hot(target_labels, self.num_classes).float()
        target_scores = one_hot * (fg_mask > 0)[..., None]
        return target_labels, target_bboxes, target_scores
