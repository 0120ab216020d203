"""Fixed-shape batched NMS (counterpart of yolo_re_tpu/ops/nms.py).

1. per anchor: best class score and its index;
2. top-K preselection by confidence with a STABLE descending sort, so
   equal scores keep the lower anchor index first, as `lax.top_k` does:
   K = `pre_topk`, or by default every anchor at mAP-eval thresholds
   (conf < 0.1) and 512 at serving ones;
3. a constant class offset (MAX_WH) makes class-aware NMS one
   class-agnostic pass;
4. greedy suppression in the NMS kernel (ops/kernels/nms.py), which stops
   once no live score is left.

Outputs are padded (B, max_det, ...) plus a validity mask. The JAX
package's adaptive K buckets for the all-anchor path (a `lax.switch` on the
count of conf-passing anchors) are exact by construction, identical to the
all-anchor program; here that program runs as it is, one kernel call over
every anchor with no device-to-host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_re_tpu_torch.ops.boxes import xywh2xyxy
from yolo_re_tpu_torch.ops.kernels.nms import nms_select

# Class-offset constant for class-aware NMS. Must exceed any box coordinate.
MAX_WH = 7680.0


def non_max_suppression(
    predictions: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    pre_topk: int | None = None,
    agnostic: bool = False,
    classes: tuple[int, ...] | None = None,
) -> dict[str, torch.Tensor]:
    """Batched NMS over (B, A, 4 + num_classes) decoded predictions (boxes
    xywh in pixels, class scores sigmoided; reference
    src/yolo/utils/nms.py:19-42). `classes` keeps only detections whose
    argmax class is in the set. `pre_topk`: the candidates kept before the
    greedy pass; None takes every anchor at conf_thres < 0.1 (mAP eval)
    and 512 otherwise.

    Returns dict of fixed-shape tensors:
        boxes   (B, max_det, 4) xyxy float32
        scores  (B, max_det) float32
        classes (B, max_det) int32, -1 for padding
        valid   (B, max_det) bool
    """
    num_anchors = predictions.shape[1]
    if pre_topk is None:
        pre_topk = num_anchors if conf_thres < 0.1 else 512
    k = min(pre_topk, num_anchors)

    boxes_xywh = predictions[..., :4].float()
    cls_scores = predictions[..., 4:].float()
    conf = cls_scores.amax(dim=-1)
    cls_idx = cls_scores.argmax(dim=-1).to(torch.int32)  # first max on ties
    conf = torch.where(conf > conf_thres, conf, 0.0)
    if classes is not None:
        wanted = torch.isin(cls_idx, torch.tensor(classes, dtype=torch.int32,
                                                  device=cls_idx.device))
        conf = torch.where(wanted, conf, 0.0)

    conf_sorted, order = torch.sort(conf, dim=1, descending=True, stable=True)
    conf_k, sel = conf_sorted[:, :k].contiguous(), order[:, :k]
    boxes = xywh2xyxy(torch.gather(boxes_xywh, 1, sel[..., None].expand(-1, -1, 4)))
    cls_k = torch.gather(cls_idx, 1, sel)
    boxes_off = boxes if agnostic else \
        boxes + (cls_k.float() * MAX_WH)[..., None]

    idx = nms_select(boxes_off.contiguous(), conf_k, iou_thres, max_det)
    valid = idx >= 0
    take = idx.clamp(min=0).long()
    out_boxes = torch.gather(boxes, 1, take[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(conf_k, 1, take)
    out_classes = torch.gather(cls_k, 1, take)
    return {
        "boxes": torch.where(valid[..., None], out_boxes, 0.0),
        "scores": torch.where(valid, out_scores, 0.0),
        "classes": torch.where(valid, out_classes, -1),
        "valid": valid,
    }


def nms_to_list(out: dict[str, torch.Tensor]) -> list[np.ndarray]:
    """Padded NMS output -> the reference's per-image list of (n, 6)
    [x1, y1, x2, y2, conf, cls] numpy arrays (host-side helper)."""
    boxes = out["boxes"].cpu().numpy()
    scores = out["scores"].cpu().numpy()
    classes = out["classes"].cpu().numpy()
    valid = out["valid"].cpu().numpy()
    result = []
    for b in range(boxes.shape[0]):
        m = valid[b]
        result.append(np.concatenate(
            [boxes[b][m], scores[b][m, None],
             classes[b][m, None].astype(np.float32)], axis=1))
    return result
