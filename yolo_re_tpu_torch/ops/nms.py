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
every anchor with no device-to-host sync, up to the kernel's MAX_K
candidates. Above it (gelan-c beyond ~740 px) K is the most conf-passing
anchors of an image, read back from the device: the same exactness, one
sync a call.

`non_max_suppression_raw` starts from the head's raw streams
(`YOLO.predict_split`) and decodes lazily: it ranks by the class logits
and decodes only the K winners' boxes, then ends in the same kernel.

The JAX functions' `backend=` and `mesh=` arguments have no counterpart:
there is one suppression, the kernel (its plain version on a CPU tensor),
and a mesh runs NMS on each replica's part (parallel/mesh.py), so neither
function takes them.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_re_tpu_torch.ops.boxes import dfl_decode, dist2bbox, xywh2xyxy
from yolo_re_tpu_torch.ops.kernels.nms import MAX_K, nms_select

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
    k = _num_candidates(num_anchors, conf_thres, pre_topk)
    boxes_xywh = predictions[..., :4].float()
    cls_scores = predictions[..., 4:].float()
    conf = cls_scores.amax(dim=-1)
    cls_idx = cls_scores.argmax(dim=-1).to(torch.int32)  # first max on ties
    k = _passing(conf, k, conf_thres, pre_topk)
    conf_k, sel, cls_k = _preselect(conf, cls_idx, k, conf_thres, classes)
    boxes = xywh2xyxy(torch.gather(boxes_xywh, 1,
                                   sel[..., None].expand(-1, -1, 4)))
    return _suppress(boxes, conf_k, cls_k, iou_thres, max_det, agnostic)


def non_max_suppression_raw(
    box_logits: torch.Tensor,
    cls_logits: torch.Tensor,
    anchors: torch.Tensor | np.ndarray,
    stride_col: torch.Tensor | np.ndarray,
    reg_max: int = 16,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    pre_topk: int | None = None,
    agnostic: bool = False,
    classes: tuple[int, ...] | None = None,
) -> dict[str, torch.Tensor]:
    """NMS straight from the raw head streams with lazy box decode
    (yolo_re_tpu/ops/nms.py:254-317): box_logits (B, A, 4*reg_max) and
    cls_logits (B, A, nc) as `YOLO.predict_split` returns them, anchors
    (A, 2) and stride_col (A, 1) from `ops.boxes.make_anchors_np`.

    The sigmoid is monotonic, so the per-anchor max and argmax are taken
    on the logits (in their dtype: bf16 logits take their max in bf16,
    then f32) and only the max is sigmoided; the same conf_thres,
    `classes` and default pre_topk as `non_max_suppression` pick the K
    candidates (stable descending sort); the DFL expectation and
    dist2bbox run on those K only; then the class offset and the NMS
    kernel. Returns `non_max_suppression`'s dict. Where an anchor's
    classes differ by less than the f32 sigmoid resolves, the dense path
    takes the first of the equal rounded scores and this one the largest
    logit, as the JAX functions do: there the two can part."""
    num_anchors = box_logits.shape[1]
    k = _num_candidates(num_anchors, conf_thres, pre_topk)
    dev = box_logits.device
    conf = torch.sigmoid(cls_logits.amax(dim=-1).float())
    cls_idx = cls_logits.argmax(dim=-1).to(torch.int32)
    k = _passing(conf, k, conf_thres, pre_topk)
    conf_k, sel, cls_k = _preselect(conf, cls_idx, k, conf_thres, classes)
    bl = torch.gather(box_logits, 1,
                      sel[..., None].expand(-1, -1, box_logits.shape[-1]))
    points = torch.as_tensor(anchors, dtype=torch.float32, device=dev)[sel]
    strides = torch.as_tensor(stride_col, dtype=torch.float32,
                              device=dev)[sel]
    dist = dfl_decode(bl.float(), reg_max)
    boxes = xywh2xyxy(dist2bbox(dist, points, xywh=True) * strides)
    return _suppress(boxes, conf_k, cls_k, iou_thres, max_det, agnostic)


def _num_candidates(num_anchors: int, conf_thres: float,
                    pre_topk: int | None) -> int:
    """K: `pre_topk`, or every anchor at mAP-eval thresholds (conf < 0.1)
    and 512 otherwise, at most the anchors."""
    if pre_topk is None:
        pre_topk = num_anchors if conf_thres < 0.1 else 512
    return min(pre_topk, num_anchors)


def _passing(conf: torch.Tensor, k: int, conf_thres: float,
             pre_topk: int | None) -> int:
    """K for the all-anchor default when it exceeds the kernel's MAX_K: the
    most anchors above conf_thres in one image (at least 1). The top K
    then hold every candidate the greedy pass can keep, in the same
    order, so the detections are those of all anchors (the JAX package's
    adaptive buckets rest on the same fact). More than MAX_K passing
    anchors in one image raises."""
    if k <= MAX_K or pre_topk is not None:
        return k
    n = max(int((conf > conf_thres).sum(dim=1).max()), 1)
    if n > MAX_K:
        raise ValueError(
            f"non_max_suppression: {n} anchors above conf_thres "
            f"{conf_thres} in one image; the NMS kernel holds at most "
            f"{MAX_K} candidates (raise conf_thres or pass pre_topk)")
    return n


def _preselect(conf: torch.Tensor, cls_idx: torch.Tensor, k: int,
               conf_thres: float, classes: tuple[int, ...] | None):
    """Per-anchor (B, A) f32 confidence and int32 class -> the top K
    (scores, anchor indices, classes): scores at or under conf_thres and
    classes outside `classes` are zeroed, then a stable descending sort
    keeps equal scores in anchor order, as `lax.top_k` does."""
    conf = torch.where(conf > conf_thres, conf, 0.0)
    if classes is not None:
        wanted = torch.isin(cls_idx, torch.tensor(classes, dtype=torch.int32,
                                                  device=cls_idx.device))
        conf = torch.where(wanted, conf, 0.0)
    conf_sorted, order = torch.sort(conf, dim=1, descending=True, stable=True)
    sel = order[:, :k]
    return conf_sorted[:, :k].contiguous(), sel, torch.gather(cls_idx, 1, sel)


def _suppress(boxes: torch.Tensor, conf_k: torch.Tensor, cls_k: torch.Tensor,
              iou_thres: float, max_det: int,
              agnostic: bool) -> dict[str, torch.Tensor]:
    """Greedy suppression of the K candidates (xyxy boxes, scores,
    classes) in the NMS kernel, class-aware through the class offset;
    the padded output dict."""
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
