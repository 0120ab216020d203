"""mAP computation — host-side numpy, COCO-style (a copy of
yolo_re_tpu/eval/metrics.py; tests/test_torch_eval.py pins the two equal).

Semantics cloned from the reference (src/yolo/eval/metrics.py): per-class,
per-IoU-threshold [0.5:0.05:0.95] greedy matching of score-sorted
predictions with one-to-one GT matching (best-IoU GT regardless of matched
state — the reference's exact rule, metrics.py:146-168), and 101-point
interpolated AP. Vectorized across IoU thresholds instead of the
reference's per-threshold re-loop.
"""

from __future__ import annotations

import numpy as np


def box_iou_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU (N, M), xyxy, numpy."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP (reference: metrics.py:32-60)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]

    thresholds = np.linspace(0, 1, 101)
    # First index where mrec >= t, for each t
    idx = np.searchsorted(mrec, thresholds, side="left")
    interp = np.where(idx < len(mpre), mpre[np.minimum(idx, len(mpre) - 1)], 0.0)
    return float(interp.mean())


def compute_map(
    pred_boxes: list[np.ndarray],
    pred_scores: list[np.ndarray],
    pred_classes: list[np.ndarray],
    gt_boxes: list[np.ndarray],
    gt_classes: list[np.ndarray],
    num_classes: int,
    iou_thresholds: list[float] | None = None,
) -> dict[str, float]:
    """COCO-style mAP (reference: metrics.py:63-198). Inputs are per-image
    numpy arrays; boxes xyxy pixels."""
    if iou_thresholds is None:
        iou_thresholds = [0.5 + 0.05 * i for i in range(10)]
    thr = np.asarray(iou_thresholds)
    num_images = len(pred_boxes)
    num_thr = len(thr)

    all_aps: dict[float, list[float]] = {t: [] for t in iou_thresholds}

    for cls_id in range(num_classes):
        entries = []   # (score, img_id, best_iou, best_gt)
        gt_counts: dict[int, int] = {}
        total_gt = 0

        per_img_preds: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for img in range(num_images):
            if len(gt_classes[img]):
                m = gt_classes[img] == cls_id
                if m.any():
                    gt_counts[img] = int(m.sum())
                    total_gt += int(m.sum())
            if len(pred_classes[img]):
                m = pred_classes[img] == cls_id
                if m.any():
                    per_img_preds[img] = (pred_boxes[img][m],
                                          pred_scores[img][m])

        if total_gt == 0:
            continue
        if not per_img_preds:
            for t in iou_thresholds:
                all_aps[t].append(0.0)
            continue

        for img, (boxes, scores) in per_img_preds.items():
            if img in gt_counts:
                gts = gt_boxes[img][gt_classes[img] == cls_id]
                ious = box_iou_np(boxes, gts)
                best_gt = ious.argmax(axis=1)
                best_iou = ious[np.arange(len(boxes)), best_gt]
            else:
                best_gt = np.full(len(boxes), -1)
                best_iou = np.zeros(len(boxes))
            for s, bi, bg in zip(scores, best_iou, best_gt):
                entries.append((float(s), img, float(bi), int(bg)))

        entries.sort(key=lambda e: e[0], reverse=True)
        n_pred = len(entries)

        # Greedy matching across all thresholds at once.
        tp = np.zeros((num_thr, n_pred))
        matched: dict[int, np.ndarray] = {
            img: np.zeros((num_thr, cnt), bool) for img, cnt in gt_counts.items()
        }
        for pi, (_, img, best_iou, best_gt) in enumerate(entries):
            if best_gt < 0 or img not in matched:
                continue
            ok = (best_iou >= thr) & ~matched[img][:, best_gt]
            tp[ok, pi] = 1
            matched[img][ok, best_gt] = True

        tp_cum = tp.cumsum(axis=1)
        fp_cum = np.arange(1, n_pred + 1)[None, :] - tp_cum
        recall = tp_cum / total_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)

        for ti, t in enumerate(iou_thresholds):
            all_aps[t].append(compute_ap(recall[ti], precision[ti]))

    results: dict[str, float] = {}
    results["map50"] = float(np.mean(all_aps[0.5])) if all_aps.get(0.5) else 0.0
    results["map75"] = float(np.mean(all_aps[0.75])) if all_aps.get(0.75) else 0.0
    all_vals = [v for t in iou_thresholds for v in all_aps.get(t, [])]
    results["map"] = float(np.mean(all_vals)) if all_vals else 0.0
    return results
