"""The comparisons that decide `correct`: what the timed path produced,
judged against the plain reference's float32 answer.

Serving (`judge_detections`): each kept detection of a request is read
against the reference's decoded predictions for the same frames.

- `box_err_px`: the L-infinity distance, in input pixels, from each kept
  box to the nearest of the reference's boxes; its anchor is the one the
  detection stands for.
- `score_err_logit`: the gap, in logits, between a detection's score and
  the reference's score of that anchor for the detection's class.
- `nms_gap_logit`: greedy NMS followed step by step. Before the k-th kept
  detection, the reference's best candidate (its top `topk` anchors by
  best-class score) that no earlier detection suppresses: the gap, in
  logits, by which the k-th lies below it (an image with no detection
  stands at conf_thres). Once an image keeps fewer than `max_det`, the
  best candidate left unsuppressed against the last candidate's score.
  "Suppresses" is read generously, so that rounding of the program's own
  boxes and scores is no gap: an IoU over iou_thres - IOU_SLACK, for a
  class within CLASS_SLACK logits of the candidate's best.

Training (`judge_training`), each number a relative gap to the
reference's:
- `loss_gap`: the worst of the first steps' losses;
- `grad_gap`: the norm of each parameter's first gradient as the
  optimizer got it, at the worst leaf;
- `change_gap`, `ema_gap`: the norm of each parameter's change, and of its
  EMA's, after the steps, at the worst leaf;
- `grad_median_gap`, `change_median_gap`: the first two at the median
  leaf, where the float8 control reads 15 to 20 times the program's
  largest reading (at the worst leaf: 1.4 to 3 times).
A leaf's gap is |norm(program) - norm(reference)| over the reference's
norm of that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under CHANGE_FLOOR of the median leaf's are left
out of the change (they move by round-off alone).
"""

from __future__ import annotations

import torch

from reference.serve import candidates, iou_matrix, xywh_to_xyxy

IOU_SLACK = 0.02
CLASS_SLACK = 0.1
CHANGE_FLOOR = 1e-3


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double()
    return torch.log(p) - torch.log1p(-p)


@torch.no_grad()
def judge_detections(ref_dec: torch.Tensor, out: dict, *,
                     conf_thres: float, iou_thres: float, max_det: int,
                     topk: int) -> dict[str, float]:
    """ref_dec: the reference's (B, A, 4 + nc) f32 predictions; out: the
    program's padded dict for the same B frames (any device)."""
    dev = ref_dec.device
    boxes = out["boxes"].to(dev).float()
    scores = out["scores"].to(dev).float()
    classes = out["classes"].to(dev).long()
    valid = out["valid"].to(dev).bool()
    b, d = valid.shape
    ref_boxes = xywh_to_xyxy(ref_dec[..., :4])
    ref_logit = _logit(ref_dec[..., 4:].clamp(1e-12, 1 - 1e-7))
    ref_conf = ref_logit.amax(-1)

    # each kept detection's anchor: the nearest reference box
    match = torch.zeros(b, d, dtype=torch.long, device=dev)
    box_err = torch.zeros(b, d, dtype=torch.float64, device=dev)
    for i in range(b):
        dist = (boxes[i, :, None, :] - ref_boxes[i, None]).abs().amax(-1)
        e, a = dist.min(-1)
        match[i], box_err[i] = a, e.double()
    cls_c = classes.clamp(min=0)
    pick_logit = ref_logit[torch.arange(b, device=dev)[:, None], match, cls_c]
    score_err = (_logit(scores.clamp(1e-12, 1 - 1e-7)) - pick_logit).abs()

    # greedy NMS, step by step, on the reference's candidates
    idx, conf, _, cand_boxes = candidates(ref_dec, conf_thres, topk)
    cand_logit = torch.gather(ref_conf, 1, idx)
    live = conf > 0
    last = torch.where(live, cand_logit, torch.inf).amin(1)
    pick_boxes = torch.gather(ref_boxes, 1, match[..., None].expand(-1, -1, 4))
    cand_cls_logit = torch.gather(
        ref_logit, 1, idx[..., None].expand(-1, -1, ref_logit.shape[-1]))
    near = torch.gather(cand_cls_logit.transpose(1, 2), 1,
                        cls_c[..., None].expand(-1, -1, idx.shape[1])) \
        >= cand_logit[:, None, :] - CLASS_SLACK                   # (B, D, K)
    cover = ((iou_matrix(pick_boxes, cand_boxes) > iou_thres - IOU_SLACK)
             & near) | (match[..., None] == idx[:, None, :])
    cover &= valid[..., None]
    before = (cover.long().cumsum(1) - cover.long()) > 0
    open_logit = torch.where(before | ~live[:, None, :], -torch.inf,
                             cand_logit[:, None, :])
    gap = open_logit.amax(-1) - pick_logit
    gap = torch.where(valid, gap, -torch.inf)
    left = torch.where(cover.any(1) | ~live, -torch.inf, cand_logit).amax(1)
    n = valid.sum(1)
    end_gap = torch.where(n == 0, left - _logit(torch.tensor(conf_thres)),
                          torch.where(n < max_det, left - last, -torch.inf))
    nms_gap = torch.maximum(gap.amax(1), end_gap).clamp(min=0)

    def worst(x: torch.Tensor) -> float:
        x = torch.where(valid, x, 0.0) if x.shape == valid.shape else x
        return float(x.max()) if x.numel() else 0.0

    return {"box_err_px": worst(box_err),
            "score_err_logit": worst(score_err),
            "nms_gap_logit": float(nms_gap.max())}


def merge_worst(readings: list[dict]) -> dict[str, float]:
    """The worst of each number over several requests."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def leaf_gaps(port: dict, ref: dict, keep=None) -> dict[str, float]:
    """Each leaf's |norm(port) - norm(ref)| / max(norm(ref), median
    norm(ref)), over the leaves in `keep` (all by default)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(torch.tensor([ref[k] for k in names]).median())
    return {k: abs(port[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def judge_training(port: dict, ref: dict, log=None) -> dict[str, float]:
    """port, ref: {"loss": [per step], "grad": {leaf: norm}, "change":
    {leaf: norm}, "ema": {leaf: norm}} (norms as floats). `log` gets a
    line on each number's worst step or leaf."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(port["loss"], ref["loss"])]
    med = float(torch.tensor(list(ref["grad"].values())).median())
    moving = {k for k, v in ref["grad"].items() if v >= CHANGE_FLOOR * med}
    out = {"loss_gap": max(gaps)}
    if log:
        log(f"losses {port['loss']} reference {ref['loss']}")
    for key, keep in (("grad", None), ("change", moving), ("ema", moving)):
        gaps = leaf_gaps(port[key], ref[key], keep)
        ranked = sorted(gaps, key=gaps.get)
        worst, median = ranked[-1], ranked[(len(ranked) - 1) // 2]
        out[key + "_gap"] = gaps[worst]
        if key != "ema":
            out[key + "_median_gap"] = gaps[median]
        if log:
            log(f"{key}_gap {gaps[worst]!r} at {worst}: {port[key][worst]!r} "
                f"against {ref[key][worst]!r}; median leaf "
                f"{gaps[median]!r} at {median}")
    return out
