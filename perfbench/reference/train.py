"""Plain reference of one YOLOv9 training step after the network's
forward: the task-aligned loss (TAL assigner, CIoU, BCE, DFL; WongKinYiu/
yolov9 `utils/loss_tal.py` and `utils/tal/assigner.py`, the dual head's
aux branch weighted 0.25), the global-norm clip, SGD over the three
parameter groups with the warm-up schedule, and the EMA of the weights.

Targets are (B, M, 5) rows of (class, cx, cy, w, h), normalized to the
image, zero rows padding. It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import REG_MAX, anchors, dfl_expect, flat

BOX_GAIN, CLS_GAIN, DFL_GAIN = 7.5, 0.5, 1.5
TOPK, ALPHA, BETA = 10, 0.5, 6.0
EPS = 1e-9


def ciou(b1: torch.Tensor, b2: torch.Tensor, eps: float = 1e-7):
    """Complete IoU of xyxy boxes (broadcasting), (...,)."""
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1] + eps
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1] + eps
    iw = (torch.minimum(b1[..., 2], b2[..., 2])
          - torch.maximum(b1[..., 0], b2[..., 0])).clamp(min=0)
    ih = (torch.minimum(b1[..., 3], b2[..., 3])
          - torch.maximum(b1[..., 1], b2[..., 1])).clamp(min=0)
    inter = iw * ih
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0],
                                                                b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1],
                                                                b2[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2[..., 0] + b2[..., 2] - b1[..., 0] - b1[..., 2]) ** 2
            + (b2[..., 1] + b2[..., 3] - b1[..., 1] - b1[..., 3]) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


@torch.no_grad()
def assign(scores, boxes, points, labels, gt, valid, nc: int):
    """TAL assignment. scores (B, A, nc) sigmoided, boxes (B, A, 4) xyxy
    px, points (A, 2) px, labels (B, M) long, gt (B, M, 4) xyxy px, valid
    (B, M) bool -> (target boxes (B, A, 4) px, target scores (B, A, nc),
    foreground (B, A) bool)."""
    b, a, _ = scores.shape
    m = gt.shape[1]
    cls_score = torch.gather(scores.transpose(1, 2), 1,
                             labels[..., None].expand(-1, -1, a))
    overlaps = ciou(gt[:, :, None], boxes[:, None]).clamp(min=0)
    align = cls_score.pow(ALPHA) * overlaps.pow(BETA)
    inside = torch.cat([points[None, None] - gt[..., None, :2],
                        gt[..., None, 2:] - points[None, None]],
                       -1).amin(-1) > EPS
    metric = align * inside
    kth = metric.topk(TOPK, dim=-1).values[..., -1:]
    pos = (metric >= kth) & (metric > 0) & valid[..., None] & inside
    pos = pos.float()
    multi = pos.sum(1, keepdim=True) > 1
    best = F.one_hot(overlaps.argmax(1), m).transpose(1, 2).float()
    pos = torch.where(multi, best, pos)
    fg = pos.sum(1) > 0
    gt_idx = pos.argmax(1)
    t_labels = torch.gather(labels, 1, gt_idx)
    t_boxes = torch.gather(gt, 1, gt_idx[..., None].expand(-1, -1, 4))
    t_scores = F.one_hot(t_labels, nc).float() * fg[..., None]
    align = align * pos
    pos_align = align.amax(-1, keepdim=True)
    pos_over = (overlaps * pos).amax(-1, keepdim=True)
    norm = (align * pos_over / (pos_align + EPS)).amax(1)[..., None]
    return t_boxes, t_scores * norm, fg


def _branch(maps, points, col, labels, gt, valid, nc):
    """(box, cls, dfl) losses of one tower set."""
    dist_logits = flat([bx for bx, _ in maps])
    logits = flat([c for _, c in maps])
    d = dfl_expect(dist_logits)
    pred = torch.cat([points - d[..., :2], points + d[..., 2:]], -1)
    t_boxes, t_scores, fg = assign(logits.detach().sigmoid(),
                                   pred.detach() * col, points * col,
                                   labels, gt, valid, nc)
    t_boxes = t_boxes / col
    tss = t_scores.sum().clamp(min=1.0)
    bce = F.binary_cross_entropy_with_logits(logits, t_scores,
                                             reduction="sum")
    weight = t_scores.sum(-1) * fg
    box = ((1.0 - ciou(pred, t_boxes)) * weight).sum()
    ltrb = torch.cat([points - t_boxes[..., :2], t_boxes[..., 2:] - points],
                     -1).clamp(0.0, REG_MAX - 1 - 0.01)
    lo = ltrb.floor().long()
    wl = (lo + 1).float() - ltrb
    logp = F.log_softmax(dist_logits.unflatten(-1, (4, REG_MAX)), -1)
    ce = -(torch.gather(logp, -1, lo[..., None])[..., 0] * wl
           + torch.gather(logp, -1, (lo + 1)[..., None])[..., 0] * (1 - wl))
    dfl = (ce.mean(-1) * weight).sum()
    return torch.stack([box, bce, dfl]) / tss


def loss(maps: dict, targets: torch.Tensor, strides, nc: int):
    """(total, items): items = (box, cls, dfl) gained, the aux branch's
    weighted 0.25; total = items.sum() * batch."""
    main = maps["main"]
    shapes = [tuple(bx.shape[2:]) for bx, _ in main]
    points, col = anchors(shapes, strides, targets.device)
    h = shapes[0][0] * strides[0]
    w = shapes[0][1] * strides[0]
    scale = torch.tensor([w, h, w, h], device=targets.device)
    xywh = targets[..., 1:5] * scale
    valid = (targets[..., 3] > 0) & (targets[..., 4] > 0)
    gt = torch.cat([xywh[..., :2] - xywh[..., 2:] / 2,
                    xywh[..., :2] + xywh[..., 2:] / 2], -1) * valid[..., None]
    labels = targets[..., 0].long()
    args = (points, col, labels, gt, valid, nc)
    items = _branch(main, *args)
    if "aux" in maps:
        items = items + 0.25 * _branch(maps["aux"], *args)
    items = items * torch.tensor([BOX_GAIN, CLS_GAIN, DFL_GAIN],
                                 device=items.device)
    return items.sum() * targets.shape[0], items.detach()


def group(name: str) -> str:
    """The optimizer group of a tensor: "weight" (convolution weights,
    decayed), "bn" (BN scales) or "bias" (BN shifts, convolution biases)."""
    if name.endswith(".bn.weight"):
        return "bn"
    if name.endswith(".weight"):
        return "weight"
    return "bias"


def schedule(step: int, steps_per_epoch: int, lr: float = 0.01,
             momentum: float = 0.937, warmup_epochs: float = 3.0,
             warmup_momentum: float = 0.8, warmup_bias_lr: float = 0.1
             ) -> tuple[float, float, float]:
    """(lr, bias lr, momentum) of update `step` (0-based) within the
    warm-up: the first update at the base values, then linear ramps."""
    if step == 0:
        return lr, lr, momentum
    xi = step / max(int(warmup_epochs * steps_per_epoch), 1)
    if xi > 1:
        raise ValueError("the reference follows the warm-up only")
    return (lr * xi, warmup_bias_lr + (lr - warmup_bias_lr) * xi,
            warmup_momentum + (momentum - warmup_momentum) * xi)


def clip(grads: dict, max_norm: float = 10.0) -> dict:
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    return {k: g * scale for k, g in grads.items()}


@torch.no_grad()
def sgd(params: dict, grads: dict, bufs: dict, lr: float, bias_lr: float,
        momentum: float, weight_decay: float = 0.0005) -> None:
    for k, p in params.items():
        g = grads[k]
        if group(k) == "weight":
            g = g + weight_decay * p
        bufs[k] = momentum * bufs[k] + g if k in bufs else g.clone()
        p -= (bias_lr if group(k) == "bias" else lr) * bufs[k]


@torch.no_grad()
def ema(avg: dict, params: dict, updates: int, decay: float = 0.9999,
        tau: float = 2000.0) -> None:
    d = float(np.float32(decay) * (1 - np.exp(-np.float32(updates)
                                                / np.float32(tau))))
    for k, p in params.items():
        avg[k].mul_(d).add_(p, alpha=1 - d)
