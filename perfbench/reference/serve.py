"""Plain reference of the serving pipeline around the network: the
letterbox of uint8 frames and class-aware greedy NMS, written from their
published semantics (WongKinYiu/yolov9 `letterbox`, cv2 INTER_LINEAR
half-pixel resize, 114-grey padding; the batched NMS of
`src/yolo/utils/nms.py`: best class per anchor, the top 512 by confidence,
greedy suppression at IoU > iou_thres within a class, at most max_det).

It imports nothing of the program under test.
"""

from __future__ import annotations

import torch

PAD = 114.0 / 255.0


def _lerp_axis(x: torch.Tensor, dim: int, out: int) -> torch.Tensor:
    """cv2 INTER_LINEAR along `dim`: source (dst + 0.5) * in/out - 0.5,
    border replicate."""
    n = x.shape[dim]
    if n == out:
        return x
    src = (torch.arange(out, dtype=torch.float64) + 0.5) * (n / out) - 0.5
    lo = src.floor()
    frac = (src - lo).to(torch.float32).to(x.device)
    i0 = lo.long().clamp(0, n - 1).to(x.device)
    i1 = (lo.long() + 1).clamp(0, n - 1).to(x.device)
    shape = [1] * x.dim()
    shape[dim] = out
    f = frac.view(shape)
    return x.index_select(dim, i0) * (1 - f) + x.index_select(dim, i1) * f


def letterbox(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, 3, size, size) f32 in [0, 1]: the
    aspect-preserving resize, then the grey border (the extra pixel of an
    odd border goes to the bottom and right)."""
    _, h, w, _ = frames.shape
    r = min(size / h, size / w)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = (size - nw) / 2, (size - nh) / 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    x = frames.float() / 255.0
    x = _lerp_axis(_lerp_axis(x, 1, nh), 2, nw)
    x = torch.nn.functional.pad(x, (0, 0, left, right, top, bottom),
                                value=PAD)
    return x.clamp(0.0, 1.0).permute(0, 3, 1, 2).contiguous()


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    half = b[..., 2:] / 2
    return torch.cat([b[..., :2] - half, b[..., :2] + half], -1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M) IoU."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[..., 2:] - a[..., :2]).prod(-1)
    area_b = (b[..., 2:] - b[..., :2]).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def candidates(decoded: torch.Tensor, conf_thres: float, topk: int):
    """(B, A, 4 + nc) -> the top `topk` anchors by best-class score, as
    (anchor index (B, K), score (B, K) with those at or under conf_thres
    set to 0, class (B, K), xyxy box (B, K, 4))."""
    scores = decoded[..., 4:]
    conf, cls = scores.max(-1)
    conf = torch.where(conf > conf_thres, conf, torch.zeros_like(conf))
    conf, idx = torch.sort(conf, dim=1, descending=True, stable=True)
    idx, conf = idx[:, :topk], conf[:, :topk]
    boxes = xywh_to_xyxy(torch.gather(
        decoded[..., :4], 1, idx[..., None].expand(-1, -1, 4)))
    return idx, conf, torch.gather(cls, 1, idx), boxes


@torch.no_grad()
def nms(decoded: torch.Tensor, conf_thres: float = 0.25,
        iou_thres: float = 0.45, max_det: int = 300, topk: int = 512):
    """Greedy class-aware NMS per image. Returns {"boxes" (B, max_det, 4)
    xyxy, "scores", "classes" (-1 padding), "valid"}, kept detections
    first, in the order the greedy pass keeps them."""
    _, conf, cls, boxes = candidates(decoded, conf_thres, topk)
    b, k = conf.shape
    same = cls[:, :, None] == cls[:, None, :]
    over = (iou_matrix(boxes, boxes) > iou_thres) & same
    later = torch.ones(k, k, dtype=torch.bool, device=conf.device).triu(1)
    over &= later
    dead = torch.zeros(b, k, dtype=torch.bool, device=conf.device)
    count = torch.zeros(b, dtype=torch.long, device=conf.device)
    order = torch.full((b, max_det), -1, dtype=torch.long, device=conf.device)
    rows = torch.arange(b, device=conf.device)
    for i in range(k):
        keep = ~dead[:, i] & (conf[:, i] > 0) & (count < max_det)
        order[rows[keep], count[keep]] = i
        count += keep.long()
        dead |= keep[:, None] & over[:, i]
    valid = order >= 0
    take = order.clamp(min=0)
    return {
        "boxes": torch.where(valid[..., None], torch.gather(
            boxes, 1, take[..., None].expand(-1, -1, 4)), 0.0),
        "scores": torch.where(valid, torch.gather(conf, 1, take), 0.0),
        "classes": torch.where(valid, torch.gather(cls, 1, take), -1),
        "valid": valid,
    }
