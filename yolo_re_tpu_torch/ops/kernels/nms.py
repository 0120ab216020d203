"""Greedy NMS selection kernel, one thread-block cluster per image.

Counterpart of the TPU kernel `yolo_re_tpu/ops/pallas/nms_kernel.py`
(`pallas_nms_select`) and of the `lax.scan` loop in
`yolo_re_tpu/ops/nms.py`; the CUDA source is `yolo_re_tpu_torch/csrc/nms.cu`.

`nms_select` calls the custom op `yolo_torch::nms_select` (so that
`torch.export` keeps the kernel in the graph). The dispatcher sends a CUDA
tensor to the hand-written kernel, its cluster size from `cluster_size`,
and a CPU tensor to `nms_select_plain`, the plain PyTorch version of the
same greedy loop.
"""

from __future__ import annotations

import torch

from yolo_re_tpu_torch.ops.kernels import build, common

# the most candidates an image may have: what one CTA of the first kernel
# held (20 bytes each); the cluster kernel takes them at c >= 2
MAX_K = (227 * 1024 - 1024) // 20
# csrc/nms.cu: threads of a CTA; bytes of shared memory a candidate takes
# (box, area, live score); the most a CTA's slice may take (227 KB less the
# kernel's 4 KB of slots and the 1 KB the card reserves a CTA); an SM's
# shared memory. The kernel's launch bound keeps two CTAs an SM by threads
# and registers, so two fit where their shared memory does.
THREADS = 256
CANDIDATE_BYTES = 24
SLICE_BYTES = 222 * 1024
CTA_EXTRA_BYTES = 5 * 1024
SM_BYTES = 228 * 1024
CLUSTER_SIZES = (1, 2, 4, 8)

launches = 0


def _iou_1_to_many(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one xyxy box per image (B, 4) against (B, K, 4), no epsilon:
    the formula of yolo_re_tpu/ops/nms.py:_iou_1_to_many."""
    lt = torch.maximum(box[:, None, :2], boxes[..., :2])
    rb = torch.minimum(box[:, None, 2:], boxes[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
    area2 = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    return inter / (area1[:, None] + area2 - inter)


def nms_select_plain(boxes_off: torch.Tensor, scores: torch.Tensor,
                     iou_thres: float, max_det: int) -> torch.Tensor:
    """The plain version: max_det greedy steps, batched over images."""
    bsz, k = scores.shape
    live = scores.clone()
    ar = torch.arange(k, device=scores.device)
    rows = torch.arange(bsz, device=scores.device)
    out = torch.full((bsz, max_det), -1, dtype=torch.int32,
                     device=scores.device)
    for i in range(max_det):
        idx = torch.argmax(live, dim=1)              # first index on ties
        keep = live[rows, idx] > 0.0
        iou = _iou_1_to_many(boxes_off[rows, idx], boxes_off)
        suppress = (iou > iou_thres) | (ar[None] == idx[:, None])
        live = torch.where(keep[:, None] & suppress, 0.0, live)
        out[:, i] = torch.where(keep, idx, -1).to(torch.int32)
    return out


def slice_bytes(k: int, c: int) -> int:
    """Shared memory of a CTA's slice: ceil(k / c) candidates."""
    return -(-k // c) * CANDIDATE_BYTES


def ctas_per_sm(k: int, c: int) -> int:
    """CTAs of the kernel an SM holds at once at slices of ceil(k / c)."""
    return 2 if 2 * (slice_bytes(k, c) + CTA_EXTRA_BYTES) <= SM_BYTES else 1


def cluster_size(b: int, k: int, sms: int) -> int:
    """CTAs per image of the kernel's launch (grid b * c): the largest c
    of CLUSTER_SIZES whose b * c CTAs the card's sms SMs hold at once
    (two an SM where their slices fit) and whose slices give every thread
    a candidate, else 1; then raised until a slice of ceil(k / c)
    candidates fits a CTA's shared memory (k > 9472 needs 2), in waves
    of clusters where the SMs cannot hold them all."""
    c = max(c for c in CLUSTER_SIZES
            if c == 1 or (b * c <= sms * ctas_per_sm(k, c)
                          and k // c >= THREADS))
    while slice_bytes(k, c) > SLICE_BYTES:
        c *= 2
    return c


def nms_select(boxes_off: torch.Tensor, scores: torch.Tensor,
               iou_thres: float, max_det: int) -> torch.Tensor:
    """boxes_off (B, K, 4) float32 xyxy with class offsets, scores (B, K)
    float32 (<= 0 marks invalid) -> (B, max_det) int32 indices, -1 = none.
    One call of the custom op `yolo_torch::nms_select`."""
    _check(boxes_off, scores)
    return _op(boxes_off, scores, float(iou_thres), int(max_det))


def _check(boxes_off: torch.Tensor, scores: torch.Tensor) -> None:
    common.check_device(boxes_off)
    if boxes_off.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms_select: boxes and scores must be float32")
    if boxes_off.dim() != 3 or boxes_off.shape[2] != 4 or \
            tuple(scores.shape) != tuple(boxes_off.shape[:2]):
        raise ValueError(f"nms_select: expected boxes (B, K, 4) and scores "
                         f"(B, K), got {tuple(boxes_off.shape)} and "
                         f"{tuple(scores.shape)}")
    if scores.device != boxes_off.device:
        raise ValueError("nms_select: boxes and scores on different devices")
    if not (boxes_off.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_select: boxes and scores must be contiguous")
    k = scores.shape[1]
    if k > MAX_K or k < 1:
        raise ValueError(f"nms_select: K must be in [1, {MAX_K}], got {k}")


@torch.library.custom_op("yolo_torch::nms_select", mutates_args=(),
                         device_types="cpu")
def _op(boxes_off: torch.Tensor, scores: torch.Tensor, iou_thres: float,
        max_det: int) -> torch.Tensor:
    """The CPU implementation: the plain version (its loop runs here, in
    the op, and is never traced)."""
    return nms_select_plain(boxes_off, scores, iou_thres, max_det)


@_op.register_kernel("cuda")
def _launch(boxes_off: torch.Tensor, scores: torch.Tensor, iou_thres: float,
            max_det: int) -> torch.Tensor:
    """The CUDA implementation: one launch of the kernel, its cluster size
    from the device's SM count. The checks are repeated here: an exported
    graph calls the op without the wrapper."""
    global launches
    _check(boxes_off, scores)
    common.check_cuda(boxes_off)
    bsz, k = scores.shape
    out = torch.empty((bsz, max_det), dtype=torch.int32,
                      device=boxes_off.device)
    c = cluster_size(bsz, k, torch.cuda.get_device_properties(
        boxes_off.device).multi_processor_count)
    lib = build.library()
    with torch.cuda.device(boxes_off.device):
        err = lib.yolo_nms_select(
            boxes_off.data_ptr(), scores.data_ptr(), out.data_ptr(), bsz, k,
            max_det, float(iou_thres), c, common.stream(boxes_off))
    build.check(err, "nms_select")
    launches += 1
    return out


@_op.register_fake
def _fake(boxes_off: torch.Tensor, scores: torch.Tensor, iou_thres: float,
          max_det: int) -> torch.Tensor:
    return boxes_off.new_empty((boxes_off.shape[0], max_det),
                               dtype=torch.int32)
