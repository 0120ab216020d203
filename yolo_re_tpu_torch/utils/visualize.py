"""Debug rendering: draw GT/prediction boxes onto images (a copy of
yolo_re_tpu/utils/visualize.py).

Reference: src/yolo/utils/visualize.py — GT red, top-20 predictions green,
per-epoch debug dirs.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

COCO_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


def draw_boxes(
    img: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray | None = None,
    scores: np.ndarray | None = None,
    color: tuple[int, int, int] = (0, 255, 0),
    names: list[str] | None = None,
    thickness: int = 2,
) -> np.ndarray:
    """Draw xyxy boxes (+labels) on a BGR image copy."""
    img = img.copy()
    names = names or COCO_NAMES
    for i, box in enumerate(boxes):
        x1, y1, x2, y2 = (int(v) for v in box[:4])
        cv2.rectangle(img, (x1, y1), (x2, y2), color, thickness)
        label = ""
        if classes is not None:
            c = int(classes[i])
            label = names[c] if 0 <= c < len(names) else str(c)
        if scores is not None:
            label = f"{label} {scores[i]:.2f}".strip()
        if label:
            cv2.putText(img, label, (x1, max(y1 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return img


def save_debug_images(
    images: np.ndarray,          # (B, H, W, 3) float [0, 1] RGB
    detections: list[np.ndarray],  # per-image (n, 6) [xyxy, conf, cls]
    targets: np.ndarray,         # (B, M, 5) normalized [cls, xywh]
    nboxes: np.ndarray,
    out_dir: str | Path,
    max_images: int = 10,
    max_preds: int = 20,
) -> None:
    """GT red, top-k preds green (reference: visualize.py:80-129)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    saved = 0
    for i in range(len(images)):
        if saved >= max_images:
            break
        n = int(nboxes[i])
        if n == 0:
            continue
        img = (np.asarray(images[i]) * 255).astype(np.uint8)[..., ::-1].copy()
        h, w = img.shape[:2]
        t = targets[i, :n]
        cx, cy, bw, bh = t[:, 1] * w, t[:, 2] * h, t[:, 3] * w, t[:, 4] * h
        gt = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
        img = draw_boxes(img, gt, t[:, 0], color=(0, 0, 255))
        det = detections[i][:max_preds]
        if len(det):
            img = draw_boxes(img, det[:, :4], det[:, 5], det[:, 4],
                             color=(0, 255, 0))
        cv2.imwrite(str(out / f"img{i}.jpg"), img)
        saved += 1
