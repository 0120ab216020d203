"""Synthetic color-coded detection data + the tiny model that learns it.

A numpy-only copy of yolo_re_tpu/data/synth.py (cv2 is imported only inside
`write_dataset`); tests/test_torch_model.py pins the two equal.

In the port it feeds the tests and chip_smoke.py: the trained fixture
assets/dryrun_tiny.npz recognizes the arrays `make_eval_batch` draws.

Class k is a solid rectangle of COLORS[k] on dark noise — learnable to
mAP50 ~0.7+ in a few hundred steps (PARITY.md "mAP parity"). The reference
has no synthetic-data module; this stands in for COCO128 on the
zero-egress host (reference benchmark: scripts/download_coco128.py).
"""

from __future__ import annotations

import os

import numpy as np

NUM_CLASSES = 4
COLORS_BGR = [(60, 60, 230), (60, 230, 60), (230, 60, 60), (60, 230, 230)]

TINY_YAML = """
model:
  num_classes: 4
layers:
  - {name: stem1, type: Conv, out_channels: 16, kernel_size: 3, stride: 2}
  - {name: stem2, type: Conv, out_channels: 32, kernel_size: 3, stride: 2}
  - {name: stage1, type: RepNCSPELAN4, out_channels: 32, hidden_channels: 32, block_channels: 16, num_repeats: 1}
  - {name: down1, type: ADown, out_channels: 32}
  - {name: stage2, type: RepNCSPELAN4, out_channels: 48, hidden_channels: 48, block_channels: 24, num_repeats: 1}
  - {name: down2, type: ADown, out_channels: 48}
  - {name: stage3, type: RepNCSPELAN4, out_channels: 64, hidden_channels: 64, block_channels: 32, num_repeats: 1}
  - {name: up1, type: Upsample, scale_factor: 2}
  - {name: concat1, type: Concat, from: [up1, stage2]}
  - {name: fpn1, type: RepNCSPELAN4, out_channels: 48, hidden_channels: 48, block_channels: 24, num_repeats: 1}
  - {name: up2, type: Upsample, scale_factor: 2}
  - {name: concat2, type: Concat, from: [up2, stage1]}
  - {name: fpn2, type: RepNCSPELAN4, out_channels: 32, hidden_channels: 32, block_channels: 16, num_repeats: 1}
  - {name: pan_down1, type: ADown, out_channels: 32}
  - {name: concat3, type: Concat, from: [pan_down1, fpn1]}
  - {name: pan1, type: RepNCSPELAN4, out_channels: 48, hidden_channels: 48, block_channels: 24, num_repeats: 1}
  - {name: pan_down2, type: ADown, out_channels: 48}
  - {name: concat4, type: Concat, from: [pan_down2, stage3]}
  - {name: pan2, type: RepNCSPELAN4, out_channels: 64, hidden_channels: 64, block_channels: 32, num_repeats: 1}
  - {name: detect, type: DetectDFL, from: [fpn2, pan1, pan2]}
"""


# Tiny dual-head (yolov9-style aux branch) model: Silence input tap,
# CBLinear/CBFuse routing, DualDetectDFL — shared-schema YAML both
# frameworks parse (used by tests/conftest.py fixtures and the dual
# loss-curve harness, scripts/validate_loss_curve.py --model tiny-dual).
TINY_DUAL_YAML = """
model:
  num_classes: 8
layers:
  - {name: input_silence, type: Silence, from: input}
  - {name: stem1, type: Conv, out_channels: 16, kernel_size: 3, stride: 2}
  - {name: stem2, type: Conv, out_channels: 32, kernel_size: 3, stride: 2}
  - {name: stage1, type: RepNCSPELAN4, out_channels: 32, hidden_channels: 32, block_channels: 16, num_repeats: 1}
  - {name: down1, type: ADown, out_channels: 32}
  - {name: stage2, type: RepNCSPELAN4, out_channels: 48, hidden_channels: 48, block_channels: 24, num_repeats: 1}
  - {name: down2, type: ADown, out_channels: 48}
  - {name: stage3, type: RepNCSPELAN4, out_channels: 64, hidden_channels: 64, block_channels: 32, num_repeats: 1}
  - {name: down3, type: ADown, out_channels: 64}
  - {name: stage4, type: RepNCSPELAN4, out_channels: 64, hidden_channels: 64, block_channels: 32, num_repeats: 1}
  - {name: spp, type: SPPELAN, out_channels: 64, hidden_channels: 32}
  - {name: up1, type: Upsample, scale_factor: 2}
  - {name: concat1, type: Concat, from: [up1, stage3]}
  - {name: fpn1, type: RepNCSPELAN4, out_channels: 48, hidden_channels: 48, block_channels: 24, num_repeats: 1}
  - {name: up2, type: Upsample, scale_factor: 2}
  - {name: concat2, type: Concat, from: [up2, stage2]}
  - {name: fpn2, type: RepNCSPELAN4, out_channels: 32, hidden_channels: 32, block_channels: 16, num_repeats: 1}
  - {name: pan_down1, type: ADown, out_channels: 32}
  - {name: concat3, type: Concat, from: [pan_down1, fpn1]}
  - {name: pan1, type: RepNCSPELAN4, out_channels: 48, hidden_channels: 48, block_channels: 24, num_repeats: 1}
  - {name: pan_down2, type: ADown, out_channels: 48}
  - {name: concat4, type: Concat, from: [pan_down2, spp]}
  - {name: pan2, type: RepNCSPELAN4, out_channels: 64, hidden_channels: 64, block_channels: 32, num_repeats: 1}
  - {name: cb_route1, type: CBLinear, from: stage2, out_channels_list: [32]}
  - {name: cb_route2, type: CBLinear, from: stage3, out_channels_list: [32, 48]}
  - {name: cb_route3, type: CBLinear, from: stage4, out_channels_list: [32, 48, 64]}
  - {name: aux_stem1, type: Conv, from: input_silence, out_channels: 16, kernel_size: 3, stride: 2}
  - {name: aux_stem2, type: Conv, out_channels: 32, kernel_size: 3, stride: 2}
  - {name: aux_stage1, type: RepNCSPELAN4, out_channels: 32, hidden_channels: 32, block_channels: 16, num_repeats: 1}
  - {name: aux_down1, type: ADown, out_channels: 32}
  - {name: aux_fuse1, type: CBFuse, from: [cb_route1, cb_route2, cb_route3, aux_down1], idx: [0, 0, 0]}
  - {name: aux_stage2, type: RepNCSPELAN4, out_channels: 48, hidden_channels: 48, block_channels: 24, num_repeats: 1}
  - {name: aux_down2, type: ADown, out_channels: 48}
  - {name: aux_fuse2, type: CBFuse, from: [cb_route2, cb_route3, aux_down2], idx: [1, 1]}
  - {name: aux_stage3, type: RepNCSPELAN4, out_channels: 48, hidden_channels: 48, block_channels: 24, num_repeats: 1}
  - {name: aux_down3, type: ADown, out_channels: 64}
  - {name: aux_fuse3, type: CBFuse, from: [cb_route3, aux_down3], idx: [2]}
  - {name: aux_stage4, type: RepNCSPELAN4, out_channels: 64, hidden_channels: 64, block_channels: 32, num_repeats: 1}
  - {name: detect, type: DualDetectDFL, from: [aux_stage2, aux_stage3, aux_stage4, fpn2, pan1, pan2]}
"""


def draw_sample(rng: np.random.Generator, size: int, *,
                dense: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """One synthetic sample: (img BGR uint8 (size, size, 3),
    labels (n, 5) [cls, cx, cy, bw, bh] normalized).

    dense=True: 56-96 small boxes on a jittered 10x10 grid (crowded-NMS /
    many-GT regime); else 1-3 medium boxes.
    """
    h = w = size
    img = rng.integers(0, 80, (h, w, 3)).astype(np.uint8)
    placements = []
    if dense:
        cells = [(r, c) for r in range(10) for c in range(10)]
        rng.shuffle(cells)
        for (r, c) in cells[:int(rng.integers(56, 97))]:
            cx = (c + 0.5) * w / 10 + rng.uniform(-4, 4)
            cy = (r + 0.5) * h / 10 + rng.uniform(-4, 4)
            bw, bh = rng.uniform(12, 24, 2)
            placements.append((cx / w, cy / h, bw / w, bh / h))
    else:
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            bw, bh = rng.uniform(0.15, 0.35, 2)
            placements.append((cx, cy, bw, bh))
    labels = []
    for (cx, cy, bw, bh) in placements:
        cls = int(rng.integers(0, NUM_CLASSES))
        x1, y1 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
        x2, y2 = int((cx + bw / 2) * w), int((cy + bh / 2) * h)
        # inclusive end like cv2.rectangle(..., thickness=-1)
        img[max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = COLORS_BGR[cls]
        labels.append([cls, cx, cy, bw, bh])
    return img, np.asarray(labels, np.float32).reshape(-1, 5)


def write_dataset(root: str, split: str, n: int, seed: int,
                  dense: bool = False) -> str:
    """On-disk images/ + labels/ split of `draw_sample` data; returns the
    image directory (the loader's `train_path`/`val_path`)."""
    import cv2

    img_dir = os.path.join(root, "images", split)
    lab_dir = os.path.join(root, "labels", split)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, labels = draw_sample(rng, 320 if dense else 160, dense=dense)
        cv2.imwrite(os.path.join(img_dir, f"im{i}.jpg"), img)
        with open(os.path.join(lab_dir, f"im{i}.txt"), "w") as f:
            f.write("\n".join(
                f"{int(c)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"
                for c, cx, cy, bw, bh in labels) + "\n")
    return img_dir


def make_eval_batch(n: int, size: int, seed: int, max_boxes: int = 8
                    ) -> dict[str, np.ndarray]:
    """In-memory RGB eval batch in the Evaluator's dict format:
    images (n, size, size, 3) uint8 RGB, targets (n, max_boxes, 5)
    [cls, xywh normalized] zero-padded, nboxes (n,)."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, size, size, 3), np.uint8)
    targets = np.zeros((n, max_boxes, 5), np.float32)
    nboxes = np.zeros((n,), np.int32)
    for i in range(n):
        img, labels = draw_sample(rng, size)
        images[i] = img[..., ::-1]                  # BGR (cv2) -> RGB
        k = min(len(labels), max_boxes)
        targets[i, :k] = labels[:k]
        nboxes[i] = k
    return {"images": images, "targets": targets, "nboxes": nboxes}
