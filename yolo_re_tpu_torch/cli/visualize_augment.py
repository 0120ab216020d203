"""Render augmented training samples for pipeline debugging (counterpart of
scripts/visualize_augment.py).

Writes N train-augmented and M val samples with their boxes drawn to
--out (train0.jpg ..., val0.jpg ...), each sample drawn from
`numpy.random.default_rng(1000 + i)`, so the files equal the JAX script's
byte for byte. The host data path is the port's copy of the JAX package's
(data/dataset.py, data/transforms.py, utils/visualize.py); nothing runs on
a device.

    python -m yolo_re_tpu_torch.cli.visualize_augment --data <train images>
        [--img-size 640] [--preset full] [--n-train 10] [--n-val 5]
        [--out debug_augment]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import cv2
import numpy as np

from yolo_re_tpu_torch.data.config import AugmentConfig
from yolo_re_tpu_torch.data.dataset import YOLODataset
from yolo_re_tpu_torch.data.transforms import (
    default_train_transforms,
    default_val_transforms,
)
from yolo_re_tpu_torch.utils.visualize import draw_boxes


def render(ds: YOLODataset, n: int, tag: str, out: Path) -> None:
    """Write the first `n` samples of `ds` as `<tag><i>.jpg` under `out`,
    boxes drawn, sample i drawn from default_rng(1000 + i)."""
    for i in range(min(n, len(ds))):
        rng = np.random.default_rng(1000 + i)
        s = ds.get_sample(i % len(ds), rng)
        img = s.img.copy()
        h, w = img.shape[:2]
        if len(s.labels):
            lab = s.labels
            cx, cy = lab[:, 1] * w, lab[:, 2] * h
            bw, bh = lab[:, 3] * w, lab[:, 4] * h
            boxes = np.stack([cx - bw / 2, cy - bh / 2,
                              cx + bw / 2, cy + bh / 2], 1)
            img = draw_boxes(img, boxes, lab[:, 0])
        cv2.imwrite(str(out / f"{tag}{i}.jpg"), img)
        print(f"wrote {tag}{i}.jpg ({len(s.labels)} boxes)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="train images dir")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--preset", default="full")
    ap.add_argument("--n-train", type=int, default=10)
    ap.add_argument("--n-val", type=int, default=5)
    ap.add_argument("--out", default="debug_augment")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    ds = YOLODataset(args.data, img_size=args.img_size, augment=True)
    ds.transforms = default_train_transforms(
        ds, args.img_size, AugmentConfig(args.preset))
    render(ds, args.n_train, "train", out)

    ds_val = YOLODataset(args.data, img_size=args.img_size)
    ds_val.transforms = default_val_transforms(args.img_size)
    render(ds_val, args.n_val, "val", out)


if __name__ == "__main__":
    main()
