"""Host data-loader throughput: the cv2 pipeline against the native C++
kernels (counterpart of scripts/bench_loader.py).

Measures images/s through the whole train-time host pipeline (decode ->
resize -> mosaic -> warp -> HSV -> flip -> pad) on a synthetic dataset,
once with the cv2/numpy prims (YOLO_TPU_NATIVE=0) and once with the
native kernels (YOLO_TPU_NATIVE=1: resize, Mosaic's blit, letterbox and
HSV through csrc/host/yolo_host.cpp, built at first use).

Example:
    python -m yolo_re_tpu_torch.cli.bench_loader --n 96 --img-size 640 \\
        --batch 16

Only the host pipeline runs: no model and no device. `loader_rates` is the
measurement on a dataset the caller already has.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def make_dataset(root: str, n: int, hw: int) -> str:
    """n random (hw, 1.3 hw) JPEGs with two labels each; returns the image
    directory."""
    import cv2
    import numpy as np

    img_dir = os.path.join(root, "images")
    lab_dir = os.path.join(root, "labels")
    os.makedirs(img_dir), os.makedirs(lab_dir)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 255, (hw, int(hw * 1.3), 3), np.uint8)
        cv2.imwrite(os.path.join(img_dir, f"{i:04d}.jpg"), img)
        with open(os.path.join(lab_dir, f"{i:04d}.txt"), "w") as f:
            f.write("1 0.5 0.5 0.4 0.4\n2 0.2 0.3 0.1 0.2\n")
    return img_dir


def run_epochs(path: str, img_size: int, batch: int, workers: int,
               epochs: int) -> float:
    """images/s of `epochs` train epochs (the "full" augmentation preset)
    after one warm-up epoch, under the current YOLO_TPU_NATIVE."""
    from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
    from yolo_re_tpu_torch.data.dataset import create_dataloader

    data = DataConfig(train_path=path, num_classes=8, img_size=img_size,
                      batch_size=batch, workers=workers,
                      augment=AugmentConfig("full"))
    loader = create_dataloader(path, data, "train")
    loader.set_epoch(0)
    for _ in loader:  # warm caches / thread pool
        pass
    t0 = time.perf_counter()
    n = 0
    for e in range(epochs):
        loader.set_epoch(e + 1)
        for b in loader:
            n += b["images"].shape[0]
    return n / (time.perf_counter() - t0)


def loader_rates(path: str, img_size: int = 640, batch: int = 16,
                 workers: int = 4, epochs: int = 3) -> dict[str, float]:
    """{"cv2": images/s, "native": images/s} of the train loader on the
    dataset at `path`. The native run requires the library (it is built
    here if it is not; a failed build raises). YOLO_TPU_NATIVE is restored
    afterwards."""
    before = os.environ.get("YOLO_TPU_NATIVE")
    rates = {}
    try:
        for name, mode in (("cv2", "0"), ("native", "1")):
            os.environ["YOLO_TPU_NATIVE"] = mode
            rates[name] = run_epochs(path, img_size, batch, workers, epochs)
    finally:
        if before is None:
            os.environ.pop("YOLO_TPU_NATIVE", None)
        else:
            os.environ["YOLO_TPU_NATIVE"] = before
    return rates


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Host loader images/s: cv2 "
                                             "against the native kernels")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as td:
        path = make_dataset(td, args.n, args.img_size)
        rates = loader_rates(path, args.img_size, args.batch, args.workers,
                             args.epochs)
    print(f"cv2 pipeline:    {rates['cv2']:7.1f} img/s")
    print(f"native pipeline: {rates['native']:7.1f} img/s "
          f"({rates['native'] / rates['cv2']:.2f}x)")


if __name__ == "__main__":
    main()
