"""Export the whole serving pipeline as one `torch.export` archive
(counterpart of scripts/export_serving.py).

One self-contained .pt2 file holds the pixels-to-detections program
(device letterbox -> fused forward -> DFL decode -> NMS) with the fused
weights and the kernels' packed weight images; the hand-written kernels
stay in it as `yolo_torch::*` custom ops. Load it with
`yolo_re_tpu_torch.serving.Detector.load_exported(path)` on a host with
this package (which registers the ops), no model code or checkpoint
needed. The program is traced on `--device`; `--target-device` moves its
weights, constants and graph to another device before it is written (for
example an archive for CPU hosts from a detector on the card, where the
ops run their plain versions), as JAX's `--platforms` does.

Example:
    python -m yolo_re_tpu_torch.cli.export_serving --weights best.npz \\
        --config configs/models/gelan-c.yaml --batch 8 --out gelan-c.pt2

The weights are an .npz of either package (converter or checkpoint
output). `--verify` reloads the archive on `--device` (moved back from
`--target-device` if that differs) and holds it against the live Detector
on random frames, bit for bit.
"""

from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Serialize the pixels-to-detections program")
    ap.add_argument("--weights", required=True,
                    help=".npz params (converter or checkpoint output)")
    ap.add_argument("--config", default="configs/models/gelan-c.yaml")
    ap.add_argument("--out", required=True, help="output archive path")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--height", type=int, default=None,
                    help="input height (default: --img-size)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--max-det", type=int, default=300)
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--target-device", default=None,
                    help="device the archive runs on (default: --device)")
    ap.add_argument("--verify", action="store_true",
                    help="reload the archive and check it against the "
                         "live pipeline on random input")
    args = ap.parse_args(argv)

    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.serving import Detector

    model = YOLO.from_yaml(args.config, num_classes=args.num_classes)
    det = Detector.from_checkpoint(
        model, args.weights, device=args.device, img_size=args.img_size,
        conf_thres=args.conf, iou_thres=args.iou, max_det=args.max_det,
        compute_dtype=args.dtype)
    det.export(args.out, args.batch, height=args.height, width=args.width,
               device=args.target_device)
    size_mb = os.path.getsize(args.out) / 1e6
    h = args.height or args.img_size
    w = args.width or args.img_size
    print(f"wrote {args.out} ({size_mb:.1f} MB): "
          f"({args.batch}, {h}, {w}, 3) uint8 on "
          f"{args.target_device or det.device} -> padded NMS dict")

    if args.verify:
        import numpy as np
        import torch

        rng = np.random.default_rng(0)
        frames = rng.integers(0, 255, (args.batch, h, w, 3), dtype=np.uint8)
        live = det(frames)
        loaded = Detector.load_exported(args.out, device=det.device)(frames)
        for k in ("boxes", "scores", "classes", "valid"):
            if not torch.equal(live[k], loaded[k]):
                raise SystemExit(f"verify: {k} of the archive differs from "
                                 f"the live pipeline")
        print("verify: artifact output matches live pipeline")


if __name__ == "__main__":
    main()
