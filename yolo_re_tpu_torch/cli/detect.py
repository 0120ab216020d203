"""Inference CLI: detect objects in images (counterpart of
scripts/detect.py).

Example:
    python -m yolo_re_tpu_torch.cli.detect --weights weights/gelan-c.npz \\
        --source img.jpg --output out/

The weights are an .npz of either package (bare weights, or a training
checkpoint, whose EMA weights are taken) or a torch `.pt` (a raw upstream
yolov9 checkpoint, renamed by the layer map named after the config's
file, a reference-schema state dict or a training container of either),
loaded in one hop. Each image is letterboxed on the host, run through the
model (fused unless --no-fuse, so that on the card the stem, ADown, chain
and conv3 kernels run) and class-aware NMS (the NMS kernel), and its boxes
are scaled back to the image and drawn into `--output`. It runs on the
card (`--device cuda`, the default) or, when asked, on the CPU with the
kernels' plain versions, in float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scale_boxes(boxes: np.ndarray, from_shape, to_shape) -> np.ndarray:
    """Undo the letterbox: boxes in the padded `from_shape` canvas ->
    pixels of the original `to_shape` image (reference
    scripts/detect.py:74-109)."""
    gain = min(from_shape[0] / to_shape[0], from_shape[1] / to_shape[1])
    pad_x = (from_shape[1] - to_shape[1] * gain) / 2
    pad_y = (from_shape[0] - to_shape[0] * gain) / 2
    boxes = boxes.copy()
    boxes[:, [0, 2]] = (boxes[:, [0, 2]] - pad_x) / gain
    boxes[:, [1, 3]] = (boxes[:, [1, 3]] - pad_y) / gain
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, to_shape[1])
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, to_shape[0])
    return boxes


def load_model(config: str, weights: str, num_classes: int,
               allow_extra: bool = False):
    """The model of `config` with `weights` (.npz or .pt) loaded
    strictly, unfused, on the CPU."""
    from yolo_re_tpu_torch.convert import load_weights, state_dict_from_jax
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.upstream import (
        is_upstream_state_dict,
        load_torch_checkpoint,
        port_state_dict,
    )

    model = YOLO.from_yaml(config, num_classes=num_classes)
    if weights.endswith(".npz"):
        sd = state_dict_from_jax(model.plan, *load_weights(weights))
    elif weights.endswith((".pt", ".pth")):
        raw = load_torch_checkpoint(weights)
        name = Path(config).stem
        if is_upstream_state_dict(raw):
            print(f"upstream yolov9 schema detected; applying the {name} "
                  f"layer map")
        sd = port_state_dict(raw, model, name, allow_extra=allow_extra)
    else:
        raise SystemExit(f"Unsupported weights format: {weights}")
    model.load_state_dict(sd, strict=True)
    return model


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Run detection on images")
    ap.add_argument("--weights", required=True,
                    help=".npz params (converter or checkpoint output) or "
                         "a torch .pt")
    ap.add_argument("--config", default="configs/models/gelan-c.yaml")
    ap.add_argument("--source", required=True, help="image file or directory")
    ap.add_argument("--output", default="runs/detect")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--classes", type=int, nargs="+", default=None,
                    help="only keep detections of these class indices")
    ap.add_argument("--show", action="store_true",
                    help="display each annotated image (needs a GUI)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="skip BN/RepConv inference fusion (and the fused "
                         "blocks' kernels)")
    ap.add_argument("--allow-extra", action="store_true",
                    help="drop unrecognized keys when ingesting a .pt "
                         "(as convert_weights does)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--json", default=None,
                    help="also write every image's detections, "
                         "[x1, y1, x2, y2, conf, cls] in its pixels, here")
    args = ap.parse_args(argv)

    import cv2
    import torch

    from yolo_re_tpu_torch.data.augment import letterbox
    from yolo_re_tpu_torch.ops.nms import nms_to_list, non_max_suppression
    from yolo_re_tpu_torch.utils.precision import full_f32
    from yolo_re_tpu_torch.utils.visualize import draw_boxes

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu)")
    model = load_model(args.config, args.weights, args.num_classes,
                       args.allow_extra)
    if not args.no_fuse:
        model.fuse()
    model = model.eval().to(device)

    src = Path(args.source)
    paths = sorted(src.glob("*")) if src.is_dir() else [src]
    paths = [p for p in paths if p.suffix.lower() in IMAGE_SUFFIXES]
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)

    times, found = [], {}
    for path in paths:
        img0 = cv2.imread(str(path))
        if img0 is None:
            print(f"skip unreadable {path}")
            continue
        img, _, _ = letterbox(img0, args.img_size, auto=False)
        x = torch.from_numpy(np.ascontiguousarray(
            img[None, :, :, ::-1].transpose(0, 3, 1, 2)))

        t0 = time.perf_counter()
        with torch.no_grad(), full_f32():
            x = x.to(device).float() / 255.0
            decoded = model(x, main_only=True)[0]
            out = non_max_suppression(
                decoded, conf_thres=args.conf, iou_thres=args.iou,
                classes=tuple(args.classes) if args.classes else None)
        det = nms_to_list(out)[0]          # copies to the host: synchronizes
        dt = (time.perf_counter() - t0) * 1000
        times.append(dt)

        det[:, :4] = scale_boxes(det[:, :4], img.shape[:2], img0.shape[:2])
        found[path.name] = det.tolist()
        vis = draw_boxes(img0, det[:, :4], det[:, 5], det[:, 4])
        out_path = out_dir / path.name
        cv2.imwrite(str(out_path), vis)
        if args.show:
            cv2.imshow(path.name, vis)
            cv2.waitKey(0)
        print(f"{path.name}: {len(det)} detections in {dt:.1f} ms -> "
              f"{out_path}")

    if args.json:
        Path(args.json).write_text(json.dumps(found))
    if times:
        # the first call includes the kernels' build and cuDNN's choices
        steady = times[1:] or times
        print(f"average: {np.mean(steady):.1f} ms/image "
              f"(first call {times[0]:.1f} ms, the kernels' build and "
              f"setup included)")


if __name__ == "__main__":
    main()
