"""Standalone validation CLI: mAP of a checkpoint on a dataset
(counterpart of scripts/val.py).

Example:
    python -m yolo_re_tpu_torch.cli.val --weights weights/gelan-c.npz \\
        --data data/coco128/images/train --num-classes 80 --bf16 --fuse

The weights are an .npz of either package (converter or checkpoint
output). It runs on the card (`--device cuda`, the default) or, when
asked, on the CPU with the kernels' plain versions, and prints one line of
`k=v` results. `--data-parallel` splits each batch over every local card
(`parallel.mesh.make_mesh`; with `--device cpu`, the CPU alone).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Evaluate a checkpoint (mAP)")
    ap.add_argument("--weights", required=True,
                    help=".npz params (converter or checkpoint output)")
    ap.add_argument("--config", default="configs/models/gelan-c.yaml")
    ap.add_argument("--data", required=True, help="val images dir or list")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--conf", type=float, default=0.001)
    ap.add_argument("--iou", type=float, default=0.6)
    ap.add_argument("--rect", action="store_true",
                    help="aspect-ratio-bucketed val batches")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--fuse", action="store_true",
                    help="fold BN/RepConv (and run the CUDA kernels) before "
                         "evaluating")
    ap.add_argument("--debug-dir", default=None,
                    help="dump GT/pred overlay images here")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard each val batch over all local devices")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from yolo_re_tpu_torch.convert import load_weights
    from yolo_re_tpu_torch.data.config import DataConfig
    from yolo_re_tpu_torch.data.dataset import create_dataloader
    from yolo_re_tpu_torch.eval.evaluator import Evaluator
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.parallel.mesh import make_mesh

    mesh = None
    if args.data_parallel:
        mesh = make_mesh() if args.device == "cuda" \
            else make_mesh(devices=(args.device,))
    model = YOLO.from_yaml(args.config, num_classes=args.num_classes)
    data = DataConfig(
        train_path=args.data, val_path=args.data,
        num_classes=args.num_classes, img_size=args.img_size,
        batch_size=args.batch, workers=args.workers, rect=args.rect,
    )
    loader = create_dataloader(args.data, data, mode="val")
    evaluator = Evaluator(
        model, loader, num_classes=args.num_classes,
        conf_thres=args.conf, iou_thres=args.iou,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        debug_dir=args.debug_dir, device=args.device, fuse=args.fuse,
        mesh=mesh,
    )
    results = evaluator.evaluate(load_weights(args.weights))
    print(" ".join(f"{k}={v:.4f}" for k, v in results.items()))


if __name__ == "__main__":
    main()
