"""Training CLI (counterpart of scripts/train.py).

Example:
    python -m yolo_re_tpu_torch.cli.train --data /data/coco128/images/train \\
        --val /data/coco128/images/val --epochs 10 --batch 16 --bf16

Trains on the card (`--device cuda`, the default: the stem and ADown train
kernels) or, when asked, on the CPU with the kernels' plain versions.
`--weights` starts from an .npz of either package, `--resume` continues a
training checkpoint of either; checkpoints (`last.npz`, `best.npz` when
`--val` is given) go to `--output` in the JAX package's layout.

Data parallelism runs one process per card. Start each with the
coordinator (host:port where process 0 listens), the process count and
its id:

    python -m yolo_re_tpu_torch.cli.train --data ... --batch 64 \
        --coordinator 10.0.0.1:29500 --num-processes 8 --process-id I

or under torchrun (`torchrun --nproc-per-node 8 -m
yolo_re_tpu_torch.cli.train --data ...`), which sets the environment
`init_distributed` reads. `--batch` is the global batch; each process
loads and steps on its slice, and process 0 alone validates and writes
the outputs. `--no-dp` trains each process on its own (one card).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Train a YOLO model")
    ap.add_argument("--data", required=True, help="train images dir or list")
    ap.add_argument("--val", default=None, help="val images dir or list")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--config", default="configs/models/gelan-c.yaml")
    ap.add_argument("--weights", default=None, help=".npz params to load")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--augment", default="full",
                    choices=["full", "light", "minimal"])
    ap.add_argument("--val-period", type=int, default=1)
    ap.add_argument("--output", default="runs/train")
    ap.add_argument("--resume", default=None, help="checkpoint to resume")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--device-augment", default=None,
                    choices=["basic", "full"],
                    help="run augmentation on the device: 'basic' = "
                         "HSV/flip, 'full' = also mosaic/zoom/mixup (the "
                         "host only decodes and letterboxes)")
    ap.add_argument("--no-dp", action="store_true",
                    help="disable data parallelism")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process: host:port where process 0 listens "
                         "(launch one process per card with "
                         "--num-processes and a distinct --process-id; "
                         "under torchrun these can be omitted)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; NCCL between processes) or "
                         "cpu (their plain versions; gloo)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from yolo_re_tpu_torch.parallel.mesh import init_distributed
    from yolo_re_tpu_torch.utils.precision import full_f32

    joined = not dist.is_initialized()
    rank, world = init_distributed(args.coordinator, args.num_processes,
                                   args.process_id, device=args.device)
    joined = joined and dist.is_initialized()
    if joined:
        print(f"data parallel: process {rank}/{world}")
    try:
        with full_f32():
            _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args) -> None:
    from yolo_re_tpu_torch.convert import load_weights
    from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.train.trainer import Trainer

    model = YOLO.from_yaml(args.config, num_classes=args.num_classes)
    params = stats = None
    if args.weights:
        params, stats = load_weights(args.weights)

    data = DataConfig(
        train_path=args.data,
        val_path=args.val,
        num_classes=args.num_classes,
        img_size=args.img_size,
        batch_size=args.batch,
        workers=args.workers,
        augment=AugmentConfig(args.augment),
    )
    trainer = Trainer(
        model, data=data,
        params=params, stats=stats,
        device=args.device,
        epochs=args.epochs,
        lr=args.lr,
        val_period=args.val_period,
        output_dir=args.output,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        data_parallel=not args.no_dp,
        device_augment={"basic": True, "full": "full",
                        None: False}[args.device_augment],
    )
    if args.resume:
        trainer.load_checkpoint(args.resume)
    results = trainer.train()
    print("final:", results)


if __name__ == "__main__":
    main()
