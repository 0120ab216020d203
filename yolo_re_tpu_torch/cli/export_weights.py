"""Export weights to the torch reference's format (counterpart of
scripts/export_weights.py).

Example:
    python -m yolo_re_tpu_torch.cli.export_weights --weights best.npz \\
        --config configs/models/gelan-c.yaml --output gelan-c-torch.pt

The inverse of `cli.convert_weights`: the input is an .npz of weights of
either package, a training checkpoint .npz, or the port's checkpoint
directory (of a checkpoint, the EMA weights); the output is a `.pt` state
dict in the reference schema (`layers.<name>...`, OIHW conv kernels, BN
running statistics and counters, the fixed DFL projection convs) that the
reference model loads with `load_state_dict(sd)` (strict), so that models
trained with the port deploy straight into the torch reference. Runs on
the CPU: no device is needed.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Export weights to the reference's torch state dict")
    ap.add_argument("--weights", required=True,
                    help=".npz params, training checkpoint .npz, or "
                         "checkpoint directory")
    ap.add_argument("--config", required=True, help="model YAML")
    ap.add_argument("--output", required=True, help=".pt to write")
    ap.add_argument("--num-classes", type=int, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from yolo_re_tpu_torch.convert import load_weights, state_dict_from_jax
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.upstream import reference_state_dict

    path = Path(args.weights)
    if path.is_dir():
        source = "checkpoint directory, EMA weights"
    else:
        with np.load(path) as data:
            ckpt = any(k.startswith("ema_params/") for k in data.files)
        source = "training checkpoint, EMA weights" if ckpt else "weights"
    model = YOLO.from_yaml(args.config, num_classes=args.num_classes)
    sd = state_dict_from_jax(model.plan, *load_weights(path))
    model.load_state_dict(sd, strict=True)
    torch.save(reference_state_dict(model, sd), args.output)
    n = sum(p.numel() for p in model.parameters())
    print(f"wrote {args.output} from {path.name} ({source}; {n:,} params, "
          f"reference torch format)")


if __name__ == "__main__":
    main()
