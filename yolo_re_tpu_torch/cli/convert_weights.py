"""Convert a torch checkpoint to an .npz of weights that both packages read
(counterpart of scripts/convert_weights.py).

Example:
    python -m yolo_re_tpu_torch.cli.convert_weights --weights gelan-c.pt \\
        --config configs/models/gelan-c.yaml --output gelan-c.npz

The input is a `.pt` holding a raw upstream WongKinYiu/yolov9 state dict
(`model.<i>.cv1...`, renamed by the layer map named after the config's
file: gelan-c or yolov9-c), a reference-schema state dict
(`layers.<name>...`), or a training container of either (its EMA weights
are taken). The output holds `params/...` and `stats/...` in the JAX
package's key layout (HWIO conv kernels): `convert.load_weights` and the
JAX package's `load_params` read it. A checkpoint tensor the model does
not consume fails the conversion, with its name, unless --allow-extra.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Convert a torch checkpoint")
    ap.add_argument("--weights", required=True, help="torch .pt state_dict")
    ap.add_argument("--config", default="configs/models/gelan-c.yaml")
    ap.add_argument("--output", required=True, help="output .npz path")
    ap.add_argument("--num-classes", type=int, default=None)
    ap.add_argument("--allow-extra", action="store_true",
                    help="drop tensors the model does not consume instead "
                         "of failing (default: any unconsumed key errors)")
    args = ap.parse_args(argv)

    import numpy as np

    from yolo_re_tpu_torch.convert import flatten_tree, jax_from_state_dict
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.upstream import (
        is_upstream_state_dict,
        load_torch_checkpoint,
        port_state_dict,
    )

    model = YOLO.from_yaml(args.config, num_classes=args.num_classes)
    sd = load_torch_checkpoint(args.weights)
    name = Path(args.config).stem
    if is_upstream_state_dict(sd):
        print(f"upstream yolov9 schema detected; applying the {name} layer "
              f"map")
    try:
        state = port_state_dict(sd, model, name, allow_extra=args.allow_extra)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"ERROR: {e}") from None
    model.load_state_dict(state, strict=True)
    params, stats = jax_from_state_dict(model.plan, model.state_dict())
    flat = {f"params/{k}": v for k, v in flatten_tree(params).items()}
    flat.update({f"stats/{k}": v for k, v in flatten_tree(stats).items()})
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    with open(args.output, "wb") as f:
        np.savez(f, **flat)
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {len(sd)} torch tensors -> {args.output} "
          f"({n / 1e6:.2f}M params)")


if __name__ == "__main__":
    main()
