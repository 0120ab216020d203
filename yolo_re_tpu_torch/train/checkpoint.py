"""Training checkpoints: the full training state in one flat .npz, in the
JAX package's key layout (counterpart of yolo_re_tpu/train/checkpoint.py,
npz backend; orbax is not ported):

    params/<layer>/...      stats/<layer>/...       opt/<layer>/...
    ema_params/<layer>/...  ema_stats/<layer>/...
    meta/epoch, meta/global_step, meta/best_fitness, meta/ema_updates,
    meta/config_json

The pytrees are the JAX package's (params, stats) layout, HWIO conv
kernels; `yolo_re_tpu_torch.convert` maps them to and from the port's
state dict. Either package reads the other's files.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

from yolo_re_tpu_torch.convert import flatten_tree, unflatten_tree

_SECTIONS = ("params", "stats", "ema_params", "ema_stats", "opt")


def save_checkpoint(path: str | Path, *, params, stats, ema, opt_bufs,
                    epoch: int, global_step: int, best_fitness: float,
                    config: dict | None = None) -> None:
    """params, stats, opt_bufs and ema["params"] / ema["stats"] are numpy
    pytrees in the JAX layout; ema["updates"] an int."""
    flat: dict[str, Any] = {}
    for name, tree in (("params", params), ("stats", stats),
                       ("ema_params", ema["params"]),
                       ("ema_stats", ema["stats"]), ("opt", opt_bufs)):
        for k, v in flatten_tree(tree).items():
            flat[f"{name}/{k}"] = np.asarray(v)
    flat["meta/epoch"] = np.int64(epoch)
    flat["meta/global_step"] = np.int64(global_step)
    flat["meta/best_fitness"] = np.float64(best_fitness)
    flat["meta/ema_updates"] = np.asarray(ema["updates"], np.int32)
    flat["meta/config_json"] = np.frombuffer(
        json.dumps(config or {}, default=str).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    tmp.replace(path)


def load_checkpoint(path: str | Path) -> dict:
    """-> {"params", "stats", "opt", "ema": {"params", "stats", "updates"},
    "epoch", "global_step", "best_fitness", "config"}, numpy pytrees."""
    if Path(path).is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint): the port reads "
            f"npz checkpoints only")
    sections: dict[str, dict] = {s: {} for s in _SECTIONS}
    meta: dict[str, Any] = {}
    with np.load(path) as data:
        for k in data.files:
            head, _, rest = k.partition("/")
            if head in sections:
                sections[head][rest] = data[k]
            elif head == "meta":
                meta[rest] = data[k]
    out = {name: unflatten_tree(tree) if tree else {}
           for name, tree in sections.items()}
    out["epoch"] = int(meta["epoch"])
    out["global_step"] = int(meta["global_step"])
    out["best_fitness"] = float(meta["best_fitness"])
    out["ema"] = {"params": out.pop("ema_params"),
                  "stats": out.pop("ema_stats"),
                  "updates": int(meta["ema_updates"])}
    cfg_bytes = meta.get("config_json")
    out["config"] = (json.loads(bytes(cfg_bytes).decode())
                     if cfg_bytes is not None and len(cfg_bytes) else {})
    return out
