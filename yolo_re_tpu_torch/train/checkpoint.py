"""Training checkpoints: the full training state in the JAX package's
flat key layout (counterpart of yolo_re_tpu/train/checkpoint.py):

    params/<layer>/...      stats/<layer>/...       opt/...
    ema_params/<layer>/...  ema_stats/<layer>/...
    meta/epoch, meta/global_step, meta/best_fitness, meta/ema_updates,
    meta/config_json

The pytrees are the JAX package's (params, stats) layout, HWIO conv
kernels; `yolo_re_tpu_torch.convert` maps them to and from the port's
state dict. `opt/` holds the default SGD's momentum buffers as a params
tree (opt/<layer>/...), or an injected optimizer's state
(opt/<state name>/...; train/trainer.py).

Two formats, as in the JAX package (`TrainConfig.checkpoint_format`):

- "npz": one .npz file. Either package reads the other's files: npz is
  the format both packages read.
- "orbax": a checkpoint directory. The JAX package writes it with orbax,
  which imports jax, so the port cannot; the port's directory is a
  `torch.distributed.checkpoint` (DCP) one instead: the same flat keys
  as tensors (meta/config_json left out), and config.json beside the
  data, as the JAX package keeps it. Each package reads only its own
  directories: `load_checkpoint` refuses a directory that is not a DCP
  checkpoint (a JAX orbax one) with a ValueError.

The port writes on process 0 only, so the DCP save and load run with
`no_dist=True`: a collective save in an initialized process group would
wait for ranks that never call it.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch

from yolo_re_tpu_torch.convert import flatten_tree, unflatten_tree

_SECTIONS = ("params", "stats", "ema_params", "ema_stats", "opt")


def _flat_state(params, stats, ema, opt_bufs, epoch: int, global_step: int,
                best_fitness: float) -> dict[str, np.ndarray]:
    """The checkpoint's flat numpy arrays, meta/config_json aside."""
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
    return flat


def save_checkpoint(path: str | Path, *, params, stats, ema, opt_bufs,
                    epoch: int, global_step: int, best_fitness: float,
                    config: dict | None = None) -> None:
    """params, stats, opt_bufs and ema["params"] / ema["stats"] are numpy
    pytrees in the JAX layout; ema["updates"] an int."""
    flat = _flat_state(params, stats, ema, opt_bufs, epoch, global_step,
                       best_fitness)
    flat["meta/config_json"] = np.frombuffer(
        json.dumps(config or {}, default=str).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    tmp.replace(path)


@contextlib.contextmanager
def _single_process():
    """Silence DCP's warning that no process group is in use: the saves
    and loads are single-process on purpose (`no_dist=True`)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        yield


def save_checkpoint_dir(path: str | Path, *, params, stats, ema, opt_bufs,
                        epoch: int, global_step: int, best_fitness: float,
                        config: dict | None = None) -> None:
    """`save_checkpoint`'s contract, written as a DCP directory at `path`
    (replacing one that is there) with config.json beside the data."""
    import torch.distributed.checkpoint as dcp

    flat = _flat_state(params, stats, ema, opt_bufs, epoch, global_step,
                       best_fitness)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    with _single_process():
        dcp.save(tensors, checkpoint_id=str(tmp), no_dist=True)
    (tmp / "config.json").write_text(json.dumps(config or {}, default=str))
    if path.exists():
        shutil.rmtree(path)
    tmp.replace(path)


def is_checkpoint_dir(path: str | Path) -> bool:
    """A directory written by `save_checkpoint_dir` (DCP's .metadata)."""
    return (Path(path) / ".metadata").is_file()


def _read_dir(path: Path) -> tuple[dict[str, np.ndarray], dict]:
    """A DCP checkpoint directory -> (flat numpy arrays, config). Tensors
    are allocated from the checkpoint's metadata, then filled."""
    if not is_checkpoint_dir(path):
        raise ValueError(
            f"{path} is a directory but not a checkpoint directory of this "
            f"package (torch.distributed.checkpoint, with its .metadata): "
            f"the JAX package's orbax directories cannot be read without "
            f"jax. npz is the format both packages read: save with "
            f"checkpoint_format='npz'")
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    tensors = {k: torch.empty(m.size, dtype=m.properties.dtype)
               for k, m in meta.items()}
    with _single_process():
        dcp.load(tensors, checkpoint_id=str(path), no_dist=True)
    cfg_file = path / "config.json"
    config = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
    return {k: v.numpy() for k, v in tensors.items()}, config


def load_checkpoint(path: str | Path) -> dict:
    """-> {"params", "stats", "opt", "ema": {"params", "stats", "updates"},
    "epoch", "global_step", "best_fitness", "config"}, numpy pytrees; from
    an .npz or a checkpoint directory (`save_checkpoint_dir`)."""
    path = Path(path)
    if path.is_dir():
        flat, config = _read_dir(path)
    else:
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        cfg_bytes = flat.pop("meta/config_json", None)
        config = (json.loads(bytes(cfg_bytes).decode())
                  if cfg_bytes is not None and len(cfg_bytes) else {})
    sections: dict[str, dict] = {s: {} for s in _SECTIONS}
    meta: dict[str, Any] = {}
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        if head in sections:
            sections[head][rest] = v
        elif head == "meta":
            meta[rest] = v
    out = {name: unflatten_tree(tree) if tree else {}
           for name, tree in sections.items()}
    out["epoch"] = int(meta["epoch"])
    out["global_step"] = int(meta["global_step"])
    out["best_fitness"] = float(meta["best_fitness"])
    out["ema"] = {"params": out.pop("ema_params"),
                  "stats": out.pop("ema_stats"),
                  "updates": int(meta["ema_updates"])}
    out["config"] = config
    return out
