"""The weight bridge: JAX-package weights -> this package's state dict.

- `state_dict_from_jax(plan, params, stats)` maps the JAX (params, stats)
  pytrees, as numpy arrays, onto the port's reference-schema state dict:
  conv kernels HWIO -> OIHW, BN scale/bias/mean/var -> bn.weight/bias/
  running_mean/running_var (the key schema of
  yolo_re_tpu/convert/torch_export.py). `YOLO.load_state_dict(...,
  strict=True)` takes the result.
- `load_weights(path)` reads the JAX package's `.npz` weight files without
  jax: bare weights (`params/...`, `stats/...`) or the EMA weights of a
  full training checkpoint (`ema_params/...`, `ema_stats/...`); the
  counterpart of yolo_re_tpu/train/checkpoint.py:load_weights.
- `flatten_tree` / `unflatten_tree`: the npz key scheme
  (yolo_re_tpu/convert/torch_import.py:446-486).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from yolo_re_tpu_torch.models.builder import Plan

# Sentinels that keep empty containers through the flat-npz round trip.
_EMPTY_DICT = "__empty_dict__"
_EMPTY_LIST = "__empty_list__"


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}{_EMPTY_DICT}"] = np.zeros(0, np.uint8)
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_EMPTY_LIST}"] = np.zeros(0, np.uint8)
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if parts[-1] == _EMPTY_DICT:
            continue  # navigation already created the empty dict
        if parts[-1] == _EMPTY_LIST:
            node[_EMPTY_LIST] = True
            continue
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node.get(_EMPTY_LIST) is True and len(node) == 1:
            return []
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_weights(path: str | Path) -> tuple[dict, dict]:
    """(params, stats) numpy pytrees from a JAX-package `.npz`: the EMA
    weights of a training checkpoint, or bare converted weights."""
    with np.load(path) as data:
        files = list(data.files)
        if any(k.startswith("ema_params/") for k in files):
            heads = ("ema_params/", "ema_stats/")
        elif any(k.startswith("params/") for k in files):
            heads = ("params/", "stats/")
        else:
            raise ValueError(
                f"{path} contains neither a training checkpoint "
                f"(ema_params/*) nor bare weights (params/*)")
        trees = [{k[len(h):]: data[k] for k in files if k.startswith(h)}
                 for h in heads]
    return unflatten_tree(trees[0]), unflatten_tree(trees[1])


# ---------------------------------------------------------------------------
# (params, stats) -> state dict
# ---------------------------------------------------------------------------

SD = dict[str, torch.Tensor]


def _t(w) -> torch.Tensor:
    """Conv kernel HWIO -> OIHW."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _v(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _conv(out: SD, p: str, params: dict, stats: dict) -> None:
    out[p + "conv.weight"] = _t(params["w"])
    out[p + "bn.weight"] = _v(params["scale"])
    out[p + "bn.bias"] = _v(params["bias"])
    out[p + "bn.running_mean"] = _v(stats["mean"])
    out[p + "bn.running_var"] = _v(stats["var"])
    out[p + "bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _repconv(out: SD, p: str, params: dict, stats: dict) -> None:
    _conv(out, p + "conv1.", params["conv1"], stats["conv1"])
    _conv(out, p + "conv2.", params["conv2"], stats["conv2"])


def _repncsp(out: SD, p: str, params: dict, stats: dict) -> None:
    for name in ("conv1", "conv2", "conv3"):
        _conv(out, f"{p}{name}.", params[name], stats[name])
    for i, (bp, bs) in enumerate(zip(params["bottlenecks"],
                                     stats["bottlenecks"])):
        _repconv(out, f"{p}bottlenecks.{i}.conv1.", bp["conv1"], bs["conv1"])
        _conv(out, f"{p}bottlenecks.{i}.conv2.", bp["conv2"], bs["conv2"])


def _elan(out: SD, p: str, params: dict, stats: dict) -> None:
    _conv(out, p + "conv_in.", params["conv_in"], stats["conv_in"])
    _repncsp(out, p + "block1.0.", params["csp1"], stats["csp1"])
    _conv(out, p + "block1.1.", params["conv1"], stats["conv1"])
    _repncsp(out, p + "block2.0.", params["csp2"], stats["csp2"])
    _conv(out, p + "block2.1.", params["conv2"], stats["conv2"])
    _conv(out, p + "conv_out.", params["conv_out"], stats["conv_out"])


def _pair(a: str, b: str):
    def emit(out: SD, p: str, params: dict, stats: dict) -> None:
        _conv(out, f"{p}{a}.", params[a], stats[a])
        _conv(out, f"{p}{b}.", params[b], stats[b])
    return emit


def _detect(out: SD, p: str, params: dict, stats: dict) -> None:
    for i, (tp, ts) in enumerate(zip(params["towers"], stats["towers"])):
        for kind in ("box", "cls"):
            prefix = f"{p}{kind}_convs.{i}."
            for j in (0, 1):
                _conv(out, f"{prefix}{j}.", tp[kind][j], ts[kind][j])
            out[f"{prefix}2.weight"] = _t(tp[kind][2]["w"])
            out[f"{prefix}2.bias"] = _v(tp[kind][2]["b"])


_EMITTERS = {
    "Conv": _conv,
    "RepConv": _repconv,
    "RepNCSPELAN4": _elan,
    "SPPELAN": _pair("conv_in", "conv_out"),
    "ADown": _pair("conv_stride", "conv_pool"),
    "DetectDFL": _detect,
}
_PARAMETER_FREE = ("Concat", "Upsample")


def state_dict_from_jax(plan: Plan, params: dict, stats: dict) -> SD:
    """JAX (params, stats) pytrees of numpy arrays -> this package's
    state dict for the model built from `plan`."""
    out: SD = {}
    for step in plan.steps:
        if step.type in _PARAMETER_FREE:
            continue
        emit = _EMITTERS.get(step.type)
        if emit is None:
            raise NotImplementedError(
                f"no weight mapping for block {step.type}")
        emit(out, f"layers.{step.name}.", params[step.name],
             stats[step.name])
    return out
