"""The weight bridge between JAX-package weights and this package's state
dict, both ways.

- `state_dict_from_jax(plan, params, stats)` maps the JAX (params, stats)
  pytrees, as numpy arrays, onto the port's reference-schema state dict:
  conv kernels HWIO -> OIHW, BN scale/bias/mean/var -> bn.weight/bias/
  running_mean/running_var (the key schema of
  yolo_re_tpu/convert/torch_export.py). `YOLO.load_state_dict(...,
  strict=True)` takes the result.
- `jax_from_state_dict(plan, state_dict)` is its inverse: the port's state
  dict -> the JAX package's (params, stats) numpy pytrees, so both
  packages read each other's checkpoints (train/checkpoint.py).
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
    """(params, stats) numpy pytrees from a JAX-package `.npz` (the EMA
    weights of a training checkpoint, or bare converted weights) or from
    the port's checkpoint directory (its EMA weights; train/checkpoint.py)."""
    if Path(path).is_dir():
        from yolo_re_tpu_torch.train.checkpoint import load_checkpoint

        ckpt = load_checkpoint(path)
        return ckpt["ema"]["params"], ckpt["ema"]["stats"]
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


def _cblinear(out: SD, p: str, params: dict, stats: dict) -> None:
    out[p + "conv.weight"] = _t(params["w"])
    out[p + "conv.bias"] = _v(params["b"])


def _tower(out: SD, p: str, i: int, params: dict, stats: dict) -> None:
    """Level i's box and cls towers under `p` (`<head>.`, or `<head>.aux_`
    / `<head>.main_` in a dual head)."""
    for kind in ("box", "cls"):
        prefix = f"{p}{kind}_convs.{i}."
        for j in (0, 1):
            _conv(out, f"{prefix}{j}.", params[kind][j], stats[kind][j])
        out[f"{prefix}2.weight"] = _t(params[kind][2]["w"])
        out[f"{prefix}2.bias"] = _v(params[kind][2]["b"])


def _detect(out: SD, p: str, params: dict, stats: dict) -> None:
    for i, (tp, ts) in enumerate(zip(params["towers"], stats["towers"])):
        _tower(out, p, i, tp, ts)


def _dual_detect(out: SD, p: str, params: dict, stats: dict) -> None:
    for branch in ("aux", "main"):
        for i, (tp, ts) in enumerate(zip(params[branch], stats[branch])):
            _tower(out, f"{p}{branch}_", i, tp, ts)


_EMITTERS = {
    "Conv": _conv,
    "RepConv": _repconv,
    "RepNCSPELAN4": _elan,
    "SPPELAN": _pair("conv_in", "conv_out"),
    "ADown": _pair("conv_stride", "conv_pool"),
    "CBLinear": _cblinear,
    "DetectDFL": _detect,
    "DualDetectDFL": _dual_detect,
}
_PARAMETER_FREE = ("Concat", "Upsample", "Silence", "CBFuse")


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


# ---------------------------------------------------------------------------
# state dict -> (params, stats): the inverse of the emitters above
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _hwio(t: torch.Tensor) -> np.ndarray:
    """Conv kernel OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(_np(t), (2, 3, 1, 0)))


def _conv_inv(sd: SD, p: str) -> tuple[dict, dict]:
    return ({"w": _hwio(sd[p + "conv.weight"]),
             "scale": _np(sd[p + "bn.weight"]),
             "bias": _np(sd[p + "bn.bias"])},
            {"mean": _np(sd[p + "bn.running_mean"]),
             "var": _np(sd[p + "bn.running_var"])})


def _named_inv(sd: SD, items) -> tuple[dict, dict]:
    """items: (JAX name, state-dict prefix, inverse emitter) triples."""
    params, stats = {}, {}
    for name, prefix, inv in items:
        params[name], stats[name] = inv(sd, prefix)
    return params, stats


def _count(sd: SD, prefix: str) -> int:
    """Number of list entries `prefix<i>.` in the state dict."""
    return len({k[len(prefix):].split(".")[0] for k in sd
                if k.startswith(prefix)})


def _repconv_inv(sd: SD, p: str) -> tuple[dict, dict]:
    return _named_inv(sd, [("conv1", p + "conv1.", _conv_inv),
                           ("conv2", p + "conv2.", _conv_inv)])


def _repncsp_inv(sd: SD, p: str) -> tuple[dict, dict]:
    params, stats = _named_inv(sd, [(n, f"{p}{n}.", _conv_inv)
                                    for n in ("conv1", "conv2", "conv3")])
    params["bottlenecks"], stats["bottlenecks"] = [], []
    for i in range(_count(sd, p + "bottlenecks.")):
        bp, bs = _named_inv(sd, [
            ("conv1", f"{p}bottlenecks.{i}.conv1.", _repconv_inv),
            ("conv2", f"{p}bottlenecks.{i}.conv2.", _conv_inv)])
        params["bottlenecks"].append(bp)
        stats["bottlenecks"].append(bs)
    return params, stats


def _elan_inv(sd: SD, p: str) -> tuple[dict, dict]:
    return _named_inv(sd, [("conv_in", p + "conv_in.", _conv_inv),
                           ("csp1", p + "block1.0.", _repncsp_inv),
                           ("conv1", p + "block1.1.", _conv_inv),
                           ("csp2", p + "block2.0.", _repncsp_inv),
                           ("conv2", p + "block2.1.", _conv_inv),
                           ("conv_out", p + "conv_out.", _conv_inv)])


def _pair_inv(a: str, b: str):
    def inv(sd: SD, p: str) -> tuple[dict, dict]:
        return _named_inv(sd, [(a, f"{p}{a}.", _conv_inv),
                               (b, f"{p}{b}.", _conv_inv)])
    return inv


def _cblinear_inv(sd: SD, p: str) -> tuple[dict, dict]:
    return ({"w": _hwio(sd[p + "conv.weight"]),
             "b": _np(sd[p + "conv.bias"])}, {})


def _towers_inv(sd: SD, p: str) -> tuple[list, list]:
    """The towers under `p` (`<head>.` or `<head>.aux_` / `.main_`), level
    by level."""
    towers, tstats = [], []
    for i in range(_count(sd, p + "box_convs.")):
        tp, ts = {}, {}
        for kind in ("box", "cls"):
            prefix = f"{p}{kind}_convs.{i}."
            tp[kind], ts[kind] = [], []
            for j in (0, 1):
                cp, cs = _conv_inv(sd, f"{prefix}{j}.")
                tp[kind].append(cp)
                ts[kind].append(cs)
            tp[kind].append({"w": _hwio(sd[f"{prefix}2.weight"]),
                             "b": _np(sd[f"{prefix}2.bias"])})
            ts[kind].append({})
        towers.append(tp)
        tstats.append(ts)
    return towers, tstats


def _detect_inv(sd: SD, p: str) -> tuple[dict, dict]:
    towers, tstats = _towers_inv(sd, p)
    return {"towers": towers}, {"towers": tstats}


def _dual_detect_inv(sd: SD, p: str) -> tuple[dict, dict]:
    params, stats = {}, {}
    for branch in ("aux", "main"):
        params[branch], stats[branch] = _towers_inv(sd, f"{p}{branch}_")
    return params, stats


_INVERSES = {
    "Conv": _conv_inv,
    "RepConv": _repconv_inv,
    "RepNCSPELAN4": _elan_inv,
    "SPPELAN": _pair_inv("conv_in", "conv_out"),
    "ADown": _pair_inv("conv_stride", "conv_pool"),
    "CBLinear": _cblinear_inv,
    "DetectDFL": _detect_inv,
    "DualDetectDFL": _dual_detect_inv,
}


def jax_from_state_dict(plan: Plan, state_dict: SD) -> tuple[dict, dict]:
    """This package's state dict (reference schema) -> the JAX package's
    (params, stats) pytrees of float32 numpy arrays, keyed by layer name
    (parameter-free layers map to empty dicts, as JAX's init gives them)."""
    params, stats = {}, {}
    for step in plan.steps:
        if step.type in _PARAMETER_FREE:
            params[step.name], stats[step.name] = {}, {}
            continue
        inv = _INVERSES.get(step.type)
        if inv is None:
            raise NotImplementedError(
                f"no weight mapping for block {step.type}")
        params[step.name], stats[step.name] = inv(
            state_dict, f"layers.{step.name}.")
    return params, stats
