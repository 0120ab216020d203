"""Upstream WongKinYiu/yolov9 checkpoints in one hop (counterpart of
yolo_re_tpu/convert/torch_import.py:177-440).

Upstream names layers by index (`model.<i>.cv1...`); the port's state dict
uses the reference schema (`layers.<name>.conv_in...`). This module holds:

- the index -> (name, block type) layer maps of gelan-c and yolov9-c;
- `upstream_to_reference_sd` / `reference_to_upstream_sd`, the key
  rewriters both ways (strict accounting of keys the maps cannot place,
  the DFL projection checked against arange, anchors/strides dropped);
- `load_torch_checkpoint`, a `.pt` state dict or training container read
  to float32 (the EMA weights preferred, fp16 widened, integer counters
  kept);
- `port_state_dict`, any of these turned into a state dict that
  `YOLO.load_state_dict(..., strict=True)` takes.

The rewriters work on a dict of numpy arrays or torch tensors and return
the same values under new keys.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

SD = dict[str, Any]

# Upstream layer index -> (reference layer name, block type): the
# reference's own maps (scripts/convert_weights.py:23-47 gelan-c, :51-95
# yolov9-c). Indices without weights (Upsample, Concat, Silence, CBFuse)
# are absent; yolov9-c's index 0 is Silence.
UPSTREAM_GELAN_C_LAYERS: dict[int, tuple[str, str]] = {
    0: ("stem1", "Conv"), 1: ("stem2", "Conv"),
    2: ("stage1", "RepNCSPELAN4"), 3: ("down1", "ADown"),
    4: ("stage2", "RepNCSPELAN4"), 5: ("down2", "ADown"),
    6: ("stage3", "RepNCSPELAN4"), 7: ("down3", "ADown"),
    8: ("stage4", "RepNCSPELAN4"), 9: ("spp", "SPPELAN"),
    12: ("fpn1", "RepNCSPELAN4"), 15: ("fpn2", "RepNCSPELAN4"),
    16: ("pan_down1", "ADown"), 18: ("pan1", "RepNCSPELAN4"),
    19: ("pan_down2", "ADown"), 21: ("pan2", "RepNCSPELAN4"),
    22: ("detect", "DetectDFL"),
}

UPSTREAM_YOLOV9_C_LAYERS: dict[int, tuple[str, str]] = {
    1: ("stem1", "Conv"), 2: ("stem2", "Conv"),
    3: ("stage1", "RepNCSPELAN4"), 4: ("down1", "ADown"),
    5: ("stage2", "RepNCSPELAN4"), 6: ("down2", "ADown"),
    7: ("stage3", "RepNCSPELAN4"), 8: ("down3", "ADown"),
    9: ("stage4", "RepNCSPELAN4"), 10: ("spp", "SPPELAN"),
    13: ("fpn1", "RepNCSPELAN4"), 16: ("fpn2", "RepNCSPELAN4"),
    17: ("pan_down1", "ADown"), 19: ("pan1", "RepNCSPELAN4"),
    20: ("pan_down2", "ADown"), 22: ("pan2", "RepNCSPELAN4"),
    23: ("cb_route1", "CBLinear"), 24: ("cb_route2", "CBLinear"),
    25: ("cb_route3", "CBLinear"),
    26: ("aux_stem1", "Conv"), 27: ("aux_stem2", "Conv"),
    28: ("aux_stage1", "RepNCSPELAN4"), 29: ("aux_down1", "ADown"),
    31: ("aux_stage2", "RepNCSPELAN4"), 32: ("aux_down2", "ADown"),
    34: ("aux_stage3", "RepNCSPELAN4"), 35: ("aux_down3", "ADown"),
    37: ("aux_stage4", "RepNCSPELAN4"),
    38: ("detect", "DualDetectDFL"),
}

UPSTREAM_LAYER_MAPS = {
    "gelan-c": UPSTREAM_GELAN_C_LAYERS,
    "yolov9-c": UPSTREAM_YOLOV9_C_LAYERS,
}


def _up_elan_rest(rest: str) -> str:
    """RepNCSPELAN4 upstream submodule names -> reference names
    (reference scripts/convert_weights.py:123-176). Upstream: cv1 | cv2/cv3
    = Sequential(RepNCSP, Conv) | cv4; a RepNCSP holds cv1/cv2/cv3 and
    m.<i> RepNBottlenecks whose cv1 is a RepConvN (conv1/conv2 inside)."""
    if rest.startswith("cv1."):
        return "conv_in." + rest[4:]
    if rest.startswith("cv4."):
        return "conv_out." + rest[4:]
    if rest.startswith("cv2."):
        rest = "block1." + rest[4:]
    elif rest.startswith("cv3."):
        rest = "block2." + rest[4:]
    for bp in ("block1.0.", "block2.0."):
        if rest.startswith(bp):
            suffix = rest[len(bp):]
            if suffix.startswith("m."):
                suffix = "bottlenecks." + suffix[2:]
                suffix = suffix.replace(".cv1.", ".conv1.")
                suffix = suffix.replace(".cv2.", ".conv2.")
            elif suffix.startswith("cv1."):
                suffix = "conv1." + suffix[4:]
            elif suffix.startswith("cv2."):
                suffix = "conv2." + suffix[4:]
            elif suffix.startswith("cv3."):
                suffix = "conv3." + suffix[4:]
            return bp + suffix
    return rest


_UPSTREAM_REST_MAPPERS: dict[str, Callable[[str], str]] = {
    "Conv": lambda rest: rest,
    "CBLinear": lambda rest: rest,
    "ADown": lambda rest: rest.replace("cv1.", "conv_stride.")
                              .replace("cv2.", "conv_pool."),
    "SPPELAN": lambda rest: rest.replace("cv1.", "conv_in.")
                                .replace("cv5.", "conv_out."),
    "RepNCSPELAN4": _up_elan_rest,
    "DetectDFL": lambda rest: rest.replace("cv2.", "box_convs.")
                                  .replace("cv3.", "cls_convs."),
    "DualDetectDFL": lambda rest: rest.replace("cv2.", "aux_box_convs.")
                                      .replace("cv3.", "aux_cls_convs.")
                                      .replace("cv4.", "main_box_convs.")
                                      .replace("cv5.", "main_cls_convs."),
}


def _seg_swap(rest: str, table: dict[str, str]) -> str:
    """Rename only the first dotted segment of `rest` by `table`."""
    head, _, tail = rest.partition(".")
    return f"{table.get(head, head)}.{tail}" if tail else table.get(head, head)


def _down_elan_rest(rest: str) -> str:
    """Inverse of `_up_elan_rest`, segment by segment, so that the
    RepConv-internal conv1/conv2 names are never touched."""
    segs = rest.split(".")
    top = {"conv_in": "cv1", "conv_out": "cv4", "block1": "cv2",
           "block2": "cv3"}
    segs[0] = top.get(segs[0], segs[0])
    if len(segs) > 2 and segs[0] in ("cv2", "cv3") and segs[1] == "0":
        if segs[2] == "bottlenecks":
            segs[2] = "m"
            if len(segs) > 4:
                segs[4] = {"conv1": "cv1", "conv2": "cv2"}.get(segs[4],
                                                               segs[4])
        else:
            segs[2] = {"conv1": "cv1", "conv2": "cv2",
                       "conv3": "cv3"}.get(segs[2], segs[2])
    return ".".join(segs)


_DOWNSTREAM_REST_MAPPERS: dict[str, Callable[[str], str]] = {
    "Conv": lambda rest: rest,
    "CBLinear": lambda rest: rest,
    "ADown": lambda rest: _seg_swap(rest, {"conv_stride": "cv1",
                                           "conv_pool": "cv2"}),
    "SPPELAN": lambda rest: _seg_swap(rest, {"conv_in": "cv1",
                                             "conv_out": "cv5"}),
    "RepNCSPELAN4": _down_elan_rest,
    "DetectDFL": lambda rest: _seg_swap(rest, {"box_convs": "cv2",
                                               "cls_convs": "cv3"}),
    "DualDetectDFL": lambda rest: _seg_swap(
        rest, {"aux_box_convs": "cv2", "aux_cls_convs": "cv3",
               "main_box_convs": "cv4", "main_cls_convs": "cv5"}),
}


def dfl_weight(reg_max: int = 16) -> np.ndarray:
    """The fixed DFL projection conv's weight: arange(reg_max)."""
    return np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1)


def _is_dfl(rest: str) -> bool:
    return rest.startswith("dfl") and rest.endswith("conv.weight")


def _check_dfl(key: str, tensor) -> None:
    """A DFL projection conv must be arange: the port derives it and
    refuses to drop another value."""
    w = np.asarray(tensor, np.float32).reshape(-1)
    if not np.allclose(w, np.arange(w.size, dtype=np.float32)):
        raise ValueError(
            f"{key}: DFL projection conv is not arange({w.size}); the port "
            "derives it and refuses to drop a non-standard value")


def reference_to_upstream_sd(sd: SD, model_name: str) -> SD:
    """A reference-schema state dict renamed into the upstream schema (the
    inverse of `upstream_to_reference_sd`), with the fixed DFL projection
    conv(s) that upstream checkpoints carry."""
    mapping = UPSTREAM_LAYER_MAPS[model_name]
    name_to_idx = {name: (idx, btype) for idx, (name, btype)
                   in mapping.items()}
    out: SD = {}
    detect_type = detect_idx = None
    for key, tensor in sd.items():
        if not key.startswith("layers."):
            continue
        _, name, rest = key.split(".", 2)
        if name not in name_to_idx:
            raise KeyError(f"layer {name!r} not in the {model_name} map")
        idx, btype = name_to_idx[name]
        if btype in ("DetectDFL", "DualDetectDFL"):
            detect_type, detect_idx = btype, idx
            if rest.startswith("dfl"):
                continue  # written below under upstream's own key
        out[f"model.{idx}.{_DOWNSTREAM_REST_MAPPERS[btype](rest)}"] = tensor
    if detect_type is not None:
        out[f"model.{detect_idx}.dfl.conv.weight"] = dfl_weight()
        if detect_type == "DualDetectDFL":
            out[f"model.{detect_idx}.dfl2.conv.weight"] = dfl_weight()
    return out


def reference_state_dict(model, sd: SD) -> dict[str, torch.Tensor]:
    """A state dict of `model` (a YOLO) -> the reference schema that the
    reference model loads with strict=True (yolo_re_tpu/convert/
    torch_export.py: export_state_dict): the same keys and values as
    float32 tensors (BN counters as they are), plus the fixed DFL
    projection conv(s) of the detect head, which the port derives."""
    out = {k: (torch.as_tensor(v) if "num_batches_tracked" in k
               else torch.as_tensor(v, dtype=torch.float32))
           for k, v in sd.items()}
    for step in model.plan.steps:
        if step.type in ("DetectDFL", "DualDetectDFL"):
            w = torch.from_numpy(dfl_weight(model.layers[step.name].reg_max))
            out[f"layers.{step.name}.dfl.conv.weight"] = w
            if step.type == "DualDetectDFL":
                out[f"layers.{step.name}.dfl2.conv.weight"] = w.clone()
    return out


def is_upstream_state_dict(sd: SD) -> bool:
    """Upstream yolov9 names layers by integer index: model.<i>.<rest>."""
    for k in sd:
        if k.startswith("model."):
            return k.split(".", 2)[1].isdigit()
    return False


def upstream_to_reference_sd(sd: SD, model_name: str, *,
                             strict: bool = True) -> SD:
    """An upstream WongKinYiu/yolov9 state dict's keys rewritten into the
    reference schema (reference scripts/convert_weights.py:204-249).

    anchors/strides buffers are dropped (derived, not loaded); BN
    num_batches_tracked counters are kept (the reference schema carries
    them); a DFL projection conv (`model.N.dfl*.conv.weight`) is checked
    against arange and dropped, and raises if it is anything else. Under
    `strict` (the default) any other key the layer map cannot place raises
    KeyError naming it; with strict=False such keys are dropped."""
    if model_name not in UPSTREAM_LAYER_MAPS:
        raise ValueError(f"No upstream layer map for {model_name!r}; "
                         f"have {sorted(UPSTREAM_LAYER_MAPS)}")
    mapping = UPSTREAM_LAYER_MAPS[model_name]
    out: SD = {}
    unplaced: list[str] = []
    for key, tensor in sd.items():
        parts = key.split(".", 2)
        if key.startswith("model.") and len(parts) == 3 and \
                parts[1].isdigit():
            idx, rest = int(parts[1]), parts[2]
        else:
            idx, rest = None, key
        if rest.rsplit(".", 1)[-1] in ("anchors", "strides"):
            continue
        if _is_dfl(rest):
            _check_dfl(key, tensor)
            continue
        if idx is None or idx not in mapping:
            unplaced.append(key)
            continue
        name, block_type = mapping[idx]
        out[f"layers.{name}.{_UPSTREAM_REST_MAPPERS[block_type](rest)}"] = \
            tensor
    if strict and unplaced:
        raise KeyError(
            f"{len(unplaced)} upstream key(s) not covered by the "
            f"{model_name} layer map: {sorted(unplaced)[:8]}"
            f"{' ...' if len(unplaced) > 8 else ''} "
            "(pass strict=False to drop them)")
    return out


def load_torch_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """A `.pt` state dict, module or training container -> {key: CPU
    tensor}. A container with `ema` and `model` entries gives its EMA
    weights (upstream's `attempt_load` does the same); floating tensors
    are widened to float32 (upstream releases ship fp16), integer
    counters are kept as they are."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and ("ema" in obj or "model" in obj):
        picked = obj.get("ema")
        obj = obj["model"] if picked is None else picked
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    out = {}
    for k, v in sd.items():
        v = torch.as_tensor(v).detach().cpu()
        out[k] = v.float() if v.is_floating_point() else v
    return out


def port_state_dict(sd: SD, model, model_name: str | None = None, *,
                    allow_extra: bool = False) -> dict[str, torch.Tensor]:
    """An upstream or reference-schema state dict -> a state dict of
    `model` (a YOLO) that `load_state_dict(strict=True)` takes: upstream
    keys renamed by the `model_name` layer map, the reference schema's DFL
    projection convs checked and dropped (the port derives them), the
    values as tensors in the model's dtypes. A key the model needs and
    `sd` lacks raises KeyError naming it (a fused RepConv's branches, a
    wrong config); a key the model does not hold raises ValueError naming
    it unless `allow_extra`."""
    if is_upstream_state_dict(sd):
        if model_name is None:
            raise ValueError("an upstream state dict needs the model's "
                             "name to pick its layer map")
        sd = upstream_to_reference_sd(sd, model_name, strict=not allow_extra)
    want = model.state_dict()
    out, extra = {}, []
    for key, value in sd.items():
        if key.startswith("layers.") and _is_dfl(key.split(".", 2)[2]):
            _check_dfl(key, value)
            continue
        if key not in want:
            extra.append(key)
            continue
        t = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.array(value))
        out[key] = t.to(want[key].dtype)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} tensor(s) of the model are not in "
                       f"the checkpoint: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    if extra and not allow_extra:
        raise ValueError(
            f"{len(extra)} checkpoint tensor(s) were not consumed by the "
            f"model: {sorted(extra)[:8]}{' ...' if len(extra) > 8 else ''} "
            "(allow_extra drops them)")
    return out
