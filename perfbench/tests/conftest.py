"""The benchmark's tests: the perfbench directory and the repository root
on the import path, and the tiny configurations the CPU runs."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import yaml

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def tiny_config(layers_yaml: str, like: str, size: int = 64) -> dict:
    """A tiny model's configuration, in float32, with the class-bias rule
    and the weights' init of the configuration `like`."""
    import run

    d = yaml.safe_load(layers_yaml)
    cfg = run.load(HERE / "configs" / f"{like}.json")
    return {"name": "tiny", "num_classes": d["model"]["num_classes"],
            "depth_multiplier": 1.0, "width_multiplier": 1.0,
            "img_size": size, "precision": "float32",
            "class_bias": cfg["class_bias"], "init": cfg.get("init", {}),
            "layers": d["layers"]}


@pytest.fixture
def tiny_serve():
    from yolo_re_tpu_torch.data.synth import TINY_YAML

    import run

    mix = {**run.load(HERE / "mixes" / "serve.host.json"), "batch": 2,
           "height": 48, "width": 80, "pool": 2, "check_requests": 2,
           "max_det": 50, "topk": 64}
    return tiny_config(TINY_YAML, "gelan-c"), mix


@pytest.fixture
def tiny_train():
    from yolo_re_tpu_torch.data.synth import TINY_DUAL_YAML

    import run

    mix = {**run.load(HERE / "mixes" / "train.b32.json"), "batch": 4,
           "size": 64, "pool": 3}
    return tiny_config(TINY_DUAL_YAML, "yolov9-c"), mix
