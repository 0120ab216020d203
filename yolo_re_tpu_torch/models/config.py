"""Model configuration schema and YAML parsing.

A framework-free copy of yolo_re_tpu/models/config.py (this package never
imports the JAX one); tests/test_torch_model.py pins the two equal.

Mirrors the reference's declarative format (named layers + explicit `from:`
edges; reference: src/yolo/model/config.py, configs/models/*.yaml) so
existing model YAMLs carry over unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import yaml


@dataclass
class ModelConfig:
    """Full model configuration (reference: src/yolo/model/config.py:6-20)."""

    num_classes: int = 80
    depth_multiplier: float = 1.0
    width_multiplier: float = 1.0
    layers: list[dict] = field(default_factory=list)


@dataclass
class LayerDef:
    """Single layer definition (reference: src/yolo/model/config.py:23-45)."""

    name: str
    type: str
    from_layers: str | list[str] | None = None
    params: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: dict) -> "LayerDef":
        data = dict(data)
        name = data.pop("name")
        layer_type = data.pop("type")
        from_layers = data.pop("from", None)
        return cls(name=name, type=layer_type, from_layers=from_layers,
                   params=data)


def parse_yaml(path: str | Path) -> ModelConfig:
    """Parse model config from YAML (reference: src/yolo/model/parser.py:19-30)."""
    with open(path) as f:
        data = yaml.safe_load(f)
    model_data = data.get("model", {})
    return ModelConfig(
        num_classes=model_data.get("num_classes", 80),
        depth_multiplier=model_data.get("depth_multiplier", 1.0),
        width_multiplier=model_data.get("width_multiplier", 1.0),
        layers=data.get("layers", []),
    )


def apply_width_multiplier(value: int, multiplier: float, divisor: int = 8) -> int:
    """Scale channels, rounding to divisor (reference: parser.py:33-47)."""
    if multiplier == 1.0:
        return value
    scaled = value * multiplier
    return max(divisor, int(scaled + divisor / 2) // divisor * divisor)


def apply_depth_multiplier(value: int, multiplier: float) -> int:
    """Scale repeat counts, min 1 (reference: parser.py:50-62)."""
    if multiplier == 1.0:
        return value
    return max(1, round(value * multiplier))
