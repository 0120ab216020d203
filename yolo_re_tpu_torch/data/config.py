"""Data and augmentation configuration (a copy of yolo_re_tpu/data/config.py;
tests/test_torch_eval.py pins the two equal).

Mirrors the reference's typed config + preset/override pattern
(reference: src/yolo/data/config.py) so DataConfig is drop-in. Adds
`max_boxes`: the static per-image GT padding size the TPU loss requires
(the reference pads dynamically inside the loss, tal.py:287-313).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from enum import Enum
from pathlib import Path

import yaml


class CacheMode(Enum):
    """Reference: src/yolo/data/config.py:13-18."""

    NONE = "none"
    RAM = "ram"
    DISK = "disk"


# Presets match the reference's field-for-field (src/yolo/data/config.py:24-73;
# "full" mirrors upstream hyp.scratch-high). The blur/median_blur/to_gray/clahe
# probabilities come from the reference's Albumentations transform defaults
# (src/yolo/data/transforms.py:333-341), which only the train pipeline enables.
# `mosaic_scale` exists in the reference config but is consumed nowhere in its
# transforms — kept here for config-surface parity, equally unused.
_AUGMENT_PRESETS: dict[str, dict] = {
    "full": dict(
        mosaic=1.0, mosaic_scale=(0.5, 1.5), mixup=0.15, degrees=0.0,
        translate=0.1, scale=0.9, shear=0.0, perspective=0.0,
        hsv_h=0.015, hsv_s=0.7, hsv_v=0.4,
        flip_lr=0.5, flip_ud=0.0, blur=0.01, median_blur=0.01, to_gray=0.01,
        clahe=0.01,
    ),
    "light": dict(
        mosaic=0.5, mosaic_scale=(0.8, 1.2), mixup=0.0, degrees=0.0,
        translate=0.1, scale=0.5, shear=0.0, perspective=0.0,
        hsv_h=0.01, hsv_s=0.5, hsv_v=0.3,
        flip_lr=0.5, flip_ud=0.0, blur=0.0, median_blur=0.0, to_gray=0.0,
        clahe=0.0,
    ),
    "minimal": dict(
        mosaic=0.0, mosaic_scale=(1.0, 1.0), mixup=0.0, degrees=0.0,
        translate=0.0, scale=0.0, shear=0.0, perspective=0.0,
        hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
        flip_lr=0.5, flip_ud=0.0, blur=0.0, median_blur=0.0, to_gray=0.0,
        clahe=0.0,
    ),
}


@dataclass
class AugmentConfig:
    """Preset + per-field override (reference: src/yolo/data/config.py:76-124)."""

    preset: str = "full"
    mosaic: float | None = None
    mosaic_scale: tuple[float, float] | None = None
    mixup: float | None = None
    degrees: float | None = None
    translate: float | None = None
    scale: float | None = None
    shear: float | None = None
    perspective: float | None = None
    hsv_h: float | None = None
    hsv_s: float | None = None
    hsv_v: float | None = None
    flip_lr: float | None = None
    flip_ud: float | None = None
    blur: float | None = None
    median_blur: float | None = None
    to_gray: float | None = None
    clahe: float | None = None

    def __post_init__(self):
        if self.preset not in _AUGMENT_PRESETS:
            raise ValueError(
                f"Unknown preset {self.preset!r}; choose from "
                f"{sorted(_AUGMENT_PRESETS)}")
        defaults = _AUGMENT_PRESETS[self.preset]
        for f in fields(self):
            if f.name == "preset":
                continue
            if getattr(self, f.name) is None:
                setattr(self, f.name, defaults[f.name])


@dataclass
class DataConfig:
    """Dataset + loader config (reference: src/yolo/data/config.py:127-159)."""

    train_path: str | None = None
    val_path: str | None = None
    num_classes: int = 80
    img_size: int = 640
    batch_size: int = 16
    workers: int = 8
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    cache: CacheMode = CacheMode.NONE
    rect: bool = False
    stride: int = 32
    max_boxes: int = 128  # static GT padding per image (TPU-specific)
    uint8_images: bool = False  # loader emits uint8 RGB (4x less transfer)
    class_names: list[str] | None = None

    @classmethod
    def from_yaml(cls, path: str | Path) -> "DataConfig":
        with open(path) as f:
            data = yaml.safe_load(f)
        if "augment" in data and isinstance(data["augment"], dict):
            data["augment"] = AugmentConfig(**data["augment"])
        if "cache" in data and isinstance(data["cache"], str):
            data["cache"] = CacheMode(data["cache"])
        known = {f.name for f in fields(cls)}
        # Accept reference-style data yamls: train/val keys + names list.
        alias = {"train": "train_path", "val": "val_path", "nc": "num_classes",
                 "names": "class_names"}
        mapped = {}
        for k, v in data.items():
            k = alias.get(k, k)
            if k in known:
                mapped[k] = v
        return cls(**mapped)
