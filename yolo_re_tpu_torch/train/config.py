"""Training configuration (reference: src/yolo/train/config.py).

A framework-free copy of yolo_re_tpu/train/config.py (this package never
imports the JAX one); tests/test_torch_train.py pins the two equal. The
port's Trainer takes every field. In the port `remat` runs
torch.utils.checkpoint per block (models/yolo.py), `checkpoint_format=
"orbax"` writes a torch.distributed.checkpoint directory, not an orbax
one (train/checkpoint.py), and `data_parallel` runs one process per card
over torch.distributed (parallel/mesh.py).

The JAX package's deltas from the reference: `device`/`amp` are replaced by `compute_dtype` (bf16 needs no
GradScaler on TPU — SURVEY §2.1) and `data_parallel` (shard the batch over
all local devices via a 1-D mesh).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import yaml


@dataclass
class TrainConfig:
    """Training hyperparameters (defaults match reference
    src/yolo/train/config.py:11-55)."""

    epochs: int = 100

    lr: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005

    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    lrf: float = 0.01

    output_dir: Path | str = "runs/train"
    save_period: int = -1
    val_period: int = 1

    compute_dtype: str = "float32"   # "float32" | "bfloat16"
    checkpoint_format: str = "npz"   # "npz" (one file) | "orbax" (directory)
    data_parallel: bool = True       # shard batch over all local devices
    # False | True (HSV/flip on device) | "full" (the whole pipeline on
    # device — mosaic, full random_perspective warp incl. nonzero
    # degrees/shear/perspective, mixup, HSV, flips; host only decodes +
    # letterboxes)
    device_augment: bool | str = False
    remat: bool | str = False        # per-block remat: True=all blocks,
                                     # "early"=downscale<=8 stages only
    grad_clip_norm: float = 10.0

    ema_decay: float = 0.9999
    ema_tau: float = 2000.0

    log_interval: int = 10
    seed: int = 0

    def __post_init__(self) -> None:
        if isinstance(self.output_dir, str):
            self.output_dir = Path(self.output_dir)

    @classmethod
    def from_yaml(cls, path: str | Path) -> "TrainConfig":
        with open(path) as f:
            data = yaml.safe_load(f)
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in data.items() if k in known})
