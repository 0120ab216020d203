"""PyTorch/CUDA port of yolo_re_tpu (GELAN / YOLOv9 detection).

The JAX package `yolo_re_tpu` stays the reference; this package keeps its
module paths (`models/`, `ops/`, `loss/`, `train/`, `data/`, `serving.py`)
so each piece has its counterpart at the same relative path. It imports
torch and numpy only, never jax or yolo_re_tpu. The TPU's Pallas kernels
on the serving and train paths are hand-written CUDA kernels here
(`csrc/`, wrappers in `ops/kernels/`).

Importing the package imports nothing heavy; use the submodules, e.g.
`from yolo_re_tpu_torch.serving import Detector` or
`from yolo_re_tpu_torch.train.trainer import Trainer`.
"""
