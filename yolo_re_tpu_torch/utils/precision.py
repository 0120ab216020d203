"""Full f32 precision for PyTorch's library convolutions and GEMMs.

The JAX package runs f32 convolutions at HIGHEST precision
(yolo_re_tpu/ops/conv.py). PyTorch's defaults do not: cuDNN runs f32
convolutions in TF32 (`torch.backends.cudnn.allow_tf32` is True), and a
caller may have let cuBLAS do the same for f32 matmuls. The port's entry
points (`Detector.__call__`, `Evaluator._dispatch`, `Trainer.train_step`)
run under `full_f32()`, so that their f32 paths compute what the reference
computes. bf16 work is unaffected: the flags concern f32 operands only.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls while the
    block (or the decorated function) runs, and restore the caller's two
    flags afterwards, also after an exception. `cudnn.enabled` is left
    alone (`torch.backends.cudnn.flags(allow_tf32=False)` would turn cuDNN
    off: its `enabled` argument defaults to False). The flags are global
    to the process: threads that run PyTorch work concurrently with the
    block see them too."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
