"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_dtype(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got "
                        f"{x.dtype}")


def check_channels_last(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: expected a 4-d tensor contiguous in "
                         f"torch.channels_last memory format")


def check_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels read 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def check_same(x: torch.Tensor, t: torch.Tensor, name: str) -> None:
    """A weight or bias: same device and dtype as x, contiguous."""
    if t.device != x.device or t.dtype != x.dtype:
        raise ValueError(f"{name}: expected {x.dtype} on {x.device}, got "
                         f"{t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")


def dtype_code(x: torch.Tensor) -> int:
    return _DTYPE_CODES[x.dtype]


def stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's device, as the raw cudaStream_t."""
    return torch.cuda.current_stream(x.device).cuda_stream
