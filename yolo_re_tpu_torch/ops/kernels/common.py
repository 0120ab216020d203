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


def packed_index(c: int, device=None) -> torch.Tensor:
    """(c, c, 3, 3) int64: the element of w[co, ci, ky, kx] of a c -> c 3x3
    conv in the packed weight image the CUDA kernels read
    (csrc/hopper.cuh: packed_index): 9 x c/16 blocks (tap, 16 input
    channels) of 16 x c elements, each c/8 groups of 8 output channels
    holding two 8 x 8 core matrices (input channels 0-7, 8-15), one output
    channel's 8 input channels contiguous."""
    co = torch.arange(c, device=device).view(c, 1, 1, 1)
    ci = torch.arange(c, device=device).view(1, c, 1, 1)
    tap = torch.arange(9, device=device).view(1, 1, 3, 3)
    return ((tap * (c // 16) + ci // 16) * (16 * c) + (co // 8) * 128
            + (ci // 8) % 2 * 64 + (co % 8) * 8 + ci % 8)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (..., c, c, 3, 3) -> the packed image of each conv, flat and
    concatenated in the order of the leading dimensions (9 c^2 elements a
    conv)."""
    c = w.shape[-4]
    v = w.reshape(-1, c // 8, 8, c // 16, 2, 8, 3, 3)
    # (conv, ng, nr, s, kh, kc, ky, kx) -> (conv, ky, kx, s, ng, kh, nr, kc)
    return v.permute(0, 6, 7, 3, 1, 4, 2, 5).reshape(-1).contiguous()


def unpack_weights(packed: torch.Tensor, c: int) -> torch.Tensor:
    """The packed image of k convs -> OIHW (k, c, c, 3, 3), read element by
    element at `packed_index`, the kernels' arithmetic."""
    per = 9 * c * c
    convs = packed.reshape(-1, per)
    idx = packed_index(c, packed.device).reshape(-1)
    return convs[:, idx].reshape(-1, c, c, 3, 3)
