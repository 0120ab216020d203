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


def packed_index(co: int, ci: int | None = None, kh: int = 3,
                 n: int | None = None, k: int | None = None,
                 device=None) -> torch.Tensor:
    """(co, ci, kh, kh) int64: the element of w[o, i, ky, kx] of a ci -> co
    conv with kh x kh taps in the packed weight image the CUDA kernels read
    (csrc/hopper.cuh: packed_index), its output channels padded with zeros
    to n (a multiple of 8; default co) and its input channels to k (a
    multiple of 16; default ci, which defaults to co): kh^2 x k/16 blocks
    (tap, 16 input channels), tap-major, of 16 x n elements, each n/8
    groups of 8 output channels holding two 8 x 8 core matrices (input
    channels 0-7, 8-15), one output channel's 8 input channels
    contiguous."""
    ci = co if ci is None else ci
    n = co if n is None else n
    k = ci if k is None else k
    o = torch.arange(co, device=device).view(co, 1, 1, 1)
    i = torch.arange(ci, device=device).view(1, ci, 1, 1)
    tap = torch.arange(kh * kh, device=device).view(1, 1, kh, kh)
    return ((tap * (k // 16) + i // 16) * (16 * n) + (o // 8) * 128
            + (i // 8) % 2 * 64 + (o % 8) * 8 + i % 8)


def pack_weights(w: torch.Tensor, n: int | None = None,
                 k: int | None = None) -> torch.Tensor:
    """OIHW (..., co, ci, kh, kw) -> the packed image of each conv, its
    output channels padded with zeros to n and its input channels to k
    (`packed_index`), flat and concatenated in the order of the leading
    dimensions (kh kw n k elements a conv)."""
    co, ci, kh, kw = w.shape[-4:]
    n = co if n is None else n
    k = ci if k is None else k
    v = w.reshape(-1, co, ci, kh, kw)
    if (n, k) != (co, ci):
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, k - ci, 0, n - co))
    v = v.reshape(-1, n // 8, 8, k // 16, 2, 8, kh, kw)
    # (conv, ng, nr, s, kh, kc, ky, kx) -> (conv, ky, kx, s, ng, kh, nr, kc)
    return v.permute(0, 6, 7, 3, 1, 4, 2, 5).reshape(-1).contiguous()


def unpack_weights(packed: torch.Tensor, co: int, ci: int | None = None,
                   kh: int = 3, n: int | None = None,
                   k: int | None = None) -> torch.Tensor:
    """The packed image of several convs -> OIHW (convs, co, ci, kh, kh),
    read element by element at `packed_index`, the kernels' arithmetic."""
    ci = co if ci is None else ci
    per = kh * kh * (co if n is None else n) * (ci if k is None else k)
    convs = packed.reshape(-1, per)
    idx = packed_index(co, ci, kh, n, k, packed.device).reshape(-1)
    return convs[:, idx].reshape(-1, co, ci, kh, kh)
