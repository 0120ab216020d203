"""The numeric design of the bf16 stem conv on the tensor cores
(csrc/stem.cu, run_bf16), emulated on the CPU.

The kernel multiplies bf16 operands on mma.sync m16n8k16: A = the im2col
of x with k = 9 ky + 3 kx + ci (the TPU kernel's order,
yolo_re_tpu/ops/pallas/stem_kernel.py), the 27 taps padded with zeros to
32, B = the weights in the same order. A product of two bf16 values is
exact in f32. The f32 sums start from the bias (the first k-step's C
operand; raw: 0), then take k-step 0 (k < 16) and k-step 1, and the
epilogue applies silu_mufu, y / (1 + exp(-y)) (raw: nothing), rounded
once to bf16. Emulated here in torch, that design stays within one bf16
ulp of |ref| (rtol 2^-7, the bound of the bf16 card tests, plus 1e-5 for
outputs near zero, where the f32 sums' order is above a bf16 ulp) of the
port's plain version (f32 conv, bias, SiLU, one rounding) at odd H and W,
and of the JAX package's stem kernel (Pallas, interpret mode, as
tests/test_torch_kernels.py runs it) where it takes the shape (H a
multiple of 4, W even), at C = 16, 64 and 80 (gelan-c's and gelan-e's
stem widths, and the narrowest).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_re_tpu.ops.pallas.stem_kernel import (
    build_stem_kernel_weights,
    stem_conv as jstem_conv,
)
from yolo_re_tpu_torch.ops.kernels import stem

RTOL, ATOL = 2.0 ** -7, 1e-5
# (B, H, W): H and W odd, one odd, and the Pallas kernel's geometry
SHAPES = [(1, 25, 31), (2, 37, 53), (2, 32, 48)]


def emulate(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None
            ) -> torch.Tensor:
    """The bf16 kernel's arithmetic: x (B, 3, H, W), w (C, 3, 3, 3) and b
    (C,) or None (raw) are f32 tensors holding bf16 values. Returns
    (B, C, ceil(H/2), ceil(W/2)) in bf16."""
    bsz, _, h, wd = x.shape
    c = w.shape[0]
    ho, wo = (h + 1) // 2, (wd + 1) // 2
    # F.unfold orders the taps 9 ci + 3 ky + kx; the kernel 9 ky + 3 kx + ci
    cols = F.unfold(x, 3, padding=1, stride=2)              # (B, 27, L)
    cols = cols.view(bsz, 3, 9, -1).transpose(1, 2).reshape(bsz, 27, -1)
    a = torch.zeros(bsz, ho * wo, 32)
    a[..., :27] = cols.transpose(1, 2)
    bm = torch.zeros(32, c)
    bm[:27] = w.permute(2, 3, 1, 0).reshape(27, c)          # [ky kx ci][c]
    acc = torch.zeros(bsz, ho * wo, c) if b is None else b.expand(
        bsz, ho * wo, c).clone()
    for s in range(2):                                      # the k-steps
        acc = acc + a[..., 16 * s:16 * s + 16] @ bm[16 * s:16 * s + 16]
    if b is not None:
        acc = acc / (1.0 + torch.exp(-acc))                 # silu_mufu
    return acc.bfloat16().view(bsz, ho, wo, c).permute(0, 3, 1, 2)


def _operands(shape, c: int, seed: int):
    """x ~ N(0, 1), w ~ 0.3 N(0, 1), b ~ N(0, 1) (the card tests' scales:
    outputs reach 4-8), each rounded to bf16 and held in f32."""
    rng = np.random.default_rng(seed)
    bsz, h, wd = shape

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float()

    return (bf(rng.standard_normal((bsz, 3, h, wd))),
            bf(0.3 * rng.standard_normal((c, 3, 3, 3))),
            bf(rng.standard_normal(c)))


def _close(y: torch.Tensor, ref: torch.Tensor) -> None:
    torch.testing.assert_close(y.float(), ref.float(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("raw", [False, True], ids=["folded", "raw"])
@pytest.mark.parametrize("c", [16, 64, 80])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_stem_design_matches_plain(shape, c, raw):
    x, w, b = _operands(shape, c, seed=c + shape[1])
    cl = torch.channels_last
    xb = x.bfloat16().contiguous(memory_format=cl)
    if raw:
        ref = stem.stem_conv_raw_plain(xb, w.bfloat16())
    else:
        ref = stem.stem_conv_plain(xb, w.bfloat16(), b.bfloat16())
    y = emulate(x, w, None if raw else b)
    assert ref.dtype == torch.bfloat16 and y.shape == ref.shape
    _close(y, ref)
    # most outputs round to the same bf16 value
    assert (y == ref).float().mean() > 0.95


@pytest.mark.parametrize("c", [16, 64, 80])
def test_bf16_stem_design_matches_pallas_stem(c):
    shape = SHAPES[-1]
    x, w, b = _operands(shape, c, seed=2 * c)
    fused = {"w": w.permute(2, 3, 1, 0).numpy(), "b": b.numpy()}   # HWIO
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy(), dtype=jnp.bfloat16)
    ref = jstem_conv(xj, build_stem_kernel_weights(fused), interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    y = emulate(x, w, b).permute(0, 2, 3, 1)
    _close(y, ref)
