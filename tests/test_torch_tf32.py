"""The numeric design of the f32 kernels' products on the tensor cores,
emulated on the CPU (3xTF32: csrc/hopper.cuh, split_tf32 and mma_3xtf32).

TF32 keeps 10 mantissa bits. The f32 bottleneck chain, the f32 stem
weight gradient and the f32 ADown backward's products split each f32
operand into hi = a rounded to TF32 (to nearest, ties away from zero:
cvt.rna.tf32.f32) and lo = a - hi cut to TF32, and take a * b as
lo_a hi_b + hi_a lo_b + hi_a hi_b. The f32 ADown forward splits its A
operand (the avg, the max) so, and its weights by cutting (hi = the weight
cut to TF32, as the tensor cores read an f32 operand's top bits). Here the
split is emulated in torch with the kernels' integer arithmetic; a product
of two TF32 values is exact in f32, as on the tensor cores, and the sums
are f32. At the shapes and scales of the chain's convs, of conv3, of the
stem weight gradient, of the ADown backward's dW1 and dA1 and of the ADown
forward's two convs, 3xTF32 meets the f32 tolerances of chip_smoke.py and
tests/test_torch_cuda.py against an f64 reference, and one TF32 product
does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

# chip_smoke.py's f32 tolerances: outputs 2e-5 x max(1, max |ref|)
# (tests/test_torch_cuda.py allows 1e-4); weight gradients a relative L2
# of 1e-5
OUT_REL = 2e-5
WGRAD_REL = 1e-5


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def cut(a: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by dropping the low 13 bits (toward zero)."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(a)
    return hi, cut(a - hi)


def split_cut(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = a cut to TF32, lo = a - hi (exact) cut to TF32: what the
    tensor cores multiply when handed a and a - cut(a) as they are (they
    read a TF32 operand's top 19 bits), as the f32 ADown forward hands them
    its weights."""
    hi = cut(a)
    return hi, cut(a - hi)


def three_tf32(op, a: torch.Tensor, b: torch.Tensor,
               split_a=split) -> torch.Tensor:
    """op (bilinear, f32) in 3xTF32, the small terms first; a split by
    `split_a`, b rounded (split)."""
    (ah, al), (bh, bl) = split_a(a), split(b)
    return (op(al, bh) + op(ah, bl)) + op(ah, bh)


def one_tf32(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return op(tf32(a), tf32(b))


def test_tf32_rounding_is_cvt_rna():
    one = 1.0
    a = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11), one + 2.0 ** -12,
                      one + 3 * 2.0 ** -11, 3.0e-7, -123.456],
                     dtype=torch.float32)
    hi = tf32(a)
    # ties go away from zero; below half an ulp goes down
    assert hi[:4].tolist() == [one + 2.0 ** -10, -(one + 2.0 ** -10), one,
                               one + 2.0 ** -9]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((hi - a).abs() <= a.abs() * 2.0 ** -11).all()
    h, lo = split(a)
    # a - hi is exact in f32, and lo keeps all but 2^-21 of a
    assert torch.equal(h, hi)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((h.double() + lo.double() - a.double()).abs()
            <= a.abs().double() * 2.0 ** -21).all()
    # cut: lo holds all but 2^-20 of a
    h, lo = split_cut(a)
    assert torch.equal(h, cut(a)) and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((h.double() + lo.double() - a.double()).abs()
            <= a.abs().double() * 2.0 ** -20).all()


def _chain(r, ws, bs, conv):
    """The bottleneck chain of csp_chain.py's plain version, each conv
    through `conv`."""
    for w1, b1, w2, b2 in zip(ws[0::2], bs[0::2], ws[1::2], bs[1::2]):
        t = F.silu(conv(r, w1) + b1.view(1, -1, 1, 1))
        r = r + F.silu(conv(t, w2) + b2.view(1, -1, 1, 1))
    return r


@pytest.mark.parametrize("n", [1, 2])
def test_3xtf32_chain_meets_the_f32_tolerance(n):
    """32 channels, weights at 0.06 and biases near 0.5 as chip_smoke.py's
    phase 3; an image cut small (40 x 40) for the CPU."""
    rng = np.random.default_rng(n)
    m = torch.from_numpy(rng.standard_normal((2, 32, 40, 40),
                                             dtype=np.float32))
    ws = [torch.from_numpy(rng.standard_normal((32, 32, 3, 3),
                                               dtype=np.float32) * 0.06)
          for _ in range(2 * n)]
    bs = [torch.from_numpy(rng.standard_normal(32, dtype=np.float32)
                           * 0.5 + 0.5) for _ in range(2 * n)]

    def conv(x, w):
        return F.conv2d(x, w, padding=1)

    ref = _chain(m.double(), [w.double() for w in ws],
                 [b.double() for b in bs], conv)
    tol = OUT_REL * max(1.0, float(ref.abs().max()))
    err = {name: float((_chain(m, ws, bs, lambda x, w, f=f: f(conv, x, w))
                        .double() - ref).abs().max())
           for name, f in (("3x", three_tf32), ("1x", one_tf32))}
    assert err["3x"] <= tol / 10, err
    assert err["1x"] > tol, err


def test_3xtf32_conv3_meets_the_f32_tolerance():
    """conv3's f32 kernel (csrc/conv3.cu): 64 -> 64 channels, weights at
    0.05 as chip_smoke.py's phase 3, an image cut small (40 x 40) for the
    CPU. Each tap's 64-deep products in 3xTF32, summed apart, then added
    in tap order; then bias and SiLU. Held against f64 and against JAX's
    f32 conv + bias + SiLU at HIGHEST precision (as
    tests/test_torch_csp.py holds conv3's plain version)."""
    rng = np.random.default_rng(64)
    x = rng.standard_normal((2, 40, 40, 64), dtype=np.float32)   # NHWC
    w = rng.standard_normal((3, 3, 64, 64), dtype=np.float32) * 0.05  # HWIO
    b = rng.standard_normal(64, dtype=np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    bt = torch.from_numpy(b).view(1, -1, 1, 1)

    def conv3(f, x, w, b):
        xp, h, wd = F.pad(x, (1, 1, 1, 1)), x.shape[2], x.shape[3]
        acc = 0.0
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            acc = acc + f(F.conv2d, xp[:, :, ky:ky + h, kx:kx + wd],
                          w[:, :, ky:ky + 1, kx:kx + 1])
        return F.silu(acc + b)

    def exact(op, a, v):
        return op(a, v)

    ref = conv3(exact, xt.double(), wt.double(), bt.double())
    tol = OUT_REL * max(1.0, float(ref.abs().max()))
    y = {name: conv3(f, xt, wt, bt)
         for name, f in (("3x", three_tf32), ("1x", one_tf32))}
    err = {name: float((v.double() - ref).abs().max())
           for name, v in y.items()}
    assert err["3x"] <= tol / 10, err
    assert err["1x"] > tol, err
    yj = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b)
    yj = np.asarray(yj * jax.nn.sigmoid(yj)).transpose(0, 3, 1, 2)
    assert float(np.abs(y["3x"].numpy() - yj).max()) <= tol


@pytest.mark.parametrize("c", [64, 80])
def test_3xtf32_wgrad_meets_the_f32_tolerance(c):
    """The stem's dW = im2col(x)^T g: x in [0, 1) as images are, g a
    cotangent at 1e-3; 2 images of 160 x 160 for the CPU."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.random((2, 3, 160, 160), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((2, c, 80, 80),
                                             dtype=np.float32) * 1e-3)

    def wgrad(a, b):
        return torch.nn.grad.conv2d_weight(a, (c, 3, 3, 3), b, stride=2,
                                           padding=1)

    ref = wgrad(x.double(), g.double())
    rel = {name: float((f(wgrad, x, g).double() - ref).norm() / ref.norm())
           for name, f in (("3x", three_tf32), ("1x", one_tf32))}
    assert rel["3x"] <= WGRAD_REL / 10, rel
    assert rel["1x"] > WGRAD_REL, rel


# tests/test_torch_cuda.py's f32 tolerance for dx (the sum of four dA1
# terms / 4, so dA1's own error bounds it)
ATOL = 1e-4
SLAB_PIXELS = 4096   # ops/kernels/adown.py: BWD_SLAB_PIXELS


def _adown_bwd_operands(seed: int):
    """The ADown backward's branch-1 operands at Ch = Co = 128: x
    quantized to halves as tests/test_torch_cuda.py's ADown cases, the
    avg of its first half, a cotangent g1 and w1 at 1/sqrt(fan-in); 96 x
    96 pixels, so 2 images have 4608 output pixels (two slabs)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((2, 256, 96, 96)) * 2) / 2
    x = torch.from_numpy(x.astype(np.float32))
    a = ((x[:, :128, :-1, :-1] + x[:, :128, :-1, 1:])
         + (x[:, :128, 1:, :-1] + x[:, :128, 1:, 1:])) * 0.25
    g = torch.from_numpy(rng.standard_normal((2, 128, 48, 48),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 128, 3, 3),
                                             dtype=np.float32)
                         / np.sqrt(9 * 128).astype(np.float32))
    return a, g, w


def test_3xtf32_adown_dw1_over_slabs_meets_the_f32_tolerance():
    """dW1 = sum over output pixels of g1[p, co] im2col(avg)[p, (ci, tap)],
    as csrc/adown_bwd.cu sums it: each slab of <= 4096 pixels apart, then
    the slabs in order (dw_reduce)."""
    a, g, _ = _adown_bwd_operands(7)
    cols = F.unfold(a, 3, padding=1, stride=2)            # (B, 9 Ch, L)
    cols = cols.permute(0, 2, 1).reshape(-1, cols.shape[1])
    gp = g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])   # (N, Co)
    n = gp.shape[0]
    slabs = -(-n // SLAB_PIXELS)
    slab = -(-n // slabs)

    def dw(f):
        out = 0.0
        for p in range(0, n, slab):
            out = out + f(lambda u, v: u.T @ v, gp[p:p + slab],
                          cols[p:p + slab])
        return out

    ref = gp.double().T @ cols.double()
    rel = {name: float((dw(f).double() - ref).norm() / ref.norm())
           for name, f in (("3x", three_tf32), ("1x", one_tf32))}
    assert slabs == 2 and rel["3x"] <= WGRAD_REL / 10, rel
    assert rel["1x"] > WGRAD_REL, rel


def test_3xtf32_adown_da1_meets_the_f32_tolerance():
    """dA1 = the transposed stride-2 conv of g1 with w1 at the avg pixels
    of odd row and odd column, each reached by 4 taps: K = Co x 4."""
    _, g, w = _adown_bwd_operands(8)

    def da1(u, v):
        return F.conv_transpose2d(u, v, stride=2, padding=1)[:, :, 1::2,
                                                              1::2]

    ref = da1(g.double(), w.double())
    err = {name: float((f(da1, g, w).double() - ref).abs().max())
           for name, f in (("3x", three_tf32), ("1x", one_tf32))}
    assert err["3x"] <= ATOL / 10, err
    assert err["1x"] > ATOL, err


def _adown_fwd_operands(ch: int, seed: int):
    """The ADown forward's operands at Ch = Co = ch: the f32 avg of x (the
    kernel's order, ((x00 + x01) + (x10 + x11)) / 4) split into the two
    branches' halves, and w1, w2 at 1/sqrt(fan-in) as the model's init
    draws them; a 12 x 12 image, so 36 output pixels."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 2 * ch, 12, 12),
                                             dtype=np.float32))
    a = ((x[:, :, :-1, :-1] + x[:, :, :-1, 1:])
         + (x[:, :, 1:, :-1] + x[:, :, 1:, 1:])) * 0.25
    a1, a2 = a.chunk(2, dim=1)
    w1 = torch.from_numpy(rng.standard_normal((ch, ch, 3, 3),
                                              dtype=np.float32)
                          / np.sqrt(9 * ch).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((ch, ch), dtype=np.float32)
                          / np.sqrt(ch).astype(np.float32))
    return a1, a2, w1, w2


def _segments(f, w: torch.Tensor, cols: torch.Tensor, parts) -> torch.Tensor:
    """sum over parts of f(w[:, part] @ cols[part]): each part's products
    summed apart (on the card, by the tensor cores), then the parts added
    in f32 (by FADD)."""
    out = 0.0
    for p in parts:
        out = out + f(lambda u, v: u @ v, w[:, p], cols[p])
    return out


# the weights' split: rounded as the other f32 kernels split, or cut as
# csrc/adown.cu's f32 forward splits them
W_SPLITS = {"round": split, "cut": split_cut}


@pytest.mark.parametrize("w_split", sorted(W_SPLITS))
@pytest.mark.parametrize("segments", ["chunks", "taps"])
@pytest.mark.parametrize("ch", [128, 256])
def test_3xtf32_adown_conv_meets_the_f32_tolerance(ch, segments, w_split):
    """Branch 1, the 3x3 stride-2 conv of the f32 avg, as an implicit
    GEMM over K = (channel, tap): "chunks" sums the 9 taps of each two
    8-channel chunks apart, as csrc/adown.cu's f32 kernel does; "taps"
    each tap's products over all channels (nine segments)."""
    a1, _, w1, _ = _adown_fwd_operands(ch, 9 + ch)
    cols = F.unfold(a1, 3, padding=1, stride=2)[0]     # (ch 9, 36)
    w = w1.reshape(ch, 9 * ch)                         # k = 9 ci + tap
    k = torch.arange(9 * ch)
    parts = ([k[(k // 9) // 16 == c] for c in range(ch // 16)]
             if segments == "chunks" else [k[k % 9 == t] for t in range(9)])
    ref = w.double() @ cols.double()
    tol = OUT_REL * max(1.0, float(ref.abs().max()))
    def three(op, a, b):
        return three_tf32(op, a, b, W_SPLITS[w_split])

    err = {name: float((_segments(f, w, cols, parts).double() - ref)
                       .abs().max())
           for name, f in (("3x", three), ("1x", one_tf32))}
    assert err["3x"] <= tol / 10, err
    assert err["1x"] > tol, err


@pytest.mark.parametrize("w_split", sorted(W_SPLITS))
@pytest.mark.parametrize("ch", [128, 256])
def test_3xtf32_adown_pool_meets_the_f32_tolerance(ch, w_split):
    """Branch 2, the 1x1 conv of maxpool(3, 2, 1) of the f32 avg, the
    products of each two 8-channel chunks summed apart, as the f32 kernel
    does."""
    _, a2, _, w2 = _adown_fwd_operands(ch, 11 + ch)
    m = F.max_pool2d(a2, 3, 2, 1)[0].reshape(ch, -1)   # (ch, 36)
    k = torch.arange(ch)
    parts = [k[k // 16 == c] for c in range(ch // 16)]
    ref = w2.double() @ m.double()
    tol = OUT_REL * max(1.0, float(ref.abs().max()))
    def three(op, a, b):
        return three_tf32(op, a, b, W_SPLITS[w_split])

    err = {name: float((_segments(f, w2, m, parts).double() - ref)
                       .abs().max())
           for name, f in (("3x", three), ("1x", one_tf32))}
    assert err["3x"] <= tol / 10, err
    assert err["1x"] > tol, err
