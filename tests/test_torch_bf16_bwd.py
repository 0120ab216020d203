"""The numeric design of the bf16 ADown backward's products on the tensor
cores (csrc/adown_bwd.cu, namespace bf16), emulated on the CPU.

The kernels multiply bf16 operands, the values the TPU kernel multiplies
(yolo_re_tpu/ops/pallas/adown_train_kernel.py): the cotangent g, the
weights, the branch-1 avg and the window max M, each rounded once to bf16
(M after the max), and sum in f32. A product of two bf16 values is exact
in f32, as on the tensor cores. The tensor cores keep each whole sum: a
slab of output pixels for dW (dw_reduce then adds the slabs in order),
Co x taps for dA1, Co for dM. Emulated here in torch at small shapes, the
design meets chip_smoke.py's bf16 tolerances (dx: 2^-6 of its largest
value; dW: relative L2 2e-2) against an f64 reference and against the JAX
backward; summing each 64-deep chunk apart and adding the chunks in f32
(the f32 kernels' way) moves the weight gradients by less than the f32
kernels' own tolerance (relative L2 1e-5). The
slab count of the bf16 weight gradient (`adown._bwd_slabs`) is checked at
gelan-c's five ADown sites on an H100's SM count.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_re_tpu.ops.adown_train import _adown_conv
from yolo_re_tpu_torch.ops.kernels import adown

# chip_smoke.py's bf16 tolerances: outputs 2^-6 x max(1, max |ref|),
# weight gradients a relative L2 of 2e-2
OUT_REL = 2.0 ** -6
WGRAD_REL = 2e-2
CHUNK = 64            # csrc/adown_bwd.cu: kWKc, kDKc
H100_SMS = 132
# gelan-c's five ADown inputs at 640 px, batch 32: (Cin, H, W) -> Cout
GELAN_C = {"down1": (256, 160, 160, 256), "down2": (512, 80, 80, 512),
           "down3": (512, 40, 40, 512), "pan_down1": (256, 80, 80, 256),
           "pan_down2": (512, 40, 40, 512)}


def bf(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 (to nearest even), kept in f32."""
    return t.bfloat16().float()


@pytest.fixture
def h100(monkeypatch):
    """`torch.cuda.get_device_properties` as an H100 reports its SMs."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(
                            multi_processor_count=H100_SMS))


def _sums(a: torch.Tensor, b: torch.Tensor, chunked: bool) -> torch.Tensor:
    """a^T b over the rows (K) of a (K, I) and b (K, O) in f32: on the
    tensor cores as one sum, or (chunked) each CHUNK rows apart and the
    chunks added in order."""
    if not chunked:
        return a.T @ b
    out = 0.0
    for k in range(0, a.shape[0], CHUNK):
        out = out + a[k:k + CHUNK].T @ b[k:k + CHUNK]
    return out


def _emulate(x, g, w1, w2, slabs: int, chunked: bool):
    """The bf16 backward as the kernels compute it: x (B, Cin, H, W), g
    (B, 2 Co, H/2, W/2), w1 (Co, Ch, 3, 3), w2 (Co, Ch, 1, 1), f32 tensors
    holding bf16 values. Returns (dx rounded to bf16, dW1, dW2)."""
    bsz, cin, h, w = x.shape
    ch, co = cin // 2, w1.shape[0]
    ho, wo = g.shape[2:]
    n = bsz * ho * wo
    xf = x.clone().requires_grad_()
    with torch.enable_grad():
        a1, a2 = adown._avg(xf).chunk(2, dim=1)       # pool_avg's order
        m = F.max_pool2d(a2, 3, 2, 1)

    def rows(t):          # (N, C), the pixels in order (b, oy, ox)
        return t.permute(0, 2, 3, 1).reshape(n, -1)

    # dW (dw_bf16): avg1 and M in bf16; per slab on the tensor cores, then
    # the slabs in order (dw_reduce)
    cols = F.unfold(bf(a1.detach()), 3, padding=1, stride=2)
    cols = cols.permute(0, 2, 1).reshape(n, 9 * ch)   # column ci * 9 + tap
    mb, g1, g2 = rows(bf(m.detach())), rows(g[:, :co]), rows(g[:, co:])
    slab = -(-n // slabs)
    dw1 = dw2 = 0.0
    for p in range(0, n, slab):
        dw1 = dw1 + _sums(cols[p:p + slab], g1[p:p + slab], chunked)
        dw2 = dw2 + _sums(mb[p:p + slab], g2[p:p + slab], chunked)
    dw1 = dw1.reshape(ch, 9, co).permute(2, 0, 1).reshape(co, ch, 3, 3)
    dw2 = dw2.T.reshape(co, ch, 1, 1)
    # dM (dgrad_bf16<false>): K = Co
    dm = _sums(g2.T, w2.reshape(co, ch), chunked)
    dm = dm.reshape(bsz, ho, wo, ch).permute(0, 3, 1, 2)
    # dA1 (dgrad_bf16<true>): K = Co x the pixel's taps, in the kernel's
    # order (ky, then kx, then the channel chunks)
    pad = (h - 1 - (2 * ho - 1), w - 1 - (2 * wo - 1))

    def da1(gg, ww):
        return F.conv_transpose2d(gg, ww, stride=2, padding=1,
                                  output_padding=pad)

    if chunked:
        d_a1 = 0.0
        for tap in range(9):
            mask = torch.zeros(9)
            mask[tap] = 1.0
            wt = w1 * mask.reshape(1, 1, 3, 3)
            for c0 in range(0, co, CHUNK):
                d_a1 = d_a1 + da1(g[:, c0:min(c0 + CHUNK, co)],
                                  wt[c0:c0 + CHUNK])
    else:
        d_a1 = da1(g[:, :co], w1)
    # dx (dx_strips): the avg and maxpool gradients of dA1 and dM, in f32
    dx, = torch.autograd.grad([a1, m], xf, [d_a1, dm])
    return bf(dx), dw1, dw2


def _reference(x, g, w1, w2):
    """The backward of the pre-BN ADown in f64 (autograd)."""
    xd, w1d, w2d = (t.double().requires_grad_() for t in (x, w1, w2))
    with torch.enable_grad():
        a1, a2 = adown._avg(xd).chunk(2, dim=1)
        y = torch.cat([F.conv2d(a1, w1d, stride=2, padding=1),
                       F.conv2d(F.max_pool2d(a2, 3, 2, 1), w2d)], dim=1)
        return torch.autograd.grad(y, (xd, w1d, w2d), g.double())


def _inputs(seed: int, shape, co: int, halves: bool):
    """bf16 values in f32: x (quantized to halves, so that maxpool ties
    are common, or standard normal), g standard normal, the weights at
    1/sqrt(fan-in) as the model's init draws them."""
    rng = np.random.default_rng(seed)
    bsz, cin, h, w = shape
    ch = cin // 2
    x = rng.standard_normal(shape)
    if halves:
        x = np.round(x * 2) / 2
    g = rng.standard_normal((bsz, 2 * co, h // 2, w // 2))
    w1 = rng.standard_normal((co, ch, 3, 3)) / np.sqrt(9 * ch)
    w2 = rng.standard_normal((co, ch, 1, 1)) / np.sqrt(ch)
    return [bf(torch.from_numpy(t.astype(np.float32)))
            for t in (x, g, w1, w2)]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _assert_within(got, ref, what: str):
    (dx, dw1, dw2), (rdx, rdw1, rdw2) = got, ref
    tol = OUT_REL * max(1.0, float(rdx.abs().max()))
    err = float((dx.double() - rdx.double()).abs().max())
    assert err <= tol, f"{what} dx: {err} > {tol}"
    for name, a, b in (("dW1", dw1, rdw1), ("dW2", dw2, rdw2)):
        assert _rel(a, b) <= WGRAD_REL, f"{what} {name}: {_rel(a, b)}"


@pytest.mark.parametrize("kind", ["normal", "halves", "wide"])
def test_m_rounded_after_the_max_is_the_max_of_the_rounded_avg(kind):
    """pool_avg rounds the f32 window max to bf16 once; the TPU kernel
    takes the max of the bf16 avg. Rounding is monotone, so the two are
    the same values (the -inf padding of the window included)."""
    rng = np.random.default_rng(["normal", "halves", "wide"].index(kind))
    a = rng.standard_normal((2, 24, 19, 23))
    if kind == "halves":
        a = np.round(a * 2) / 2 + rng.integers(0, 2, a.shape) * 2.0 ** -9
    elif kind == "wide":
        a = a * np.exp2(rng.integers(-20, 20, a.shape))
    a = torch.from_numpy(a.astype(np.float32))
    after = bf(F.max_pool2d(a, 3, 2, 1))
    before = F.max_pool2d(bf(a), 3, 2, 1)
    assert torch.equal(after, before)
    # and rounding does move the values: the test is not vacuous
    assert not torch.equal(after, F.max_pool2d(a, 3, 2, 1))


def test_bf16_slabs_fill_the_rounds_of_resident_blocks(h100):
    """dw_bf16's slab count at gelan-c's five sites on an H100 (2 blocks
    an SM): its blocks never exceed the rounds of resident blocks that
    4096-pixel slabs take, and fill more of them; a small call keeps at
    least one 64-pixel chunk a slab."""
    resident = adown.BWD_BF16_BLOCKS_PER_SM * H100_SMS
    got = {}
    for name, (cin, h, w, cout) in GELAN_C.items():
        ch, co, n = cin // 2, cout // 2, 32 * (h // 2) * (w // 2)
        slabs = adown._bwd_slabs(n, ch, co, torch.device("cuda"))
        per_slab = 10 * -(-ch // 128) * -(-co // 128)
        base = -(-n // adown.BWD_SLAB_PIXELS)
        rounds = -(-base * per_slab // resident)
        assert base <= slabs <= adown.BWD_MAX_SLABS
        assert slabs * per_slab <= rounds * resident
        assert (slabs + 1) * per_slab > rounds * resident or \
            slabs == adown.BWD_MAX_SLABS
        got[name] = slabs
    assert got == {"down1": 52, "down2": 13, "down3": 6, "pan_down1": 26,
                   "pan_down2": 6}
    assert adown._bwd_slabs(300, 16, 24, torch.device("cuda")) == 5
    assert adown._bwd_slabs(30, 8, 8, torch.device("cuda")) == 1


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["tensor_cores", "chunk_sums"])
@pytest.mark.parametrize("shape,co,halves", [((2, 256, 96, 96), 128, True),
                                             ((2, 256, 96, 96), 128, False),
                                             ((1, 32, 19, 23), 24, True)])
def test_bf16_products_meet_the_bf16_tolerance(h100, shape, co, halves,
                                               chunked):
    """Against the f64 backward of the same bf16 values. (2, 256, 96, 96)
    -> 128: gelan-c's branch width, 4608 output pixels in the H100's 26
    slabs of 178, x quantized to halves (exact in bf16: the avg and M are
    too) and standard normal (the avg and M rounded); (1, 32, 19, 23) ->
    24: Ch = 16, Co = 24 (a partial 64-channel chunk), odd H and W. The
    two ways of summing differ by less than the f32 tolerance."""
    x, g, w1, w2 = _inputs(len(shape) + co + halves, shape, co, halves)
    bsz, cin, h, w = shape
    slabs = adown._bwd_slabs(bsz * (h // 2) * (w // 2), cin // 2, co,
                             torch.device("cuda"))
    got = _emulate(x, g, w1, w2, slabs, chunked)
    _assert_within(got, _reference(x, g, w1, w2), "f64")
    other = _emulate(x, g, w1, w2, slabs, not chunked)
    for a, b in zip(got[1:], other[1:]):
        assert _rel(a, b) <= 1e-5


def test_bf16_products_match_the_jax_backward(h100):
    """Against the JAX package's train ADown backward (the Pallas kernel in
    interpret mode, f32), on the inputs of tests/test_torch_train.py's
    ADown cases rounded to bf16: x (2, 16, 16, 256) NHWC, packed to
    (2, 16, 8, 512) as the JAX Function takes it."""
    x, g, w1, w2 = _inputs(4, (2, 256, 16, 16), 128, False)
    xh = x.permute(0, 2, 3, 1).numpy()
    gh = g.permute(0, 2, 3, 1).numpy()

    def obj(xp, w1h, w2h):
        return (_adown_conv(xp, w1h, w2h, True) * jnp.asarray(gh)).sum()

    jdx, jdw1, jdw2 = jax.grad(obj, argnums=(0, 1, 2))(
        jnp.asarray(xh).reshape(2, 16, 8, 512),
        jnp.asarray(w1.permute(2, 3, 1, 0).numpy()),
        jnp.asarray(w2.permute(2, 3, 1, 0).numpy()))
    ref = (torch.from_numpy(np.array(jdx).reshape(2, 16, 16, 256))
           .permute(0, 3, 1, 2),
           torch.from_numpy(np.array(jdw1)).permute(3, 2, 0, 1),
           torch.from_numpy(np.array(jdw2)).permute(3, 2, 0, 1))
    slabs = adown._bwd_slabs(2 * 8 * 8, 128, 128, torch.device("cuda"))
    _assert_within(_emulate(x, g, w1, w2, slabs, False), ref, "jax")
