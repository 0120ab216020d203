"""The port's stage1 kernels held against the JAX package on the CPU: the
bottleneck chain (ops/kernels/csp_chain.py) and the 64-channel 3x3
conv + SiLU (ops/kernels/conv3.py), each as its plain version (what a
wrapper runs on a CPU tensor), against the TPU kernel run in Pallas
interpret mode and against the JAX package's plain graph; then the fused
stage1-geometry RepNCSPELAN4 that routes through both. Inputs come from
numpy seeds and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.models import blocks as JB
from yolo_re_tpu.models.fuse import _fuse as jfuse
from yolo_re_tpu.ops import packed_elan as pe
from yolo_re_tpu.ops.pallas import csp_chain_kernel as ck
from yolo_re_tpu.ops.pallas.conv3_kernel import build_conv3_weights
from yolo_re_tpu.ops.pallas.conv3_kernel import conv3_silu as jconv3_silu
from yolo_re_tpu_torch import convert
from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.fuse import fuse_model
from yolo_re_tpu_torch.ops.kernels import conv3, csp_chain

# the JAX package's own bounds: the chain kernel against the packed loop,
# f32 (tests/test_blocks.py:592-638); conv3 against XLA, bf16
# (test_blocks.py:267-289); the chain-engaged ELAN, bf16 (test_blocks.py:
# 641-683)
CHAIN_ATOL = 2e-5
CONV3_BF16_ATOL = 0.05
ELAN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _cl(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (the same bytes)."""
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _vec(b) -> torch.Tensor:
    return torch.from_numpy(np.array(b, np.float32))


# ---------------------------------------------------------------------------
# the bottleneck chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shape", [(1, (1, 16, 32)), (2, (2, 48, 32))],
                         ids=["n1", "n2"])
def test_chain_plain_matches_jax_kernel_and_packed_loop(n, shape):
    """n=1 on one row block; n=2 at H=48 spans the TPU kernel's first,
    middle and last row blocks. m is (B, H, W, 32) NHWC, which is the TPU
    kernel's p=4 packed (B, H, W/4, 128) byte for byte."""
    cfg = JB.RepNCSPConfig(64, 64, num_repeats=n)
    p, s = jax.device_get(JB.RepNCSP.init(jax.random.key(20 + n), cfg))
    fp, _ = jfuse(JB.RepNCSP, cfg, p, s)
    bsz, h, w = shape
    m = np.random.default_rng(30 + n).standard_normal(
        (bsz, h, w, 32)).astype(np.float32)
    packed = jnp.asarray(m.reshape(bsz, h, w // 4, 128))

    r_pal = ck.bottleneck_chain(packed, ck.build_bottleneck_chain_weights(fp),
                                interpret=True)
    r_loop = packed
    for bot in fp["bottlenecks"]:
        t = r_loop
        for leaf in (bot["conv1"]["fused"], bot["conv2"]):
            t = pe._pconv(t, {"w": jnp.asarray(pe._pack_same(
                np.asarray(leaf["w"], np.float32), 4)),
                "b": jnp.asarray(np.tile(np.asarray(leaf["b"]), 4))})
        r_loop = r_loop + t

    bots = fp["bottlenecks"]
    w1 = torch.stack([_oihw(b["conv1"]["fused"]["w"]) for b in bots])
    b1 = torch.stack([_vec(b["conv1"]["fused"]["b"]) for b in bots])
    w2 = torch.stack([_oihw(b["conv2"]["w"]) for b in bots])
    b2 = torch.stack([_vec(b["conv2"]["b"]) for b in bots])
    y = csp_chain.bottleneck_chain(_cl(m), w1, b1, w2, b2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    for ref in (r_pal, r_loop):
        np.testing.assert_allclose(
            _nhwc(y), np.asarray(ref).reshape(bsz, h, w, 32), atol=CHAIN_ATOL)


def test_chain_plain_rounds_as_the_tpu_kernel_in_bf16():
    """bf16: each conv's output rounded to bf16 and the residual added in
    bf16, the TPU kernel's rounding points (csp_chain_kernel.py:206-215)."""
    cfg = JB.RepNCSPConfig(64, 64, num_repeats=2)
    p, s = jax.device_get(JB.RepNCSP.init(jax.random.key(5), cfg))
    fp, _ = jfuse(JB.RepNCSP, cfg, p, s)
    m = np.random.default_rng(6).standard_normal((1, 16, 32, 32))
    m = np.asarray(jnp.asarray(m, jnp.bfloat16).astype(jnp.float32))
    ref = ck.bottleneck_chain(
        jnp.asarray(m.reshape(1, 16, 8, 128), jnp.bfloat16),
        ck.build_bottleneck_chain_weights(fp), interpret=True)
    bots = fp["bottlenecks"]
    args = [torch.stack([_oihw(b["conv1"]["fused"]["w"]) for b in bots]),
            torch.stack([_vec(b["conv1"]["fused"]["b"]) for b in bots]),
            torch.stack([_oihw(b["conv2"]["w"]) for b in bots]),
            torch.stack([_vec(b["conv2"]["b"]) for b in bots])]
    # the TPU kernel takes bf16 weights and f32 biases
    args = [a.bfloat16() if a.dim() == 5 else a for a in args]
    mb = _cl(m).bfloat16()
    r = mb
    for i in range(2):
        t = torch.nn.functional.conv2d(r.float(), args[0][i].float(),
                                       args[1][i], padding=1)
        t = torch.nn.functional.silu(t).bfloat16()
        t = torch.nn.functional.conv2d(t.float(), args[2][i].float(),
                                       args[3][i], padding=1)
        r = r + torch.nn.functional.silu(t).bfloat16()
    y = csp_chain.bottleneck_chain_plain(mb, *args)
    assert y.dtype == torch.bfloat16 and torch.equal(y, r)
    # one bf16 ulp of the outputs (|y| < 8) where the two sum differently
    np.testing.assert_allclose(
        _nhwc(y), np.asarray(ref, np.float32).reshape(1, 16, 32, 32),
        atol=2 ** -4)


# ---------------------------------------------------------------------------
# the 64-channel 3x3 conv + SiLU
# ---------------------------------------------------------------------------

def _conv3_case(seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32)
    b = rng.standard_normal((64,)).astype(np.float32)
    return rng, w, b


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 8, 24), (1, 32, 16)])
def test_conv3_plain_matches_jax_kernel_bf16(shape):
    rng, w, b = _conv3_case(11)
    x = jnp.asarray(rng.standard_normal((*shape, 64)), jnp.bfloat16)
    ref = jconv3_silu(x, build_conv3_weights({"w": jnp.asarray(w),
                                              "b": jnp.asarray(b)}),
                      interpret=True)
    xt = _cl(np.asarray(x.astype(jnp.float32))).bfloat16()
    y = conv3.conv3_silu(xt, _oihw(w).bfloat16(), _vec(b).bfloat16())
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref, np.float32),
                               atol=CONV3_BF16_ATOL)


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 7, 13)])
def test_conv3_plain_matches_xla_conv_f32(shape):
    rng, w, b = _conv3_case(12)
    x = rng.standard_normal((*shape, 64)).astype(np.float32)
    yr = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + b
    ref = np.asarray(yr * jax.nn.sigmoid(yr))
    y = conv3.conv3_silu(_cl(x), _oihw(w), _vec(b))
    np.testing.assert_allclose(_nhwc(y), ref, atol=1e-5)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    cl = torch.channels_last
    x = torch.zeros(1, 64, 6, 6).contiguous(memory_format=cl)
    w, b = torch.zeros(64, 64, 3, 3), torch.zeros(64)
    with pytest.raises(ValueError, match="channels_last"):
        conv3.conv3_silu(x.contiguous(), w, b)
    with pytest.raises(ValueError, match="64"):
        conv3.conv3_silu(torch.zeros(1, 32, 6, 6).contiguous(
            memory_format=cl), w, b)
    with pytest.raises(ValueError, match="float32"):
        conv3.conv3_silu(x, w.bfloat16(), b)
    with pytest.raises(TypeError, match="dtype"):
        conv3.conv3_silu(x.half(), w.half(), b.half())
    m = torch.zeros(1, 32, 6, 6).contiguous(memory_format=cl)
    ws, bs = torch.zeros(5, 32, 32, 3, 3), torch.zeros(5, 32)
    with pytest.raises(ValueError, match="1 to 4"):
        csp_chain.bottleneck_chain(m, ws, bs, ws, bs)
    with pytest.raises(ValueError, match="b2"):
        csp_chain.bottleneck_chain(m, ws[:2], bs[:2], ws[:2], bs[:1])
    with pytest.raises(ValueError, match="32"):
        csp_chain.bottleneck_chain(x, ws[:1], bs[:1], ws[:1], bs[:1])
    with pytest.raises(ValueError, match="no kernel for device"):
        csp_chain.bottleneck_chain(m.to("meta"), *(t[:1].to("meta") for t in
                                                   (ws, bs, ws, bs)))


# ---------------------------------------------------------------------------
# the fused stage1 RepNCSPELAN4 (both kernels engaged)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 2])
def test_stage1_elan_matches_jax_with_the_chain(monkeypatch, n, dtype):
    """gelan-c's stage1 geometry (hidden 128, block 64: bottlenecks 32
    wide, block convs 64 -> 64). The JAX package runs its packed path with
    the chain kernel (bf16 only: its f32 path keeps the packed loop), in
    interpret mode; the port runs both kernel wrappers (plain versions on
    the CPU)."""
    monkeypatch.setenv("YOLO_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("YOLO_TPU_CSP_CHAIN", "1")
    cfg = JB.RepNCSPELAN4Config(96, 256, hidden_channels=128,
                                block_channels=64, num_repeats=n)
    params, stats = jax.device_get(JB.RepNCSPELAN4.init(
        jax.random.key(40 + n), cfg))
    rng = np.random.default_rng(n)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0, 0.3, np.shape(v))
        .astype(np.float32), stats)
    sd = {}
    convert._elan(sd, "", params, stats)
    module = B.RepNCSPELAN4(96, 256, 128, 64, n)
    module.load_state_dict(sd, strict=True)
    fuse_model(module.eval())
    assert all(csp.chain for csp in (module.block1[0], module.block2[0]))
    assert all(c.is_conv3 and c.bn is None
               for c in (module.block1[1], module.block2[1]))
    fp, fs = jfuse(JB.RepNCSPELAN4, cfg, params, stats)

    x = np.random.default_rng(41).standard_normal((2, 8, 32, 96))
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x, jdtype)
    calls = []
    orig = ck.bottleneck_chain

    def spy(m, weights, **kw):
        calls.append(m.shape)
        return orig(m, weights, **kw)

    monkeypatch.setattr(ck, "bottleneck_chain", spy)
    ref, _ = JB.RepNCSPELAN4.apply(cfg, fp, fs, xj, train=False)
    assert len(calls) == (2 if dtype == torch.bfloat16 else 0)

    counts = {"chain": 0, "conv3": 0}
    for mod, name, key in ((csp_chain, "bottleneck_chain_packed", "chain"),
                           (conv3, "conv3_silu_packed", "conv3")):
        def counted(*a, _f=getattr(mod, name), _k=key):
            counts[_k] += 1
            return _f(*a)
        monkeypatch.setattr(mod, name, counted)
    module.to(dtype)
    with torch.no_grad():
        y = module(_cl(np.asarray(xj.astype(jnp.float32))).to(dtype))
    assert counts == {"chain": 2, "conv3": 2}
    assert y.dtype == dtype
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref, np.float32),
                               atol=ELAN_ATOL[dtype])


def test_fuse_stacks_the_chain_only_at_its_geometry():
    """The chain needs residual 32-wide bottlenecks, at most four; its
    stacked weights are not part of the state dict."""
    cases = {(64, 64, 1): True, (64, 64, 4): True, (64, 64, 5): False,
             (32, 32, 1): False, (128, 128, 1): False}
    for (cin, cout, n), want in cases.items():
        csp = fuse_model(B.RepNCSP(cin, cout, n).eval())
        assert csp.chain is want, (cin, cout, n)
        assert not any(k.startswith("chain") for k in csp.state_dict())
    no_res = B.RepNCSP(64, 64, 1, shortcut=False).eval()
    assert fuse_model(no_res).chain is False
    grouped = B.Conv(64, 64, 3, 1, groups=4)
    assert not grouped.is_conv3 and B.Conv(64, 64, 3, 1).is_conv3


# ---------------------------------------------------------------------------
# the packed weight image the CUDA kernels read (csrc/hopper.cuh)
# ---------------------------------------------------------------------------

def _read_packed(packed: np.ndarray, c: int) -> np.ndarray:
    """OIHW weights of the k convs in a packed image, read one element at a
    time by the kernels' index arithmetic (hopper.cuh: packed_index)."""
    per = 9 * c * c
    convs = packed.reshape(-1, per)
    w = np.empty((len(convs), c, c, 3, 3), packed.dtype)
    for co in range(c):
        for ci in range(c):
            for tap in range(9):
                i = ((tap * (c // 16) + ci // 16) * (16 * c) + (co // 8) * 128
                     + (ci // 8) % 2 * 64 + (co % 8) * 8 + ci % 8)
                w[:, co, ci, tap // 3, tap % 3] = convs[:, i]
    return w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv3_packed_weights_read_back_exactly(dtype):
    rng, w, b = _conv3_case(13)
    wt, bt = _oihw(w).to(dtype), _vec(b).to(dtype)
    x = _cl(rng.standard_normal((2, 9, 11, 64))).to(dtype)
    wp = conv3.pack_weights(wt)
    assert wp.shape == (9 * 64 * 64,) and wp.dtype == dtype
    read = torch.from_numpy(_read_packed(wp.float().numpy(), 64)[0]).to(dtype)
    assert torch.equal(read, wt) and torch.equal(conv3.unpack_weights(wp), wt)
    ref = conv3.conv3_silu_plain(x, wt, bt)
    assert torch.equal(conv3.conv3_silu_plain(x, read, bt), ref)
    assert torch.equal(conv3.conv3_silu_packed(x, wp, bt), ref)
    assert torch.equal(conv3.conv3_silu(x, wt, bt), ref)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_chain_packed_weights_read_back_exactly(n):
    rng = np.random.default_rng(50 + n)
    w1, w2 = (torch.from_numpy(rng.standard_normal(
        (n, 32, 32, 3, 3)).astype(np.float32) * 0.06) for _ in range(2))
    b1, b2 = (torch.from_numpy(rng.standard_normal((n, 32)).astype(
        np.float32) * 0.5 + 0.5) for _ in range(2))
    m = _cl(rng.standard_normal((1, 7, 10, 32))).bfloat16()
    args = [t.bfloat16() for t in (w1, b1, w2, b2)]
    wp, bias = csp_chain.pack_weights(*args)
    assert wp.shape == (n * 2 * 9 * 32 * 32,) and bias.shape == (n, 2, 32)
    read = torch.from_numpy(_read_packed(wp.float().numpy(), 32)).bfloat16()
    assert torch.equal(read[0::2], args[0]) and torch.equal(read[1::2],
                                                            args[2])
    assert all(torch.equal(a, b) for a, b in
               zip(csp_chain.unpack_weights(wp, bias), args))
    ref = csp_chain.bottleneck_chain_plain(m, *args)
    assert torch.equal(csp_chain.bottleneck_chain_plain(
        m, read[0::2], bias[:, 0], read[1::2], bias[:, 1]), ref)
    assert torch.equal(csp_chain.bottleneck_chain_packed(m, wp, bias), ref)


def test_fuse_packs_kernel_weights_as_buffers_that_follow_to():
    """A fused conv3-geometry Conv and a chain RepNCSP keep their packed
    weights in non-persistent buffers: cast with the module, equal to the
    packing of the cast weights, absent from the state dict."""
    conv = B.Conv(64, 64, 3, 1).eval()
    csp = B.RepNCSP(64, 64, 2).eval()
    for mod in (conv, csp):
        fuse_model(mod).to(torch.bfloat16)
        names = {name for name, _ in mod.named_buffers()}
        assert names & {"conv3_w", "chain_w", "chain_b"}
        assert not names & set(mod.state_dict())
    assert torch.equal(conv.conv3_w, conv3.pack_weights(conv.conv.weight))
    bots = list(csp.bottlenecks)
    wp, bias = csp_chain.pack_weights(
        torch.stack([b.conv1.fused.weight for b in bots]),
        torch.stack([b.conv1.fused.bias for b in bots]),
        torch.stack([b.conv2.conv.weight for b in bots]),
        torch.stack([b.conv2.conv.bias for b in bots]))
    assert csp.chain_w.dtype == torch.bfloat16
    assert torch.equal(csp.chain_w, wp) and torch.equal(csp.chain_b, bias)
