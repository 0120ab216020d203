"""Train-mode BN + activation: ops/conv.py's `BatchNormAct` and the plain
versions of ops/kernels/bn_silu.py held against the JAX package, and the
dispatch between it and the eager chain, on the CPU.

On a CPU tensor the wrappers run their plain versions (the CUDA kernels run
only on the card: tests/test_torch_cuda.py). The JAX side is the package's
own train BN (`yolo_re_tpu/ops/conv.py: conv_bn_act(train=True)`) behind an
identity 1x1 conv, which passes y through exactly in f32 and in bf16, so
that `jax.vjp` gives the gradient of BN + activation alone.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.ops.conv import conv_bn_act as jconv_bn_act
from yolo_re_tpu_torch.ops import conv
from yolo_re_tpu_torch.ops.kernels import bn_silu
from yolo_re_tpu_torch.parallel import mesh

# (C, modules): a C that fills its channel tiles (64: 8 bf16 vectors of 8),
# one that does not (40: 5 vectors in a tile of 8 threads), one that is no
# multiple of the 16-byte vector (12: the kernels' one-element walk), and
# ADown's two modules sharing one pass (2 x 24)
CASES = [(64, 1), (40, 1), (12, 1), (48, 2)]


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _inputs(c: int, seed: int):
    """y ~ 1.5 N(0, 1) + 0.3 (B, H, W) = (3, 7, 5) NHWC, BN scale ~ U(0.5,
    1.5), bias ~ N(0, 0.3), running stats, the output cotangent."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((3, 7, 5, c)) * 1.5 + 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.3).astype(np.float32)
    mean = (rng.standard_normal(c) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    g = rng.standard_normal((3, 7, 5, c)).astype(np.float32)
    return y, scale, bias, mean, var, g


def _cl(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor of dtype in channels_last memory."""
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)


def _jax_bn_act(y, scale, bias, mean, var, g, dtype, act):
    """(z, new running mean, new running var, dy, dscale, dbias) of the JAX
    package's train BN + act, as numpy f32 (z, dy NHWC)."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    c = y.shape[-1]
    w = jnp.eye(c, dtype=jd).reshape(1, 1, c, c)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def f(yj, sj, bj):
        return jconv_bn_act({"w": w, "scale": sj, "bias": bj}, stats, yj,
                            act=act, train=True)

    z, vjp, st = jax.vjp(f, jnp.asarray(y).astype(jd), jnp.asarray(scale),
                         jnp.asarray(bias), has_aux=True)
    dy, ds, db = vjp(jnp.asarray(g).astype(jd))
    return tuple(np.asarray(jnp.asarray(a, jnp.float32))
                 for a in (z, st["mean"], st["var"], dy, ds, db))


def _running(mean, var, modules):
    k = mean.size // modules
    return [(torch.from_numpy(mean[i * k:(i + 1) * k].copy()),
             torch.from_numpy(var[i * k:(i + 1) * k].copy()),
             torch.zeros((), dtype=torch.int64)) for i in range(modules)]


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("c,modules", CASES)
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bn_act_matches_jax(dtype, act, c, modules):
    """`BatchNormAct` on the CPU (the plain versions of the four kernel
    jobs) against the JAX package's train BN + act: z, the running
    statistics (each module's, counted once) and the gradients of y, scale
    and bias.

    f32: the same arithmetic summed in another order (1e-5). bf16: z at
    the same rounding points, so "none" is equal and SiLU within two bf16
    ulps (2^-6 of |z|: JAX rounds the sigmoid and the product in bf16,
    torch takes SiLU in f32 and rounds once); the gradients, which the JAX
    package rounds at each bf16 op and the kernels once, against JAX in
    f32 on the same bf16 inputs within 2^-8 (dx's one rounding, 2^-9, and
    the forward's rounding of y * inv + shift, which the f32 reference does
    not make), and no farther from it than JAX's own bf16 gradients."""
    y, scale, bias, mean, var, g = _inputs(c, 1)
    yt = _cl(y, dtype).requires_grad_()
    gt = _cl(g, dtype)
    w = torch.from_numpy(scale).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    running = _running(mean, var, modules)
    z = conv.BatchNormAct.apply(yt, w, b, running, act)
    z.backward(gt)
    assert z.dtype == dtype
    assert z.is_contiguous(memory_format=torch.channels_last)
    assert [int(r[2]) for r in running] == [1] * modules

    ref = _jax_bn_act(y, scale, bias, mean, var, g, dtype, act)
    zr = _nchw(ref[0])
    rm = torch.cat([r[0] for r in running])
    rv = torch.cat([r[1] for r in running])
    torch.testing.assert_close(rm, torch.from_numpy(ref[1]), atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(rv, torch.from_numpy(ref[2]), atol=1e-6,
                               rtol=1e-6)
    grads = (yt.grad.float(), w.grad, b.grad)
    if dtype == torch.float32:
        torch.testing.assert_close(z, zr, atol=1e-5, rtol=1e-5)
        for got, want in zip(grads, (_nchw(ref[3]), *ref[4:])):
            assert _rel_l2(got, torch.as_tensor(want)) <= 1e-5
        return
    if act == "none":
        assert torch.equal(z.float(), zr)
    else:
        assert bool(((z.float() - zr).abs() <= 2.0 ** -6 * zr.abs()).all())
    rounded = [torch.from_numpy(a).bfloat16().float().numpy() for a in (y, g)]
    f32 = _jax_bn_act(rounded[0], scale, bias, mean, var, rounded[1],
                      torch.float32, act)
    for got, mine, want in zip(grads, (_nchw(ref[3]), *ref[4:]),
                               (_nchw(f32[3]), *f32[4:])):
        want = torch.as_tensor(want)
        err = _rel_l2(got, want)
        assert err <= 2.0 ** -8
        assert err <= _rel_l2(torch.as_tensor(mine), want)


@pytest.mark.parametrize("modules", [1, 2])
def test_running_stats_updated_once(modules):
    """The running statistics take one update per forward, and none when
    the forward runs again inside `recomputing()` (a checkpointed block's
    recompute): values and num_batches_tracked."""
    y, scale, bias, mean, var, _ = _inputs(48, 2)
    yt = _cl(y, torch.bfloat16)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    running = _running(mean, var, modules)
    conv.BatchNormAct.apply(yt, w, b, running, "silu")
    once = [tuple(t.clone() for t in r) for r in running]
    with conv.recomputing():
        z = conv.BatchNormAct.apply(yt, w, b, running, "silu")
    for r, o in zip(running, once):
        for t, t0 in zip(r, o):
            assert torch.equal(t, t0)
        assert int(r[2]) == 1
    # the recompute's output is the first run's
    fresh = _running(mean, var, modules)
    assert torch.equal(z, conv.BatchNormAct.apply(yt, w, b, fresh, "silu"))
    ref_mean = yt.float().mean(dim=(0, 2, 3))
    assert not torch.equal(torch.cat([r[0] for r in running]),
                           torch.from_numpy(mean))
    torch.testing.assert_close(
        torch.cat([r[0] for r in running]),
        0.97 * torch.from_numpy(mean) + 0.03 * ref_mean, atol=1e-6,
        rtol=1e-6)


def _row_pitch_cases():
    cl = torch.empty(2, 16, 5, 6).contiguous(memory_format=torch.channels_last)
    wide = torch.empty(2, 48, 5, 6).contiguous(
        memory_format=torch.channels_last)
    one = torch.empty(1, 16, 1, 1)
    return {"channels_last": (cl, 16), "slice": (wide[:, 8:24], 48),
            "one_pixel": (one, 16), "one_row": (wide[:1, :16, :1], 48),
            "nchw": (torch.empty(2, 16, 5, 6), None),
            "strided_channels": (wide[:, ::2], None),
            "three_d": (torch.empty(2, 16, 5), None)}


@pytest.mark.parametrize("case", sorted(_row_pitch_cases()))
def test_row_pitch(case):
    """The backward reads g's rows at their pitch: C for channels_last, the
    wider tensor's C for a channel slice of it (a concat's gradient); any
    other layout has none and is copied first."""
    t, want = _row_pitch_cases()[case]
    assert bn_silu.row_pitch(t) == want


def test_backward_takes_a_channel_slice():
    """`BatchNormAct`'s backward on a gradient that is a channel slice of a
    wider channels_last tensor equals its backward on a dense copy."""
    y, scale, bias, mean, var, g = _inputs(16, 4)
    yt = _cl(y, torch.bfloat16)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    z, stats = bn_silu.forward(yt, w, b, "silu", _running(mean, var, 1),
                               True, conv.BN_EPS, conv.BN_MOMENTUM)
    wide = torch.randn(3, 40, 7, 5, generator=torch.Generator().manual_seed(
        5)).bfloat16().contiguous(memory_format=torch.channels_last)
    gs = wide[:, 8:24]
    for a, b2 in zip(bn_silu.backward(gs, yt, stats, "silu"),
                     bn_silu.backward(gs.contiguous(
                         memory_format=torch.channels_last), yt, stats,
                         "silu")):
        assert torch.equal(a, b2)


def _refusal_cases():
    y = torch.randn(2, 16, 5, 6).contiguous(memory_format=torch.channels_last)
    stats = torch.zeros(bn_silu.STAT_ROWS, 16)
    w, b = torch.ones(16), torch.zeros(16)
    run = [(torch.zeros(16), torch.ones(16),
            torch.zeros((), dtype=torch.int64))]

    def fwd(y=y, w=w, act="silu", run=run):
        return bn_silu.forward(y, w, b, act, run, True, 1e-3, 0.03)

    return {
        "nchw": lambda: fwd(y=y.contiguous()),
        "float16": lambda: fwd(y=y.half()),
        "activation": lambda: fwd(act="relu"),
        "bf16_weight": lambda: fwd(w=w.bfloat16()),
        "running_channels": lambda: fwd(run=run * 2),
        "g_nchw": lambda: bn_silu.backward(y.contiguous(), y, stats, "silu"),
        "g_dtype": lambda: bn_silu.backward(y.bfloat16(), y, stats, "silu"),
        "stats_shape": lambda: bn_silu.backward(y, y, stats[:4], "silu"),
        "stats_dtype": lambda: bn_silu.backward(y, y, stats.double(),
                                                "silu"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_wrappers_refuse(case):
    """The wrappers check before they dispatch, on the CPU as on the card:
    a tensor that is not channels_last, a dtype the kernels lack, an
    activation they lack, tables of the wrong shape or dtype."""
    with pytest.raises((TypeError, ValueError)):
        _refusal_cases()[case]()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["cpu", "global_batch", "relu"])
def test_dispatch_sends_to_the_eager_chain(case):
    """`batch_norm_act` decides from its input: a CUDA tensor in train mode
    with SiLU and no data-parallel group takes the kernels (decided here
    on a fake CUDA tensor, which needs no card); a CPU tensor, a
    `global_batch` group or another activation take the eager chain, and
    `eager_sites` counts the site, `fused_sites` does not."""
    bn = torch.nn.BatchNorm2d(8, eps=conv.BN_EPS, momentum=conv.BN_MOMENTUM)
    act = "relu" if case == "relu" else "silu"
    with FakeTensorMode():
        on_card = torch.empty(2, 8, 3, 3, device="cuda")
        assert conv.takes_kernels(on_card, bn, "silu")
        assert conv.takes_kernels(on_card, bn, "none")
        assert not conv.takes_kernels(on_card, bn.eval(), "silu")
        bn.train()
        if case == "global_batch":
            with mesh.global_batch("a group"):
                assert not conv.takes_kernels(on_card, bn, act)
        elif case == "relu":
            assert not conv.takes_kernels(on_card, bn, act)
    y = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(0))
    assert not conv.takes_kernels(y, bn, "silu")
    ref = conv.get_activation(act)(conv.batch_norm(y, torch.nn.BatchNorm2d(
        8, eps=conv.BN_EPS, momentum=conv.BN_MOMENTUM)))
    before = (conv.fused_sites, conv.eager_sites)
    if case == "global_batch":
        # a one-process gloo group: the global moments are this batch's
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        try:
            with mesh.global_batch(dist.group.WORLD):
                out = conv.batch_norm_act(y, (bn,), act)
        finally:
            dist.destroy_process_group()
    else:
        out = conv.batch_norm_act(y, (bn,), act)
    assert (conv.fused_sites, conv.eager_sites) == (before[0],
                                                    before[1] + 1)
    torch.testing.assert_close(out, ref)
