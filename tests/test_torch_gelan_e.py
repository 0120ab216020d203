"""gelan-e and gelan-c-d2 on the port, held against the JAX package on the
CPU.

gelan-e (width 1.25, depth 2.0) runs the stem at C = 80 and its five
ADowns at Co = 160 and 320 a branch (Cin 320 and 640), widths no gelan-c
site has; its bottlenecks (40 channels) and 3x3 block convs (80) are
outside the chain's and conv3's geometry. gelan-c-d2 (depth 2.0) runs the
chain at n = 2. Here: the kernels' plain versions at gelan-e's widths
against the JAX blocks and the Pallas stem (interpret mode; the Pallas
ADown takes only multiples of 256 channels, so gelan-e's ADowns run the
JAX package's plain graph), the kernel sites of both fused models, and
the multiplier path on a small model (TINY_YAML's layers at width 1.25,
depth 2.0): unfused and fused forward and one Trainer step. The CUDA
kernels are held against these plain versions at the same widths in
tests/test_torch_cuda.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.models import blocks as JB
from yolo_re_tpu.models.fuse import _fuse as jfuse
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.ops.conv import avg_pool2d as javg
from yolo_re_tpu.ops.conv import conv2d as jconv2d
from yolo_re_tpu.ops.conv import max_pool2d as jmax
from yolo_re_tpu.ops.pallas.stem_kernel import (
    build_stem_kernel_weights,
    stem_conv as jstem_conv,
    stem_conv_packed_raw,
    stem_wgrad_packed,
    to_phase_planes,
    unpack_rows,
)
from yolo_re_tpu.ops.stem_train import _pack_w2_jnp
from yolo_re_tpu.train.config import TrainConfig as JTrainConfig
from yolo_re_tpu.train.trainer import Trainer as JTrainer
from yolo_re_tpu_torch import convert
from yolo_re_tpu_torch.data import synth
from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.fuse import fuse_model
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.kernels import adown, stem
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
# f32 kernels and blocks, the JAX package's tolerance (test_blocks.py:208)
KERNEL_ATOL = 2e-5
# weight gradients (f32 sums in another order): relative L2
WGRAD_REL = 1e-5
# f32 decoded output, PARITY.md "Parity" (gelan-c: 3.1e-5)
DECODED_ATOL = 3.1e-5
# loss items, PARITY.md "Loss / assignment" (~3e-6 relative)
LOSS_RTOL = 1e-5
# gelan-e's ADown widths (Cin -> Cout): Co = 160 and 320 a branch
GELAN_E_ADOWN = [((2, 12, 14), 320), ((1, 10, 8), 640)]
# TINY_YAML's layers through the multiplier path: 16 -> 24, 32 -> 40,
# 48 -> 64, 64 -> 80 channels; every RepNCSP at num_repeats 2
MULT_YAML = synth.TINY_YAML.replace(
    "model:\n  num_classes: 4\n",
    "model:\n  num_classes: 4\n  depth_multiplier: 2.0\n"
    "  width_multiplier: 1.25\n")


def _cl(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (the same bytes)."""
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _hwio(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().numpy(), (2, 3, 1, 0))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _perturb_stats(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: np.asarray(s) + rng.uniform(0, 0.3, np.shape(s))
        .astype(np.float32), stats)


@pytest.fixture(scope="module")
def mult_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny_mult.yaml"
    p.write_text(MULT_YAML)
    return str(p)


# ---------------------------------------------------------------------------
# the kernels' plain versions at gelan-e's widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("hw,cin", GELAN_E_ADOWN,
                         ids=[f"cin{c}" for _, c in GELAN_E_ADOWN])
def test_adown_block_matches_jax_at_gelan_e_widths(hw, cin, fused):
    """The port's ADown block (fused: the packed call, N = 256 or 512 with
    a zero tail in the last n-block) against the JAX block."""
    bsz, h, w = hw
    cfg = JB.ADownConfig(cin, cin)
    params, stats = jax.device_get(JB.ADown.init(jax.random.key(cin), cfg))
    stats = _perturb_stats(stats, 1)
    sd = {}
    convert._EMITTERS["ADown"](sd, "", params, stats)
    module = B.ADown(cin, cin)
    module.load_state_dict(sd, strict=True)
    if fused:
        params, stats = jfuse(JB.ADown, cfg, params, stats)
        fuse_model(module.eval())
        assert module.packed
        k, n = adown.packed_sizes(cin // 2, cin // 2)
        assert (k, n) == (cin // 2, {320: 256, 640: 512}[cin])
        assert module.adown_w1.shape == (9 * k * n,)
        w1, w2 = adown.unpack_weights(module.adown_w1, module.adown_w2,
                                      cin // 2, cin // 2)
        assert torch.equal(w1, module.conv_stride.conv.weight)
        assert torch.equal(w2, module.conv_pool.conv.weight)
    x = np.random.default_rng(2).standard_normal((bsz, h, w, cin)) \
        .astype(np.float32)
    ref, _ = JB.ADown.apply(cfg, params, stats, jnp.asarray(x), train=False)
    before = adown.launches
    with torch.no_grad():
        y = module.eval()(_cl(x))
    assert adown.launches == before          # CPU: the plain version ran
    assert y.shape == (bsz, cin, h // 2, w // 2)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=KERNEL_ATOL)


def _direct(x, w1, w2, r):
    """The pre-BN ADown of the JAX package's plain graph, summed against
    the cotangent r."""
    half = x.shape[-1] // 2
    s = javg(x, 2, 1, 0)
    y1 = jconv2d(s[..., :half], w1, stride=2, padding=1)
    y2 = jconv2d(jmax(s[..., half:], 3, 2, 1), w2)
    y = jnp.concatenate([y1, y2], -1)
    return y, (y * r).sum()


@pytest.mark.parametrize("hw,cin", GELAN_E_ADOWN,
                         ids=[f"cin{c}" for _, c in GELAN_E_ADOWN])
def test_adown_train_plain_matches_jax_at_gelan_e_widths(hw, cin):
    """adown_raw and adown_bwd (the train kernels' plain versions) against
    the JAX graph and its gradient, inputs quantized to halves so that
    maxpool ties are common (the gradient goes to the first maximum)."""
    bsz, h, w = hw
    ch = cin // 2
    rng = np.random.default_rng(cin)
    x = (np.round(rng.standard_normal((bsz, h, w, cin)) * 2) / 2) \
        .astype(np.float32)
    w1 = (rng.standard_normal((3, 3, ch, ch)) / np.sqrt(9 * ch)) \
        .astype(np.float32)
    w2 = (rng.standard_normal((1, 1, ch, ch)) / np.sqrt(ch)) \
        .astype(np.float32)
    r = rng.standard_normal((bsz, h // 2, w // 2, cin)).astype(np.float32)
    ref_y, _ = _direct(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                       jnp.asarray(r))
    ref = jax.grad(lambda *a: _direct(*a, jnp.asarray(r))[1],
                   argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w1),
                                      jnp.asarray(w2))
    before = (adown.raw_launches, adown.bwd_launches)
    y = adown.adown_raw(_cl(x), _oihw(w1), _oihw(w2))
    dx, dw1, dw2 = adown.adown_bwd(_cl(x), _cl(r), _oihw(w1), _oihw(w2))
    assert (adown.raw_launches, adown.bwd_launches) == before
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref_y), atol=KERNEL_ATOL)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(ref[0]),
                               atol=KERNEL_ATOL)
    assert _rel_l2(_hwio(dw1), ref[1]) <= WGRAD_REL
    assert _rel_l2(_hwio(dw2), ref[2]) <= WGRAD_REL


@pytest.fixture(scope="module")
def stem80():
    """gelan-e's stem1 (3 -> 80, k3 s2), BN folded, and an input."""
    cfg = JB.ConvConfig(3, 80, 3, 2)
    params, stats = jax.device_get(JB.Conv.init(jax.random.key(5), cfg))
    fp, _ = jfuse(JB.Conv, cfg, params, _perturb_stats(stats, 6))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    g = rng.standard_normal((2, 8, 12, 80)).astype(np.float32)
    return fp, x, g


def test_stem_plain_matches_pallas_stem_at_c80(stem80):
    fp, x, _ = stem80
    ref = jstem_conv(jnp.asarray(x), build_stem_kernel_weights(fp),
                     interpret=True)
    before = stem.launches
    y = stem.stem_conv(_cl(x), _oihw(fp["w"]),
                       torch.from_numpy(np.array(fp["b"], np.float32)))
    assert stem.launches == before
    assert y.shape == (2, 80, 8, 12)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=KERNEL_ATOL)


def test_stem_train_plain_matches_pallas_at_c80(stem80):
    """The raw stem and its weight gradient at C = 80 against the Pallas
    train stem (the cotangent row-paired to 2C = 160 lanes)."""
    fp, x, g = stem80
    w = np.asarray(fp["w"], np.float32)
    planes = to_phase_planes(jnp.asarray(x))
    ref = unpack_rows(stem_conv_packed_raw(
        planes, _pack_w2_jnp(jnp.asarray(w)), wo=12, dtype=jnp.float32,
        interpret=True))
    gp = g.reshape(2, 4, 2, 12, 80).transpose(0, 1, 3, 2, 4) \
        .reshape(2, 4, 12, 160)
    dw2 = np.asarray(stem_wgrad_packed(planes, jnp.asarray(gp),
                                       interpret=True))
    ref_dw = (dw2[:32, :80] + dw2[32:, 80:])[:27].reshape(3, 3, 3, 80)
    before = (stem.raw_launches, stem.wgrad_launches)
    y = stem.stem_conv_raw(_cl(x), _oihw(w))
    dw = stem.stem_wgrad(_cl(x), _cl(g))
    assert (stem.raw_launches, stem.wgrad_launches) == before
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=KERNEL_ATOL)
    assert dw.shape == (80, 3, 3, 3)
    assert _rel_l2(_hwio(dw), ref_dw) <= WGRAD_REL


# ---------------------------------------------------------------------------
# the fused models' kernel sites
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,want", [
    ("gelan-e", {"stem": 1, "adown": 5, "csp_chain": 0, "conv3": 0}),
    ("gelan-c-d2", {"stem": 1, "adown": 5, "csp_chain": 2, "conv3": 10})])
def test_fused_kernel_sites(name, want):
    """The blocks whose fused forward calls a kernel: gelan-e's stem
    (C = 80) and five ADowns alone; gelan-c-d2's stem, five ADowns,
    stage1's two RepNCSPs as chains of n = 2, and ten 64 -> 64 3x3 convs
    (stage1's two block convs and the second conv of each of the eight
    bottlenecks of stage2's and fpn2's RepNCSPs). chip_smoke.py phase 13
    holds the card's launches to these counts."""
    model = YOLO.from_yaml(ROOT / "configs" / "models" / f"{name}.yaml")
    mods = list(model.fuse().modules())
    sites = {
        "stem": sum(isinstance(m, B.Conv) and m.is_stem for m in mods),
        "adown": sum(isinstance(m, B.ADown) and m.packed for m in mods),
        "csp_chain": sum(isinstance(m, B.RepNCSP) and m.chain
                         for m in mods),
        "conv3": sum(isinstance(m, B.Conv) and m.is_conv3 for m in mods)}
    assert sites == want
    chains = [m for m in mods if isinstance(m, B.RepNCSP) and m.chain]
    assert all(len(m.bottlenecks) == 2 for m in chains)
    stem1 = model.layers["stem1"].conv
    assert stem1.out_channels == (80 if name == "gelan-e" else 64)


# ---------------------------------------------------------------------------
# the multiplier path: TINY_YAML's layers at width 1.25, depth 2.0
# ---------------------------------------------------------------------------

def test_multiplier_plan_widths(mult_yaml):
    plan = YOLO.from_yaml(mult_yaml).plan
    kw = {s.name: s.kwargs for s in plan.steps}
    assert kw["stem1"]["out_channels"] == 24
    assert kw["stage1"]["num_repeats"] == 2
    assert (kw["stage2"]["out_channels"], kw["stage2"]["block_channels"]) \
        == (64, 32)
    assert kw["pan2"]["out_channels"] == 80


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_multiplier_decoded_matches_jax(mult_yaml, fused):
    jmodel, model = JYOLO.from_yaml(mult_yaml), YOLO.from_yaml(mult_yaml)
    params, stats = jax.device_get(jmodel.init(jax.random.key(2)))
    model.load_state_dict(convert.state_dict_from_jax(model.plan, params,
                                                      stats), strict=True)
    if fused:
        params, stats = jmodel.fuse(params, stats)
        model.fuse()
    x = synth.make_eval_batch(2, 96, 4)["images"].astype(np.float32) / 255
    ref, _ = jmodel.predict(params, stats, jnp.asarray(x))
    with torch.no_grad():
        dec, _ = model.eval()(_cl(x))
    assert dec.shape == ref.shape == (2, 756, 8)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref),
                               atol=DECODED_ATOL)


def _constant_lr(step):
    return 0.01, 0.01, 0.937


def test_multiplier_train_step_matches_jax(mult_yaml, tmp_path):
    """One f32 Trainer step from the same init and batch: the loss and its
    items within the loss tolerance, the updated parameters (90% or more
    of them moved) within the tolerance tests/test_torch_dual.py holds
    gradients to (measured: 3.7e-7 at most)."""
    jmodel = JYOLO.from_yaml(mult_yaml)
    params, stats = jax.device_get(jmodel.init(jax.random.key(0)))
    b = synth.make_eval_batch(2, 64, 5)
    common = {"epochs": 1, "data_parallel": False,
              "output_dir": str(tmp_path)}
    jt = JTrainer(jmodel, config=JTrainConfig(**common), train_loader=[b],
                  params=params, stats=stats, schedule=_constant_lr)
    tt = Trainer(YOLO.from_yaml(mult_yaml), config=TrainConfig(**common),
                 train_loader=[b], params=params, stats=stats,
                 schedule=_constant_lr, device="cpu")
    images = b["images"].astype(np.float32) / 255
    out = jt._train_step(jt.params, jt.stats, jt.opt_bufs, jt.ema,
                         jnp.asarray(images), jnp.asarray(b["targets"]),
                         np.int32(0))
    jparams, jloss, jitems = out[0], out[4], out[5]
    loss, items, _ = tt.train_step(images, b["targets"])
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    np.testing.assert_allclose(np.asarray(items), np.asarray(jitems),
                               rtol=LOSS_RTOL)
    new, _ = convert.jax_from_state_dict(tt.model.plan,
                                         tt.model.state_dict())
    a = convert.flatten_tree(new)
    b0 = convert.flatten_tree(params)
    ref = {k: v for k, v in convert.flatten_tree(
        jax.device_get(jparams)).items() if v.size}
    moved = [k for k in ref if not np.array_equal(ref[k], b0[k])]
    assert len(moved) > 0.9 * len(ref)
    for k in ref:
        np.testing.assert_allclose(a[k], ref[k], atol=1e-6, rtol=1e-4,
                                   err_msg=k)
