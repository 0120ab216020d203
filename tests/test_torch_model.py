"""The PyTorch port's model stack held against the JAX package on the CPU:
copied modules, the weight bridge, every ported block (unfused and fused)
and the whole model's decoded output. Inputs come from numpy seeds and are
handed to both packages; weights pass from JAX's init through
yolo_re_tpu_torch.convert.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_re_tpu.convert.torch_export import export_state_dict
from yolo_re_tpu.data import synth as jsynth
from yolo_re_tpu.models import blocks as JB
from yolo_re_tpu.models.config import parse_yaml as jparse_yaml
from yolo_re_tpu.models.fuse import _fuse as jfuse
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.train.checkpoint import load_weights as jload_weights
from yolo_re_tpu_torch import convert
from yolo_re_tpu_torch.data import synth
from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.config import parse_yaml
from yolo_re_tpu_torch.models.fuse import fuse_model
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.kernels import adown as adown_kernel

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs" / "models").glob("*.yaml"))
FIXTURE = ROOT / "assets" / "dryrun_tiny.npz"
# JAX-package tolerance for one block, f32 (tests/test_blocks.py:208)
BLOCK_ATOL = 2e-5
# f32 decoded output, PARITY.md "Parity" (gelan-c: 3.1e-5)
DECODED_ATOL = 3.1e-5


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    p.write_text(synth.TINY_YAML)
    return str(p)


@pytest.fixture(scope="module")
def tiny_dual_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny_dual.yaml"
    p.write_text(synth.TINY_DUAL_YAML)
    return str(p)


def _config_path(name, tiny_yaml, tiny_dual_yaml):
    return {"TINY_YAML": tiny_yaml, "TINY_DUAL_YAML": tiny_dual_yaml}.get(
        name, ROOT / "configs" / "models" / f"{name}.yaml")


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def _perturb_stats(stats, seed):
    """Non-trivial BN running stats, so BN and its folding are exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: np.asarray(s) + rng.uniform(0, 0.3, np.shape(s))
        .astype(np.float32), stats)


# ---------------------------------------------------------------------------
# package boundary and copied modules
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import yolo_re_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'yolo_re_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().splitlines()
    assert int(n_mods) >= 15
    assert bad == "[]"


@pytest.mark.parametrize("name", [p.stem for p in CONFIGS] + ["TINY_YAML"])
def test_parse_yaml_copy_matches_jax(name, tiny_yaml):
    path = tiny_yaml if name == "TINY_YAML" else \
        ROOT / "configs" / "models" / f"{name}.yaml"
    assert parse_yaml(path).__dict__ == jparse_yaml(path).__dict__


def test_make_eval_batch_copy_is_bit_equal():
    assert synth.TINY_YAML == jsynth.TINY_YAML
    assert synth.TINY_DUAL_YAML == jsynth.TINY_DUAL_YAML
    for seed in (0, 7):
        a = synth.make_eval_batch(3, 96, seed)
        b = jsynth.make_eval_batch(3, 96, seed)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# plan and weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gelan-c", "TINY_YAML", "yolov9-c",
                                  "TINY_DUAL_YAML"])
def test_plan_matches_jax(name, tiny_yaml, tiny_dual_yaml):
    path = _config_path(name, tiny_yaml, tiny_dual_yaml)
    tp, jp = YOLO.from_yaml(path).plan, JYOLO.from_yaml(path).plan
    assert tp.strides == jp.strides
    assert tp.detect_name == jp.detect_name
    assert tp.detect_inputs == jp.detect_inputs
    assert len(tp.steps) == len(jp.steps)
    for ts, js in zip(tp.steps, jp.steps):
        assert (ts.name, ts.type, ts.inputs, ts.scale) == \
            (js.name, js.type, js.inputs, js.scale)
        for field, value in ts.kwargs.items():
            assert getattr(js.cfg, field) == value, (ts.name, field)


def _zeros_like_init(jmodel):
    """A full model's (params, stats) STRUCTURE as numpy zeros: jax.eval_shape
    runs no init, so the full model costs nothing on the CPU."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("name", ["gelan-c", "TINY_YAML", "yolov9-c",
                                  "TINY_DUAL_YAML"])
def test_state_dict_bridge_matches_export(name, tiny_yaml, tiny_dual_yaml):
    """state_dict_from_jax == export_state_dict key by key and value by
    value, apart from num_batches_tracked and the derived DFL convs (the
    dual head's `dfl` and `dfl2`: fixed projections that neither package
    stores)."""
    path = _config_path(name, tiny_yaml, tiny_dual_yaml)
    jmodel, model = JYOLO.from_yaml(path), YOLO.from_yaml(path)
    if not name.startswith("TINY"):
        params, stats = _zeros_like_init(jmodel)
    else:
        params, stats = jax.device_get(jmodel.init(jax.random.key(3)))
        stats = _perturb_stats(stats, 4)
    ref = export_state_dict(jmodel.plan, params, stats)
    sd = convert.state_dict_from_jax(model.plan, params, stats)
    skip = {k for k in ref if k.endswith("num_batches_tracked")
            or ".dfl." in k or ".dfl2." in k}
    assert set(ref) - skip == {k for k in sd
                               if not k.endswith("num_batches_tracked")}
    for k in set(ref) - skip:
        assert sd[k].dtype == torch.float32, k
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    model.load_state_dict(sd, strict=True)


def test_load_weights_matches_jax(tmp_path):
    params, stats = convert.load_weights(FIXTURE)
    jparams, jstats = jload_weights(FIXTURE)
    for mine, ref in ((params, jparams), (stats, jstats)):
        a = convert.flatten_tree(mine)
        b = convert.flatten_tree(jax.device_get(ref))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # a training checkpoint: the EMA weights win over the raw ones
    flat = {f"ema_params/{k}": v for k, v in
            convert.flatten_tree(params).items()}
    flat.update({f"ema_stats/{k}": v for k, v in
                 convert.flatten_tree(stats).items()})
    flat.update({f"params/{k}": np.zeros_like(v) for k, v in
                 convert.flatten_tree(params).items()})
    ckpt = tmp_path / "ckpt.npz"
    np.savez(ckpt, **flat)
    ema_params, _ = convert.load_weights(ckpt)
    np.testing.assert_array_equal(ema_params["stem1"]["w"],
                                  params["stem1"]["w"])
    with pytest.raises(ValueError, match="neither"):
        np.savez(tmp_path / "bad.npz", x=np.zeros(1))
        convert.load_weights(tmp_path / "bad.npz")


# ---------------------------------------------------------------------------
# blocks, unfused and fused, against B.<Block>.apply
# ---------------------------------------------------------------------------

def _emit_repnbottleneck(out, p, params, stats):
    convert._repconv(out, p + "conv1.", params["conv1"], stats["conv1"])
    convert._conv(out, p + "conv2.", params["conv2"], stats["conv2"])


_BLOCK_CASES = {
    # name: (JAX config, port module, state emitter, input NHWC shape)
    "Conv": (JB.ConvConfig(16, 24, 3, 2), lambda: B.Conv(16, 24, 3, 2),
             convert._conv, (2, 9, 12, 16)),
    "Conv_stem": (JB.ConvConfig(3, 16, 3, 2), lambda: B.Conv(3, 16, 3, 2),
                  convert._conv, (2, 17, 20, 3)),
    "RepConv": (JB.RepConvConfig(16, 24), lambda: B.RepConv(16, 24),
                convert._repconv, (2, 8, 8, 16)),
    "RepNBottleneck": (JB.RepNBottleneckConfig(16, 16),
                       lambda: B.RepNBottleneck(16, 16),
                       _emit_repnbottleneck, (2, 8, 8, 16)),
    "RepNCSP": (JB.RepNCSPConfig(16, 24, 2), lambda: B.RepNCSP(16, 24, 2),
                convert._repncsp, (2, 8, 8, 16)),
    "RepNCSPELAN4": (JB.RepNCSPELAN4Config(24, 32, 32, 16, 1),
                     lambda: B.RepNCSPELAN4(24, 32, 32, 16, 1),
                     convert._elan, (2, 8, 12, 24)),
    "SPPELAN": (JB.SPPELANConfig(32, 32, 16), lambda: B.SPPELAN(32, 32, 16),
                convert._EMITTERS["SPPELAN"], (2, 10, 10, 32)),
    "ADown": (JB.ADownConfig(32, 48), lambda: B.ADown(32, 48),
              convert._EMITTERS["ADown"], (2, 10, 14, 32)),
    "ADown_odd": (JB.ADownConfig(48, 48), lambda: B.ADown(48, 48),
                  convert._EMITTERS["ADown"], (1, 9, 7, 48)),
}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", sorted(_BLOCK_CASES))
def test_block_matches_jax(name, fused):
    cfg, make, emit, shape = _BLOCK_CASES[name]
    jblock = JB.get_block_class(name.split("_")[0])
    params, stats = jax.device_get(jblock.init(jax.random.key(1), cfg))
    stats = _perturb_stats(stats, 2)
    sd = {}
    emit(sd, "", params, stats)
    module = make()
    module.load_state_dict(sd, strict=True)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    if fused:
        params, stats = jfuse(jblock, cfg, params, stats)
        fuse_model(module)
    ref, _ = jblock.apply(cfg, params, stats, jnp.asarray(x), train=False)
    with torch.no_grad():
        y = module.eval()(_nchw(x))
    assert y.shape == _nchw(np.asarray(ref)).shape
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=BLOCK_ATOL)


@pytest.mark.parametrize("cin,cout,shape", [(32, 32, (2, 10, 14)),
                                            (48, 48, (1, 9, 7)),
                                            (256, 256, (1, 8, 12))])
def test_fused_adown_packs_weights_as_buffers(cin, cout, shape):
    """A fused ADown (TINY_YAML's widths and gelan-c's 256) carries both
    weights packed once, in non-persistent buffers: its state dict is
    the fused convs' alone, the buffers are the packing of the fused
    weights and follow `.to()`, and its forward (the packed call) still
    matches the JAX package's fused block."""
    cfg = JB.ADownConfig(cin, cout)
    params, stats = jax.device_get(JB.ADown.init(jax.random.key(4), cfg))
    stats = _perturb_stats(stats, 5)
    sd = {}
    convert._EMITTERS["ADown"](sd, "", params, stats)
    module = B.ADown(cin, cout)
    module.load_state_dict(sd, strict=True)
    fuse_model(module.eval())
    assert module.packed
    cs, cp = module.conv_stride.conv, module.conv_pool.conv
    assert set(module.state_dict()) == {
        "conv_stride.conv.weight", "conv_stride.conv.bias",
        "conv_pool.conv.weight", "conv_pool.conv.bias"}
    w1p, w2p = adown_kernel.pack_weights(cs.weight.detach(),
                                         cp.weight.detach())
    assert torch.equal(module.adown_w1, w1p)
    assert torch.equal(module.adown_w2, w2p)
    x = np.random.default_rng(6).standard_normal((*shape, cin)) \
        .astype(np.float32)
    fp, fs = jfuse(JB.ADown, cfg, params, stats)
    ref, _ = JB.ADown.apply(cfg, fp, fs, jnp.asarray(x), train=False)
    launches = adown_kernel.launches
    with torch.no_grad():
        y = module(_nchw(x))
    assert adown_kernel.launches == launches      # CPU: the plain version
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=BLOCK_ATOL)
    module.to(torch.bfloat16)
    assert module.adown_w1.dtype == module.adown_w2.dtype == torch.bfloat16
    assert torch.equal(module.adown_w1, adown_kernel.pack_weights(
        cs.weight.detach(), cp.weight.detach())[0])


@pytest.mark.parametrize("kind", ["Concat", "Upsample"])
def test_parameter_free_blocks_match_jax(kind):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    b = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    if kind == "Concat":
        ref, _ = JB.Concat.apply(JB.ConcatConfig(), {}, {},
                                 [jnp.asarray(a), jnp.asarray(b)])
        y = B.Concat()([_nchw(a), _nchw(b)])
    else:
        ref, _ = JB.Upsample.apply(JB.UpsampleConfig(2), {}, {},
                                   jnp.asarray(a))
        y = B.Upsample(2)(_nchw(a))
    np.testing.assert_array_equal(_nhwc(y), np.asarray(ref))


# ---------------------------------------------------------------------------
# the whole model: decoded (B, A, 4+nc)
# ---------------------------------------------------------------------------

def _decoded_pair(tiny_yaml, params, stats, x, fused):
    jmodel, model = JYOLO.from_yaml(tiny_yaml), YOLO.from_yaml(tiny_yaml)
    model.load_state_dict(convert.state_dict_from_jax(model.plan, params,
                                                      stats), strict=True)
    if fused:
        params, stats = jmodel.fuse(params, stats)
        model.fuse()
    ref, _ = jmodel.predict(params, stats, jnp.asarray(x))
    with torch.no_grad():
        dec, raw = model(_nchw(x))
    assert len(raw) == 3 and raw[0].shape[1] == 64 + model.num_classes
    return dec.numpy(), np.asarray(ref)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_decoded_matches_jax_random_init(tiny_yaml, fused):
    jmodel = JYOLO.from_yaml(tiny_yaml)
    params, stats = jax.device_get(jmodel.init(jax.random.key(0)))
    x = synth.make_eval_batch(2, 160, 1)["images"].astype(np.float32) / 255
    dec, ref = _decoded_pair(tiny_yaml, params, stats, x, fused)
    assert dec.shape == ref.shape == (2, 2100, 8)
    np.testing.assert_allclose(dec, ref, atol=DECODED_ATOL)


def test_decoded_matches_jax_trained_fixture(tiny_yaml):
    params, stats = convert.load_weights(FIXTURE)
    x = synth.make_eval_batch(2, 160, 2)["images"].astype(np.float32) / 255
    dec, ref = _decoded_pair(tiny_yaml, params, stats, x, fused=False)
    # class scores hold the PARITY.md bound
    np.testing.assert_allclose(dec[..., 4:], ref[..., 4:], atol=DECODED_ATOL)
    # Box coordinates: measured 4.3e-4 px. The backbone agrees to ~1e-6
    # relative (2.4e-5 absolute at pan2), but the trained head's box
    # logits are sharp, and the DFL expectation over 16 bins magnifies
    # logit rounding into the pixel-scaled coordinates; at random init
    # (test above) the same path holds 3.1e-5.
    np.testing.assert_allclose(dec[..., :4], ref[..., :4], atol=1e-3)


def test_init_parameters_matches_jax_distributions():
    """Same init distributions as the JAX package (not the same numbers)."""
    model = YOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    model.init_parameters(torch.Generator().manual_seed(0))
    w = model.layers["stem2"].conv.weight.detach()
    bound = 1 / np.sqrt(9 * 64)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    det = model.layers["detect"]
    assert torch.all(det.box_convs[0][2].bias == 1.0)
    np.testing.assert_allclose(float(det.cls_convs[2][2].bias[0]),
                               np.log(5 / 80 / (640 / 32) ** 2), rtol=1e-6)
    assert torch.all(model.layers["stage1"].conv_in.bn.running_var == 1.0)
    n = sum(p.numel() for p in model.parameters())
    jmodel = JYOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))[0]
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))


def test_forward_refuses_train_mode(tiny_yaml):
    """Train mode runs the unfused model (tests/test_torch_train.py); a
    fused model has no BN left to train and refuses it."""
    model = YOLO.from_yaml(tiny_yaml).fuse().train()
    with pytest.raises(RuntimeError, match="eval"):
        model(torch.zeros(1, 3, 32, 32))
