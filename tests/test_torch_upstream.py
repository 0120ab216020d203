"""The port's upstream key maps (yolo_re_tpu_torch/upstream.py) held against
the JAX package's (yolo_re_tpu/convert/torch_import.py) on the CPU.

Synthetic upstream WongKinYiu/yolov9 state dicts of gelan-c and yolov9-c
are built as tests/test_convert.py builds them, by `reference_to_upstream_sd`
on a reference-schema export, here of the full models' parameter
structure from `jax.eval_shape` (no full-size init), filled with seeded
random values. Both packages rename them key for key and value for value
alike; the result loads into the port's model with strict=True. Then the
error cases and the `.pt` containers, and `cli.convert_weights`, whose
`.npz` the JAX package loads to the same predictions as the port's.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.convert import torch_import as J
from yolo_re_tpu.convert.torch_export import export_state_dict
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu_torch import convert, upstream
from yolo_re_tpu_torch.cli import convert_weights
from yolo_re_tpu_torch.data import synth
from yolo_re_tpu_torch.models.yolo import YOLO

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "assets" / "dryrun_tiny.npz"
# f32 decoded output, PARITY.md "Parity" (gelan-c: 3.1e-5)
DECODED_ATOL = 3.1e-5
DETECT_INDEX = {"gelan-c": 22, "yolov9-c": 38}


def _random_like_init(jmodel, seed):
    """A full model's (params, stats) structure from jax.eval_shape, filled
    with seeded random values (variances positive)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    return jax.tree_util.tree_map(
        lambda s: np.abs(rng.standard_normal(s.shape, np.float32)) + 0.5,
        shapes)


@pytest.fixture(scope="module", params=["gelan-c", "yolov9-c"])
def upstream_case(request):
    """(name, JAX params, stats, reference-schema sd, upstream sd)."""
    name = request.param
    jmodel = JYOLO.from_yaml(ROOT / "configs" / "models" / f"{name}.yaml")
    params, stats = _random_like_init(jmodel, len(name))
    ref_sd = export_state_dict(jmodel.plan, params, stats)
    return name, params, stats, ref_sd, J.reference_to_upstream_sd(ref_sd,
                                                                  name)


def _assert_sd_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_layer_maps_equal_jax():
    assert upstream.UPSTREAM_LAYER_MAPS == J.UPSTREAM_LAYER_MAPS
    np.testing.assert_array_equal(upstream.dfl_weight(),
                                  np.arange(16, dtype=np.float32)
                                  .reshape(1, 16, 1, 1))


def test_rewriters_equal_jax(upstream_case):
    """Both directions, key for key and value for value, on numpy values
    and (the port) on torch tensors."""
    name, _, _, ref_sd, up = upstream_case
    assert upstream.is_upstream_state_dict(up)
    assert J.is_upstream_state_dict(up)
    assert not upstream.is_upstream_state_dict(ref_sd)
    _assert_sd_equal(upstream.reference_to_upstream_sd(ref_sd, name), up)
    back = J.upstream_to_reference_sd(up, name)
    _assert_sd_equal(upstream.upstream_to_reference_sd(up, name), back)
    tup = {k: torch.from_numpy(np.asarray(v)) for k, v in up.items()}
    _assert_sd_equal(upstream.upstream_to_reference_sd(tup, name), back)
    assert f"model.{DETECT_INDEX[name]}.dfl.conv.weight" in up
    assert not any(".dfl" in k for k in back)


def test_reference_state_dict_equals_jax_export(upstream_case):
    """upstream.reference_state_dict (cli.export_weights' output) of the
    bridged weights equals the JAX package's export_state_dict key for
    key, value for value and dtype for dtype: gelan-c's one DFL
    projection conv, yolov9-c's two."""
    name, params, stats, ref_sd, _ = upstream_case
    model = YOLO.from_yaml(ROOT / "configs" / "models" / f"{name}.yaml")
    sd = convert.state_dict_from_jax(model.plan, params, stats)
    out = upstream.reference_state_dict(model, sd)
    _assert_sd_equal(out, ref_sd)
    for k, v in ref_sd.items():
        assert out[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
    assert sum(k.endswith("conv.weight") and ".dfl" in k for k in out) == \
        (2 if name == "yolov9-c" else 1)


def test_upstream_loads_into_the_port(upstream_case):
    """port_state_dict on the upstream dict loads with strict=True and
    equals the bridge of the same weights (BN counters apart)."""
    name, params, stats, _, up = upstream_case
    model = YOLO.from_yaml(ROOT / "configs" / "models" / f"{name}.yaml")
    sd = upstream.port_state_dict(up, model, name)
    model.load_state_dict(sd, strict=True)
    ref = convert.state_dict_from_jax(model.plan, params, stats)
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k


# ---------------------------------------------------------------------------
# the error cases and the containers, on gelan-c
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gelan_up():
    jmodel = JYOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    params, stats = _random_like_init(jmodel, 1)
    up = J.reference_to_upstream_sd(
        export_state_dict(jmodel.plan, params, stats), "gelan-c")
    model = YOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    return model, up


def test_unknown_key_strict(gelan_up):
    model, up = gelan_up
    sd = dict(up)
    sd["model.11.mystery.weight"] = np.zeros(4, np.float32)
    for fn in (upstream.upstream_to_reference_sd,
               J.upstream_to_reference_sd):
        with pytest.raises(KeyError, match="model.11.mystery.weight"):
            fn(sd, "gelan-c")
    _assert_sd_equal(
        upstream.upstream_to_reference_sd(sd, "gelan-c", strict=False),
        J.upstream_to_reference_sd(sd, "gelan-c", strict=False))
    with pytest.raises(KeyError, match="model.11.mystery.weight"):
        upstream.port_state_dict(sd, model, "gelan-c")
    model.load_state_dict(upstream.port_state_dict(
        sd, model, "gelan-c", allow_extra=True), strict=True)
    # anchors/strides buffers are dropped, BN counters kept
    sd = dict(up)
    sd["model.22.anchors"] = np.zeros((2, 3), np.float32)
    sd["model.22.strides"] = np.array([8.0, 16.0, 32.0], np.float32)
    sd["model.0.bn.num_batches_tracked"] = np.int64(123)
    out = upstream.upstream_to_reference_sd(sd, "gelan-c")
    _assert_sd_equal(out, J.upstream_to_reference_sd(sd, "gelan-c"))
    assert int(out["layers.stem1.bn.num_batches_tracked"]) == 123
    with pytest.raises(ValueError, match="No upstream layer map"):
        upstream.upstream_to_reference_sd(up, "gelan-e")


def test_nonstandard_dfl_rejected(gelan_up):
    model, up = gelan_up
    sd = dict(up)
    sd["model.22.dfl.conv.weight"] = np.ones((1, 16, 1, 1), np.float32)
    for fn in (upstream.upstream_to_reference_sd,
               J.upstream_to_reference_sd):
        with pytest.raises(ValueError, match="DFL"):
            fn(sd, "gelan-c")
    # a reference-schema dict's DFL projection is checked too
    ref = upstream.upstream_to_reference_sd(up, "gelan-c")
    ref["layers.detect.dfl.conv.weight"] = np.ones((1, 16, 1, 1),
                                                   np.float32)
    with pytest.raises(ValueError, match="DFL"):
        upstream.port_state_dict(ref, model)


def test_fused_repconv_fails_with_named_key(gelan_up):
    """An inference-fused RepConvN (one conv + bias in place of the
    conv1/conv2 branches) fails naming the missing branch key."""
    model, up = gelan_up
    drop = ("model.2.cv2.0.m.0.cv1.conv1.", "model.2.cv2.0.m.0.cv1.conv2.")
    sd = {k: v for k, v in up.items() if not k.startswith(drop)}
    w = up["model.2.cv2.0.m.0.cv1.conv1.conv.weight"]
    sd["model.2.cv2.0.m.0.cv1.conv.weight"] = w
    sd["model.2.cv2.0.m.0.cv1.conv.bias"] = np.zeros(w.shape[0], np.float32)
    with pytest.raises(KeyError, match="conv1"):
        upstream.port_state_dict(sd, model, "gelan-c")
    with pytest.raises(KeyError, match="conv1"):
        J.convert_state_dict(JYOLO.from_yaml(
            ROOT / "configs" / "models" / "gelan-c.yaml").plan,
            J.upstream_to_reference_sd(sd, "gelan-c"))


def test_checkpoint_containers_equal_jax(gelan_up, tmp_path):
    """EMA containers give the EMA weights (not the zeroed decoy model);
    fp16 checkpoints are widened to f32, integer counters kept; the port's
    loader equals the JAX package's value for value."""
    model, up = gelan_up
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in up.items()}
    t["model.0.bn.num_batches_tracked"] = torch.tensor(7)
    decoy = {k: torch.zeros_like(v) for k, v in t.items()}
    torch.save({"model": decoy, "ema": t, "epoch": 3}, tmp_path / "ema.pt")
    half = {k: v.half() if v.is_floating_point() else v for k, v in t.items()}
    torch.save({"model": half}, tmp_path / "half.pt")
    torch.save(t, tmp_path / "bare.pt")
    for name in ("ema", "half", "bare"):
        path = str(tmp_path / f"{name}.pt")
        mine, ref = upstream.load_torch_checkpoint(path), \
            J.load_torch_checkpoint(path)
        assert mine.keys() == ref.keys()
        for k in ref:
            assert mine[k].numpy().dtype == ref[k].dtype, k
            np.testing.assert_array_equal(mine[k].numpy(), ref[k],
                                          err_msg=k)
        assert mine["model.0.bn.num_batches_tracked"].dtype == torch.int64
        assert all(v.dtype != torch.float16 for v in mine.values())
        model.load_state_dict(upstream.port_state_dict(mine, model,
                                                       "gelan-c"),
                              strict=True)
    w = upstream.load_torch_checkpoint(str(tmp_path / "half.pt"))
    np.testing.assert_array_equal(
        w["model.0.conv.weight"].numpy(),
        t["model.0.conv.weight"].half().float().numpy())


# ---------------------------------------------------------------------------
# cli.convert_weights: an .npz both packages read
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_as_gelan_c(tmp_path_factory):
    """TINY_YAML in a file named gelan-c.yaml: its layers are a subset of
    gelan-c's, by name, so gelan-c's upstream layer map places them."""
    p = tmp_path_factory.mktemp("cfg") / "gelan-c.yaml"
    p.write_text(synth.TINY_YAML)
    return str(p)


def _fixture_sd(config: str) -> dict:
    model = YOLO.from_yaml(config)
    return convert.state_dict_from_jax(model.plan,
                                       *convert.load_weights(FIXTURE))


@pytest.mark.parametrize("schema", ["upstream", "reference"])
def test_convert_weights_npz_loads_in_both_packages(tiny_as_gelan_c,
                                                    tmp_path, schema,
                                                    capsys):
    """The trained tiny fixture as a `.pt` (upstream schema in an EMA
    container, or the reference schema with its DFL projection) -> the
    CLI's .npz: equal to the fixture's weights, and JAX's `load_params`
    of it predicts what the port's forward on `convert.load_weights` of
    it does."""
    sd = _fixture_sd(tiny_as_gelan_c)
    if schema == "upstream":
        obj = {"ema": upstream.reference_to_upstream_sd(sd, "gelan-c"),
               "model": None}
    else:
        obj = dict(sd)
        obj["layers.detect.dfl.conv.weight"] = torch.from_numpy(
            upstream.dfl_weight())
    torch.save(obj, tmp_path / "w.pt")
    out = tmp_path / "w.npz"
    convert_weights.main(["--weights", str(tmp_path / "w.pt"), "--config",
                          tiny_as_gelan_c, "--output", str(out)])
    assert ("upstream yolov9 schema detected" in capsys.readouterr().out) \
        == (schema == "upstream")
    params, stats = convert.load_weights(out)
    fparams, fstats = convert.load_weights(FIXTURE)
    for mine, ref in ((params, fparams), (stats, fstats)):
        a, b = convert.flatten_tree(mine), convert.flatten_tree(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jparams, jstats = J.load_params(str(out))
    jmodel, model = JYOLO.from_yaml(tiny_as_gelan_c), \
        YOLO.from_yaml(tiny_as_gelan_c)
    model.load_state_dict(convert.state_dict_from_jax(model.plan, params,
                                                      stats), strict=True)
    x = synth.make_eval_batch(2, 160, 3)["images"].astype(np.float32) / 255
    ref, _ = jmodel.predict(jparams, jstats, jnp.asarray(x))
    with torch.no_grad():
        dec, _ = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    # class scores at PARITY.md's bound; the trained head's box
    # coordinates at tests/test_torch_model.py's trained-fixture bound
    np.testing.assert_allclose(dec[..., 4:].numpy(), np.asarray(ref)[..., 4:],
                               atol=DECODED_ATOL)
    np.testing.assert_allclose(dec[..., :4].numpy(), np.asarray(ref)[..., :4],
                               atol=1e-3)


def test_convert_weights_refuses_unconsumed_keys(tiny_as_gelan_c, tmp_path):
    sd = _fixture_sd(tiny_as_gelan_c)
    sd["layers.stage1.extra.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "w.pt")
    argv = ["--weights", str(tmp_path / "w.pt"), "--config",
            tiny_as_gelan_c, "--output", str(tmp_path / "w.npz")]
    with pytest.raises(SystemExit, match="layers.stage1.extra.weight"):
        convert_weights.main(argv)
    assert not (tmp_path / "w.npz").exists()
    convert_weights.main(argv + ["--allow-extra"])
    assert (tmp_path / "w.npz").exists()


def test_scale_boxes_equals_the_jax_cli():
    """cli.detect's scale_boxes against scripts/detect.py's."""
    from yolo_re_tpu_torch.cli.detect import scale_boxes

    spec = importlib.util.spec_from_file_location(
        "jax_detect_cli", ROOT / "scripts" / "detect.py")
    jdetect = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdetect)
    boxes = np.random.default_rng(0).uniform(-20, 700, (50, 4)) \
        .astype(np.float32)
    for to_shape in ((480, 640), (720, 1280), (640, 480), (100, 900)):
        np.testing.assert_array_equal(
            scale_boxes(boxes, (640, 640), to_shape),
            jdetect.scale_boxes(boxes, (640, 640), to_shape))
