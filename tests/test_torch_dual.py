"""yolov9-c's modules in the port held against the JAX package on the CPU:
Silence, CBLinear, CBFuse (at sizes that do not divide), the dual head in
train and eval mode, TINY_DUAL_YAML's decoded aux and main outputs
(unfused and fused) and its main-only forward, the dual TAL loss, four
Trainer steps against the JAX Trainer with checkpoints read both ways, and
the Detector and Evaluator on the dual model. Inputs come from numpy seeds
and are handed to both packages; weights pass from JAX's init through
yolo_re_tpu_torch.convert. JAX's full yolov9-c runs nowhere here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_re_tpu.eval.evaluator import Evaluator as JEvaluator
from yolo_re_tpu.loss.tal import TALoss as JTALoss
from yolo_re_tpu.models import blocks as JB
from yolo_re_tpu.models.heads import DualDetectDFL as JDual
from yolo_re_tpu.models.heads import DualDetectDFLConfig
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.models.yolo import param_labels as jparam_labels
from yolo_re_tpu.ops.conv import interpolate_nearest as jinterpolate
from yolo_re_tpu.serving import Detector as JDetector
from yolo_re_tpu.train import checkpoint as jckpt
from yolo_re_tpu.train.config import TrainConfig as JTrainConfig
from yolo_re_tpu.train.trainer import Trainer as JTrainer
from yolo_re_tpu_torch import convert
from yolo_re_tpu_torch.data.synth import TINY_DUAL_YAML, make_eval_batch
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.loss.tal import TALoss
from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.fuse import fuse_model
from yolo_re_tpu_torch.models.heads import DualDetectDFL
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.conv import interpolate_nearest
from yolo_re_tpu_torch.serving import Detector, inference_model
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

# JAX-package tolerance for one block, f32 (tests/test_blocks.py:208)
BLOCK_ATOL = 2e-5
# f32 decoded output, PARITY.md "Parity" (yolov9-c: aux 6.1e-5, main
# 3.1e-5, at 640 px, where boxes stay below 1024 px and one f32 ulp is at
# most 6.1e-5). Random-init boxes reach ~480 px, and the DFL expectation
# over 16 bins turns a 1e-7 logit rounding into a few ulps of them
# (TINY_DUAL_YAML's boxes, aux and main: 9.2e-5 at ~480 px, 3 ulps), so
# boxes may also sit 4 ulps (2^-22 of |ref|) apart
DECODED_ATOL, DECODED_RTOL = 6.1e-5, 2.0 ** -22
# loss items, PARITY.md "Loss / assignment" (~3e-6 relative)
LOSS_RTOL = 1e-5
# post-NMS boxes and scores (tests/test_torch_serving.py)
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def dual_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny_dual.yaml"
    p.write_text(TINY_DUAL_YAML)
    return str(p)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _perturb_stats(stats, seed):
    """Non-trivial BN running stats, so BN and its folding are exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: np.asarray(s) + rng.uniform(0, 0.3, np.shape(s))
        .astype(np.float32), stats)


def _zero_class_biases(params):
    """Class biases 0 instead of the prior's: random weights then score
    near 0.5, so NMS keeps full candidate sets."""
    for branch in ("aux", "main"):
        for tower in params["detect"][branch]:
            tower["cls"][2]["b"] = np.zeros_like(tower["cls"][2]["b"])
    return params


def _unit_scale_stats(tree, rng):
    """BN running statistics at the scale the init's convs give: a
    U(-1/sqrt(fan_in), +) conv divides its input's variance by 3, so
    var ~ U(0.25, 0.4) (mean ~ U(-0.1, 0.1)) keeps the activations at unit
    scale through the depth. With the init's (0, 1) they shrink layer by
    layer until the head's outputs are its biases and the scores tie to
    1e-7, where NMS's picks between the packages are a coin toss."""
    if isinstance(tree, list):
        return [_unit_scale_stats(v, rng) for v in tree]
    if "var" in tree:
        return {"mean": rng.uniform(-0.1, 0.1, np.shape(tree["mean"]))
                .astype(np.float32),
                "var": rng.uniform(0.25, 0.4, np.shape(tree["var"]))
                .astype(np.float32)}
    return {k: _unit_scale_stats(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def dual_weights(dual_yaml):
    """TINY_DUAL_YAML's JAX init (seed 0) with unit-scale BN statistics."""
    params, stats = jax.device_get(
        JYOLO.from_yaml(dual_yaml).init(jax.random.key(0)))
    return params, _unit_scale_stats(stats, np.random.default_rng(1))


# ---------------------------------------------------------------------------
# Silence, CBLinear, CBFuse
# ---------------------------------------------------------------------------

def _tuple_nhwc(y) -> list[np.ndarray]:
    return [_nhwc(t) for t in y] if isinstance(y, tuple) else [_nhwc(y)]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_interpolate_nearest_matches_jax():
    """The source index floor(dst * in / out) in float64, at every pair of
    sizes up to 12 (most do not divide), equal bit for bit."""
    x = _rand(np.random.default_rng(0), 1, 12, 12, 2)
    for h in range(1, 13):
        for out in range(1, 13):
            xs = x[:, :h, :h]
            ref = jinterpolate(xs, out, out + 1)      # numpy in, numpy out
            y = interpolate_nearest(_nchw(xs), out, out + 1)
            np.testing.assert_array_equal(_nhwc(y), ref, err_msg=(h, out))


_DUAL_BLOCKS = {
    # name: (JAX config, port module, inputs from an rng)
    "Silence": (JB.SilenceConfig(), B.Silence,
                lambda rng: _rand(rng, 2, 5, 6, 8)),
    "CBLinear": (JB.CBLinearConfig(16, (8, 12, 20)),
                 lambda: B.CBLinear(16, (8, 12, 20)),
                 lambda rng: _rand(rng, 2, 9, 11, 16)),
    "CBLinear_k3s2": (JB.CBLinearConfig(16, (8, 24), 3, 2),
                      lambda: B.CBLinear(16, (8, 24), 3, 2),
                      lambda rng: _rand(rng, 2, 9, 11, 16)),
    # sizes that do not divide: 3 -> 7 and 8 -> 5 rows, 3 -> 5 and 8 -> 6
    # columns; the second tuple's entry 0, the first's entry 1
    "CBFuse": (JB.CBFuseConfig((1, 0)), lambda: B.CBFuse((1, 0)),
               lambda rng: [(_rand(rng, 2, 3, 3, 6), _rand(rng, 2, 3, 3, 6)),
                            (_rand(rng, 2, 8, 8, 6),),
                            _rand(rng, 2, 7, 5, 6)]),
    "CBFuse_down": (JB.CBFuseConfig((0,)), lambda: B.CBFuse((0,)),
                    lambda rng: [(_rand(rng, 1, 8, 8, 4),),
                                 _rand(rng, 1, 5, 6, 4)]),
}


def _to_torch(x):
    if isinstance(x, list):
        return [_to_torch(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_to_torch(v) for v in x)
    return _nchw(x)


def _to_jax(x):
    if isinstance(x, list):
        return [_to_jax(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_to_jax(v) for v in x)
    return jnp.asarray(x)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", sorted(_DUAL_BLOCKS))
def test_dual_block_matches_jax(name, fused):
    """Each block against B.<Block>.apply; `fuse()` leaves all three alone
    (yolo_re_tpu/models/fuse.py:52)."""
    cfg, make, inputs = _DUAL_BLOCKS[name]
    jblock = JB.get_block_class(name.split("_")[0])
    params, stats = jax.device_get(jblock.init(jax.random.key(2), cfg))
    module = make()
    sd = {}
    if name.startswith("CBLinear"):
        convert._cblinear(sd, "", params, stats)
    module.load_state_dict(sd, strict=True)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    if fused:
        fuse_model(module)
        assert module.state_dict().keys() == before.keys()
        assert all(torch.equal(v, before[k])
                   for k, v in module.state_dict().items())
    x = inputs(np.random.default_rng(3))
    ref, _ = jblock.apply(cfg, params, stats, _to_jax(x), train=False)
    with torch.no_grad():
        y = module.eval()(_to_torch(x))
    got, want = _tuple_nhwc(y), [np.asarray(r) for r in
                                 (ref if isinstance(ref, tuple) else (ref,))]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=BLOCK_ATOL)


# ---------------------------------------------------------------------------
# the dual head
# ---------------------------------------------------------------------------

_HEAD_CFG = DualDetectDFLConfig(8, (48, 48, 64, 32, 48, 64), (8, 16, 32))


def _head_pair():
    params, stats = jax.device_get(JDual.init(jax.random.key(4), _HEAD_CFG))
    stats = _perturb_stats(stats, 5)
    head = DualDetectDFL(_HEAD_CFG.num_classes, _HEAD_CFG.in_channels,
                         _HEAD_CFG.strides)
    sd = {}
    convert._dual_detect(sd, "", params, stats)
    head.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(6)
    feats = [_rand(rng, 2, int(64 // s), int(64 // s), c) for s, c in
             zip(_HEAD_CFG.strides * 2, _HEAD_CFG.in_channels)]
    return params, stats, head, feats


def test_dual_head_train_matches_jax():
    params, stats, head, feats = _head_pair()
    ref, _ = JDual.apply(_HEAD_CFG, params, stats,
                         [jnp.asarray(f) for f in feats], train=True)
    out = head.train()([_nchw(f) for f in feats])
    assert out.keys() == ref.keys() == {"aux", "main"}
    for k in ("aux", "main"):
        for (yb, yc), (rb, rc) in zip(out[k], ref[k], strict=True):
            np.testing.assert_allclose(_nhwc(yb), np.asarray(rb),
                                       atol=BLOCK_ATOL)
            np.testing.assert_allclose(_nhwc(yc), np.asarray(rc),
                                       atol=BLOCK_ATOL)


def test_dual_head_eval_matches_jax():
    """Decoded and raw, aux and main; the main-only call equals the full
    call's "main" bit for bit."""
    params, stats, head, feats = _head_pair()
    (dec_ref, raw_ref), _ = JDual.apply(_HEAD_CFG, params, stats,
                                        [jnp.asarray(f) for f in feats])
    head.eval()
    with torch.no_grad():
        dec, raw = head([_nchw(f) for f in feats])
        dec_m, raw_m = head([_nchw(f) for f in feats[3:]], main_only=True)
    for k in ("aux", "main"):
        assert dec[k].shape == (2, 84, 4 + 8)
        np.testing.assert_allclose(dec[k].numpy(), np.asarray(dec_ref[k]),
                                   atol=DECODED_ATOL, rtol=DECODED_RTOL)
        for r, rr in zip(raw[k], raw_ref[k], strict=True):
            np.testing.assert_allclose(_nhwc(r), np.asarray(rr),
                                       atol=BLOCK_ATOL)
    assert torch.equal(dec_m, dec["main"])
    assert all(torch.equal(a, b) for a, b in zip(raw_m, raw["main"],
                                                 strict=True))
    with pytest.raises(ValueError, match="eval"):
        head.train()(feats[3:], main_only=True)


def test_dual_head_bias_init_matches_jax():
    """Both tower sets get the bias init: box 1.0, cls log(5 / nc /
    (640 / stride)^2), equal to JAX's init."""
    params, _ = jax.device_get(JDual.init(jax.random.key(4), _HEAD_CFG))
    head = DualDetectDFL(_HEAD_CFG.num_classes, _HEAD_CFG.in_channels,
                         _HEAD_CFG.strides)
    head.init_bias()
    for branch in ("aux", "main"):
        box = getattr(head, f"{branch}_box_convs")
        cls = getattr(head, f"{branch}_cls_convs")
        for i, tower in enumerate(params[branch]):
            for seq, kind in ((box, "box"), (cls, "cls")):
                np.testing.assert_array_equal(
                    seq[i][2].bias.detach().numpy(), tower[kind][2]["b"])


# ---------------------------------------------------------------------------
# the whole model: parameters, decoded aux and main, the main-only forward
# ---------------------------------------------------------------------------

def test_yolov9c_parameter_count_matches_jax():
    model = YOLO.from_yaml("configs/models/yolov9-c.yaml")
    shapes = jax.eval_shape(JYOLO.from_yaml(
        "configs/models/yolov9-c.yaml").init, jax.random.key(0))[0]
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    main = {s.name for s in model.main_steps}
    assert "stem1" in main and "detect" in main
    assert not {n for n in main if n.startswith(("aux_", "cb_"))}


def test_param_labels_match_jax_groups_dual(dual_yaml):
    """CBLinear's biased conv and both tower sets fall in the JAX
    package's optimizer groups (yolo_re_tpu/models/yolo.py:25-40)."""
    model = YOLO.from_yaml(dual_yaml)
    labels = model.param_labels()
    shapes = jax.eval_shape(JYOLO.from_yaml(dual_yaml).init,
                            jax.random.key(0))[0]
    jlabels = jax.tree_util.tree_leaves(jparam_labels(shapes))
    jsizes = [int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)]
    params = dict(model.named_parameters())
    assert labels["layers.cb_route1.conv.weight"] == "weight"
    assert labels["layers.cb_route1.conv.bias"] == "bias"
    for group in ("weight", "bn", "bias"):
        assert sum(params[k].numel() for k, v in labels.items()
                   if v == group) == \
            sum(n for n, lab in zip(jsizes, jlabels) if lab == group)


def test_bridge_round_trips_exactly(dual_yaml, dual_weights):
    """state dict -> JAX pytrees -> state dict, equal bit for bit, with the
    JAX init's tree structure."""
    params, stats = dual_weights
    model = YOLO.from_yaml(dual_yaml)
    sd = convert.state_dict_from_jax(model.plan, params, stats)
    model.load_state_dict(sd, strict=True)
    back = convert.jax_from_state_dict(model.plan, model.state_dict())
    for mine, ref in zip(back, (params, stats)):
        a, b = convert.flatten_tree(mine), convert.flatten_tree(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dual_decoded_matches_jax(dual_yaml, dual_weights, fused):
    """TINY_DUAL_YAML at 128 px: decoded aux and main against
    JYOLO.predict, and the main-only forward equal to the full forward's
    main, decoded and raw, bit for bit."""
    params, stats = dual_weights
    jmodel, model = JYOLO.from_yaml(dual_yaml), YOLO.from_yaml(dual_yaml)
    model.load_state_dict(convert.state_dict_from_jax(model.plan, params,
                                                      stats), strict=True)
    if fused:
        params, stats = jmodel.fuse(params, stats)
        model.fuse()
    x = make_eval_batch(2, 128, 1)["images"].astype(np.float32) / 255
    ref, _ = jmodel.predict(params, stats, jnp.asarray(x))
    with torch.no_grad():
        dec, raw = model(_nchw(x))
        dec_m, raw_m = model(_nchw(x), main_only=True)
    for k in ("aux", "main"):
        assert dec[k].shape == np.asarray(ref[k]).shape == (2, 336, 12)
        np.testing.assert_allclose(dec[k].numpy(), np.asarray(ref[k]),
                                   atol=DECODED_ATOL, rtol=DECODED_RTOL)
        assert len(raw[k]) == 3
    assert torch.equal(dec_m, dec["main"])
    assert all(torch.equal(a, b) for a, b in zip(raw_m, raw["main"],
                                                 strict=True))


def test_main_only_forward_runs_no_aux_layer(dual_yaml):
    model = YOLO.from_yaml(dual_yaml).fuse()
    ran = []
    for name, layer in model.layers.items():
        layer.register_forward_hook(lambda m, i, o, n=name: ran.append(n))
    with torch.no_grad():
        model(torch.rand(1, 3, 64, 64), main_only=True)
    assert ran == [s.name for s in model.main_steps]
    assert not [n for n in ran if n.startswith(("aux_", "cb_"))]
    with pytest.raises(ValueError, match="eval"):
        YOLO.from_yaml(dual_yaml).train()(torch.rand(1, 3, 64, 64),
                                          main_only=True)


# ---------------------------------------------------------------------------
# the dual TAL loss
# ---------------------------------------------------------------------------

def _dual_loss_inputs(seed, nc=8, img=64, strides=(8, 16, 32)):
    rng = np.random.default_rng(seed)
    preds = {}
    for k in ("aux", "main"):
        preds[k] = [(_rand(rng, 2, img // s, img // s, 64),
                     _rand(rng, 2, img // s, img // s, nc) - 2)
                    for s in strides]
    targets = np.zeros((2, 5, 5), np.float32)
    for i, n in enumerate((3, 2)):
        for j in range(n):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            bw, bh = rng.uniform(0.15, 0.4, 2)
            targets[i, j] = [rng.integers(0, nc), cx, cy, bw, bh]
    return preds, targets


def test_forward_dual_loss_and_grads_match_jax():
    preds, targets = _dual_loss_inputs(7)
    jloss, tloss = JTALoss(8, 16, (8, 16, 32)), TALoss(8, 16, (8, 16, 32))

    def jobj(preds):
        return jloss(preds, jnp.asarray(targets))

    (jtotal, jitems), jgrads = jax.value_and_grad(jobj, has_aux=True)(
        {k: [(jnp.asarray(b), jnp.asarray(c)) for b, c in v]
         for k, v in preds.items()})
    tp = {k: [(_nchw(b).requires_grad_(), _nchw(c).requires_grad_())
              for b, c in v] for k, v in preds.items()}
    total, items = tloss(tp, torch.from_numpy(targets))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems),
                               rtol=LOSS_RTOL)
    # the aux branch enters at a quarter: its items differ from main's
    single, _ = tloss.forward_single(
        [(b.detach(), c.detach()) for b, c in tp["main"]],
        torch.from_numpy(targets))
    assert float(single) != pytest.approx(float(total.detach()), rel=1e-3)
    for k in ("aux", "main"):
        for (gb, gc), (b, c) in zip(jgrads[k], tp[k]):
            np.testing.assert_allclose(_nhwc(b.grad), np.asarray(gb),
                                       atol=1e-6, rtol=1e-4)
            np.testing.assert_allclose(_nhwc(c.grad), np.asarray(gc),
                                       atol=1e-6, rtol=1e-4)


# ---------------------------------------------------------------------------
# the Trainer: four f32 steps against the JAX Trainer, checkpoints
# ---------------------------------------------------------------------------

class _Loader(list):
    """A list of batches with the loader hooks the JAX Trainer calls."""

    batch_size = 2
    drop_last = True

    def set_epoch(self, epoch):
        pass


def _constant_lr(step):
    """scripts/validate_loss_curve.py's schedule: lr 0.01, momentum 0.937."""
    return 0.01, 0.01, 0.937


@pytest.fixture(scope="module")
def trained_dual(dual_yaml, tmp_path_factory):
    """The port's and the JAX Trainer after the same 4 f32 steps on
    TINY_DUAL_YAML at 64 px from the same init and batches: (port trainer,
    jax trainer, port curve, jax curve, output dir)."""
    out = tmp_path_factory.mktemp("train_dual")
    jmodel = JYOLO.from_yaml(dual_yaml)
    params, stats = jax.device_get(jmodel.init(jax.random.key(0)))
    batches = _Loader(make_eval_batch(2, 64, 20 + i, max_boxes=4)
                      for i in range(2))
    common = {"epochs": 2, "data_parallel": False, "output_dir": str(out)}
    jt = JTrainer(jmodel, config=JTrainConfig(**common), train_loader=batches,
                  params=params, stats=stats, schedule=_constant_lr)
    tt = Trainer(YOLO.from_yaml(dual_yaml), config=TrainConfig(**common),
                 train_loader=batches, params=params, stats=stats,
                 schedule=_constant_lr, device="cpu")
    jcurve, tcurve = [], []
    for step in range(4):
        b = batches[step % 2]
        (jt.params, jt.stats, jt.opt_bufs, jt.ema, loss, _, _) = \
            jt._train_step(jt.params, jt.stats, jt.opt_bufs, jt.ema,
                           jnp.asarray(b["images"]),
                           jnp.asarray(b["targets"]), np.int32(step))
        jt.global_step += 1
        jcurve.append(float(loss))
        tcurve.append(float(tt.train_step(b["images"], b["targets"])[0]))
    return tt, jt, tcurve, jcurve, out


def test_dual_loss_curve_matches_jax_trainer(trained_dual):
    """test_loss_curve_matches_jax_trainer's bounds (2% relative for the
    first six steps), the first step to the loss items' tolerance."""
    _, _, tcurve, jcurve, _ = trained_dual
    for s, (a, b) in enumerate(zip(tcurve, jcurve)):
        assert abs(a - b) / abs(b) < 0.02, (s, a, b)
    assert tcurve[0] == pytest.approx(jcurve[0], rel=LOSS_RTOL)
    assert len(set(tcurve)) == 4


def test_dual_port_checkpoint_loads_in_jax(trained_dual, dual_yaml):
    """The port's checkpoint reads in the JAX package with JAX init's tree
    structure, and JAX serves from it."""
    tt, _, _, _, out = trained_dual
    tt._save(out / "port.npz", epoch=1)
    ck = jckpt.load_checkpoint(out / "port.npz")
    assert (ck["epoch"], ck["global_step"]) == (1, 4)
    jmodel = JYOLO.from_yaml(dual_yaml)
    init = jax.device_get(jmodel.init(jax.random.key(1)))
    params, stats = convert.jax_from_state_dict(tt.model.plan,
                                                tt.model.state_dict())
    for mine, ref, tree in ((params, ck["params"], init[0]),
                            (stats, ck["stats"], init[1])):
        a, b = convert.flatten_tree(mine), convert.flatten_tree(ref)
        assert a.keys() == b.keys() == convert.flatten_tree(tree).keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    w = tt.ema["params"]["layers.cb_route2.conv.bias"]
    np.testing.assert_array_equal(ck["ema"]["params"]["cb_route2"]["b"],
                                  w.numpy())
    x = make_eval_batch(1, 64, 3)["images"].astype(np.float32) / 255
    ref, _ = jmodel.predict(ck["params"], ck["stats"], jnp.asarray(x))
    model = tt.model.eval()
    with torch.no_grad():
        dec, _ = model(_nchw(x))
    model.train()
    for k in ("aux", "main"):
        np.testing.assert_allclose(dec[k].numpy(), np.asarray(ref[k]),
                                   atol=DECODED_ATOL, rtol=DECODED_RTOL)


def test_dual_jax_checkpoint_resumes_in_port(trained_dual, dual_yaml):
    _, jt, _, _, out = trained_dual
    jt._save(out / "jax.npz", epoch=1)
    fresh = Trainer(YOLO.from_yaml(dual_yaml),
                    config=TrainConfig(data_parallel=False,
                                       output_dir=str(out)),
                    train_loader=[None], device="cpu")
    fresh.load_checkpoint(out / "jax.npz")
    assert (fresh.global_step, fresh.start_epoch) == (4, 2)
    ref = convert.state_dict_from_jax(fresh.model.plan,
                                      *jax.device_get((jt.params, jt.stats)))
    sd = fresh.model.state_dict()
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k
    opt_ref = convert.state_dict_from_jax(
        fresh.model.plan, *jax.device_get((jt.opt_bufs, jt.stats)))
    for k, v in fresh.opt_bufs.items():
        assert torch.equal(v, opt_ref[k]), k


# ---------------------------------------------------------------------------
# Detector and Evaluator on the dual model
# ---------------------------------------------------------------------------

def test_dual_detector_matches_jax(dual_yaml, dual_weights):
    """f32 at 128 px, class biases 0: the port's Detector (main-only
    forward) against the JAX Detector (whole dual program, decoded
    "main")."""
    params, stats = dual_weights
    params = _zero_class_biases(jax.tree_util.tree_map(np.copy, params))
    kw = {"img_size": 128, "compute_dtype": "float32"}
    jdet = JDetector(JYOLO.from_yaml(dual_yaml), params, stats, **kw)
    det = Detector(YOLO.from_yaml(dual_yaml), (params, stats), device="cpu",
                   **kw)
    images = make_eval_batch(3, 128, 4)["images"]
    ref, out = jdet(images), det(images)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]),
                               atol=BOX_ATOL)
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=SCORE_ATOL)
    assert int(out["valid"].sum()) > 0


def test_dual_evaluator_matches_jax(dual_yaml, dual_weights):
    """f32, class biases 0, two in-memory batches at 128 px: one batch's
    padded NMS output (all anchors, conf 1e-3, iou 0.6) and the mAP against
    the JAX Evaluator."""
    params, stats = dual_weights
    params = _zero_class_biases(jax.tree_util.tree_map(np.copy, params))
    batches = [make_eval_batch(2, 128, 30 + i) for i in range(2)]
    jev = JEvaluator(JYOLO.from_yaml(dual_yaml), batches)
    model = YOLO.from_yaml(dual_yaml)
    ev = Evaluator(model, batches, device="cpu")
    ref = jev._step(params, stats, jnp.asarray(batches[0]["images"]))
    out, _ = ev._dispatch(inference_model(model, (params, stats), ev.device,
                                          ev.dtype), batches[0])
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]),
                               atol=BOX_ATOL)
    assert int(out["valid"].sum()) > 0
    jres = jev.evaluate(params, stats)
    res = ev.evaluate((params, stats))
    for k in ("map50", "map"):
        assert abs(res[k] - jres[k]) <= 5e-3, (k, res[k], jres[k])
