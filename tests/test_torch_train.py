"""The port's training path held against the JAX package on the CPU.

The train kernels' plain versions (what a CPU tensor runs) against the TPU
kernels they stand for, run in Pallas interpret mode as the JAX package's
own tests run them; every gelan-c block in train mode; the TAL assigner and
loss; the optimizer pieces; the 12-step loss curve of the port's Trainer
against the JAX Trainer; checkpoints read across the two packages; and a
train step with jax blocked. Inputs are made from numpy seeds and handed to
both packages. The CUDA kernels themselves are held against these plain
versions in tests/test_torch_cuda.py (marker `cuda`).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_re_tpu.loss.assigner import TaskAlignedAssigner as JAssigner
from yolo_re_tpu.loss.tal import TALoss as JTALoss
from yolo_re_tpu.loss.tal import pad_targets as jpad_targets
from yolo_re_tpu.models import blocks as JB
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.models.yolo import param_labels as jparam_labels
from yolo_re_tpu.ops.adown_train import _adown_conv
from yolo_re_tpu.ops.conv import avg_pool2d as javg, conv2d as jconv2d
from yolo_re_tpu.ops.boxes import bbox_iou as jbbox_iou
from yolo_re_tpu.ops.conv import max_pool2d as jmax
from yolo_re_tpu.ops.pallas.stem_kernel import (
    stem_conv_packed_raw,
    stem_wgrad_packed,
    to_phase_planes,
    unpack_rows,
)
from yolo_re_tpu.ops.stem_train import _pack_w2_jnp
from yolo_re_tpu.train import checkpoint as jckpt
from yolo_re_tpu.train import ema as jema
from yolo_re_tpu.train import optimizer as jopt
from yolo_re_tpu.train.config import TrainConfig as JTrainConfig
from yolo_re_tpu.train.schedule import WarmupCosineSchedule as JSchedule
from yolo_re_tpu.train.trainer import Trainer as JTrainer
from yolo_re_tpu_torch import convert
from yolo_re_tpu_torch.data import synth
from yolo_re_tpu_torch.loss.assigner import TaskAlignedAssigner
from yolo_re_tpu_torch.loss.tal import TALoss, pad_targets
from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.boxes import bbox_iou
from yolo_re_tpu_torch.ops.kernels import adown, stem
from yolo_re_tpu_torch.ops.stem_train import stem_conv_raw_train
from yolo_re_tpu_torch.train import ema, optimizer
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.schedule import WarmupCosineSchedule
from yolo_re_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
# f32 kernels and blocks, the JAX package's tolerance (test_blocks.py:208)
KERNEL_ATOL = 2e-5
# weight gradients (f32 sums in another order): relative L2
WGRAD_REL = 1e-5
# train-mode blocks: batch statistics over a few hundred pixels divide by
# a std estimated from them, which amplifies ~1e-7 conv differences
TRAIN_ATOL = 1e-4
# loss items, PARITY.md "Loss / assignment" (~3e-6 relative)
LOSS_RTOL = 1e-5


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


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    p.write_text(synth.TINY_YAML)
    return str(p)


# ---------------------------------------------------------------------------
# kernels 2 and 3: the train stem
# ---------------------------------------------------------------------------

def _stem_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 64)) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, 8, 12, 64)).astype(np.float32)
    return x, w, g


def test_stem_conv_raw_plain_matches_pallas():
    x, w, _ = _stem_inputs(0)
    ref = unpack_rows(stem_conv_packed_raw(
        to_phase_planes(jnp.asarray(x)), _pack_w2_jnp(jnp.asarray(w)),
        wo=12, dtype=jnp.float32, interpret=True))
    before = stem.raw_launches
    y = stem.stem_conv_raw(_cl(x), _oihw(w))
    assert stem.raw_launches == before          # CPU: the plain version ran
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=KERNEL_ATOL)


def test_stem_wgrad_plain_matches_pallas():
    x, _, g = _stem_inputs(1)
    # row-paired cotangent: gp[b, i, ox, 64r + c] = g[b, 2i + r, ox, c]
    gp = g.reshape(2, 4, 2, 12, 64).transpose(0, 1, 3, 2, 4) \
        .reshape(2, 4, 12, 128)
    dw2 = np.asarray(stem_wgrad_packed(to_phase_planes(jnp.asarray(x)),
                                       jnp.asarray(gp), interpret=True))
    ref = (dw2[:32, :64] + dw2[32:, 64:])[:27].reshape(3, 3, 3, 64)
    before = stem.wgrad_launches
    dw = stem.stem_wgrad(_cl(x), _cl(g))
    assert stem.wgrad_launches == before
    assert dw.dtype == torch.float32 and dw.shape == (64, 3, 3, 3)
    assert _rel_l2(_hwio(dw), ref) <= WGRAD_REL


def test_stem_train_function_grads():
    """The autograd Function: weight gradient of the plain conv, no input
    gradient, and it refuses an input that requires grad."""
    x, w, g = _stem_inputs(2)
    wt = _oihw(w).requires_grad_()
    y = stem_conv_raw_train(_cl(x), wt)
    (y * _cl(g)).sum().backward()
    w_ref = _oihw(w).requires_grad_()
    y_ref = torch.nn.functional.conv2d(_cl(x), w_ref, stride=2, padding=1)
    (y_ref * _cl(g)).sum().backward()
    torch.testing.assert_close(y, y_ref, atol=KERNEL_ATOL, rtol=0)
    assert _rel_l2(wt.grad, w_ref.grad) <= WGRAD_REL
    with pytest.raises(ValueError, match="require grad"):
        stem_conv_raw_train(_cl(x).requires_grad_(), wt)


# ---------------------------------------------------------------------------
# kernels 5 and 6: the train ADown
# ---------------------------------------------------------------------------

def _adown_inputs(seed, h, w, c=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c // 2, c // 2)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((1, 1, c // 2, c // 2)) * 0.1).astype(np.float32)
    r = rng.standard_normal((2, h // 2, w // 2, c)).astype(np.float32)
    return x, w1, w2, r


@pytest.mark.parametrize("h,w", [(16, 16), (20, 16)])
def test_adown_raw_plain_matches_pallas(h, w):
    x, w1, w2, _ = _adown_inputs(3, h, w)
    xp = jnp.asarray(x).reshape(2, h, w // 2, 512)
    ref = _adown_conv(xp, jnp.asarray(w1), jnp.asarray(w2), True)
    before = adown.raw_launches
    y = adown.adown_raw(_cl(x), _oihw(w1), _oihw(w2))
    assert adown.raw_launches == before
    assert y.shape == (2, 256, h // 2, w // 2)
    # tests/test_adown_train.py:36-49
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("h,w", [(16, 16), (20, 16)])
def test_adown_bwd_plain_matches_pallas_grads(h, w):
    x, w1, w2, r = _adown_inputs(4, h, w)
    xp = jnp.asarray(x).reshape(2, h, w // 2, 512)

    def obj(xp, w1, w2):
        return (_adown_conv(xp, w1, w2, True) * jnp.asarray(r)).sum()

    gk = jax.grad(obj, argnums=(0, 1, 2))(xp, jnp.asarray(w1),
                                          jnp.asarray(w2))
    before = adown.bwd_launches
    dx, dw1, dw2 = adown.adown_bwd(_cl(x), _cl(r), _oihw(w1), _oihw(w2))
    assert adown.bwd_launches == before
    got = (_nhwc(dx).reshape(2, h, w // 2, 512), _hwio(dw1), _hwio(dw2))
    # tests/test_adown_train.py:52-73: normalized by the largest value
    for name, a, b in zip(("dx", "dw1", "dw2"), got, gk):
        b = np.asarray(b, np.float32)
        denom = np.abs(b).max() or 1.0
        np.testing.assert_allclose(a / denom, b / denom, atol=2e-5,
                                   err_msg=name)


def test_adown_bwd_plain_routes_ties_like_select_and_scatter():
    """Inputs quantized to halves: many windows of the maxpool hold tied
    maxima, and the gradient goes to the first of them, as XLA's
    select_and_scatter routes it (the JAX package's direct graph)."""
    rng = np.random.default_rng(5)
    x = (np.round(rng.standard_normal((2, 10, 12, 32)) * 2) / 2) \
        .astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 16, 16)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((1, 1, 16, 16)) * 0.1).astype(np.float32)
    r = rng.standard_normal((2, 5, 6, 32)).astype(np.float32)

    def direct(x, w1, w2):
        s = javg(x, 2, 1, 0)
        y1 = jconv2d(s[..., :16], w1, stride=2, padding=1)
        y2 = jconv2d(jmax(s[..., 16:], 3, 2, 1), w2)
        return (jnp.concatenate([y1, y2], -1) * jnp.asarray(r)).sum()

    ref = jax.grad(direct, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    dx, dw1, dw2 = adown.adown_bwd(_cl(x), _cl(r), _oihw(w1), _oihw(w2))
    a = torch.from_numpy(x).permute(0, 3, 1, 2)[:, 16:]
    s = adown._avg(a)
    win = torch.nn.functional.unfold(s, 3, padding=1, stride=2)
    win = win.reshape(2, 16, 9, -1)
    n_ties = int(((win == win.amax(2, keepdim=True)).sum(2) > 1).sum())
    assert n_ties > 50
    np.testing.assert_allclose(_nhwc(dx), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(_hwio(dw1), np.asarray(ref[1]), atol=1e-4)
    np.testing.assert_allclose(_hwio(dw2), np.asarray(ref[2]), atol=1e-4)


def test_train_wrappers_reject_what_the_kernels_do_not_take():
    xs = torch.zeros(1, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="g must be"):
        stem.stem_wgrad(xs, torch.zeros(1, 16, 3, 4).contiguous(
            memory_format=torch.channels_last))
    xa = torch.zeros(1, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    w1, w2 = torch.zeros(4, 4, 3, 3), torch.zeros(4, 4, 1, 1)
    with pytest.raises(ValueError, match="w1"):
        adown.adown_raw(xa, torch.zeros(4, 8, 3, 3), w2)
    with pytest.raises(ValueError, match="g must be"):
        adown.adown_bwd(xa, torch.zeros(1, 8, 2, 3).contiguous(
            memory_format=torch.channels_last), w1, w2)


# ---------------------------------------------------------------------------
# every gelan-c block in train mode: outputs and new running stats
# ---------------------------------------------------------------------------

def _bottleneck_inv(sd, p):
    return convert._named_inv(sd, [
        ("conv1", p + "conv1.", convert._repconv_inv),
        ("conv2", p + "conv2.", convert._conv_inv)])


def _emit_bottleneck(out, p, params, stats):
    convert._repconv(out, p + "conv1.", params["conv1"], stats["conv1"])
    convert._conv(out, p + "conv2.", params["conv2"], stats["conv2"])


_TRAIN_CASES = {
    # name: (JAX config, port module, emitter, inverse, input NHWC shape)
    "Conv": (JB.ConvConfig(16, 24, 3, 2), lambda: B.Conv(16, 24, 3, 2),
             convert._conv, convert._conv_inv, (2, 9, 12, 16)),
    "Conv_stem": (JB.ConvConfig(3, 16, 3, 2), lambda: B.Conv(3, 16, 3, 2),
                  convert._conv, convert._conv_inv, (2, 17, 20, 3)),
    "RepConv": (JB.RepConvConfig(16, 24), lambda: B.RepConv(16, 24),
                convert._repconv, convert._repconv_inv, (2, 8, 8, 16)),
    "RepNBottleneck": (JB.RepNBottleneckConfig(16, 16),
                       lambda: B.RepNBottleneck(16, 16), _emit_bottleneck,
                       _bottleneck_inv, (2, 8, 8, 16)),
    "RepNCSP": (JB.RepNCSPConfig(16, 24, 2), lambda: B.RepNCSP(16, 24, 2),
                convert._repncsp, convert._repncsp_inv, (2, 8, 8, 16)),
    "RepNCSPELAN4": (JB.RepNCSPELAN4Config(24, 32, 32, 16, 1),
                     lambda: B.RepNCSPELAN4(24, 32, 32, 16, 1),
                     convert._elan, convert._elan_inv, (2, 8, 12, 24)),
    "SPPELAN": (JB.SPPELANConfig(32, 32, 16), lambda: B.SPPELAN(32, 32, 16),
                convert._EMITTERS["SPPELAN"], convert._INVERSES["SPPELAN"],
                (2, 10, 10, 32)),
    "ADown": (JB.ADownConfig(32, 32), lambda: B.ADown(32, 32),
              convert._EMITTERS["ADown"], convert._INVERSES["ADown"],
              (2, 10, 14, 32)),
    "ADown_odd": (JB.ADownConfig(48, 48), lambda: B.ADown(48, 48),
                  convert._EMITTERS["ADown"], convert._INVERSES["ADown"],
                  (1, 9, 7, 48)),
}


@pytest.mark.parametrize("name", sorted(_TRAIN_CASES))
def test_block_train_mode_matches_jax(name):
    cfg, make, emit, inv, shape = _TRAIN_CASES[name]
    jblock = JB.get_block_class(name.split("_")[0])
    params, stats = jax.device_get(jblock.init(jax.random.key(1), cfg))
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map(
        lambda s: np.asarray(s) + rng.uniform(0, 0.3, np.shape(s))
        .astype(np.float32), stats)
    sd = {}
    emit(sd, "", params, stats)
    module = make()
    module.load_state_dict(sd, strict=True)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    apply = jax.jit(lambda p, s, x: jblock.apply(cfg, p, s, x, train=True))
    ref, new_stats = apply(params, stats, jnp.asarray(x))
    y = module.train()(_cl(x))
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=TRAIN_ATOL)
    _, got_stats = inv(module.state_dict(), "")
    a = convert.flatten_tree(got_stats)
    b = convert.flatten_tree(jax.device_get(new_stats))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_param_labels_match_jax_groups(tiny_yaml):
    model = YOLO.from_yaml(tiny_yaml)
    labels = model.param_labels()
    shapes = jax.eval_shape(JYOLO.from_yaml(tiny_yaml).init,
                            jax.random.key(0))[0]
    jlabels = jax.tree_util.tree_leaves(jparam_labels(shapes))
    jsizes = [int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)]
    params = dict(model.named_parameters())
    for group in ("weight", "bn", "bias"):
        assert sum(params[k].numel() for k, v in labels.items()
                   if v == group) == \
            sum(n for n, lab in zip(jsizes, jlabels) if lab == group)


# ---------------------------------------------------------------------------
# loss: assigner and TAL
# ---------------------------------------------------------------------------

def _loss_inputs(seed, nc=4, img=64, strides=(8, 16, 32)):
    rng = np.random.default_rng(seed)
    pairs = []
    for s in strides:
        h = img // s
        pairs.append((rng.standard_normal((2, h, h, 64)).astype(np.float32),
                      (rng.standard_normal((2, h, h, nc)) - 2)
                      .astype(np.float32)))
    targets = np.zeros((2, 5, 5), np.float32)
    for i, n in enumerate((3, 2)):
        for j in range(n):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            bw, bh = rng.uniform(0.15, 0.4, 2)
            targets[i, j] = [rng.integers(0, nc), cx, cy, bw, bh]
    return pairs, targets


def test_tal_loss_and_grads_match_jax():
    pairs, targets = _loss_inputs(7)
    jloss = JTALoss(4, 16, (8, 16, 32))
    tloss = TALoss(4, 16, (8, 16, 32))

    def jobj(pairs):
        return jloss(pairs, jnp.asarray(targets))

    (jtotal, jitems), jgrads = jax.value_and_grad(jobj, has_aux=True)(
        [(jnp.asarray(b), jnp.asarray(c)) for b, c in pairs])
    tp = [(_cl(b).requires_grad_(), _cl(c).requires_grad_())
          for b, c in pairs]
    total, items = tloss(tp, torch.from_numpy(targets))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems),
                               rtol=LOSS_RTOL)
    for (gb, gc), (b, c) in zip(jgrads, tp):
        np.testing.assert_allclose(_nhwc(b.grad), np.asarray(gb), atol=1e-6,
                                   rtol=1e-4)
        np.testing.assert_allclose(_nhwc(c.grad), np.asarray(gc), atol=1e-6,
                                   rtol=1e-4)


@pytest.mark.parametrize("iou_type", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("xywh", [False, True], ids=["xyxy", "xywh"])
def test_bbox_iou_matches_jax(iou_type, xywh):
    rng = np.random.default_rng(12)
    a = rng.uniform(0, 50, (6, 4)).astype(np.float32)
    b = rng.uniform(0, 50, (1, 5, 4)).astype(np.float32)
    if not xywh:                       # valid xyxy boxes
        a[:, 2:] += a[:, :2]
        b[..., 2:] += b[..., :2]
    ref = jbbox_iou(jnp.asarray(a[:, None]), jnp.asarray(b), xywh=xywh,
                    iou_type=iou_type)
    got = bbox_iou(torch.from_numpy(a[:, None]), torch.from_numpy(b),
                   xywh=xywh, iou_type=iou_type)
    assert got.shape == (6, 5, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_pad_targets_copy_matches_jax():
    labels = [np.ones((3, 5), np.float32), np.zeros((0, 5), np.float32),
              np.full((1, 5), 2.0, np.float32)]
    for max_boxes in (None, 2, 6):
        np.testing.assert_array_equal(pad_targets(labels, max_boxes),
                                      jpad_targets(labels, max_boxes))


def test_assigner_matches_jax_with_ties():
    """Scores quantized to a few levels and boxes on a grid: equal align
    metrics are common, and the k-th-value threshold keeps the same
    anchors in both packages."""
    rng = np.random.default_rng(8)
    a = 64
    pd_scores = (rng.integers(1, 5, (2, a, 4)) / 5).astype(np.float32)
    ctr = rng.integers(2, 14, (2, a, 2)) * 4.0
    pd_bboxes = np.concatenate([ctr - 8, ctr + 8], -1).astype(np.float32)
    anc = np.stack(np.meshgrid(np.arange(8) * 8 + 4, np.arange(8) * 8 + 4),
                   -1).reshape(-1, 2).astype(np.float32)
    gt_bboxes = np.array([[[4, 4, 40, 36], [20, 24, 60, 60], [0, 0, 0, 0]],
                          [[8, 8, 56, 56], [0, 0, 0, 0], [0, 0, 0, 0]]],
                         np.float32)
    gt_labels = np.array([[[1], [3], [0]], [[2], [0], [0]]], np.float32)
    mask_gt = np.array([[[1], [1], [0]], [[1], [0], [0]]], np.float32)
    args = (pd_scores, pd_bboxes, anc, gt_labels, gt_bboxes, mask_gt)
    ref = JAssigner(topk=10, num_classes=4)(*map(jnp.asarray, args))
    got = TaskAlignedAssigner(topk=10, num_classes=4)(
        *map(torch.from_numpy, args))
    fg = np.asarray(ref[3])
    np.testing.assert_array_equal(got[3].numpy(), fg)
    assert fg.sum() > 10
    np.testing.assert_array_equal(got[0].numpy()[fg], np.asarray(ref[0])[fg])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------

def _opt_state(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 3, 3, 3), "scale": (4,), "bias": (4,), "b": (6,)}
    mk = lambda: {k: rng.standard_normal(s).astype(np.float32)  # noqa: E731
                  for k, s in shapes.items()}
    labels = {"w": "weight", "scale": "bn", "bias": "bias", "b": "bias"}
    return mk(), mk(), mk(), labels


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_sgd_step_and_clip_match_jax():
    params, grads, bufs, labels = _opt_state(9)
    grads = {k: v * 20 for k, v in grads.items()}      # norm above 10
    jg, jnorm = jopt.clip_by_global_norm(grads, 10.0)
    tg, tnorm = optimizer.clip_by_global_norm(_t(grads), 10.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    assert float(tnorm) > 10
    kw = {"lr": 0.01, "bias_lr": 0.05, "momentum": 0.9,
          "weight_decay": 5e-4}
    jp, jb = jopt.sgd_step(params, jg, bufs, labels, **kw)
    tp, tb = _t(params), _t(bufs)
    optimizer.sgd_step(tp, tg, tb, labels, **kw)
    # a few f32 ulps of values up to ~4 (fused multiply-adds differ)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_schedule_trajectory_matches_jax():
    kw = {"base_lr": 0.01, "total_steps": 60, "warmup_steps": 9,
          "warmup_momentum": 0.8, "base_momentum": 0.937,
          "warmup_bias_lr": 0.1, "lrf": 0.01}
    js, ts = JSchedule(**kw), WarmupCosineSchedule(**kw)
    for step in range(70):
        np.testing.assert_allclose(ts(step), [float(v) for v in js(step)],
                                   rtol=1e-6, err_msg=str(step))
    assert ts(0) == (0.01, 0.01, 0.937)          # the step-0 quirk


def test_ema_matches_jax():
    params, stats, _, _ = _opt_state(10)
    state = jema.init_ema(params, stats)
    tstate = ema.init_ema(_t(params), _t(stats))
    rng = np.random.default_rng(11)
    for _ in range(5):
        params = {k: v + rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in params.items()}
        state = jema.ema_update(state, params, stats, decay=0.9999, tau=3.0)
        ema.ema_update(tstate, _t(params), _t(stats), decay=0.9999, tau=3.0)
    assert tstate["updates"] == int(state["updates"]) == 5
    for k in params:
        np.testing.assert_allclose(tstate["params"][k].numpy(),
                                   np.asarray(state["params"][k]),
                                   rtol=1e-6, atol=1e-6)


def test_train_config_copy_matches_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(TrainConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JTrainConfig)]


# ---------------------------------------------------------------------------
# the Trainer: 12-step loss curve, checkpoints, jax blocked
# ---------------------------------------------------------------------------

class _Loader(list):
    """A list of batches with the loader hooks the JAX Trainer calls."""

    batch_size = 2
    drop_last = True

    def set_epoch(self, epoch):
        pass


def _curve_batches(size=96, batch=2, ncls=4):
    """scripts/validate_loss_curve.py:90-106: three batches of random
    [0, 1) images, two boxes per image, NHWC."""
    rng = np.random.default_rng(11)
    batches = _Loader()
    for _ in range(3):
        images = rng.random((batch, 3, size, size), np.float32)
        targets = np.zeros((batch, 4, 5), np.float32)
        for i in range(batch):
            for j in range(2):
                cls = int(rng.integers(0, ncls))
                cx, cy = rng.uniform(0.3, 0.7, 2)
                bw, bh = rng.uniform(0.2, 0.4, 2)
                targets[i, j] = [cls, cx, cy, bw, bh]
        batches.append({"images": images.transpose(0, 2, 3, 1),
                        "targets": targets})
    return batches


def _constant_lr(step):
    """The validate_loss_curve.py schedule: constant lr 0.01, momentum
    0.937 (JAX traces it, the port calls it)."""
    return 0.01, 0.01, 0.937


@pytest.fixture(scope="module")
def trained_pair(tiny_yaml, tmp_path_factory):
    """The port's and the JAX package's Trainer after the same 12 f32 steps
    from the same init and batches: (port trainer, jax trainer, port
    curve, jax curve, output dir)."""
    out = tmp_path_factory.mktemp("train")
    jmodel = JYOLO.from_yaml(tiny_yaml)
    params, stats = jax.device_get(jmodel.init(jax.random.key(0)))
    batches = _curve_batches()
    common = {"epochs": 4, "data_parallel": False, "output_dir": str(out)}
    jt = JTrainer(jmodel, config=JTrainConfig(**common), train_loader=batches,
                  params=params, stats=stats, schedule=_constant_lr)
    tt = Trainer(YOLO.from_yaml(tiny_yaml), config=TrainConfig(**common),
                 train_loader=batches, params=params, stats=stats,
                 schedule=_constant_lr, device="cpu")
    jcurve, tcurve = [], []
    for step in range(12):
        b = batches[step % 3]
        (jt.params, jt.stats, jt.opt_bufs, jt.ema, loss, _, _) = \
            jt._train_step(jt.params, jt.stats, jt.opt_bufs, jt.ema,
                           jnp.asarray(b["images"]),
                           jnp.asarray(b["targets"]), np.int32(step))
        jt.global_step += 1
        jcurve.append(float(loss))
        tcurve.append(float(tt.train_step(b["images"], b["targets"])[0]))
    return tt, jt, tcurve, jcurve, out


def test_loss_curve_matches_jax_trainer(trained_pair):
    """The bounds of scripts/validate_loss_curve.py:158-172: 2% relative
    for the first half of the steps, 8% after (rounding differences grow
    through momentum and BN)."""
    _, _, tcurve, jcurve, _ = trained_pair
    for s, (a, b) in enumerate(zip(tcurve, jcurve)):
        bound = 0.02 if s < 6 else 0.08
        assert abs(a - b) / abs(b) < bound, (s, a, b)
    assert tcurve[0] == pytest.approx(jcurve[0], rel=LOSS_RTOL)


def test_port_checkpoint_loads_in_jax(trained_pair):
    tt, _, _, _, out = trained_pair
    tt._save(out / "port.npz", epoch=3)
    ck = jckpt.load_checkpoint(out / "port.npz")
    assert (ck["epoch"], ck["global_step"]) == (3, 12)
    assert int(ck["ema"]["updates"]) == 12
    params, stats = convert.jax_from_state_dict(tt.model.plan,
                                                tt.model.state_dict())
    for mine, ref in ((params, ck["params"]), (stats, ck["stats"])):
        a, b = convert.flatten_tree(mine), convert.flatten_tree(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    w = tt.ema["params"]["layers.stem1.conv.weight"]
    np.testing.assert_array_equal(ck["ema"]["params"]["stem1"]["w"], _hwio(w))
    buf = tt.opt_bufs["layers.down1.conv_pool.bn.weight"]
    np.testing.assert_array_equal(
        ck["opt"]["down1"]["conv_pool"]["scale"], buf.numpy())


def test_jax_checkpoint_resumes_in_port(trained_pair, tiny_yaml):
    _, jt, _, _, out = trained_pair
    jt._save(out / "jax.npz", epoch=3)
    fresh = Trainer(YOLO.from_yaml(tiny_yaml),
                    config=TrainConfig(data_parallel=False,
                                       output_dir=str(out)),
                    train_loader=[None], device="cpu")
    fresh.load_checkpoint(out / "jax.npz")
    assert (fresh.global_step, fresh.start_epoch) == (12, 4)
    assert fresh.ema["updates"] == 12
    ref = convert.state_dict_from_jax(fresh.model.plan,
                                      *jax.device_get((jt.params, jt.stats)))
    sd = fresh.model.state_dict()
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k
    ema_ref = convert.state_dict_from_jax(
        fresh.model.plan, *jax.device_get((jt.ema["params"],
                                           jt.ema["stats"])))
    for k, v in fresh.ema["stats"].items():
        assert torch.equal(v, ema_ref[k]), k
    opt_ref = convert.state_dict_from_jax(
        fresh.model.plan, *jax.device_get((jt.opt_bufs, jt.stats)))
    for k, v in fresh.opt_bufs.items():
        assert torch.equal(v, opt_ref[k]), k


def test_trainer_refuses_what_is_not_ported(tiny_yaml):
    model = YOLO.from_yaml(tiny_yaml)
    cfg = {"data_parallel": False}
    for kw in ({"optimizer": object()}, {"remat": True},
               {"checkpoint_format": "orbax"}):
        with pytest.raises(NotImplementedError, match="slice"):
            Trainer(model, config=TrainConfig(**cfg), train_loader=[None],
                    device="cpu", **kw)


def test_train_step_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'yolo_re_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import tempfile, numpy as np\n"
        "from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch\n"
        "from yolo_re_tpu_torch.models.yolo import YOLO\n"
        "from yolo_re_tpu_torch.train.config import TrainConfig\n"
        "from yolo_re_tpu_torch.train.trainer import Trainer\n"
        "p = tempfile.mktemp(suffix='.yaml'); open(p, 'w').write(TINY_YAML)\n"
        "b = make_eval_batch(2, 64, 0)\n"
        "t = Trainer(YOLO.from_yaml(p), config=TrainConfig(data_parallel=False,"
        " output_dir=tempfile.mkdtemp()), train_loader=[b], device='cpu')\n"
        "loss = float(t.train_step(b['images'], b['targets'])[0])\n"
        "assert np.isfinite(loss) and loss > 0, loss\n"
        "print(sorted(m for m in sys.modules if m.startswith('jax')"
        " and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
