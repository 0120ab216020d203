"""Lazy-decode NMS in the port held against the JAX package on the CPU:
the head's split streams (`YOLO.predict_split`, `head_mode="split"`) and
`non_max_suppression_raw` (yolo_re_tpu/ops/nms.py:254-317) on the same
streams, and against the port's dense path (decoded forward +
`non_max_suppression`). The NMS kernel's plain version runs here; the
card's kernel is held against the CPU in tests/test_torch_cuda.py and
chip_smoke.py phase 16 (d).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.ops.nms import non_max_suppression_raw as jnms_raw
from yolo_re_tpu_torch.convert import load_weights, state_dict_from_jax
from yolo_re_tpu_torch.data.synth import TINY_DUAL_YAML, TINY_YAML, \
    make_eval_batch
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.boxes import dfl_decode, dist2bbox, \
    make_anchors_np
from yolo_re_tpu_torch.ops.nms import non_max_suppression, \
    non_max_suppression_raw
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / \
    "dryrun_tiny.npz"
SIZE = 160
# the split streams against the JAX package's, f32 logits of the whole
# forward (measured 1.2e-5 on the trained fixture's box logits, |max| 12)
STREAM_ATOL = 1e-4
# NMS outputs, raw against JAX's raw and against the dense path
# (tests/test_nms.py:138)
NMS_ATOL = 1e-4
# (conf_thres, iou_thres, classes, agnostic, logits dtype): serving
# (K = 512 of 2100 anchors), mAP eval (every anchor), a class filter,
# class-agnostic, and bf16 logits
CASES = {"serving": (0.25, 0.45, None, False, "float32"),
         "eval": (1e-3, 0.6, None, False, "float32"),
         "classes": (0.05, 0.45, (1, 3), False, "float32"),
         "agnostic": (0.05, 0.45, None, True, "float32"),
         "bf16": (0.05, 0.45, None, False, "bfloat16"),
         "bf16 eval": (1e-3, 0.6, None, False, "bfloat16")}


def _unit_scale_stats(tree, rng):
    """tests/test_torch_dual.py: BN statistics at the scale the init's
    convs give, so the random dual model's scores do not tie."""
    if isinstance(tree, list):
        return [_unit_scale_stats(v, rng) for v in tree]
    if "var" in tree:
        return {"mean": rng.uniform(-0.1, 0.1, np.shape(tree["mean"]))
                .astype(np.float32),
                "var": rng.uniform(0.25, 0.4, np.shape(tree["var"]))
                .astype(np.float32)}
    return {k: _unit_scale_stats(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{name: (port model (eval), JAX model, params, stats)}: TINY_YAML
    with the trained fixture's weights, TINY_DUAL_YAML at random init
    with unit-scale statistics."""
    d = tmp_path_factory.mktemp("cfg")
    out = {}
    for name, text in (("tiny", TINY_YAML), ("tiny-dual", TINY_DUAL_YAML)):
        path = d / f"{name}.yaml"
        path.write_text(text)
        jmodel = JYOLO.from_yaml(path)
        if name == "tiny":
            params, stats = load_weights(FIXTURE)
        else:
            params, stats = jax.device_get(jmodel.init(jax.random.key(0)))
            stats = _unit_scale_stats(stats, np.random.default_rng(1))
        model = YOLO.from_yaml(path)
        model.load_state_dict(state_dict_from_jax(model.plan, params, stats),
                              strict=True)
        out[name] = (model.eval(), jmodel, params, stats)
    return out


def _images(seed: int) -> np.ndarray:
    return make_eval_batch(2, SIZE, seed)["images"].astype(np.float32) / 255


@pytest.fixture(scope="module")
def streams(models):
    """The trained fixture's split streams from both packages on the same
    images, and the port's decoded forward."""
    model, jmodel, params, stats = models["tiny"]
    x = _images(3)
    with torch.no_grad():
        box, cls = model.predict_split(torch.from_numpy(x)
                                       .permute(0, 3, 1, 2))
        decoded, _ = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    jbox, jcls = jax.device_get(jmodel.predict_split(params, stats,
                                                     jnp.asarray(x)))
    return box, cls, jbox, jcls, decoded


@pytest.mark.parametrize("name", ["tiny", "tiny-dual"])
def test_split_streams_match_jax(models, name):
    """`predict_split` against the JAX package's `predict_split`: the
    flat f32 box logits (B, A, 4*reg_max) and class logits (B, A, nc) in
    the same anchor order (a dual head: its main branch), and the port's
    own decoded forward rebuilt from them."""
    model, jmodel, params, stats = models[name]
    x = _images(4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        box, cls = model.predict_split(xt)
        decoded, _ = model(xt)
    if isinstance(decoded, dict):
        decoded = decoded["main"]
    jbox, jcls = jax.device_get(jmodel.predict_split(params, stats,
                                                     jnp.asarray(x)))
    a = sum((SIZE // int(s)) ** 2 for s in model.strides)
    assert box.shape == (2, a, 64) and cls.shape == (2, a, model.num_classes)
    assert box.dtype == cls.dtype == torch.float32
    assert jbox.dtype == jcls.dtype == np.float32
    np.testing.assert_allclose(box.numpy(), jbox, atol=STREAM_ATOL)
    np.testing.assert_allclose(cls.numpy(), jcls, atol=STREAM_ATOL)
    shapes = [(SIZE // int(s), SIZE // int(s)) for s in model.strides]
    points, col = (torch.from_numpy(v) for v in
                   make_anchors_np(shapes, model.strides))
    dbox = dist2bbox(dfl_decode(box, 16), points[None], xywh=True) * col[None]
    torch.testing.assert_close(torch.cat([dbox, torch.sigmoid(cls)], -1),
                               decoded, rtol=1e-6, atol=NMS_ATOL)


def test_split_mode_is_eval_only(models):
    model = models["tiny"][0]
    x = torch.zeros(1, 3, 64, 64)
    model.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            model.predict_split(x)
        with pytest.raises(ValueError, match="eval"):
            model(x, head_mode="split")
    finally:
        model.eval()
    with pytest.raises(ValueError, match="head mode"):
        model(x, head_mode="lazy")


def _dense(box: torch.Tensor, cls: torch.Tensor, strides) -> torch.Tensor:
    """The decoded (B, A, 4+nc) predictions of (possibly bf16) streams, as
    the head decodes: DFL in f32, sigmoid of the f32 logits."""
    shapes = [(SIZE // int(s), SIZE // int(s)) for s in strides]
    points, col = (torch.from_numpy(v) for v in
                   make_anchors_np(shapes, strides))
    dbox = dist2bbox(dfl_decode(box.float(), 16), points[None],
                     xywh=True) * col[None]
    return torch.cat([dbox, torch.sigmoid(cls.float())], -1)


def _assert_nms_close(a: dict, b: dict, what: str) -> None:
    np.testing.assert_array_equal(np.asarray(a["valid"]),
                                  np.asarray(b["valid"]), err_msg=what)
    for k in ("boxes", "scores", "classes"):
        np.testing.assert_allclose(np.asarray(a[k], np.float32),
                                   np.asarray(b[k], np.float32),
                                   atol=NMS_ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_nms_raw_matches_jax_and_the_dense_path(models, streams, case):
    """`non_max_suppression_raw` on the trained fixture's streams against
    the JAX package's on the same streams (both in the case's dtype) and
    against the port's decoded tensor + `non_max_suppression`: the same
    detections (tests/test_nms.py:138's 1e-4), some of them valid."""
    conf, iou, classes, agnostic, dtype = CASES[case]
    model = models["tiny"][0]
    box, cls, _, _, decoded = streams
    tdt = getattr(torch, dtype)
    box, cls = box.to(tdt), cls.to(tdt)
    shapes = [(SIZE // int(s), SIZE // int(s)) for s in model.strides]
    points, col = make_anchors_np(shapes, model.strides)
    kw = {"conf_thres": conf, "iou_thres": iou, "classes": classes,
          "agnostic": agnostic}
    got = non_max_suppression_raw(box, cls, torch.from_numpy(points),
                                  torch.from_numpy(col), **kw)
    jdt = getattr(jnp, dtype)
    ref = jnms_raw(jnp.asarray(box.float().numpy()).astype(jdt),
                   jnp.asarray(cls.float().numpy()).astype(jdt),
                   jnp.asarray(points), jnp.asarray(col), **kw)
    _assert_nms_close(got, jax.device_get(ref), f"{case} against JAX")
    dense = decoded if dtype == "float32" else \
        _dense(box, cls, model.strides)
    _assert_nms_close(got, non_max_suppression(dense, **kw),
                      f"{case} against the dense path")
    n = int(got["valid"].sum())
    assert n > 0, case
    if classes is not None:
        assert set(got["classes"][got["valid"]].tolist()) <= set(classes)


def test_nms_raw_takes_numpy_anchors_and_pre_topk(models, streams):
    """numpy anchors as make_anchors_np returns them; an explicit
    pre_topk below the passing count changes what the dense path with the
    same pre_topk keeps alike."""
    model = models["tiny"][0]
    box, cls, _, _, decoded = streams
    shapes = [(SIZE // int(s), SIZE // int(s)) for s in model.strides]
    points, col = make_anchors_np(shapes, model.strides)
    got = non_max_suppression_raw(box, cls, points, col, conf_thres=1e-3,
                                  pre_topk=64, max_det=50)
    _assert_nms_close(got, non_max_suppression(decoded, conf_thres=1e-3,
                                               pre_topk=64, max_det=50),
                      "pre_topk 64")
    assert got["boxes"].shape == (2, 50, 4)
