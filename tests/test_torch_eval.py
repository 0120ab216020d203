"""The port's evaluation slice held against the JAX package on the CPU: the
all-anchor eval NMS, the copied data and metrics modules (bit-equal), the
Evaluator on the trained fixture, Trainer validation, the val CLI, and the
entry points' refusal to fall back to the CPU.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.data import augment as jaugment
from yolo_re_tpu.data.config import AugmentConfig as JAugmentConfig
from yolo_re_tpu.data.config import DataConfig as JDataConfig
from yolo_re_tpu.data.dataset import create_dataloader as jcreate_dataloader
from yolo_re_tpu.eval import metrics as jmetrics
from yolo_re_tpu.eval.evaluator import Evaluator as JEvaluator
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.ops.nms import non_max_suppression as jnms
from yolo_re_tpu.train.checkpoint import load_weights as jload_weights
from yolo_re_tpu_torch import convert
from yolo_re_tpu_torch.data import augment
from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
from yolo_re_tpu_torch.data.dataset import DataLoader, create_dataloader
from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch, \
    write_dataset
from yolo_re_tpu_torch.eval import metrics
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.nms import non_max_suppression
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "assets" / "dryrun_tiny.npz"
# the trained fixture's own val set (scripts/make_dryrun_fixture.py:42)
VAL_IMAGES, VAL_SEED = 16, 1
# Evaluator against the JAX Evaluator, mAP50 and mAP (measured gap: 0)
MAP_ATOL = 5e-3


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


@pytest.fixture(scope="module")
def fixture_val(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return write_dataset(str(root), "val", VAL_IMAGES, seed=VAL_SEED)


def _batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ---------------------------------------------------------------------------
# all-anchor eval NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [160, 320])
def test_all_anchor_nms_matches_jax_adaptive_path(tiny_yaml, size):
    """conf 1e-3, iou 0.6, max_det 300 on the trained fixture's decoded
    output. The JAX package takes its adaptive K buckets (at 160 px the
    512 bucket of 525 anchors; at 320 px buckets up to 2048 of 2100), the
    port one pass over every anchor: the same detections, in the same
    order."""
    jmodel = JYOLO.from_yaml(tiny_yaml)
    params, stats = jload_weights(FIXTURE)
    x = make_eval_batch(4, size, 3)["images"].astype(np.float32) / 255
    decoded, _ = jmodel.predict(params, stats, jnp.asarray(x))
    ref = jnms(decoded, conf_thres=0.001, iou_thres=0.6, max_det=300)
    out = non_max_suppression(torch.from_numpy(np.array(decoded)),
                              conf_thres=0.001, iou_thres=0.6, max_det=300)
    for k in ("valid", "classes", "scores"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]),
                               atol=1e-5)
    assert out["valid"].sum() > 20


# ---------------------------------------------------------------------------
# copied modules: bit-equal
# ---------------------------------------------------------------------------

def test_metrics_copy_is_bit_equal():
    rng = np.random.default_rng(0)
    args = [[], [], [], [], []]
    for _ in range(6):
        n, m = int(rng.integers(0, 12)), int(rng.integers(0, 5))
        xy = rng.uniform(0, 100, (n, 2))
        args[0].append(np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))],
                                      1).astype(np.float32))
        args[1].append(rng.uniform(0, 1, n).astype(np.float32))
        args[2].append(rng.integers(0, 3, n))
        gxy = rng.uniform(0, 100, (m, 2))
        args[3].append(np.concatenate([gxy, gxy + rng.uniform(5, 40, (m, 2))],
                                      1).astype(np.float32))
        args[4].append(rng.integers(0, 3, m))
    assert metrics.compute_map(*args, 3) == jmetrics.compute_map(*args, 3)
    a, b = args[0][1], args[3][1]
    np.testing.assert_array_equal(metrics.box_iou_np(a, b),
                                  jmetrics.box_iou_np(a, b))
    r, p = np.sort(rng.uniform(0, 1, 9)), rng.uniform(0, 1, 9)
    assert metrics.compute_ap(r, p) == jmetrics.compute_ap(r, p)


def test_data_config_copy_is_equal(tmp_path):
    for preset in ("full", "light", "minimal"):
        assert vars(AugmentConfig(preset)) == vars(JAugmentConfig(preset))
    y = tmp_path / "data.yaml"
    y.write_text("train: a/images\nval: b/images\nnc: 3\nnames: [x, y, z]\n"
                 "img_size: 320\ncache: ram\naugment: {preset: light}\n")
    mine, ref = DataConfig.from_yaml(y), JDataConfig.from_yaml(y)
    assert vars(mine).keys() == vars(ref).keys()
    for k, v in vars(mine).items():
        if k == "augment":
            assert vars(v) == vars(ref.augment)
        elif k == "cache":
            assert v.value == ref.cache.value
        else:
            assert v == getattr(ref, k), k


def test_augment_primitives_copy_is_bit_equal():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (90, 130, 3), dtype=np.uint8)
    for kw in ({}, {"auto": True}, {"scale_fill": True}, {"scaleup": False}):
        a, b = augment.letterbox(img, 160, **kw), jaugment.letterbox(img, 160,
                                                                    **kw)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    a, b = img.copy(), img.copy()
    augment.augment_hsv(a, 0.1, 0.5, 0.4, np.random.default_rng(1))
    jaugment.augment_hsv(b, 0.1, 0.5, 0.4, np.random.default_rng(1))
    np.testing.assert_array_equal(a, b)
    labels = np.array([[0, 10, 10, 60, 50], [1, 70, 20, 120, 80]], np.float32)
    for persp in (0.0, 0.001):
        a = augment.random_perspective(img, labels, degrees=10, shear=2,
                                       perspective=persp,
                                       rng=np.random.default_rng(2))
        b = jaugment.random_perspective(img, labels, degrees=10, shear=2,
                                        perspective=persp,
                                        rng=np.random.default_rng(2))
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_val_batches_match_jax_loader(synthetic_dataset, fixture_val, rect):
    """The conftest dataset (varied image sizes) and the fixture's val
    set, square and rect-batched."""
    for path in (synthetic_dataset, fixture_val):
        kw = {"img_size": 128, "batch_size": 3, "workers": 2, "rect": rect}
        mine = list(create_dataloader(path, DataConfig(**kw), mode="val"))
        ref = list(jcreate_dataloader(path, JDataConfig(**kw), mode="val"))
        _batches_equal(mine, ref)


def test_train_batches_match_jax_loader(synthetic_dataset):
    """Seeded train-mode batches through the full augmentation preset
    (mosaic, perspective, mixup, HSV, flips), two epochs, uint8 and f32."""
    for uint8 in (False, True):
        kw = {"img_size": 96, "batch_size": 4, "workers": 2,
              "uint8_images": uint8}
        aug = {"preset": "full", "mixup": 0.5, "degrees": 5.0}
        loader = create_dataloader(
            synthetic_dataset, DataConfig(augment=AugmentConfig(**aug), **kw))
        jloader = jcreate_dataloader(
            synthetic_dataset, JDataConfig(augment=JAugmentConfig(**aug),
                                           **kw))
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
            _batches_equal(list(loader), list(jloader))


# ---------------------------------------------------------------------------
# Evaluator, Trainer validation, CLI
# ---------------------------------------------------------------------------

def test_evaluator_matches_jax_evaluator(tiny_yaml, fixture_val):
    """The trained fixture at 160 px, f32: mAP50 and mAP within MAP_ATOL of
    the JAX Evaluator (measured: equal, 0.8150 and 0.5764)."""
    kw = {"val_path": fixture_val, "num_classes": 4, "img_size": 160,
          "batch_size": 5, "workers": 2}
    params, stats = jload_weights(FIXTURE)
    ref = JEvaluator(JYOLO.from_yaml(tiny_yaml), jcreate_dataloader(
        fixture_val, JDataConfig(**kw), "val")).evaluate(params, stats)
    loader = create_dataloader(fixture_val, DataConfig(**kw), "val")
    ev = Evaluator(YOLO.from_yaml(tiny_yaml), loader, device="cpu")
    out = ev.evaluate(convert.load_weights(FIXTURE))
    for k in ("map50", "map"):
        assert abs(out[k] - ref[k]) <= MAP_ATOL, (k, out[k], ref[k])
    assert out["map50"] > 0.5 and out["images_per_sec"] > 0
    # unfused, from a state dict, with debug images
    model = YOLO.from_yaml(tiny_yaml)
    sd = convert.state_dict_from_jax(model.plan, *convert.load_weights(
        FIXTURE))
    debug = Path(fixture_val).parent.parent / "debug"
    ev = Evaluator(model, loader, device="cpu", fuse=False,
                   debug_dir=str(debug))
    unfused = ev.evaluate(sd, epoch=3)
    assert abs(unfused["map50"] - out["map50"]) <= MAP_ATOL
    assert len(list((debug / "epoch3").glob("*.jpg"))) == 10


def test_trainer_validate_writes_best(tiny_yaml, tmp_path):
    """data= builds both loaders; train() validates the EMA weights each
    epoch and keeps the best map50 in best.npz."""
    root = str(tmp_path / "synth")
    data = DataConfig(train_path=write_dataset(root, "train", 4, seed=0),
                      val_path=write_dataset(root, "val", 6, seed=VAL_SEED),
                      num_classes=4, img_size=160, batch_size=4, workers=2,
                      augment=AugmentConfig("minimal"))
    params, stats = convert.load_weights(FIXTURE)
    cfg = TrainConfig(epochs=1, data_parallel=False, lr=1e-4,
                      output_dir=str(tmp_path / "run"))
    tr = Trainer(YOLO.from_yaml(tiny_yaml), data=data, config=cfg,
                 params=params, stats=stats, device="cpu")
    assert isinstance(tr.train_loader, DataLoader) and \
        isinstance(tr.val_loader, DataLoader)
    results = tr.train()
    assert results["map50"] > 0.5 and tr.best_fitness == results["map50"]
    assert (tmp_path / "run" / "best.npz").exists()
    line = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()[-1]
    assert '"val_map50"' in line


def test_val_cli_runs_with_jax_blocked(tiny_yaml, fixture_val):
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'yolo_re_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['val', '--weights', {str(FIXTURE)!r}, '--config', "
        f"{tiny_yaml!r}, '--data', {fixture_val!r}, '--num-classes', '4', "
        "'--img-size', '160', '--batch', '8', '--workers', '2', "
        "'--device', 'cpu', '--fuse']\n"
        "runpy.run_module('yolo_re_tpu_torch.cli.val', run_name='__main__')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib') and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result, blocked = out.stdout.strip().splitlines()[-2:]
    values = dict(kv.split("=") for kv in result.split())
    assert set(values) == {"map50", "map75", "map", "images_per_sec"}
    assert float(values["map50"]) > 0.5
    assert blocked == "[]"


# ---------------------------------------------------------------------------
# no silent CPU fallback; what is not ported raises
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_a_card(
        tiny_yaml, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = YOLO.from_yaml(tiny_yaml)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, config=TrainConfig(data_parallel=False),
                train_loader=[None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(model, [None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(model, model.state_dict())


def test_eval_slice_refuses_what_is_not_ported(tiny_yaml, fixture_val):
    """Sharded eval, the loader's shard= and the val CLI's --data-parallel
    are ported (tests/test_torch_parallel.py holds each to the single
    path, the CLI in a subprocess): what is refused is a mesh that is not
    a Mesh and a global batch that does not split."""
    model = YOLO.from_yaml(tiny_yaml)
    with pytest.raises(TypeError, match="Mesh"):
        Evaluator(model, [None], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        create_dataloader(fixture_val, DataConfig(), "val", shard=(0, 3))
    assert len(create_dataloader(fixture_val, DataConfig(batch_size=8),
                                 "val", shard=(1, 2))) == VAL_IMAGES // 8
