"""The port's Evaluator against the JAX Evaluator on dense ground truth
(scripts/validate_eval_parity.py --dense): 16 images of 56-96 objects
drawn at 320 px (data/synth.py, dense=True), max_boxes 128, the trained
fixture assets/dryrun_tiny.npz on TINY_YAML, f32 on the CPU.

The JAX Evaluator's NMS picks its program by the number of candidates
above the confidence threshold (yolo_re_tpu/ops/nms.py: ADAPTIVE_BUCKETS
512, 1024, 2048, else every anchor); the port keeps every anchor at
mAP-eval thresholds. The fixture was trained at 160 px and is sure of
itself at 320: no image keeps more than 512 candidates there, so JAX runs
its smallest program. Letterboxed to 480 and 640 px the same images keep
more (TINY_YAML's head reads strides 4, 8 and 16: 8400, 18900 and 33600
anchors), and the comparison reaches JAX's larger programs too.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_re_tpu.data.config import DataConfig as JDataConfig
from yolo_re_tpu.data.dataset import create_dataloader as jcreate_dataloader
from yolo_re_tpu.eval.evaluator import Evaluator as JEvaluator
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.ops.nms import ADAPTIVE_BUCKETS
from yolo_re_tpu.train.checkpoint import load_weights as jload_weights
from yolo_re_tpu_torch import convert
from yolo_re_tpu_torch.data.config import DataConfig
from yolo_re_tpu_torch.data.dataset import create_dataloader
from yolo_re_tpu_torch.data.synth import NUM_CLASSES, TINY_YAML, \
    write_dataset
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops import nms as nms_ops
from yolo_re_tpu_torch.ops.kernels import nms as nms_kernel
from yolo_re_tpu_torch.ops.boxes import dfl_decode, dist2bbox, \
    make_anchors_np
from yolo_re_tpu_torch.ops.nms import non_max_suppression, \
    non_max_suppression_raw
from yolo_re_tpu_torch.serving import inference_model
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / \
    "dryrun_tiny.npz"
# scripts/validate_eval_parity.py --dense: 16 val images (seed 1), drawn
# at 320 px, max_boxes 128; evaluated at these sizes
IMAGES, SEED, MAX_BOXES = 16, 1, 128
SIZES = (320, 480, 640)
CONF = 0.001                   # the Evaluators' default threshold
# mAP50 and mAP against the JAX Evaluator (the sparse fixture's gap: 0)
MAP_ATOL = 1e-6


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    root = tmp_path_factory.mktemp("dense")
    cfg = root / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    val = write_dataset(str(root / "data"), "val", IMAGES, seed=SEED,
                        dense=True)
    return str(cfg), val


def _data(val: str, size: int) -> dict:
    return {"val_path": val, "num_classes": NUM_CLASSES, "img_size": size,
            "batch_size": 8, "workers": 2, "max_boxes": MAX_BOXES}


def _candidates(cfg: str, val: str, size: int) -> np.ndarray:
    """Per image, the anchors whose best class score is above CONF (the
    count JAX's adaptive NMS dispatches on), from the port's fused f32
    model on the port's val batches."""
    model = YOLO.from_yaml(cfg)
    model = inference_model(model, convert.load_weights(FIXTURE),
                            torch.device("cpu"), torch.float32)
    counts = []
    with torch.no_grad():
        for batch in create_dataloader(val, DataConfig(**_data(val, size)),
                                       "val"):
            x = torch.as_tensor(batch["images"])
            decoded, _ = model(x.permute(0, 3, 1, 2), main_only=True)
            assert decoded.shape[1] == sum((size // s) ** 2
                                           for s in (4, 8, 16))
            counts.append((decoded[..., 4:].amax(-1) > CONF).sum(-1).numpy())
    return np.concatenate(counts)


def test_dense_scenes_reach_past_the_smallest_bucket(dense):
    """Some image keeps more than 512 candidates; the JAX program each
    size's batches take is printed."""
    most = {}
    for size in SIZES:
        counts = _candidates(*dense, size)
        assert len(counts) == IMAGES
        most[size] = int(counts.max())
    programs = {size: next((b for b in ADAPTIVE_BUCKETS if n <= b), "all")
                for size, n in most.items()}
    print(f"most candidates above {CONF} in one image: {most}; JAX's "
          f"program: {programs}")
    assert max(most.values()) > ADAPTIVE_BUCKETS[0] == 512


@pytest.mark.parametrize("size", SIZES)
def test_dense_evaluator_matches_jax(dense, size):
    cfg, val = dense
    ref = JEvaluator(JYOLO.from_yaml(cfg), jcreate_dataloader(
        val, JDataConfig(**_data(val, size)), "val")).evaluate(
        *jload_weights(FIXTURE))
    out = Evaluator(YOLO.from_yaml(cfg), create_dataloader(
        val, DataConfig(**_data(val, size)), "val"), device="cpu").evaluate(
        convert.load_weights(FIXTURE))
    print(f"dense at {size} px: mAP50 {out['map50']} / {ref['map50']}, "
          f"mAP {out['map']} / {ref['map']} (port / JAX)")
    for k in ("map50", "map"):
        assert abs(out[k] - ref[k]) <= MAP_ATOL, (k, out[k], ref[k])
    assert out["map50"] > 0


# ---------------------------------------------------------------------------
# all-anchor NMS beyond the kernel's MAX_K (the 480 and 640 px cases above:
# 18900 and 33600 anchors, where non_max_suppression used to raise)
# ---------------------------------------------------------------------------

A, NC, SMALL_MAX_K = 1000, 4, 300


def _inputs(passing: int):
    """Raw streams of A anchors whose best class score is above CONF in
    `passing` of them per image (two images), their decoded predictions,
    and the anchor points."""
    g = torch.Generator().manual_seed(passing)
    box = torch.randn(2, A, 64, generator=g)
    cls = torch.randn(2, A, NC, generator=g) - 12.0   # sigmoid ~ 6e-6
    for b in range(2):
        hot = torch.randperm(A, generator=g)[:passing]
        cls[b, hot] += 12.0 + 2.0 * torch.rand(len(hot), NC, generator=g)
    anchors, strides = make_anchors_np([(20, 40), (10, 20)], (8, 16))
    assert len(anchors) == A
    decoded = torch.cat([
        dist2bbox(dfl_decode(box, 16), torch.as_tensor(anchors)) *
        torch.as_tensor(strides), torch.sigmoid(cls)], dim=-1)
    return box, cls, anchors, strides, decoded


def test_all_anchor_nms_beyond_max_k_is_exact(monkeypatch):
    """With MAX_K cut below the anchors, both NMS functions take K from
    the conf-passing count and give the all-anchor detections exactly;
    more passing anchors than MAX_K raise."""
    box, cls, anchors, strides, decoded = _inputs(250)
    assert (decoded[..., 4:].amax(-1) > CONF).sum(1).max() == 250
    ref = non_max_suppression(decoded, conf_thres=CONF, max_det=100)
    ref_raw = non_max_suppression_raw(box, cls, anchors, strides,
                                      conf_thres=CONF, max_det=100)
    assert int(ref["valid"].sum()) > 0
    # the kernel's wrapper refuses more than its MAX_K candidates
    monkeypatch.setattr(nms_ops, "MAX_K", SMALL_MAX_K)
    monkeypatch.setattr(nms_kernel, "MAX_K", SMALL_MAX_K)
    for got, want in ((non_max_suppression(decoded, conf_thres=CONF,
                                           max_det=100), ref),
                      (non_max_suppression_raw(box, cls, anchors, strides,
                                               conf_thres=CONF,
                                               max_det=100), ref_raw)):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    _, _, _, _, crowded = _inputs(SMALL_MAX_K + 1)
    with pytest.raises(ValueError, match="above conf_thres"):
        non_max_suppression(crowded, conf_thres=CONF)
