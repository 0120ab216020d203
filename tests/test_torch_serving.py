"""The port's serving path as a whole, held against the JAX Detector on the
CPU: the trained fixture assets/dryrun_tiny.npz with TINY_YAML at 160 px,
so the detections are real. Both Detectors compute in float32."""

from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.serving import Detector as JDetector
from yolo_re_tpu.train.checkpoint import load_weights as jload_weights
from yolo_re_tpu_torch.convert import load_weights, state_dict_from_jax
from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.serving import Detector

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / \
    "dryrun_tiny.npz"
# post-NMS boxes are letterbox-canvas pixels: the decoded boxes of the
# trained fixture agree to 4.3e-4 px (tests/test_torch_model.py)
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    path.write_text(TINY_YAML)
    jdet = JDetector(JYOLO.from_yaml(path), *jload_weights(FIXTURE),
                     img_size=160, compute_dtype="float32")
    model = YOLO.from_yaml(path)
    det = Detector.from_checkpoint(model, str(FIXTURE), device="cpu",
                                   img_size=160, compute_dtype="float32")
    return jdet, det, model


def _compare(ref, out):
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]),
                               atol=BOX_ATOL)
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=SCORE_ATOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_detector_matches_jax_on_trained_fixture(detectors, seed):
    jdet, det, _ = detectors
    images = make_eval_batch(4, 160, seed)["images"]
    out = det(images)
    _compare(jdet(images), out)
    assert out["boxes"].shape == (4, 300, 4)
    assert out["valid"].sum(dim=1).min() >= 1     # a detection per image


def test_detector_letterboxes_like_jax(detectors):
    """Frames of another size and aspect: resize + pad on the device, then
    boxes mapped back to the original pixels."""
    jdet, det, _ = detectors
    images = make_eval_batch(2, 240, 4)["images"][:, :, 30:210]  # 240x180
    ref, out = jdet(images), det(images)
    _compare(ref, out)
    shapes = [(240, 180)] * 2
    for a, b in zip(det.to_list(out, shapes), jdet.to_list(ref, shapes)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=BOX_ATOL)


def test_detector_fuses_a_copy(detectors):
    _, det, model = detectors
    assert model.layers["stem1"].bn is not None      # caller's model as it was
    assert det.model.layers["stem1"].bn is None      # the Detector's is fused
    assert det.model.layers["down1"].conv_stride.conv.bias is not None


def test_detector_takes_a_state_dict(detectors):
    """A state dict of the model serves the same as the JAX pytrees."""
    _, det, model = detectors
    loaded = YOLO.from_config(model.config)
    loaded.load_state_dict(
        state_dict_from_jax(loaded.plan, *load_weights(FIXTURE)), strict=True)
    det2 = Detector(loaded, loaded.state_dict(), device="cpu", img_size=160,
                    compute_dtype="float32")
    images = make_eval_batch(2, 160, 6)["images"]
    a, b = det(images), det2(images)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_detector_takes_the_main_branch_of_a_dual_head(tmp_path):
    """A TINY_DUAL_YAML Detector serves the main branch alone: its output
    equals NMS over the full dual forward's decoded "main", bit for bit,
    and no aux layer runs (the JAX Detector keeps decoded["main"] of the
    whole program; tests/test_torch_dual.py holds the two Detectors)."""
    from yolo_re_tpu_torch.data.device_pipeline import batched_letterbox
    from yolo_re_tpu_torch.data.synth import TINY_DUAL_YAML
    from yolo_re_tpu_torch.ops.nms import non_max_suppression

    path = tmp_path / "tiny_dual.yaml"
    path.write_text(TINY_DUAL_YAML)
    model = YOLO.from_yaml(path)
    model.init_parameters(torch.Generator().manual_seed(0))
    det = Detector(model, model.state_dict(), device="cpu", img_size=128,
                   compute_dtype="float32", conf_thres=0.0)
    ran = []
    for name, layer in det.model.layers.items():
        layer.register_forward_hook(lambda m, i, o, n=name: ran.append(n))
    images = make_eval_batch(2, 128, 7)["images"]
    out = det(images)
    assert ran and not [n for n in ran if n.startswith(("aux_", "cb_"))]
    x = batched_letterbox(torch.as_tensor(images), 128, dtype=torch.float32)
    with torch.no_grad():
        decoded, _ = det.model(x.permute(0, 3, 1, 2))
    ref = non_max_suppression(decoded["main"], conf_thres=0.0,
                              iou_thres=det.iou_thres, max_det=det.max_det)
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)
    assert int(out["valid"].sum()) > 0


def test_detector_cuda_without_cuda_raises(detectors, monkeypatch):
    _, _, model = detectors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(model, model.state_dict(), device="cuda")
