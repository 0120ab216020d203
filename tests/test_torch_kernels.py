"""The port's kernel functions held against the JAX package on the CPU.

On a CPU tensor each wrapper in yolo_re_tpu_torch/ops/kernels/ takes its
plain PyTorch version (the CUDA kernels run only on the card: see
tests/test_torch_cuda.py and chip_smoke.py). Here the plain versions are
held against the TPU kernels they stand for, run as the JAX package's own
tests run them on the CPU (Pallas interpret mode), and against the JAX
package's plain graphs. Also the device letterbox, and the wrappers'
argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.data.device_pipeline import batched_letterbox as jletterbox
from yolo_re_tpu.models import blocks as JB
from yolo_re_tpu.models.fuse import _fuse as jfuse
from yolo_re_tpu.ops.nms import non_max_suppression as jnms
from yolo_re_tpu.ops.pallas.adown_kernel import (
    adown_from_packed,
    build_adown_kernel_weights,
)
from yolo_re_tpu.ops.pallas.nms_kernel import pallas_nms_select
from yolo_re_tpu.ops.pallas.stem_kernel import (
    build_stem_kernel_weights,
    stem_conv as jstem_conv,
)
from yolo_re_tpu_torch.data.device_pipeline import batched_letterbox
from yolo_re_tpu_torch.ops.kernels import adown, nms, stem
from yolo_re_tpu_torch.ops.nms import MAX_WH, non_max_suppression

# the JAX package's tolerance for these kernels in f32 (test_blocks.py:208)
KERNEL_ATOL = 2e-5
IOU_THRES = 0.45


def _cl(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (the same bytes)."""
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _vec(b) -> torch.Tensor:
    return torch.from_numpy(np.array(b, np.float32))


def _perturbed_fused(block, cfg, seed):
    params, stats = jax.device_get(block.init(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda s: np.asarray(s) + rng.uniform(0, 0.3, np.shape(s))
        .astype(np.float32), stats)
    return jfuse(block, cfg, params, stats)


# ---------------------------------------------------------------------------
# stem
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stem_weights():
    fp, _ = _perturbed_fused(JB.Conv, JB.ConvConfig(3, 64, 3, 2), 3)
    return fp


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 24, 40, 3),
                                   (1, 64, 32, 3)])
def test_stem_plain_matches_pallas_stem(shape, stem_weights):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    ref = jstem_conv(jnp.asarray(x), build_stem_kernel_weights(stem_weights),
                     interpret=True)
    before = stem.launches
    y = stem.stem_conv(_cl(x), _oihw(stem_weights["w"]),
                       _vec(stem_weights["b"]))
    assert stem.launches == before          # CPU: the plain version ran
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=KERNEL_ATOL)


def test_stem_plain_odd_sizes_match_fused_conv(stem_weights):
    """Odd H, W (ceil(H/2) outputs, zero padding on all sides) against the
    JAX package's plain fused Conv."""
    x = np.random.default_rng(5).standard_normal((1, 25, 31, 3)) \
        .astype(np.float32)
    ref, _ = JB.Conv.apply(JB.ConvConfig(3, 64, 3, 2), stem_weights, {},
                           jnp.asarray(x))
    y = stem.stem_conv(_cl(x), _oihw(stem_weights["w"]),
                       _vec(stem_weights["b"]))
    assert y.shape == (1, 64, 13, 16)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=KERNEL_ATOL)


# ---------------------------------------------------------------------------
# ADown
# ---------------------------------------------------------------------------

def _adown_args(fp):
    cs, cp = fp["conv_stride"], fp["conv_pool"]
    return _oihw(cs["w"]), _vec(cs["b"]), _oihw(cp["w"]), _vec(cp["b"])


@pytest.fixture(scope="module")
def adown256():
    fp, _ = _perturbed_fused(JB.ADown, JB.ADownConfig(256, 256), 1)
    return fp


@pytest.mark.parametrize("hw", [(16, 16), (8, 24), (48, 16)])
def test_adown_plain_matches_pallas_adown(hw, adown256):
    h, w = hw
    x = np.random.default_rng(2).standard_normal((2, h, w, 256)) \
        .astype(np.float32)
    ref = adown_from_packed(jnp.asarray(x).reshape(2, h, w // 2, 512),
                            build_adown_kernel_weights(adown256, jnp.float32),
                            interpret=True)
    before = adown.launches
    y = adown.adown(_cl(x), *_adown_args(adown256))
    assert adown.launches == before
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=KERNEL_ATOL)


@pytest.mark.parametrize("cin,cout,hw", [(32, 32, (40, 40)),
                                         (48, 48, (20, 20)),
                                         (32, 48, (9, 14)),
                                         (64, 64, (7, 5))])
def test_adown_plain_matches_jax_block(cin, cout, hw):
    cfg = JB.ADownConfig(cin, cout)
    fp, fs = _perturbed_fused(JB.ADown, cfg, 6)
    x = np.random.default_rng(7).standard_normal((2, *hw, cin)) \
        .astype(np.float32)
    ref, _ = JB.ADown.apply(cfg, fp, fs, jnp.asarray(x))
    y = adown.adown(_cl(x), *_adown_args(fp))
    assert y.shape == (2, cout, hw[0] // 2, hw[1] // 2)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), atol=KERNEL_ATOL)


# the packed weight images of the ADown kernels (csrc/adown.cu)
ADOWN_WIDTHS = [(128, 128), (256, 256), (16, 16), (24, 24)]


def _adown_packed_index(co, ch, taps):
    """Element of w[o, i, tap] in the packed image, by the formula of
    csrc/hopper.cuh: packed_index (numpy, independent of the wrapper)."""
    ks = -(-ch // 16)
    n = 128 if co <= 128 else -(-co // 256) * 256
    o, i, t = np.meshgrid(np.arange(co), np.arange(ch), np.arange(taps),
                          indexing="ij")
    return ((t * ks + i // 16) * (16 * n) + (o // 8) * 128
            + (i // 8) % 2 * 64 + (o % 8) * 8 + i % 8), 16 * ks * n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ch,co", ADOWN_WIDTHS,
                         ids=[f"{c}to{o}" for c, o in ADOWN_WIDTHS])
def test_adown_packed_weights_round_trip(ch, co, dtype):
    """gelan-c's branch widths (128, 256) and TINY_YAML's (16, 24): pack ->
    unpack gives the OIHW weights back; every weight sits where the
    kernels' index arithmetic reads it, and the padding is zero."""
    rng = np.random.default_rng(ch + co)
    w1 = torch.from_numpy(rng.standard_normal((co, ch, 3, 3))
                          .astype(np.float32)).to(dtype)
    w2 = torch.from_numpy(rng.standard_normal((co, ch, 1, 1))
                          .astype(np.float32)).to(dtype)
    before = adown.pack_launches
    w1p, w2p = adown.pack_weights(w1, w2)
    assert adown.pack_launches == before        # CPU: the plain version
    k, n = adown.packed_sizes(ch, co)
    assert w1p.shape == (9 * k * n,) and w2p.shape == (k * n,)
    assert w1p.dtype == w2p.dtype == dtype
    r1, r2 = adown.unpack_weights(w1p, w2p, ch, co)
    assert torch.equal(r1, w1) and torch.equal(r2, w2)
    for wp, w, taps in ((w1p, w1, 9), (w2p, w2, 1)):
        idx, per_tap = _adown_packed_index(co, ch, taps)
        flat = wp.float().numpy()
        np.testing.assert_array_equal(
            flat[idx], w.float().numpy().reshape(co, ch, taps))
        pad = np.ones(flat.size, bool)
        pad[idx.ravel()] = False
        assert flat.size == taps * per_tap and not flat[pad].any()
    # the cast the train forward's pack makes
    c1, c2 = adown.pack_weights(w1.float(), w2.float(), torch.bfloat16)
    assert torch.equal(c1, adown.pack_weights(w1.bfloat16(), w2.bfloat16())[0])
    assert torch.equal(c2, adown.pack_weights(w1.bfloat16(), w2.bfloat16())[1])


@pytest.mark.parametrize("cin,cout,hw", [(32, 32, (10, 14)),
                                         (48, 48, (9, 7)),
                                         (256, 256, (12, 16)),
                                         (512, 512, (6, 10))])
def test_adown_packed_plain_equals_adown_plain(cin, cout, hw):
    """On the CPU `adown_packed` and `adown` (which packs first) are the
    plain version, bit for bit, and so is `adown_raw` with f32 master
    weights and a bf16 x (it rounds them to bf16 as the kernel's pack
    does)."""
    rng = np.random.default_rng(cin + hw[0])
    x = _cl(rng.standard_normal((2, *hw, cin)).astype(np.float32))
    w1, w2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                               * 0.05)
              for s in ((cout // 2, cin // 2, 3, 3),
                        (cout // 2, cin // 2, 1, 1)))
    b1, b2 = (torch.from_numpy(rng.standard_normal(cout // 2)
                               .astype(np.float32)) for _ in range(2))
    ref = adown.adown_plain(x, w1, b1, w2, b2)
    w1p, w2p = adown.pack_weights(w1, w2)
    before = adown.launches
    assert torch.equal(adown.adown_packed(x, w1p, b1, w2p, b2), ref)
    assert torch.equal(adown.adown(x, w1, b1, w2, b2), ref)
    assert adown.launches == before
    xb = x.bfloat16()
    assert torch.equal(adown.adown_raw(xb, w1, w2),
                       adown.adown_raw_plain(xb, w1.bfloat16(),
                                             w2.bfloat16()))


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _xyxy(b):
    return np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2],
                          axis=1)


def _iou_matrix(xyxy):
    x = xyxy.astype(np.float64)
    lt = np.maximum(x[:, None, :2], x[None, :, :2])
    rb = np.minimum(x[:, None, 2:], x[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / (area[:, None] + area[None] - inter)


def _nms_predictions(seed, batch=2, anchors=600, nc=3, ties=False):
    """(B, A, 4+nc) decoded predictions: clustered boxes (so suppression
    happens), no same-class pair within 1e-4 of the IoU threshold, and with
    ties=True scores rounded to bf16 so that equal scores are common."""
    rng = np.random.default_rng(seed)
    preds = []
    for _ in range(batch):
        centers = rng.uniform(60, 580, (30, 2))
        xy = centers[rng.integers(0, 30, anchors)] + \
            rng.normal(0, 8, (anchors, 2))
        wh = rng.uniform(20, 70, (anchors, 2))
        boxes = np.concatenate([xy, wh], axis=1).astype(np.float32)
        scores = rng.uniform(0, 1, (anchors, nc)).astype(np.float32)
        if ties:
            scores = torch.from_numpy(scores).to(torch.bfloat16).float() \
                .numpy()
        cls = scores.argmax(1)
        near = np.abs(_iou_matrix(_xyxy(boxes)) - IOU_THRES) < 1e-4
        near &= cls[:, None] == cls[None, :]
        np.fill_diagonal(near, False)
        scores[np.triu(near).any(axis=1)] = 0.0   # drop one box of each pair
        preds.append(np.concatenate([boxes, scores], axis=1))
    return np.stack(preds)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "bf16_ties"])
def test_nms_select_plain_matches_pallas_select(ties):
    pred = _nms_predictions(11, ties=ties)
    conf, cls = pred[..., 4:].max(-1), pred[..., 4:].argmax(-1)
    conf = np.where(conf > 0.25, conf, 0.0).astype(np.float32)
    boxes_off = (_xyxy(pred.reshape(-1, 7)[:, :4]).reshape(2, -1, 4)
                 + (cls * MAX_WH)[..., None]).astype(np.float32)
    ref = pallas_nms_select(jnp.asarray(boxes_off), jnp.asarray(conf),
                            iou_thres=IOU_THRES, max_det=300)
    before = nms.launches
    idx = nms.nms_select(torch.from_numpy(boxes_off),
                         torch.from_numpy(conf), IOU_THRES, 300)
    assert nms.launches == before
    assert idx.dtype == torch.int32 and idx.shape == (2, 300)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    assert (idx >= 0).sum() > 20


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "bf16_ties"])
def test_nms_matches_jax(backend, ties):
    pred = _nms_predictions(12, ties=ties)
    ref = jnms(jnp.asarray(pred), conf_thres=0.25, iou_thres=IOU_THRES,
               max_det=300, backend=backend)
    out = non_max_suppression(torch.from_numpy(pred), conf_thres=0.25,
                              iou_thres=IOU_THRES, max_det=300)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]),
                               atol=1e-5)
    np.testing.assert_array_equal(out["scores"].numpy(),
                                  np.asarray(ref["scores"]))
    assert out["valid"].sum() > 20


def test_nms_classes_filter_and_agnostic_match_jax():
    pred = _nms_predictions(13, batch=1)
    for kw in ({"classes": (0, 2)}, {"agnostic": True}):
        ref = jnms(jnp.asarray(pred), conf_thres=0.3, iou_thres=IOU_THRES,
                   max_det=50, backend="xla", **kw)
        out = non_max_suppression(torch.from_numpy(pred), conf_thres=0.3,
                                  iou_thres=IOU_THRES, max_det=50, **kw)
        for k in ("valid", "classes"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


# ---------------------------------------------------------------------------
# letterbox
# ---------------------------------------------------------------------------

def test_batched_letterbox_matches_jax():
    imgs = np.random.default_rng(8).integers(0, 256, (2, 120, 200, 3),
                                             dtype=np.uint8)
    ref = jletterbox(jnp.asarray(imgs), 160)
    y = batched_letterbox(torch.from_numpy(imgs), 160)
    assert y.shape == (2, 160, 160, 3) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-6)


# ---------------------------------------------------------------------------
# wrapper argument checks (the same on every device)
# ---------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 3, 8, 8)
    w, b = torch.zeros(16, 3, 3, 3), torch.zeros(16)
    with pytest.raises(ValueError, match="channels_last"):
        stem.stem_conv(x.contiguous(), w, b)      # NCHW-contiguous
    xc = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="dtype"):
        stem.stem_conv(xc.half(), w.half(), b.half())
    with pytest.raises(ValueError, match="multiple of 16"):
        stem.stem_conv(xc, torch.zeros(12, 3, 3, 3), torch.zeros(12))
    with pytest.raises(ValueError, match="float32"):
        stem.stem_conv(xc, w.bfloat16(), b)
    xa = torch.zeros(1, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="w1"):
        adown.adown(xa, torch.zeros(4, 8, 3, 3), torch.zeros(4),
                    torch.zeros(4, 4, 1, 1), torch.zeros(4))
    with pytest.raises(ValueError, match="even Cin"):
        adown.adown(torch.zeros(1, 7, 6, 6).contiguous(
            memory_format=torch.channels_last), torch.zeros(4, 3, 3, 3),
            torch.zeros(4), torch.zeros(4, 3, 1, 1), torch.zeros(4))
    w1p, w2p = adown.pack_weights(torch.zeros(4, 4, 3, 3),
                                  torch.zeros(4, 4, 1, 1))
    with pytest.raises(ValueError, match="packed image"):
        adown.adown_packed(xa, w1p[:-8], torch.zeros(4), w2p, torch.zeros(4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        adown.pack_weights(torch.zeros(4, 4, 3, 3), torch.zeros(4, 4, 1, 1),
                           torch.float16)
    with pytest.raises(ValueError, match="K must be"):
        nms.nms_select(torch.zeros(1, nms.MAX_K + 1, 4),
                       torch.zeros(1, nms.MAX_K + 1), 0.45, 10)
    with pytest.raises(TypeError, match="float32"):
        nms.nms_select(torch.zeros(1, 4, 4).double(),
                       torch.zeros(1, 4).double(), 0.45, 10)


def test_profile_launches_needs_a_card(monkeypatch, capsys):
    """The launch profiler measures device time only: without a card it
    exits with 2 and prints no timing."""
    from yolo_re_tpu_torch.cli import profile_launches

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["train"], ["train", "f32"], ["eval"], ["eval", "bf16"],
                 ["roof"], ["other"], ["train", "yolov9-c"],
                 ["eval", "bf16", "yolov9-c"], ["train", "f32", "gelan-c"],
                 ["train", "nomodel"], ["eval", "f32"], ["roof", "yolov9-c"],
                 ["train", "aug"], ["train", "f32", "aug", "gelan-c"],
                 ["augment"], ["augment", "f32"], ["bn"], ["bn", "f32"],
                 ["bn", "gelan-c"]):
        assert profile_launches.main(argv) == 2
    assert profile_launches.parse(["train", "f32", "yolov9-c"]) == \
        ("train", "f32", False, "yolov9-c")
    assert profile_launches.parse(["train", "f32", "aug"]) == \
        ("train", "f32", True, "gelan-c")
    assert profile_launches.parse(["eval"]) == ("eval", "", False, "gelan-c")
    assert profile_launches.parse(["augment", "f32"]) == \
        ("augment", "f32", False, "")
    assert profile_launches.parse(["bn"]) == ("bn", "", False, "yolov9-c")
    assert profile_launches.parse(["bn", "f32", "gelan-c"]) == \
        ("bn", "f32", False, "gelan-c")
    for bad in (["bn", "bf16"], ["bn", "aug"], ["train", "nomodel"], ["eval", "f32"], ["roof", "x"],
                ["eval", "bf16", "yolov9-c", "x"], ["eval", "aug"],
                ["train", "aug", "f32"], ["augment", "gelan-c"],
                ["augment", "bf16"]):
        assert profile_launches.parse(bad) is None
    assert "ms" not in capsys.readouterr().out
