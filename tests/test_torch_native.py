"""The port's native host runtime (yolo_re_tpu_torch/utils/native.py and
csrc/host/yolo_host.cpp) on the CPU: tests/test_native.py's cases against
cv2 at its bounds, each function's output equal to the JAX package's
library on the same inputs, the loader's and Mosaic's native dispatch
against the JAX package's and against the port's own cv2 path, and the
build: a fresh build directory, concurrent first use, and
YOLO_TPU_NATIVE=1 without a compiler.
"""

import os
import sys
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest

from yolo_re_tpu.data.config import AugmentConfig as JAugmentConfig
from yolo_re_tpu.data.config import DataConfig as JDataConfig
from yolo_re_tpu.data.dataset import YOLODataset as JYOLODataset
from yolo_re_tpu.data.dataset import create_dataloader as jcreate_dataloader
from yolo_re_tpu.data.transforms import Mosaic as JMosaic
from yolo_re_tpu.data.transforms import Sample as JSample
from yolo_re_tpu.utils import native as jnative
from yolo_re_tpu_torch.data.augment import letterbox
from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
from yolo_re_tpu_torch.data.dataset import YOLODataset, create_dataloader
from yolo_re_tpu_torch.data.transforms import Mosaic, Sample
from yolo_re_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parent.parent
JAX_LIB = ROOT / "native" / "libyolo_host.so"
needs_jax_lib = pytest.mark.skipif(
    not JAX_LIB.exists(),
    reason="native/libyolo_host.so (the JAX package's build, `make -C "
           "native`) is absent")


def _img(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)


def test_source_copy_is_byte_equal():
    assert native.SOURCE.read_bytes() == \
        (ROOT / "native" / "yolo_host.cpp").read_bytes()


def test_library_builds_and_loads():
    assert native.available()
    lib = native.build()
    assert lib.parent.parent == native.BUILD_DIR
    assert lib.name == native.LIB_NAME


# ---------------------------------------------------------------------------
# tests/test_native.py's cases against cv2, at its bounds
# ---------------------------------------------------------------------------

def test_resize_matches_cv2():
    img = _img(0, 100, 160)
    ours = native.resize_bilinear(img, 50, 80)
    ref = cv2.resize(img, (80, 50), interpolation=cv2.INTER_LINEAR)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_letterbox_matches_python(monkeypatch):
    monkeypatch.setenv("YOLO_TPU_NATIVE", "0")
    img = _img(1, 100, 200)
    out_n, ratio_n, pad_n = native.letterbox(img, 640, 640)
    out_p, ratio_p, pad_p = letterbox(img, 640)
    assert out_n.shape == out_p.shape
    np.testing.assert_allclose(ratio_n, ratio_p, rtol=1e-6)
    np.testing.assert_allclose(pad_n, pad_p, atol=1e-5)
    assert np.abs(out_n.astype(int) - out_p.astype(int)).max() <= 2


BLITS = [(10, 20, 50, 80, 0, 0), (90, 95, 100, 100, 5, 7),
         (100, 100, 100, 100, 0, 0)]


def test_blit_matches_numpy():
    src = _img(3, 40, 60)
    c1 = np.full((100, 100, 3), 114, np.uint8)
    c2 = c1.copy()
    # interior tile, edge-clipped tile, and a fully out-of-bounds tile
    for (y1a, x1a, y2a, x2a, y1b, x1b) in BLITS:
        native.blit(c1, src, y1a, x1a, y2a, x2a, y1b, x1b)
        c2[y1a:y2a, x1a:x2a] = src[y1b:y1b + (y2a - y1a),
                                   x1b:x1b + (x2a - x1a)]
    np.testing.assert_array_equal(c1, c2)


HOSTILE = [(-5, 0, 5, 8, 0, 0),      # negative dest row origin
           (0, -3, 8, 5, 0, 0),      # negative dest col origin
           (0, 0, 8, 8, -2, -2),     # negative src origin
           (0, 0, 20, 20, 0, 0),     # rect bigger than src
           (2, 2, 10, 10, 6, 6)]     # src exhausted before dest rect


@pytest.mark.parametrize("args", HOSTILE)
def test_blit_hostile_args_cannot_escape_buffers(args):
    """Both rect origins clamped and the extent bounded by the source:
    the numpy oracle intersects the shifted rects with both buffers."""
    src = _img(4, 8, 8)
    y1a, x1a, y2a, x2a, y1b, x1b = args
    canvas = np.full((10, 10, 3), 114, np.uint8)
    expect = canvas.copy()
    dy0, dx0, sy0, sx0 = y1a, x1a, y1b, x1b
    if dy0 < 0:
        sy0, dy0 = sy0 - dy0, 0
    if dx0 < 0:
        sx0, dx0 = sx0 - dx0, 0
    if sy0 < 0:
        dy0, sy0 = dy0 - sy0, 0
    if sx0 < 0:
        dx0, sx0 = dx0 - sx0, 0
    rows = min(min(y2a, 10) - dy0, 8 - sy0)
    cols = min(min(x2a, 10) - dx0, 8 - sx0)
    if rows > 0 and cols > 0:
        expect[dy0:dy0 + rows, dx0:dx0 + cols] = \
            src[sy0:sy0 + rows, sx0:sx0 + cols]
    native.blit(canvas, src, *args)
    np.testing.assert_array_equal(canvas, expect)


def test_hsv_identity_gains():
    img = _img(2, 16, 16)
    orig = img.copy()
    native.hsv_augment(img, 1.0, 1.0, 1.0)
    # BGR -> HSV -> BGR round trip: small quantization drift only
    assert np.abs(img.astype(int) - orig.astype(int)).max() <= 6


# ---------------------------------------------------------------------------
# the port's build against the JAX package's library, bit for bit
# ---------------------------------------------------------------------------

def _resize(m):
    return [m.resize_bilinear(_img(5, 97, 131), 61, 200),
            m.resize_bilinear(_img(12, 40, 30), 120, 90)]


def _letterbox(m):
    out = []
    for img, (h, w), up in ((_img(6, 100, 200), (640, 640), True),
                            (_img(7, 333, 120), (160, 96), True),
                            (_img(8, 50, 70), (128, 128), False)):
        canvas, ratio, pad = m.letterbox(img, h, w, scaleup=up)
        out += [canvas, np.array(ratio), np.array(pad)]
    return out


def _blit(m):
    out = []
    src = _img(9, 40, 60)
    for args in BLITS + HOSTILE:
        canvas = np.full((100, 100, 3), 114, np.uint8)
        m.blit(canvas, src, *args)
        out.append(canvas)
    return out


def _hsv(m):
    return [m.hsv_augment(_img(10, 48, 64), *gains)
            for gains in ((1.0, 1.0, 1.0), (1.3, 0.6, 1.4), (0.7, 1.5, 0.5))]


@needs_jax_lib
@pytest.mark.parametrize("fn", [_resize, _letterbox, _blit, _hsv],
                         ids=["resize", "letterbox", "blit", "hsv"])
def test_functions_equal_the_jax_library(fn):
    assert jnative.available()
    got, ref = fn(native), fn(jnative)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the loader's dispatch
# ---------------------------------------------------------------------------

def _train_batch(create, data_cls, aug_cls, path):
    data = data_cls(train_path=path, num_classes=8, img_size=64,
                    batch_size=4, workers=2, max_boxes=16,
                    augment=aug_cls("full"))
    loader = create(path, data, "train")
    loader.set_epoch(0)
    return next(iter(loader))


@needs_jax_lib
def test_loader_native_dispatch_matches_jax_and_cv2(synthetic_dataset,
                                                    monkeypatch):
    """Under YOLO_TPU_NATIVE=1 the port's train batch (the dataset's
    resize, Mosaic, letterbox and HSV through the C++ kernels) equals the
    JAX loader's under the same switch, and stays within
    tests/test_native.py's bounds of the port's own cv2 batch (per-kernel
    drift of 1-2 LSB compounds through resize -> warp -> HSV)."""
    monkeypatch.setenv("YOLO_TPU_NATIVE", "1")
    nat = _train_batch(create_dataloader, DataConfig, AugmentConfig,
                       synthetic_dataset)
    ref = _train_batch(jcreate_dataloader, JDataConfig, JAugmentConfig,
                       synthetic_dataset)
    assert nat.keys() == ref.keys()
    for k in nat:
        np.testing.assert_array_equal(nat[k], ref[k], err_msg=k)
    monkeypatch.setenv("YOLO_TPU_NATIVE", "0")
    cv = _train_batch(create_dataloader, DataConfig, AugmentConfig,
                      synthetic_dataset)
    np.testing.assert_array_equal(cv["targets"], nat["targets"])
    diff = np.abs(cv["images"] - nat["images"])
    assert diff.max() <= 12.5 / 255.0, f"max pixel diff {diff.max()}"
    assert diff.mean() <= 1.0 / 255.0, f"mean pixel diff {diff.mean()}"
    assert diff.max() > 0     # the two paths really differ


@needs_jax_lib
def test_mosaic_native_dispatch(synthetic_dataset, monkeypatch):
    """Mosaic's tile resize and blit under YOLO_TPU_NATIVE=1: the canvas
    equals the JAX Mosaic's under the same switch, and the port's cv2
    canvas within resize rounding (same geometry and labels)."""
    def run(mosaic_cls, sample_cls, ds_cls, mode):
        monkeypatch.setenv("YOLO_TPU_NATIVE", mode)
        ds = ds_cls(synthetic_dataset, img_size=64)
        img, labels, shape = ds.load_raw(0)
        mosaic = mosaic_cls(ds, img_size=64, prob=1.0)
        return mosaic(sample_cls(img.copy(), labels.copy(), 64, shape),
                      np.random.default_rng(7))

    nat = run(Mosaic, Sample, YOLODataset, "1")
    ref = run(JMosaic, JSample, JYOLODataset, "1")
    np.testing.assert_array_equal(nat.img, ref.img)
    np.testing.assert_array_equal(nat.labels, ref.labels)
    cv = run(Mosaic, Sample, YOLODataset, "0")
    np.testing.assert_array_equal(cv.labels, nat.labels)
    assert np.abs(cv.img.astype(int) - nat.img.astype(int)).max() <= 2


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_native_1_without_a_compiler_raises(tmp_path, monkeypatch):
    """A fresh build directory and a CXX that does not exist: "1" raises
    naming the compiler, "auto" and "0" fall to cv2, and nothing is left
    in the build directory but the empty key directory."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setenv("YOLO_TPU_NATIVE", "1")
    with pytest.raises(RuntimeError, match="no-such-c"):
        native.enabled()
    with pytest.raises(RuntimeError, match="did not build"):
        native.resize_bilinear(_img(0, 8, 8), 4, 4)
    assert not native.available()
    monkeypatch.setenv("YOLO_TPU_NATIVE", "auto")
    assert native.enabled() is False
    monkeypatch.setenv("YOLO_TPU_NATIVE", "0")
    assert native.enabled() is False
    assert not list(tmp_path.rglob("*.so"))


def test_failed_compile_raises_with_the_compilers_output(tmp_path,
                                                          monkeypatch):
    """A compiler that runs and fails: its stderr is in the error."""
    cxx = tmp_path / "bad-cxx"
    cxx.write_text("#!/bin/sh\necho 'fatal: refusing to compile' >&2\n"
                   "exit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setenv("YOLO_TPU_NATIVE", "1")
    with pytest.raises(RuntimeError, match="refusing to compile"):
        native.enabled()


def test_concurrent_first_use_builds_once(tmp_path, monkeypatch):
    """More threads than cores ask for the library at once, in a fresh
    build directory, with a short switch interval: one library, loaded
    once, renamed into place with no temporary left behind, and it gives
    the shared build's output."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    got = []
    threads = [threading.Thread(target=lambda: got.append(native._lib()))
               for _ in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == len(threads) and all(g is got[0] for g in got)
    assert not isinstance(got[0], RuntimeError), got[0]
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert [p.name for p in files] == [native.LIB_NAME]
    img = _img(11, 30, 50)
    fresh = native.resize_bilinear(img, 20, 70)
    monkeypatch.undo()
    assert np.array_equal(fresh, native.resize_bilinear(img, 20, 70))


def test_wrong_buffers_raise():
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.blit(np.zeros((10, 10, 3), np.float32), _img(0, 4, 4),
                    0, 0, 4, 4, 0, 0)
    with pytest.raises(ValueError, match="in place"):
        native.hsv_augment(_img(0, 8, 16)[:, ::2], 1.0, 1.0, 1.0)
