"""The port's train input path held against the JAX package on the CPU.

Device augmentation (yolo_re_tpu_torch/data/device_pipeline.py): the JAX
functions draw from `jax.random` keys, the port's apply draws handed over
as tensors. `_mosaic_draws` and its siblings mirror each JAX function's key
splits on the same key, so the port applies exactly what JAX drew; the
outputs are then held to JAX's on the same inputs. Tolerances: f32 fast
path, HSV, flips, mixup and compaction 1e-6 abs (images in [0, 1], targets
normalized); the general (gather) warp 1e-4 abs, since a floor can flip at
an integer coordinate; bf16 images within one bf16 ulp of |ref| (rtol
2^-7); keep masks and valid-box counts equal. A few cases hold the general
warp against the port's host cv2 path (data/augment.py), as
tests/test_device_pipeline.py does for JAX.

The Trainer: device_augment=True / "full" on on-disk data, one augmented
step against the JAX Trainer's with the draws of fold_in(key(seed + 1),
step) injected, draws across a checkpoint resume, and the one-batch-ahead
copy (`_prefetched`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.data import device_pipeline as J
from yolo_re_tpu.data.config import AugmentConfig as JAugmentConfig
from yolo_re_tpu.data.config import DataConfig as JDataConfig
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.train.config import TrainConfig as JTrainConfig
from yolo_re_tpu.train.trainer import Trainer as JTrainer
from yolo_re_tpu_torch.data import device_pipeline as T
from yolo_re_tpu_torch.data import synth
from yolo_re_tpu_torch.data.augment import random_perspective
from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]
FAST_ATOL = 1e-6
GENERAL_ATOL = 1e-4
BF16_RTOL = 2.0 ** -7
GENERAL = {"degrees": 10.0, "shear": 2.0, "perspective": 1e-3}


def _inputs(seed: int, b: int = 4, s: int = 32, m: int = 6):
    """Images (B, S, S, 3) of uint8 levels / 255 (ties between channels and
    gray pixels, as loader batches have), targets (B, M, 5) with 0-M boxes
    each, the valid rows first."""
    rng = np.random.default_rng(seed)
    images = (rng.integers(0, 256, (b, s, s, 3)) / 255.0).astype(np.float32)
    images[0, :4] = images[0, :4, :, :1]                # gray rows
    targets = np.zeros((b, m, 5), np.float32)
    for i in range(b):
        for j in range(int(rng.integers(0, m + 1)) if i else m):
            targets[i, j] = [rng.integers(0, 4), *rng.uniform(0.2, 0.8, 2),
                             *rng.uniform(0.05, 0.45, 2)]
    return images, targets


def _both(images: np.ndarray, targets: np.ndarray, dtype):
    """(torch images, torch targets, jax images, jax targets)."""
    return (torch.from_numpy(images).to(dtype), torch.from_numpy(targets),
            jnp.asarray(images).astype(JDT[dtype]), jnp.asarray(targets))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, dtype, atol: float) -> None:
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=rtol)


def _same_boxes(got, ref, atol: float) -> None:
    """Targets: the valid rows equal in number and place, values close."""
    g, r = _np(got), _np(ref)
    np.testing.assert_array_equal(g[..., 3] > 0, r[..., 3] > 0)
    np.testing.assert_allclose(g, r, atol=atol)


def _torch(draws: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


# ---------------------------------------------------------------------------
# the JAX functions' key splits, mirrored
# ---------------------------------------------------------------------------

def _mosaic_draws(key, b, s, *, scale=0.9, translate=0.1, degrees=0.0,
                  shear=0.0, perspective=0.0, mosaic_p=1.0):
    """mosaic_affine (and _compose_warp_matrices on its fifth key)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    ka, ksx, ksy, kpx, kpy = jax.random.split(k5, 5)

    def u(k, shape, lo, hi):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    return {"partner": jax.random.randint(k1, (b, 3), 0, b),
            "zoom": u(k2, (b,), max(1.0 - scale, 0.1), 1.0 + scale),
            "shift": u(k3, (b, 2), 0.5 - translate, 0.5 + translate) * s,
            "mosaic": jax.random.uniform(k4, (b,)) < mosaic_p,
            "angle": u(ka, (b,), -degrees, degrees),
            "shear": jnp.stack([u(ksx, (b,), -shear, shear),
                                u(ksy, (b,), -shear, shear)], -1),
            "persp": jnp.stack([u(kpx, (b,), -perspective, perspective),
                                u(kpy, (b,), -perspective, perspective)], -1)}


def _mixup_draws(key, b, p=0.15):
    k1, k2 = jax.random.split(key)
    return {"mixup_r": jax.random.beta(k1, 32.0, 32.0, (b,))
            .astype(jnp.float32),
            "mixup": jax.random.uniform(k2, (b,)) < p}


def _batch_draws(key, b, *, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, flip_lr=0.5,
                 flip_ud=0.0):
    """augment_batch: hsv_jitter's gains, random_flip's masks."""
    k_hsv, k_flip = jax.random.split(key)
    k_lr, k_ud = jax.random.split(k_flip)
    gains = jnp.asarray([hsv_h, hsv_s, hsv_v], jnp.float32)
    return {"hsv": jax.random.uniform(k_hsv, (b, 3), minval=-1.0,
                                      maxval=1.0) * gains + 1.0,
            "flip_lr": jax.random.uniform(k_lr, (b,)) < flip_lr,
            "flip_ud": jax.random.uniform(k_ud, (b,)) < flip_ud}


def _full_draws(key, b, s, *, scale=0.9, translate=0.1, degrees=0.0,
                shear=0.0, perspective=0.0, mosaic_p=1.0, mixup_p=0.15,
                **batch_hyps):
    """augment_batch_full: mosaic, mixup, augment_batch on its three keys."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {**_mosaic_draws(k1, b, s, scale=scale, translate=translate,
                            degrees=degrees, shear=shear,
                            perspective=perspective, mosaic_p=mosaic_p),
            **_mixup_draws(k2, b, mixup_p),
            **_batch_draws(k3, b, **batch_hyps)}


# ---------------------------------------------------------------------------
# each function against its JAX twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_hsv_jitter_matches_jax(dtype):
    images, _ = _inputs(0)
    ti, _, ji, _ = _both(images, np.zeros((4, 1, 5), np.float32), dtype)
    key = jax.random.key(3)
    ref = J.hsv_jitter(ji, key, 0.015, 0.7, 0.4)
    # hsv_jitter draws on its key (augment_batch hands it a split)
    gains = jax.random.uniform(key, (4, 3), minval=-1.0, maxval=1.0) \
        * jnp.asarray([0.015, 0.7, 0.4], jnp.float32) + 1.0
    got = T.hsv_jitter(ti, torch.from_numpy(np.array(gains)))
    assert got.dtype == dtype
    _close(got, ref, dtype, FAST_ATOL)
    hsv = T._rgb_to_hsv(ti.float())
    np.testing.assert_allclose(hsv.numpy(), np.asarray(
        J._rgb_to_hsv(ji.astype(jnp.float32))), atol=FAST_ATOL)
    np.testing.assert_allclose(T._hsv_to_rgb(hsv).numpy(), np.asarray(
        J._hsv_to_rgb(jnp.asarray(hsv.numpy()))), atol=FAST_ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_random_flip_matches_jax(dtype):
    images, targets = _inputs(1)
    ti, tt, ji, jt = _both(images, targets, dtype)
    key = jax.random.key(4)
    ref_i, ref_t = J.random_flip(ji, jt, key, flip_lr=0.5, flip_ud=0.5)
    k_lr, k_ud = jax.random.split(key)
    do_lr = jax.random.uniform(k_lr, (4,)) < 0.5
    do_ud = jax.random.uniform(k_ud, (4,)) < 0.5
    assert 0 < int(do_lr.sum()) < 4 or 0 < int(do_ud.sum()) < 4
    got_i, got_t = T.random_flip(ti, tt, torch.from_numpy(np.array(do_lr)),
                                 torch.from_numpy(np.array(do_ud)))
    _close(got_i, ref_i, dtype, 0.0)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))


def test_affine_weights_and_warp_matrices_match_jax():
    rng = np.random.default_rng(2)
    src = rng.uniform(-5, 70, (3, 32)).astype(np.float32)
    np.testing.assert_allclose(
        T._affine_weights(torch.from_numpy(src), 64).numpy(),
        np.asarray(J._affine_weights(jnp.asarray(src), 64)), atol=FAST_ATOL)
    key = jax.random.key(5)
    d = _mosaic_draws(key, 3, 32, **GENERAL)
    ref = J._compose_warp_matrices(jax.random.split(key, 5)[4], d["zoom"],
                                   d["shift"], 64, **GENERAL)
    t = _torch(d)
    got = T._compose_warp_matrices(t["zoom"], t["shift"], 64, t["angle"],
                                   t["shear"], t["persp"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)


def _warp_matrix(seed: int, s: int, perspective: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return _host_matrix(rng, (2 * s, 2 * s), (s, s), degrees=10.0, scale=0.5,
                        shear=2.0, perspective=perspective, translate=0.1)[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("perspective", [0.0, 5e-4])
def test_warp_perspective_and_boxes_match_jax(perspective, dtype):
    s = 32
    canvas, targets = _inputs(6, b=2, s=2 * s)
    M = np.stack([_warp_matrix(7, s, perspective),
                  _warp_matrix(8, s, perspective)]).astype(np.float32)
    tc, _, jc, _ = _both(canvas, targets, dtype)
    use = perspective > 0
    ref = J.warp_perspective(jc, jnp.asarray(M), s, use_perspective=use)
    got = T.warp_perspective(tc, torch.from_numpy(M), s, use_perspective=use)
    assert got.dtype == dtype
    _close(got, ref, dtype, GENERAL_ATOL)
    boxes = [targets[..., k] * 2 * s for k in range(1, 5)]
    ref_b = J.warp_boxes(jnp.asarray(M), *map(jnp.asarray, boxes), s,
                         use_perspective=use)
    got_b = T.warp_boxes(torch.from_numpy(M), *map(torch.from_numpy, boxes),
                         s, use_perspective=use)
    for g, r in zip(got_b, ref_b):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=GENERAL_ATOL)


MOSAIC_CASES = {"fast": {}, "fast_p0.5": {"mosaic_p": 0.5},
                "general": GENERAL}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(MOSAIC_CASES))
def test_mosaic_affine_matches_jax(case, dtype):
    hyps = MOSAIC_CASES[case]
    images, targets = _inputs(9)
    ti, tt, ji, jt = _both(images, targets, dtype)
    key = jax.random.key(10)
    ref_i, ref_t = J.mosaic_affine(ji, jt, key, **hyps)
    d = _mosaic_draws(key, 4, 32, **hyps)
    if "mosaic_p" in hyps:
        assert 0 < int(d["mosaic"].sum()) < 4
    got_i, got_t = T.mosaic_affine(ti, tt, _torch(d), **hyps)
    assert got_i.dtype == dtype and got_t.shape == (4, 24, 5)
    atol = GENERAL_ATOL if case == "general" else FAST_ATOL
    _close(got_i, ref_i, dtype, atol)
    _same_boxes(got_t, ref_t, atol)
    assert int((got_t[..., 3] > 0).sum()) > 4


@pytest.mark.parametrize("perspective", [0.0, 1e-9])
def test_mosaic_area_threshold_relaxes_under_perspective(perspective):
    """Identity zoom, centered shift (the output is the canvas center),
    the image its own partner: the box's copies in the left tiles are cut
    to ~3% of their area, kept under perspective (area threshold 0.01)
    and dropped without (0.1); those in the right tiles are kept either
    way. The same in both packages."""
    s = 128
    images = np.full((1, s, s, 3), 0.5, np.float32)
    targets = np.array([[[1, 0.29, 0.5, 0.48, 0.4]]], np.float32)
    ti, tt, ji, jt = _both(images, targets, torch.float32)
    fixed = {"partner": np.zeros((1, 3), np.int32),
             "zoom": np.ones(1, np.float32),
             "shift": np.full((1, 2), s / 2, np.float32)}
    key = jax.random.key(18)
    _, ref_t = J.mosaic_affine(
        ji, jt, key, partner_idx=jnp.asarray(fixed["partner"]),
        zoom=jnp.asarray(fixed["zoom"]), shift=jnp.asarray(fixed["shift"]),
        perspective=perspective)
    d = {**_mosaic_draws(key, 1, s, perspective=perspective), **fixed}
    _, got_t = T.mosaic_affine(ti, tt, _torch(d), perspective=perspective)
    _same_boxes(got_t, ref_t, GENERAL_ATOL)
    widths = sorted(got_t[0, :, 3].tolist(), reverse=True)
    slivers = [0.03, 0.03] if perspective else [0.0, 0.0]
    np.testing.assert_allclose(widths, [0.45, 0.45] + slivers, atol=1e-5)


def test_cap_targets_matches_jax_with_gaps():
    """Valid rows scattered among padding rows: a stable sort keeps their
    order (ties keep the lower index), then the cap cuts."""
    rng = np.random.default_rng(11)
    t = rng.uniform(0.1, 0.5, (3, 12, 5)).astype(np.float32)
    t[rng.random((3, 12)) < 0.5, 3:] = 0.0
    for cap in (4, 12):
        np.testing.assert_array_equal(
            T.cap_targets(torch.from_numpy(t), cap).numpy(),
            np.asarray(J.cap_targets(jnp.asarray(t), cap)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mixup_matches_jax(dtype):
    images, targets = _inputs(12)
    ti, tt, ji, jt = _both(images, targets, dtype)
    key = jax.random.key(13)
    ref_i, ref_t = J.mixup(ji, jt, key, p=0.5)
    d = _torch(_mixup_draws(key, 4, 0.5))
    assert 0 < int(d["mixup"].sum()) < 4
    got_i, got_t = T.mixup(ti, tt, d["mixup_r"], d["mixup"])
    _close(got_i, ref_i, dtype, FAST_ATOL)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))


@pytest.mark.parametrize("dtype", DTYPES)
def test_augment_batch_matches_jax(dtype):
    images, targets = _inputs(14)
    ti, tt, ji, jt = _both(images, targets, dtype)
    key = jax.random.key(15)
    hyps = {"flip_lr": 0.5, "flip_ud": 0.5}
    ref_i, ref_t = J.augment_batch(ji, jt, key, **hyps)
    got_i, got_t = T.augment_batch(ti, tt, _torch(_batch_draws(key, 4,
                                                               **hyps)),
                                   **hyps)
    _close(got_i, ref_i, dtype, FAST_ATOL)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))


FULL_CASES = {"fast": {"mixup_p": 0.5},
              "general": {**GENERAL, "mixup_p": 0.5, "mosaic_p": 0.5}}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_augment_batch_full_matches_jax(case, dtype):
    hyps = FULL_CASES[case]
    images, targets = _inputs(16)
    ti, tt, ji, jt = _both(images, targets, dtype)
    key = jax.random.key(17)
    ref_i, ref_t = J.augment_batch_full(ji, jt, key, **hyps)
    d = _full_draws(key, 4, 32, **hyps)
    assert 0 < int(d["mixup"].sum()) < 4
    got_i, got_t = T.augment_batch_full(ti, tt, _torch(d), **hyps)
    assert got_i.dtype == dtype and got_t.shape == targets.shape
    atol = GENERAL_ATOL if case == "general" else FAST_ATOL
    _close(got_i, ref_i, dtype, atol)
    _same_boxes(got_t, ref_t, atol)


def test_draw_augment_is_a_function_of_the_generator_seed():
    """The same seed draws the same values; every draw lies in its range
    (drawn whatever the hyperparameters)."""
    kw = {"scale": 0.5, "translate": 0.1, "degrees": 10.0, "shear": 2.0,
          "perspective": 1e-3, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4}
    a = T.draw_augment(np.random.default_rng([1, 7]), 64, 640, **kw)
    b = T.draw_augment(np.random.default_rng([1, 7]), 64, 640, **kw)
    c = T.draw_augment(np.random.default_rng([1, 8]), 64, 640, **kw)
    assert a.keys() == b.keys() == c.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["zoom"], c["zoom"])
    assert a["partner"].min() >= 0 and a["partner"].max() < 64
    assert 0.5 <= a["zoom"].min() and a["zoom"].max() <= 1.5
    assert 0.4 * 640 <= a["shift"].min() and a["shift"].max() <= 0.6 * 640
    assert np.abs(a["angle"]).max() <= 10 and np.abs(a["shear"]).max() <= 2
    assert np.abs(a["persp"]).max() <= 1e-3
    assert np.all(np.abs(a["hsv"] - 1) <= [0.015, 0.7, 0.4])
    assert a["mosaic"].all() and 0 < a["mixup"].sum() < 64
    assert all(a[k].dtype == np.float32 for k in
               ("zoom", "shift", "angle", "hsv", "mixup_r"))


# ---------------------------------------------------------------------------
# the general warp against the port's host cv2 path
# ---------------------------------------------------------------------------

def _smooth_image(h, w, seed=0):
    """Low-gradient image: cv2's fixed-point bilinear and the float one
    stay close on it."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        0.5 + 0.4 * np.sin(x / 17.0 + seed) * np.cos(y / 13.0),
        0.5 + 0.4 * np.cos(x / 11.0 + 1.0) * np.sin(y / 19.0 + seed),
        0.5 + 0.4 * np.sin((x + y) / 23.0),
    ], axis=-1)
    return img.astype(np.float32)


def _host_matrix(rng, img_shape, out_hw, degrees, scale, shear, perspective,
                 translate):
    """random_perspective's M = T @ S @ R @ P @ C in the host's draw order
    (data/augment.py). Returns (M, zoom)."""
    import cv2

    height, width = out_hw
    C = np.eye(3)
    C[0, 2] = -img_shape[1] / 2
    C[1, 2] = -img_shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T_ = np.eye(3)
    T_[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T_[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    return T_ @ S @ R @ P @ C, s


@pytest.mark.parametrize("perspective", [0.0, 5e-4])
def test_warp_perspective_matches_host_cv2(perspective):
    import cv2

    s = 48
    canvas = _smooth_image(2 * s, 2 * s, seed=int(perspective > 0))
    M, _ = _host_matrix(np.random.default_rng(7), canvas.shape, (s, s),
                        degrees=10.0, scale=0.5, shear=2.0,
                        perspective=perspective, translate=0.1)
    ours = T.warp_perspective(
        torch.from_numpy(canvas[None]), torch.from_numpy(M[None]).float(),
        s, use_perspective=perspective > 0)[0].numpy()
    warp = (cv2.warpPerspective(canvas, M, dsize=(s, s),
                                borderValue=(114 / 255.0,) * 3)
            if perspective else
            cv2.warpAffine(canvas, M[:2], dsize=(s, s),
                           borderValue=(114 / 255.0,) * 3))
    diff = np.abs(ours - warp)
    assert diff.mean() < 2e-3, diff.mean()
    assert np.percentile(diff, 99) < 2e-2, np.percentile(diff, 99)


def test_warp_boxes_match_host_random_perspective_labels():
    """The device corner transform and candidate filter give the host
    random_perspective's labels at degrees = 10, and the device warp its
    image (uint8 canvas, pad 114)."""
    s = 64
    canvas = (np.clip(_smooth_image(2 * s, 2 * s), 0, 1) * 255).astype(
        np.uint8)
    boxes = np.array([[0, 20.0, 25.0, 70.0, 80.0],
                      [1, 60.0, 64.0, 100.0, 96.0],
                      [2, 5.0, 5.0, 9.0, 9.0],
                      [3, 90.0, 10.0, 126.0, 60.0]], np.float32)
    kw = {"degrees": 10.0, "translate": 0.1, "scale": 0.5, "shear": 2.0,
          "perspective": 0.0}
    host_img, host_labels = random_perspective(
        canvas.copy(), boxes.copy(), border=(-s // 2, -s // 2),
        rng=np.random.default_rng(3), **kw)
    M, zs = _host_matrix(np.random.default_rng(3), canvas.shape, (s, s),
                         **kw)
    mt = torch.from_numpy(M[None]).float()
    cxy = [torch.from_numpy(v)[None] for v in (
        (boxes[:, 1] + boxes[:, 3]) / 2, (boxes[:, 2] + boxes[:, 4]) / 2,
        boxes[:, 3] - boxes[:, 1], boxes[:, 4] - boxes[:, 2])]
    x1, y1, x2, y2 = (v[0].numpy() for v in T.warp_boxes(
        mt, *cxy, s, use_perspective=False))
    w2, h2 = x2 - x1, y2 - y1
    w1, h1 = cxy[2][0].numpy() * zs, cxy[3][0].numpy() * zs
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    keep = (w2 > 2) & (h2 > 2) & (ar < 100) \
        & (w2 * h2 / (w1 * h1 + 1e-16) > 0.1)
    assert keep.sum() == len(host_labels) >= 2
    np.testing.assert_allclose(np.stack([x1, y1, x2, y2], -1)[keep],
                               host_labels[:, 1:5], atol=1e-3)
    ours = T.warp_perspective(torch.from_numpy(canvas[None]).float(), mt, s,
                              pad=114.0, use_perspective=False)[0].numpy()
    diff = np.abs(ours - host_img.astype(np.float32))
    assert diff.mean() < 2.0, diff.mean()   # cv2's fixed-point bilinear


# ---------------------------------------------------------------------------
# the Trainer: device_augment and the one-batch-ahead copy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    p.write_text(synth.TINY_YAML)
    return str(p)


@pytest.fixture(scope="module")
def disk_data(tmp_path_factory):
    """(train dir, val dir) of synth.write_dataset images (160 px)."""
    root = str(tmp_path_factory.mktemp("data"))
    return (synth.write_dataset(root, "train", 8, seed=0),
            synth.write_dataset(root, "val", 4, seed=1))


def _norm(arrays) -> float:
    """The global L2 norm of numpy arrays or tensors, in f64."""
    return math.sqrt(sum(float((np.asarray(a.detach() if isinstance(
        a, torch.Tensor) else a, np.float64) ** 2).sum()) for a in arrays))


class _Loader(list):
    """A list of batches with the loader hooks the JAX Trainer calls."""

    batch_size = 4
    drop_last = True

    def set_epoch(self, epoch):
        pass


def _uint8_batches(n: int, size: int = 64) -> _Loader:
    return _Loader(synth.make_eval_batch(4, size, seed) for seed in range(n))


def _trainer(tiny_yaml, tmp_path, batches, mode="full", **kw) -> Trainer:
    """A CPU Trainer from seed 0 on `batches`, the augmentation
    hyperparameters of the "full" preset."""
    return Trainer(YOLO.from_yaml(tiny_yaml), train_loader=batches,
                   data=DataConfig(num_classes=4, augment=AugmentConfig()),
                   config=TrainConfig(data_parallel=False,
                                      output_dir=str(tmp_path), **kw),
                   device_augment=mode, device="cpu")


@pytest.mark.parametrize("mode", [True, "full"], ids=["true", "full"])
def test_trainer_device_augment_on_disk_data(mode, tiny_yaml, disk_data,
                                             tmp_path):
    """tests/test_train.py:166-207 for the port: the host stages that moved
    to the device are zeroed in the loaders' copy of the config (the
    caller's stays as it was), both loaders emit uint8, and an epoch gives
    finite losses."""
    train, val = disk_data
    data = DataConfig(train_path=train, val_path=val, num_classes=4,
                      img_size=64, batch_size=4, workers=2, max_boxes=16,
                      augment=AugmentConfig("full"))
    tr = Trainer(YOLO.from_yaml(tiny_yaml), data=data,
                 config=TrainConfig(epochs=1, data_parallel=False,
                                    output_dir=str(tmp_path)),
                 device_augment=mode, device="cpu")
    assert data.augment.mosaic == 1.0 and data.augment.hsv_h == 0.015
    assert not data.uint8_images
    full = mode == "full"
    assert tr._device_aug_full == full
    assert tr._device_aug["flip_lr"] == 0.5 and tr._device_aug["hsv_s"] == 0.7
    assert ("mosaic_p" in tr._device_aug) == full
    stages = {type(t).__name__: t
              for t in tr.train_loader.dataset.transforms.transforms}
    assert stages["HSV"].s_gain == 0.0 and stages["RandomFlip"].flip_lr == 0.0
    assert (stages["Mosaic"].prob, stages["MixUp"].prob) == \
        ((0.0, 0.0) if full else (1.0, 0.15))
    assert (stages["Mosaic"].scale == 0.0) == full
    for loader in (tr.train_loader, tr.val_loader):
        assert loader.uint8_images
        assert next(iter(loader))["images"].dtype == np.uint8
    items = tr.train_one_epoch(0)
    assert np.all(np.isfinite(items)) and tr.global_step == 2


def test_augmented_step_matches_jax_trainer(tiny_yaml, tmp_path, monkeypatch):
    """Two f32 steps of device_augment="full" on uint8 batches from one
    init: the port's draws are those of the JAX Trainer's
    fold_in(key(seed + 1), step), injected through `_aug_draws`. Loss
    items, parameter norms and update norms within the 2% of the Trainer's
    loss-curve bound. (The second step's gradient norm is ill-conditioned
    on these mosaics: input noise at the level by which JAX's jitted
    augmentation differs from its eager one moves it by percents on the
    CPU alone, so it is not compared.)"""
    batches = _uint8_batches(2)
    jmodel = JYOLO.from_yaml(tiny_yaml)
    params, stats = jax.device_get(jmodel.init(jax.random.key(0)))
    jt = JTrainer(jmodel, data=JDataConfig(augment=JAugmentConfig()),
                  config=JTrainConfig(data_parallel=False,
                                      output_dir=str(tmp_path)),
                  train_loader=batches, params=params, stats=stats,
                  device_augment="full")
    tt = Trainer(YOLO.from_yaml(tiny_yaml), train_loader=batches,
                 data=DataConfig(num_classes=4, augment=AugmentConfig()),
                 config=TrainConfig(data_parallel=False,
                                    output_dir=str(tmp_path)),
                 params=params, stats=stats, device_augment="full",
                 device="cpu")
    assert tt._device_aug == jt._device_aug
    key = jax.random.key(tt.config.seed + 1)

    def mirrored(step, b, s):
        return {k: np.array(v) for k, v in _full_draws(
            jax.random.fold_in(key, step), b, s, **tt._device_aug).items()}

    monkeypatch.setattr(tt, "_aug_draws", mirrored)
    for step, b in enumerate(batches):
        jp = jax.device_get(jt.params)
        tp = {k: v.clone() for k, v in tt.params.items()}
        (jt.params, jt.stats, jt.opt_bufs, jt.ema, _, jitems, _) = \
            jt._train_step(jt.params, jt.stats, jt.opt_bufs, jt.ema,
                           jnp.asarray(b["images"]),
                           jnp.asarray(b["targets"]), np.int32(step))
        items = tt.train_step(b["images"], b["targets"])[1]
        np.testing.assert_allclose(items.numpy(), np.asarray(jitems),
                                   rtol=0.02)
        jnew = jax.tree_util.tree_leaves(jax.device_get(jt.params))
        norms = {"params": (_norm(tt.params.values()), _norm(jnew)),
                 "update": (_norm(tt.params[k] - v for k, v in tp.items()),
                            _norm(np.asarray(a) - b_ for a, b_ in zip(
                                jnew, jax.tree_util.tree_leaves(jp))))}
        for name, (mine, ref) in norms.items():
            assert abs(mine - ref) <= 0.02 * ref, (step, name, mine, ref)


def test_resumed_run_draws_what_an_unbroken_run_drew(tiny_yaml, tmp_path):
    """Three steps in one run; the same run's checkpoint after two, resumed
    in a new Trainer: its third step draws the same values and, on the CPU,
    gives the same loss bit for bit."""
    batches = _uint8_batches(3)
    seen: list[tuple[int, dict]] = []

    def recording(tr):
        draw = tr._aug_draws

        def record(step, b, s):
            out = draw(step, b, s)
            seen.append((step, out))
            return out
        tr._aug_draws = record
        return tr

    a = recording(_trainer(tiny_yaml, tmp_path, batches))
    for b in batches[:2]:
        a.train_step(b["images"], b["targets"])
    a._save(tmp_path / "ckpt.npz", epoch=0)
    loss_a = a.train_step(batches[2]["images"], batches[2]["targets"])[0]
    b = recording(_trainer(tiny_yaml, tmp_path, batches))
    b.load_checkpoint(tmp_path / "ckpt.npz")
    loss_b = b.train_step(batches[2]["images"], batches[2]["targets"])[0]
    assert [s for s, _ in seen] == [0, 1, 2, 2]
    (_, da), (_, db) = seen[2], seen[3]
    assert all(np.array_equal(da[k], db[k]) for k in da)
    assert not np.array_equal(seen[1][1]["zoom"], da["zoom"])
    assert torch.equal(loss_a, loss_b)


def test_device_augment_without_data_augments_nothing(tiny_yaml, tmp_path,
                                                       caplog):
    batches = _uint8_batches(1)
    cfg = TrainConfig(data_parallel=False, output_dir=str(tmp_path))
    with caplog.at_level("WARNING", logger="yolo_re_tpu_torch.train.trainer"):
        tr = Trainer(YOLO.from_yaml(tiny_yaml), config=cfg,
                     train_loader=batches, device_augment="full",
                     device="cpu")
    assert tr._device_aug is None
    assert [r.levelname for r in caplog.records] == ["WARNING"]
    assert "no effect without data=" in caplog.records[0].getMessage()
    plain = Trainer(YOLO.from_yaml(tiny_yaml), config=TrainConfig(
        data_parallel=False, output_dir=str(tmp_path)), train_loader=batches,
        device="cpu")
    b = batches[0]
    assert torch.equal(tr.train_step(b["images"], b["targets"])[0],
                       plain.train_step(b["images"], b["targets"])[0])


def test_prefetched_puts_the_next_batch_before_yielding(tiny_yaml, tmp_path):
    pulled = []

    class Logged(_Loader):
        def __iter__(self):
            for i, b in enumerate(list.__iter__(self)):
                pulled.append(i)
                yield b

    batches = Logged(_uint8_batches(3))
    tr = _trainer(tiny_yaml, tmp_path, batches)
    for n, (x, t, ready, host) in enumerate(tr._prefetched()):
        assert pulled[-1] == min(n + 1, 2) and host is batches[n]
        assert ready is None and x.dtype == torch.uint8
        assert torch.equal(x, torch.from_numpy(host["images"]))
        assert torch.equal(t, torch.from_numpy(host["targets"]))
    assert n == 2


def test_epoch_through_prefetch_equals_train_steps(tiny_yaml, tmp_path):
    """On the CPU an augmented epoch (`_prefetched`) is bit-equal to the
    same batches through `train_step`."""
    batches = _uint8_batches(3)
    a = _trainer(tiny_yaml, tmp_path, batches)
    b = _trainer(tiny_yaml, tmp_path, batches)
    items = a.train_one_epoch(0)
    steps = [b.train_step(x["images"], x["targets"])[1] for x in batches]
    assert a.global_step == b.global_step == 3
    np.testing.assert_array_equal(
        items, (steps[0] + steps[1] + steps[2]).numpy() / 3)
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    for k, v in a.ema["params"].items():
        assert torch.equal(v, b.ema["params"][k]), k


def test_train_step_augment_false_skips_the_device_augmentation(tiny_yaml,
                                                                 tmp_path):
    """`train_step(..., augment=False)` on a "full"-augmenting Trainer is a
    step of a Trainer without device augmentation, bit for bit; the next
    step, augmented as configured, is not."""
    batches = _uint8_batches(2)
    tr = _trainer(tiny_yaml, tmp_path, batches)
    plain = _trainer(tiny_yaml, tmp_path, batches, mode=False)
    b = batches[0]
    assert torch.equal(tr.train_step(b["images"], b["targets"],
                                     augment=False)[0],
                       plain.train_step(b["images"], b["targets"])[0])
    b = batches[1]
    assert not torch.equal(tr.train_step(b["images"], b["targets"])[0],
                           plain.train_step(b["images"], b["targets"])[0])
