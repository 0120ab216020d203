"""Host-side image augmentation primitives (numpy + OpenCV): a copy of
yolo_re_tpu/data/augment.py, its native host kernels' dispatch included
(`YOLO_TPU_NATIVE`, utils/native.py; the default is the cv2/numpy
branches). tests/test_torch_eval.py pins the two equal on cv2 and
tests/test_torch_native.py under the native switch.

These run in the data-loader workers on CPU, feeding the TPU; semantics
follow the reference (src/yolo/data/augment.py) — same matrices, same
padding value 114, same candidate filtering — so training distributions
match. Coordinate conversions are shared with the device-side ops module
conceptually but implemented in numpy here to stay torch/jax-free in
workers.
"""

from __future__ import annotations

import math

import cv2
import numpy as np

from yolo_re_tpu_torch.utils import native


def augment_hsv(img: np.ndarray, h_gain: float = 0.5, s_gain: float = 0.5,
                v_gain: float = 0.5, rng: np.random.Generator | None = None
                ) -> np.ndarray:
    """In-place HSV jitter via LUTs (reference: src/yolo/data/augment.py:12-37)."""
    if h_gain == 0 and s_gain == 0 and v_gain == 0:
        return img
    rng = rng or np.random.default_rng()
    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    # Callers rely on in-place mutation, so only dispatch when the native
    # kernel can work on the buffer directly (no contiguity copy).
    if native.enabled() and img.flags["C_CONTIGUOUS"] and img.ndim == 3:
        return native.hsv_augment(img, float(r[0]), float(r[1]), float(r[2]))
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    dtype = img.dtype

    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(dtype)

    im_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat),
                        cv2.LUT(val, lut_val)))
    cv2.cvtColor(im_hsv, cv2.COLOR_HSV2BGR, dst=img)
    return img


def letterbox(
    img: np.ndarray,
    new_shape: int | tuple[int, int] = 640,
    color: tuple[int, int, int] = (114, 114, 114),
    auto: bool = False,
    scale_fill: bool = False,
    scaleup: bool = True,
    stride: int = 32,
) -> tuple[np.ndarray, tuple[float, float], tuple[float, float]]:
    """Aspect-preserving resize + pad (reference: src/yolo/data/augment.py:40-94).

    Returns (image, (ratio_w, ratio_h), (pad_w, pad_h)).
    """
    shape = img.shape[:2]  # (h, w)
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]

    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2

    # Native host runtime: the C++ kernel covers the common square-pad case
    # (resize + 114-pad, same +-0.1 rounding; within 1-2 LSB of cv2).
    if (native.enabled() and not auto and not scale_fill
            and img.dtype == np.uint8 and img.ndim == 3
            and color == (114, 114, 114)):
        out, ratio_n, pad_n = native.letterbox(
            img, new_shape[0], new_shape[1], pad_value=114, scaleup=scaleup)
        return out, ratio_n, pad_n

    if shape[::-1] != new_unpad:
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=color)
    return img, ratio, (dw, dh)


def random_perspective(
    img: np.ndarray,
    labels: np.ndarray,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
    perspective: float = 0.0,
    border: tuple[int, int] = (0, 0),
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Composed center/perspective/rotate-scale/shear/translate warp.

    labels: (n, 5) [cls, x1, y1, x2, y2] in pixels.
    Reference: src/yolo/data/augment.py:97-184 — same C·P·R·S·T matrix
    composition and candidate filter.
    """
    rng = rng or np.random.default_rng()
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2

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

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, M, dsize=(width, height),
                                      borderValue=(114, 114, 114))
        else:
            img = cv2.warpAffine(img, M[:2], dsize=(width, height),
                                 borderValue=(114, 114, 114))

    n = len(labels)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = labels[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)

        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate(
            (x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T

        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)

        # Perspective warps shrink projected boxes much harder than affine
        # ones, so the survival threshold relaxes with it enabled
        # (reference: augment.py:178-180).
        keep = _box_candidates(labels[:, 1:5].T * s, new.T,
                               area_thr=0.01 if perspective else 0.10)
        labels = labels[keep]
        labels[:, 1:5] = new[keep]

    return img, labels


def _box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2,
                    ar_thr: float = 100, area_thr: float = 0.1,
                    eps: float = 1e-16) -> np.ndarray:
    """Filter degenerate boxes after warp (reference: augment.py:187-211)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def xyxy2xywhn(x: np.ndarray, w: int, h: int, clip: bool = False,
               eps: float = 0.0) -> np.ndarray:
    """Pixel xyxy -> normalized xywh (reference: augment.py:214-238)."""
    if clip:
        x = x.copy()
        x[..., [0, 2]] = x[..., [0, 2]].clip(0, w - eps)
        x[..., [1, 3]] = x[..., [1, 3]].clip(0, h - eps)
    y = np.empty_like(x, dtype=np.float32)
    y[..., 0] = ((x[..., 0] + x[..., 2]) / 2) / w
    y[..., 1] = ((x[..., 1] + x[..., 3]) / 2) / h
    y[..., 2] = (x[..., 2] - x[..., 0]) / w
    y[..., 3] = (x[..., 3] - x[..., 1]) / h
    return y


def xywhn2xyxy(x: np.ndarray, w: int, h: int, padw: float = 0,
               padh: float = 0) -> np.ndarray:
    """Normalized xywh -> pixel xyxy (reference: augment.py:241-261)."""
    y = np.empty_like(x, dtype=np.float32)
    y[..., 0] = w * (x[..., 0] - x[..., 2] / 2) + padw
    y[..., 1] = h * (x[..., 1] - x[..., 3] / 2) + padh
    y[..., 2] = w * (x[..., 0] + x[..., 2] / 2) + padw
    y[..., 3] = h * (x[..., 1] + x[..., 3] / 2) + padh
    return y
