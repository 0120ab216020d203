"""Composable augmentation pipeline (host-side, numpy/cv2): a copy of
yolo_re_tpu/data/transforms.py, Mosaic's native resize and tile blit
(`YOLO_TPU_NATIVE`, utils/native.py) included. tests/test_torch_eval.py
pins the two equal on cv2 and tests/test_torch_native.py under the native
switch.

Mirrors the reference pipeline (src/yolo/data/transforms.py) with three
deliberate changes:

- every transform takes an explicit `np.random.Generator` — deterministic
  per-sample seeding instead of global random state,
- Mosaic uses the *requested* index plus 3 random picks, fixing the
  reference quirk where it always used `dataset.indices[0]`
  (SURVEY §2.4.2; reference transforms.py:111),
- the albumentations dependency (Blur/MedianBlur/ToGray/CLAHE at p=0.01,
  reference transforms.py:317-371) is replaced with direct cv2 equivalents.

Label format flow matches the reference: xywhn in the dataset -> xyxy pixels
through mosaic/perspective -> xywhn out (NormalizeLabels).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import cv2
import numpy as np

from yolo_re_tpu_torch.data.augment import (
    augment_hsv,
    letterbox,
    random_perspective,
    xywhn2xyxy,
    xyxy2xywhn,
)
from yolo_re_tpu_torch.utils import native

@dataclass
class Sample:
    """One training sample in flight (reference: transforms.py:25-40).

    img: BGR uint8 HWC. labels: (n, 5) [cls, x, y, w, h] — normalized xywh
    unless a transform documents otherwise. original_shape: (h, w) pre-resize.
    """

    img: np.ndarray
    labels: np.ndarray
    img_size: int = 640
    original_shape: tuple[int, int] | None = None

    def __post_init__(self):
        if self.original_shape is None:
            self.original_shape = self.img.shape[:2]


class Transform:
    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: list[Transform]):
        self.transforms = list(transforms)

    def __call__(self, sample, rng):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class Mosaic(Transform):
    """4-image mosaic on a 2s x 2s canvas, then random_perspective with
    border crop back to s x s (reference: transforms.py:64-162)."""

    def __init__(self, dataset, img_size: int = 640, prob: float = 1.0,
                 degrees: float = 0.0, translate: float = 0.1,
                 scale: float = 0.9, shear: float = 0.0,
                 perspective: float = 0.0):
        self.dataset = dataset
        self.img_size = img_size
        self.prob = prob
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.perspective = perspective

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            # Skip path: letterbox; output labels become xyxy pixels — the
            # same contract as the mosaic path (reference: transforms.py:90-105).
            h0, w0 = sample.img.shape[:2]
            img, ratio, pad = letterbox(sample.img, self.img_size,
                                        auto=False, scaleup=True)
            labels = sample.labels.copy()
            if len(labels):
                labels[:, 1:5] = xywhn2xyxy(labels[:, 1:5],
                                            ratio[0] * w0, ratio[1] * h0,
                                            pad[0], pad[1])
            return Sample(img, labels, self.img_size, sample.original_shape)

        s = self.img_size
        yc, xc = (int(rng.uniform(s // 2, 2 * s - s // 2)) for _ in range(2))
        # Current sample + 3 random picks, shuffled into the 4 tiles
        # (quirk fix vs reference transforms.py:111, see module docstring).
        extra = [int(rng.integers(0, len(self.dataset))) for _ in range(3)]

        canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
        all_labels = []

        loads = [(sample.img, sample.labels, sample.original_shape)]
        for idx in extra:
            img_i, labels_i, shape_i = self.dataset.load_raw(idx)
            loads.append((img_i, labels_i, shape_i))
        order = rng.permutation(4)
        loads = [loads[i] for i in order]

        use_native = native.enabled()
        for i, (img, labels, _) in enumerate(loads):
            h, w = img.shape[:2]
            r = s / max(h, w)
            if r != 1:
                if use_native:
                    img = native.resize_bilinear(img, int(h * r), int(w * r))
                else:
                    img = cv2.resize(img, (int(w * r), int(h * r)),
                                     interpolation=cv2.INTER_LINEAR)
                h, w = img.shape[:2]

            if i == 0:  # top left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
                x2b, y2b = w, h
            elif i == 1:  # top right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:  # bottom left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b = w - (x2a - x1a), 0
                x2b, y2b = w, min(y2a - y1a, h)
            else:  # bottom right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)

            if use_native:
                native.blit(canvas, img, y1a, x1a, y2a, x2a, y1b, x1b)
            else:
                canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b

            if len(labels):
                lab = labels.copy()
                lab[:, 1:5] = xywhn2xyxy(lab[:, 1:5], w, h, padw, padh)
                all_labels.append(lab)

        labels4 = (np.concatenate(all_labels, 0) if all_labels
                   else np.zeros((0, 5), np.float32))
        if len(labels4):
            np.clip(labels4[:, 1:5], 0, 2 * s, out=labels4[:, 1:5])

        img4, labels4 = random_perspective(
            canvas, labels4,
            degrees=self.degrees, translate=self.translate, scale=self.scale,
            shear=self.shear, perspective=self.perspective,
            border=(-s // 2, -s // 2), rng=rng)

        return Sample(img4, labels4, self.img_size, sample.original_shape)


class MixUp(Transform):
    """Beta(32, 32) blend with a letterboxed second image
    (reference: transforms.py:165-194). Expects pixel-xyxy labels
    (post-Mosaic). Deviation: the second image's labels are shifted by the
    letterbox padding — the reference omits the offset (a misalignment its
    survey did not flag); we align them correctly.
    """

    def __init__(self, dataset, prob: float = 0.15, alpha: float = 32.0):
        self.dataset = dataset
        self.prob = prob
        self.alpha = alpha

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        idx = int(rng.integers(0, len(self.dataset)))
        img2, labels2, _ = self.dataset.load_raw(idx)
        h, w = img2.shape[:2]
        img2, ratio, pad = letterbox(img2, sample.img_size, auto=False,
                                     scaleup=True)
        labels2 = labels2.copy()
        if len(labels2):
            labels2[:, 1:5] = xywhn2xyxy(labels2[:, 1:5],
                                         ratio[0] * w, ratio[1] * h,
                                         pad[0], pad[1])
        r = rng.beta(self.alpha, self.alpha)
        img = (sample.img.astype(np.float32) * r
               + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
        labels = np.concatenate([sample.labels, labels2], 0)
        return Sample(img, labels, sample.img_size, sample.original_shape)


class Letterbox(Transform):
    """Resize+pad; converts labels xywhn -> xywhn w.r.t. the new canvas
    (reference: transforms.py:197-220)."""

    def __init__(self, img_size: int = 640, auto: bool = False,
                 scaleup: bool = True, stride: int = 32):
        self.img_size = img_size
        self.auto = auto
        self.scaleup = scaleup
        self.stride = stride

    def __call__(self, sample, rng):
        h0, w0 = sample.img.shape[:2]
        img, ratio, pad = letterbox(sample.img, self.img_size, auto=self.auto,
                                    scaleup=self.scaleup, stride=self.stride)
        labels = sample.labels.copy()
        if len(labels):
            labels[:, 1:5] = xywhn2xyxy(labels[:, 1:5],
                                        int(round(w0 * ratio[0])),
                                        int(round(h0 * ratio[1])),
                                        pad[0], pad[1])
            labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], img.shape[1],
                                        img.shape[0], clip=True)
        return Sample(img, labels, self.img_size, sample.original_shape)


class RandomPerspective(Transform):
    """Standalone warp for non-mosaic pipelines (reference:
    transforms.py:223-255). Labels xywhn in/out."""

    def __init__(self, degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
                 perspective=0.0):
        self.kwargs = dict(degrees=degrees, translate=translate, scale=scale,
                           shear=shear, perspective=perspective)

    def __call__(self, sample, rng):
        h, w = sample.img.shape[:2]
        labels = sample.labels.copy()
        if len(labels):
            labels[:, 1:5] = xywhn2xyxy(labels[:, 1:5], w, h)
        img, labels = random_perspective(sample.img, labels, rng=rng,
                                         **self.kwargs)
        if len(labels):
            labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], img.shape[1],
                                        img.shape[0], clip=True)
        return Sample(img, labels, sample.img_size, sample.original_shape)


class HSV(Transform):
    """Reference: transforms.py:258-268."""

    def __init__(self, h_gain=0.015, s_gain=0.7, v_gain=0.4):
        self.h_gain, self.s_gain, self.v_gain = h_gain, s_gain, v_gain

    def __call__(self, sample, rng):
        augment_hsv(sample.img, self.h_gain, self.s_gain, self.v_gain, rng)
        return sample


class RandomFlip(Transform):
    """LR/UD flips on normalized labels (reference: transforms.py:271-297)."""

    def __init__(self, flip_lr: float = 0.5, flip_ud: float = 0.0):
        self.flip_lr = flip_lr
        self.flip_ud = flip_ud

    def __call__(self, sample, rng):
        img, labels = sample.img, sample.labels
        if self.flip_ud and rng.random() < self.flip_ud:
            img = np.flipud(img)
            if len(labels):
                labels[:, 2] = 1.0 - labels[:, 2]
        if self.flip_lr and rng.random() < self.flip_lr:
            img = np.fliplr(img)
            if len(labels):
                labels[:, 1] = 1.0 - labels[:, 1]
        return Sample(np.ascontiguousarray(img), labels, sample.img_size,
                      sample.original_shape)


class NormalizeLabels(Transform):
    """Pixel xyxy -> xywhn (post-mosaic path; reference: transforms.py:300-314)."""

    def __call__(self, sample, rng):
        labels = sample.labels
        if len(labels):
            h, w = sample.img.shape[:2]
            labels = labels.copy()
            labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], w, h, clip=True)
        return Sample(sample.img, labels, sample.img_size,
                      sample.original_shape)


class PixelAugment(Transform):
    """cv2 stand-ins for the reference's albumentations block
    (Blur / MedianBlur / ToGray / CLAHE, each p=0.01;
    reference: transforms.py:317-371). Label-preserving."""

    def __init__(self, blur=0.01, median_blur=0.01, to_gray=0.01, clahe=0.01):
        self.blur = blur
        self.median_blur = median_blur
        self.to_gray = to_gray
        self.clahe = clahe

    def __call__(self, sample, rng):
        img = sample.img
        if self.blur and rng.random() < self.blur:
            k = int(rng.integers(1, 4)) * 2 + 1
            img = cv2.blur(img, (k, k))
        if self.median_blur and rng.random() < self.median_blur:
            k = int(rng.integers(1, 4)) * 2 + 1
            img = cv2.medianBlur(img, k)
        if self.to_gray and rng.random() < self.to_gray:
            gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            img = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
        if self.clahe and rng.random() < self.clahe:
            lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
            clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
            lab[..., 0] = clahe.apply(lab[..., 0])
            img = cv2.cvtColor(lab, cv2.COLOR_LAB2BGR)
        return Sample(img, sample.labels, sample.img_size,
                      sample.original_shape)


def default_train_transforms(dataset, img_size: int, aug) -> Compose:
    """Train pipeline, order matching reference transforms.py:374-414:
    Mosaic -> MixUp -> NormalizeLabels -> PixelAugment -> HSV -> RandomFlip."""
    mosaic = Mosaic(dataset, img_size, prob=aug.mosaic, degrees=aug.degrees,
                    translate=aug.translate, scale=aug.scale, shear=aug.shear,
                    perspective=aug.perspective)
    return Compose([
        mosaic,
        MixUp(dataset, prob=aug.mixup),
        NormalizeLabels(),
        PixelAugment(aug.blur, aug.median_blur, aug.to_gray, aug.clahe),
        HSV(aug.hsv_h, aug.hsv_s, aug.hsv_v),
        RandomFlip(aug.flip_lr, aug.flip_ud),
    ])


def default_val_transforms(img_size: int, auto: bool = False,
                           stride: int = 32) -> Compose:
    """Val pipeline (reference: transforms.py:417-422)."""
    return Compose([
        Letterbox(img_size, auto=auto, scaleup=False, stride=stride),
    ])
