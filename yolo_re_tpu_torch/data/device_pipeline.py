"""On-device batched letterbox (counterpart of the resize/letterbox half of
yolo_re_tpu/data/device_pipeline.py).

The bilinear resize is two products against static interpolation-weight
matrices (cv2 INTER_LINEAR half-pixel semantics, border replicate), as in
the JAX package, and the letterbox keeps its gain and rounding, so boxes
map back to the original frame identically. The train-time augmentations
of that module wait for the train slice.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_PAD = 114.0 / 255.0


@lru_cache(maxsize=128)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) interpolation weights, cv2 INTER_LINEAR semantics:
    half-pixel centers `src = (dst + 0.5) * in/out - 0.5`, border replicate."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(src).astype(np.int64)
    frac = (src - x0).astype(np.float32)
    lo = np.clip(x0, 0, in_size - 1)
    hi = np.clip(x0 + 1, 0, in_size - 1)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - frac)
    np.add.at(m, (rows, hi), frac)
    return m


def resize_bilinear(img: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Batched bilinear resize (B, H, W, C) float -> (B, out_h, out_w, C):
    one product over rows, one over columns."""
    _, h, w, _ = img.shape
    x = img
    if h != out_h:
        rh = torch.from_numpy(_resize_matrix(h, out_h)).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", rh, x)
    if w != out_w:
        rw = torch.from_numpy(_resize_matrix(w, out_w)).to(x.device, x.dtype)
        x = torch.einsum("pw,bhwc->bhpc", rw, x)
    return x


def batched_letterbox(images: torch.Tensor, new_shape: int | tuple[int, int],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Letterbox a uniform-size batch on its device.

    images: (B, H, W, 3) uint8 (or float already in [0, 1]).
    Returns (B, S_h, S_w, 3) in [0, 1], aspect-preserving resize with
    114-grey padding — the gain and rounding of the host `letterbox`
    (yolo_re_tpu/data/augment.py:41-82). Order: f32 -> /255 -> resize ->
    pad -> clip -> cast.
    """
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    _, h, w, _ = images.shape
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0

    r = min(new_shape[0] / h, new_shape[1] / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (new_shape[1] - new_w) / 2, (new_shape[0] - new_h) / 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))

    x = resize_bilinear(x, new_h, new_w)
    x = torch.nn.functional.pad(x, (0, 0, left, right, top, bottom),
                                value=_PAD)
    return x.clamp(0.0, 1.0).to(dtype)
