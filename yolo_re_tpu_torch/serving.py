"""Serving: from uint8 frames to padded detections (counterpart of
yolo_re_tpu/serving.py).

    uint8 (B, H, W, 3) RGB -> letterbox on the device (resize as products,
    114 pad) -> fused (BN/RepConv-folded) forward -> DFL decode
    -> class-aware fixed-shape NMS -> padded (B, max_det) detections

The fused forward runs the stem and every ADown through their CUDA kernels
on a CUDA device, and NMS through the NMS kernel. PyTorch runs eagerly
here: no torch.compile and no CUDA graphs. Mesh serving and the exported
artifact wait for later slices.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from yolo_re_tpu_torch.convert import load_weights, state_dict_from_jax
from yolo_re_tpu_torch.data.device_pipeline import batched_letterbox
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.nms import nms_to_list, non_max_suppression

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def inference_model(model: YOLO, state_dict_or_params: Any,
                    device: torch.device, dtype: torch.dtype,
                    fuse: bool = True) -> YOLO:
    """A copy of `model` holding the weights (a state dict of `model`, or
    the JAX package's (params, stats) pytrees), loaded with strict=True,
    fused if asked, in eval mode on `device` in `dtype`. The caller's
    model is left as it was."""
    sd = state_dict_or_params
    if isinstance(sd, tuple):
        sd = state_dict_from_jax(model.plan, *sd)
    model = copy.deepcopy(model)
    model.load_state_dict(sd, strict=True)
    if fuse:
        model.fuse()
    return model.eval().to(device=device, dtype=dtype)


class Detector:
    """End-to-end detector over fused weights.

    Example:
        det = Detector.from_checkpoint(model, "best.npz", device="cuda")
        out = det(frames_u8)                      # dict of padded tensors
        dets = det.to_list(out, original_shapes)  # per-image (n, 6) numpy

    state_dict_or_params: a state dict of `model` (for example
    `model.state_dict()`), or the JAX package's (params, stats) pytrees.
    The model is copied, loaded with strict=True and fused; the caller's
    model is left as it was. `device` defaults to "cuda" and raises
    without a CUDA device; pass "cpu" to run the kernels' plain versions.
    """

    def __init__(self, model: YOLO, state_dict_or_params: Any, *,
                 device: str | torch.device = "cuda", img_size: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, compute_dtype: str = "bfloat16"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector(device='cuda'): no CUDA device")
        if compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[compute_dtype]
        self.model = inference_model(model, state_dict_or_params,
                                     self.device, self.dtype)
        self.img_size = img_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det

    @classmethod
    def from_checkpoint(cls, model: YOLO, path: str, **kwargs) -> "Detector":
        return cls(model, load_weights(path), **kwargs)

    @torch.inference_mode()
    def __call__(self, images_u8: np.ndarray | torch.Tensor
                 ) -> dict[str, torch.Tensor]:
        """images_u8: (B, H, W, 3) uint8 RGB, uniform size per call.

        Returns padded tensors on the detector's device: boxes
        (B, max_det, 4) xyxy in letterbox-canvas pixels, scores, classes,
        valid."""
        frames = torch.as_tensor(images_u8).to(self.device)
        x = batched_letterbox(frames, self.img_size, dtype=self.dtype)
        decoded, _ = self.model(x.permute(0, 3, 1, 2))
        return non_max_suppression(
            decoded, conf_thres=self.conf_thres, iou_thres=self.iou_thres,
            max_det=self.max_det)

    def to_list(self, out: dict[str, torch.Tensor],
                original_shapes: list[tuple[int, int]] | None = None):
        """Padded output -> per-image (n, 6) [xyxy, conf, cls] numpy, with
        boxes mapped back to original pixels when shapes are given."""
        dets = nms_to_list(out)
        if original_shapes is None:
            return dets
        mapped = []
        for det, (h0, w0) in zip(dets, original_shapes):
            det = det.copy()
            gain = min(self.img_size / h0, self.img_size / w0)
            pad_x = (self.img_size - w0 * gain) / 2
            pad_y = (self.img_size - h0 * gain) / 2
            det[:, [0, 2]] = ((det[:, [0, 2]] - pad_x) / gain).clip(0, w0)
            det[:, [1, 3]] = ((det[:, [1, 3]] - pad_y) / gain).clip(0, h0)
            mapped.append(det)
        return mapped
