"""Batched COCO-style validation (counterpart of
yolo_re_tpu/eval/evaluator.py; reference src/yolo/eval/evaluator.py).

Per batch, on the device: uint8 (or [0, 1] float) NHWC images ->
normalize in the compute dtype -> the model (fused by default: the stem,
conv3, bottleneck-chain and ADown kernels on a CUDA device) -> decode ->
all-anchor NMS (ops/nms.py, one NMS kernel call) -> the padded
(B, max_det) dict, the only thing that crosses to the host. The host
matches batch i - 1 against its GT while the device runs batch i: the
padded output goes by a non-blocking copy into pinned host memory, and a
CUDA event marks when it has landed. `mesh=` (sharded validation) waits
for the port's scale slice.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from yolo_re_tpu_torch.eval.metrics import compute_map
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.nms import nms_to_list, non_max_suppression
from yolo_re_tpu_torch.serving import DTYPES, inference_model
from yolo_re_tpu_torch.utils.precision import full_f32

log = logging.getLogger(__name__)
# batches in flight while the host matches older ones
# (yolo_re_tpu/eval/evaluator.py:128-148)
PIPELINE_DEPTH = 2


class Evaluator:
    """mAP evaluation over a validation loader.

    Example:
        ev = Evaluator(model, create_dataloader(path, data, mode="val"))
        results = ev.evaluate(load_weights("best.npz"))   # map50, map, ...

    conf/iou thresholds match reference evaluator.py:38-39. `loader`
    yields {"images" (B, H, W, 3) uint8 RGB or float in [0, 1],
    "targets" (B, M, 5) [cls, xywh normalized], "nboxes" (B,)}, numpy or
    torch. `device` defaults to "cuda" and raises without a card; pass
    "cpu" to run the kernels' plain versions. `fuse` folds BN and RepConv
    before evaluating (the kernels run only on the fused model).
    """

    def __init__(self, model: YOLO, loader, num_classes: int | None = None,
                 conf_thres: float = 0.001, iou_thres: float = 0.6,
                 max_det: int = 300, compute_dtype: str = "float32",
                 debug_dir: str | None = None, mesh=None,
                 device: str | torch.device = "cuda", fuse: bool = True):
        if mesh is not None:
            raise NotImplementedError(
                "Evaluator(mesh=...) is not ported to yolo_re_tpu_torch yet: "
                "it waits for the scale slice of the port")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Evaluator(device='cuda'): no CUDA device")
        if compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}")
        self.model = model
        self.loader = loader
        self.num_classes = num_classes or model.num_classes
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.dtype = DTYPES[compute_dtype]
        self.debug_dir = debug_dir
        self.fuse = fuse

    @torch.inference_mode()
    @full_f32()
    def _dispatch(self, model: YOLO, batch) -> tuple[dict, Any]:
        """Enqueue one batch; returns (padded NMS output on the host, the
        CUDA event that marks its arrival or None). Runs with TF32 off
        (`utils.precision.full_f32`): the JAX package's f32 convs run at
        HIGHEST precision."""
        images = torch.as_tensor(np.asarray(batch["images"]))
        x = images.to(self.device, non_blocking=True)
        x = x.to(self.dtype) / 255.0 if x.dtype == torch.uint8 \
            else x.to(self.dtype)
        # a dual head: its main branch alone (yolo_re_tpu/eval/
        # evaluator.py:86-87; reference evaluator.py:105-113)
        decoded, _ = model(x.permute(0, 3, 1, 2), main_only=True)
        out = non_max_suppression(decoded, conf_thres=self.conf_thres,
                                  iou_thres=self.iou_thres,
                                  max_det=self.max_det)
        if self.device.type != "cuda":
            return out, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                .copy_(v, non_blocking=True) for k, v in out.items()}
        event = torch.cuda.Event()
        event.record()
        return host, event

    def evaluate(self, state_dict_or_params: Any,
                 epoch: int = 0) -> dict[str, float]:
        """mAP of the weights over the loader. `state_dict_or_params`: a
        state dict of the (unfused) model, or the JAX package's
        (params, stats) pytrees."""
        model = inference_model(self.model, state_dict_or_params,
                                self.device, self.dtype, fuse=self.fuse)
        acc: dict[str, list] = {k: [] for k in (
            "pred_boxes", "pred_scores", "pred_classes", "gt_boxes",
            "gt_classes")}
        debug: list | None = [] if self.debug_dir else None
        t0 = time.perf_counter()
        n_images = 0

        def collect(item) -> int:
            out, event, batch = item
            if event is not None:
                event.synchronize()
            self._collect(out, batch, acc, debug)
            return np.asarray(batch["images"]).shape[0]

        pending: deque = deque()
        for batch in self.loader:
            pending.append((*self._dispatch(model, batch), batch))
            while len(pending) > PIPELINE_DEPTH:
                n_images += collect(pending.popleft())
        while pending:
            n_images += collect(pending.popleft())

        if debug:
            # First ~10 GT-bearing images, GT red / top-20 preds green, in a
            # per-epoch directory (reference: eval/evaluator.py:164-196).
            from yolo_re_tpu_torch.utils.visualize import save_debug_images

            save_debug_images(
                np.concatenate([d[0] for d in debug]),
                [det for d in debug for det in d[1]],
                np.concatenate([d[2] for d in debug]),
                np.concatenate([d[3] for d in debug]),
                f"{self.debug_dir}/epoch{epoch}")

        results = compute_map(acc["pred_boxes"], acc["pred_scores"],
                              acc["pred_classes"], acc["gt_boxes"],
                              acc["gt_classes"], self.num_classes)
        dt = time.perf_counter() - t0
        results["images_per_sec"] = n_images / max(dt, 1e-9)
        log.info("eval: %d images in %.1fs | mAP50 %.4f mAP75 %.4f mAP %.4f",
                 n_images, dt, results["map50"], results["map75"],
                 results["map"])
        return results

    def _collect(self, nms_out, batch, acc, debug) -> None:
        """Fold one batch's padded NMS output (on the host) and its GT into
        the accumulators (yolo_re_tpu/eval/evaluator.py:171-206)."""
        images = np.asarray(batch["images"])
        b, h, w = images.shape[0], images.shape[1], images.shape[2]
        dets = nms_to_list(nms_out)[:b]

        targets = np.asarray(batch["targets"])
        nboxes = np.asarray(batch["nboxes"])
        for i in range(b):
            det = dets[i]
            acc["pred_boxes"].append(det[:, :4])
            acc["pred_scores"].append(det[:, 4])
            acc["pred_classes"].append(det[:, 5].astype(np.int64))

            n = int(nboxes[i])
            t = targets[i, :n]
            if n:
                cx, cy, bw, bh = (t[:, 1] * w, t[:, 2] * h,
                                  t[:, 3] * w, t[:, 4] * h)
                boxes = np.stack([cx - bw / 2, cy - bh / 2,
                                  cx + bw / 2, cy + bh / 2], axis=1)
                acc["gt_boxes"].append(boxes.astype(np.float32))
                acc["gt_classes"].append(t[:, 0].astype(np.int64))
            else:
                acc["gt_boxes"].append(np.zeros((0, 4), np.float32))
                acc["gt_classes"].append(np.zeros((0,), np.int64))
        if (debug is not None
                and (nboxes > 0).any()  # only batches with GT are usable
                and sum(int((d[3] > 0).sum()) for d in debug) < 10):
            host = images[:b].astype(np.float32)
            if images.dtype == np.uint8:
                host = host / 255.0
            if not debug or debug[0][0].shape[1:] == host.shape[1:]:
                debug.append((host, dets, targets, nboxes))
