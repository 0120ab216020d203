"""Serving: from uint8 frames to padded detections (counterpart of
yolo_re_tpu/serving.py).

    uint8 (B, H, W, 3) RGB -> letterbox on the device (resize as products,
    114 pad) -> fused (BN/RepConv-folded) forward -> DFL decode
    -> class-aware fixed-shape NMS -> padded (B, max_det) detections

The fused forward runs the stem, every ADown, the RepNCSP chains and the
64-channel 3x3 convs through their CUDA kernels on a CUDA device, and NMS
through the NMS kernel. The pipeline is one module, `ServingProgram`:
`Detector.__call__` runs it eagerly (no torch.compile and no CUDA graphs),
and `Detector.export` writes it, weights included, to one `torch.export`
archive that `Detector.load_exported` runs again, on the device it was
traced on or, moved by `move_program`, on another. The kernels are custom
ops (`yolo_torch::*`, registered when their modules are imported), so the
archive calls the same kernels on a card and their plain versions on the
CPU. `Detector(mesh=)` serves over a
`parallel.mesh.Mesh` of local devices: one program per device, a batch
padded to a multiple of the mesh's size, split, run, and the outputs
gathered on the first device with the padding sliced off
(yolo_re_tpu/serving.py:128-149).

While a `torch.profiler` collects, a call opens its spans
(`utils/profiling.span`): `serve.request` holds `serve.copy` (the frames'
`.to(device)`) and `ServingProgram.forward`'s `serve.letterbox`,
`serve.forward` and `serve.nms` (a loaded archive's call:
`serve.program`). On a mesh the replicas' threads open none.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch
from torch import nn

from yolo_re_tpu_torch.convert import load_weights, state_dict_from_jax
from yolo_re_tpu_torch.data.device_pipeline import batched_letterbox
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.nms import nms_to_list, non_max_suppression
from yolo_re_tpu_torch.parallel.mesh import (
    Mesh,
    device_context,
    replicate,
    run_replicas,
)
from yolo_re_tpu_torch.utils.precision import full_f32
from yolo_re_tpu_torch.utils.profiling import span

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


class ServingProgram(nn.Module):
    """Pixels to detections: uint8 (B, H, W, 3) frames on the model's
    device -> letterbox -> the model's main-only forward -> NMS -> the
    padded dict. What `Detector.__call__` runs and `Detector.export`
    writes."""

    def __init__(self, model: YOLO, img_size: int, dtype: torch.dtype,
                 conf_thres: float, iou_thres: float, max_det: int):
        super().__init__()
        self.model = model
        self.img_size = img_size
        self.dtype = dtype
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det

    def forward(self, frames: torch.Tensor) -> dict[str, torch.Tensor]:
        with span("serve.letterbox"):
            x = batched_letterbox(frames, self.img_size, dtype=self.dtype)
        # a dual head: its main branch alone, as the JAX Detector keeps
        # only decoded["main"] (yolo_re_tpu/serving.py:116-117)
        with span("serve.forward"):
            decoded, _ = self.model(x.permute(0, 3, 1, 2), main_only=True)
        with span("serve.nms"):
            return non_max_suppression(
                decoded, conf_thres=self.conf_thres,
                iou_thres=self.iou_thres, max_det=self.max_det)


class Detector:
    """End-to-end detector over fused weights.

    Example:
        det = Detector.from_checkpoint(model, "best.npz", device="cuda")
        out = det(frames_u8)                      # dict of padded tensors
        dets = det.to_list(out, original_shapes)  # per-image (n, 6) numpy
        det.export("det.pt2", batch=8, height=720, width=1280)
        run = Detector.load_exported("det.pt2")   # same contract as det
        cpu = Detector.load_exported("det.pt2", device="cpu")

    state_dict_or_params: a state dict of `model` (for example
    `model.state_dict()`), or the JAX package's (params, stats) pytrees.
    The model is copied, loaded with strict=True and fused (unless
    fuse=False: then the kernels of the fused blocks do not run); the
    caller's model is left as it was. `device` defaults to "cuda" and
    raises without a CUDA device; pass "cpu" to run the kernels' plain
    versions. With `mesh` the devices are the mesh's (the first one holds
    `model`, `program` and the outputs) and `device` is not read; each
    other device gets a copy of the fused model, its packed weights
    moved with it. The thresholds are fixed at construction.
    """

    def __init__(self, model: YOLO, state_dict_or_params: Any, *,
                 device: str | torch.device = "cuda", img_size: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, compute_dtype: str = "bfloat16",
                 fuse: bool = True, mesh: Mesh | None = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else torch.device(device)
        devices = mesh.devices if mesh is not None else (self.device,)
        if any(d.type == "cuda" for d in devices) and \
                not torch.cuda.is_available():
            raise RuntimeError("Detector(device='cuda'): no CUDA device")
        if compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[compute_dtype]
        with device_context(self.device):
            self.model = inference_model(model, state_dict_or_params,
                                         self.device, self.dtype, fuse=fuse)
        self.img_size = img_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        # one program per mesh device (the first is `program`)
        self.programs = [
            ServingProgram(m, img_size, self.dtype, conf_thres, iou_thres,
                           max_det)
            for m in (replicate(self.model, mesh) if mesh is not None
                      else [self.model])]
        self.program = self.programs[0]

    @classmethod
    def from_checkpoint(cls, model: YOLO, path: str, **kwargs) -> "Detector":
        return cls(model, load_weights(path), **kwargs)

    @torch.inference_mode()
    @full_f32()
    def __call__(self, images_u8: np.ndarray | torch.Tensor
                 ) -> dict[str, torch.Tensor]:
        """images_u8: (B, H, W, 3) uint8 RGB, uniform size per call.

        Returns padded tensors on the detector's device: boxes
        (B, max_det, 4) xyxy in letterbox-canvas pixels, scores, classes,
        valid. Runs with TF32 off (`utils.precision.full_f32`), so an f32
        detector's library convs compute in full f32. With a mesh each
        device runs its part of the batch padded to a multiple of the
        mesh's size, under that device's context (the kernels launch on
        the current device's stream); the outputs come back on the first
        device, padding sliced off."""
        frames = torch.as_tensor(images_u8)
        with span("serve.request"):
            if self.mesh is None:
                with span("serve.copy"):
                    frames = frames.to(self.device)
                return self.program(frames)

            def run(program, part, dev):
                with span("serve.copy"):
                    part = part.to(dev)
                return program(part)
            return run_replicas(run, self.programs, self.mesh, frames)

    def export(self, path: str, batch: int, *, height: int | None = None,
               width: int | None = None,
               device: str | torch.device | None = None) -> None:
        """Write the whole pixels-to-detections program (`ServingProgram`),
        the fused weights and the kernels' packed weight images included,
        to one `torch.export` archive (.pt2) at `path`. Its input is
        (batch, height, width, 3) uint8 (height and width default to
        img_size), its output the padded NMS dict; the shapes are static,
        as in the JAX export. The kernels stay in the graph as
        `yolo_torch::*` custom ops, which run the kernels on a card and
        their plain versions on the CPU.

        The program is traced on this detector's device, and the device is
        part of it: its weights, its constants (the letterbox matrices,
        anchors and DFL projection, which the graph copies to the device on
        every call) and every `device=` in the graph. `device=None` keeps
        that device; another device (JAX's `platforms=`) retargets all of
        them before the archive is written (`move_program`), so that a
        detector on a card can write an archive for CPU hosts and the
        other way round. `load_exported(..., device=)` moves an archive at
        load time instead."""
        h = height or self.img_size
        w = width or self.img_size
        example = torch.zeros((batch, h, w, 3), dtype=torch.uint8,
                              device=self.device)
        # no_grad, not inference_mode: inference tensors do not trace
        with torch.no_grad(), full_f32():
            program = torch.export.export(self.program, (example,),
                                          strict=False)
        # the archive would keep the example frames (88 MB at gelan-c's
        # 32 x 720 x 1280); the loaded program does not read them
        program.example_inputs = None
        if device is not None:
            program = move_program(program, device)
        torch.export.save(program, path)

    @staticmethod
    def load_exported(path: str, device: str | torch.device | None = None
                      ) -> "ExportedDetector":
        """Load an archive `export` wrote: a callable with the Detector's
        contract at the exported shape ((batch, height, width, 3) uint8 in,
        the padded NMS dict out) on the archive's device, or on `device`
        when one is given (`move_program`)."""
        # registers the kernels' custom ops, which the graph calls
        from yolo_re_tpu_torch.ops.kernels import (  # noqa: F401
            adown,
            conv3,
            csp_chain,
            nms,
            stem,
        )
        program = torch.export.load(path)
        if device is not None:
            program = move_program(program, device)
        return ExportedDetector(program)

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


def move_program(program: torch.export.ExportedProgram,
                 device: str | torch.device) -> torch.export.ExportedProgram:
    """`program` retargeted to `device` in place (torch.export.passes.
    move_to_device_pass): every weight and buffer (the kernels' packed
    weight images among them), every tensor constant, every `device=` and
    `.to(device)` in the graph, and the tensors' metadata, so that its
    input's device (`ExportedDetector.device`) is `device` too."""
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, str(torch.device(device)))


class ExportedDetector:
    """A loaded serving archive (`Detector.load_exported`). A call takes
    numpy or a tensor of exactly the exported shape and dtype (anything
    else raises), moves it to the archive's device (contiguous) and runs
    the program under no_grad with TF32 off (`full_f32`: the TF32 flags
    are global, not part of the graph, so an f32 archive's library convs
    would otherwise run in TF32)."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self.module = program.module()
        (name,) = program.graph_signature.user_inputs
        spec = next(n.meta["val"] for n in program.graph.nodes
                    if n.op == "placeholder" and n.name == name)
        self.shape = tuple(int(d) for d in spec.shape)
        self.dtype = spec.dtype
        self.device = spec.device

    def __call__(self, images_u8: np.ndarray | torch.Tensor
                 ) -> dict[str, torch.Tensor]:
        frames = torch.as_tensor(images_u8)
        if tuple(frames.shape) != self.shape or frames.dtype != self.dtype:
            raise ValueError(
                f"the archive takes {self.dtype} frames of shape "
                f"{self.shape}, got {frames.dtype} {tuple(frames.shape)}")
        # contiguous, as the example the program was traced on
        with torch.no_grad(), full_f32(), span("serve.request"):
            with span("serve.copy"):
                frames = frames.to(self.device).contiguous()
            with span("serve.program"):
                return self.module(frames)
