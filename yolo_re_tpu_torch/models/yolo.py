"""The YOLO model: `nn.Module` over a static plan (counterpart of
yolo_re_tpu/models/yolo.py).

Layers live in `self.layers` (an `nn.ModuleDict` keyed by the YAML layer
names), so parameters carry the reference state-dict names
(`layers.stem1.conv.weight`, ...). In eval mode `forward` returns the
decoded predictions; in train mode (`model.train()`: BN batch statistics
and running-stat updates) the head's per-level (box, cls) pairs that the
TAL loss takes (a dual head: both as {"aux", "main"} dicts).
`forward(x, main_only=True)` runs only what the head's main branch needs
(the serving and eval forward). `param_labels` groups the parameters for
the optimizer.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import torch
from torch import nn

from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.builder import INPUT, Plan, build_plan
from yolo_re_tpu_torch.models.config import ModelConfig, parse_yaml
from yolo_re_tpu_torch.models.fuse import fuse_model
from yolo_re_tpu_torch.models.heads import HEADS, DualDetectDFL


def param_labels(model: nn.Module) -> dict[str, str]:
    """Label each parameter 'weight' (conv weights), 'bn' (BN scales) or
    'bias' (BN shifts and conv biases)."""
    labels = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, nn.BatchNorm2d):
                labels[name] = "bn" if p_name == "weight" else "bias"
            elif isinstance(mod, nn.Conv2d):
                labels[name] = "weight" if p_name == "weight" else "bias"
            else:
                raise ValueError(f"no optimizer group for {name}")
    return labels


class YOLO(nn.Module):
    """YOLO detection model over a static plan.

    Example:
        model = YOLO.from_yaml("configs/models/gelan-c.yaml")
        model.init_parameters(torch.Generator().manual_seed(0))
        decoded, raw = model.eval()(images_nchw)
        pairs = model.train()(images_nchw)     # [(box, cls)] per level
    """

    def __init__(self, plan: Plan, config: ModelConfig | None = None):
        super().__init__()
        self.plan = plan
        self.config = config
        self.num_classes = plan.num_classes
        self.strides = plan.strides
        self.layers = nn.ModuleDict()
        for step in plan.steps:
            cls = HEADS.get(step.type) or B.get_block_class(step.type)
            self.layers[step.name] = cls(**step.kwargs)
        # layer outputs that later steps read; the rest are dropped
        self._save_names = {n for step in plan.steps for n in step.inputs}
        self.main_steps = self._main_steps()
        self.fused = False
        self.eval()

    def _main_steps(self) -> tuple:
        """The steps that the head's main inputs depend on, in plan order,
        the head's step taking only those inputs: what a program that keeps
        only the main branch's output computes (the JAX Detector and
        Evaluator compile the whole dual graph and XLA drops the rest: the
        aux stem and stages, the CBLinears, CBFuses and aux towers). For a
        single head these are the steps the head depends on."""
        plan = self.plan
        if plan.detect_name is None:
            return plan.steps
        inputs = plan.detect_inputs
        if isinstance(self.layers[plan.detect_name], DualDetectDFL):
            inputs = inputs[len(inputs) // 2:]
        needed, keep = set(inputs), []
        for step in reversed(plan.steps):
            if step.name == plan.detect_name:
                keep.append(dataclasses.replace(step, inputs=inputs))
            elif step.name in needed:
                keep.append(step)
                needed.update(step.inputs)
        return tuple(reversed(keep))

    # -- construction -----------------------------------------------------

    @classmethod
    def from_config(cls, config: ModelConfig,
                    input_channels: int = 3) -> "YOLO":
        return cls(build_plan(config, input_channels), config)

    @classmethod
    def from_yaml(cls, path: str | Path, input_channels: int = 3,
                  num_classes: int | None = None) -> "YOLO":
        config = parse_yaml(path)
        if num_classes is not None:
            config.num_classes = num_classes
        return cls.from_config(config, input_channels)

    # -- parameters --------------------------------------------------------

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> "YOLO":
        """The JAX package's init, drawn from `generator` (CPU):
        conv weights (and the head's conv biases) U(-1/sqrt(fan_in), +),
        BN scale 1, bias 0, running mean 0, var 1, then the head's bias
        init. Same distributions as yolo_re_tpu, not the same numbers."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
                bound = 1.0 / math.sqrt(fan_in)
                for p in (m.weight, m.bias):
                    if p is not None:
                        u = torch.rand(p.shape, generator=generator)
                        p.copy_(u * (2 * bound) - bound)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in self.modules():
            if isinstance(m, tuple(HEADS.values())):
                m.init_bias()
        return self

    def fuse(self) -> "YOLO":
        """Fold all BN (and RepConv branches) for inference, in place."""
        fuse_model(self)
        self.fused = True
        return self

    def param_labels(self) -> dict[str, str]:
        """'weight' | 'bn' | 'bias' per parameter name, the optimizer
        groups of the JAX package (yolo_re_tpu/models/yolo.py:25-40;
        reference src/yolo/model/model.py:165-203): conv weights decay,
        BN scales and all biases do not."""
        return param_labels(self)

    # -- execution ----------------------------------------------------------

    def forward(self, x: torch.Tensor, main_only: bool = False):
        """x: (B, 3, H, W) float; run in torch.channels_last memory.

        Eval: (decoded (B, A, 4+nc) f32, raw per-level maps); a dual head:
        ({"aux": decoded, "main": decoded}, {"aux": raw, "main": raw}).
        Train: the per-level (box, cls) f32 pairs ({"aux", "main"} for a
        dual head).

        main_only (eval only): run `main_steps` alone, a dual head only its
        main towers, and return the main branch's (decoded, raw), equal to
        `model(x)`'s "main" entries: the eager stand-in for XLA's
        dead-code elimination in the JAX Detector and Evaluator, which
        keep only `decoded["main"]`. For a single head it is the full
        forward."""
        if self.training and self.fused:
            raise RuntimeError(
                "a fused model has no BN to train: call .eval(), or train "
                "the unfused model")
        if self.training and main_only:
            raise ValueError("main_only is an eval forward")
        x = x.contiguous(memory_format=torch.channels_last)
        outputs = {INPUT: x}
        out = x
        last = self.plan.steps[-1].name
        for step in self.main_steps if main_only else self.plan.steps:
            # CBFuse takes a list even from one input (yolo_re_tpu/models/
            # yolo.py:118); a CBLinear's tuple is kept as it is
            if len(step.inputs) == 1 and step.type != "CBFuse":
                inp = outputs[step.inputs[0]]
            else:
                inp = [outputs[n] for n in step.inputs]
            if step.name == self.plan.detect_name:
                if not isinstance(inp, list):
                    inp = [inp]
                out = self.layers[step.name](inp, main_only=main_only)
            else:
                out = self.layers[step.name](inp)
            if step.name in self._save_names or step.name == last:
                outputs[step.name] = out
        return out
