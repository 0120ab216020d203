"""The YOLO model: `nn.Module` over a static plan (counterpart of
yolo_re_tpu/models/yolo.py).

Layers live in `self.layers` (an `nn.ModuleDict` keyed by the YAML layer
names), so parameters carry the reference state-dict names
(`layers.stem1.conv.weight`, ...). In eval mode `forward` returns the
decoded predictions; in train mode (`model.train()`: BN batch statistics
and running-stat updates) the head's per-level (box, cls) pairs that the
TAL loss takes (a dual head: both as {"aux", "main"} dicts).
`forward(x, main_only=True)` runs only what the head's main branch needs
(the serving and eval forward); `head_mode="split"` (eval,
`predict_split`) returns the head's flat raw streams for lazy-decode NMS.
`forward(x, remat=True | "early")` in train mode recomputes each block
(every block, or those at a downscale <= 8) in the backward instead of
keeping its activations (torch.utils.checkpoint; the JAX package's
`jax.checkpoint` per plan step). `param_labels` groups the parameters for
the optimizer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from pathlib import Path

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.builder import INPUT, Plan, build_plan
from yolo_re_tpu_torch.models.config import ModelConfig, parse_yaml
from yolo_re_tpu_torch.models.fuse import fuse_model
from yolo_re_tpu_torch.models.heads import HEADS, DualDetectDFL
from yolo_re_tpu_torch.ops.conv import recomputing
from yolo_re_tpu_torch.parallel.mesh import batch_group, global_batch


def check_remat(remat) -> bool | str:
    """yolo_re_tpu/models/yolo.py:104-108: a bool (ints by truthiness, as
    from YAML or a CLI) or "early"; any other string raises."""
    if not isinstance(remat, str):
        return bool(remat)
    if remat != "early":
        raise ValueError(f"remat must be a bool or 'early', got {remat!r}")
    return remat


def remat_step(step, remat: bool | str) -> bool:
    """Whether `remat` recomputes this plan step: every step for True; for
    "early" the steps whose output is at a downscale <= 8, which hold most
    of the activation memory and a minority of the operations."""
    return remat is True or (remat == "early" and 0 < step.scale <= 8)


@contextlib.contextmanager
def _recompute(group):
    """The checkpoint's recompute context: the running statistics stay as
    the first run left them, and the batch reductions span the group the
    first run saw. On a card autograd runs the backward on its own
    thread, where the caller's `global_batch` is not set."""
    with global_batch(group), recomputing():
        yield


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

    def forward(self, x: torch.Tensor, main_only: bool = False,
                head_mode: str = "full", remat: bool | str = False):
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
        forward.

        head_mode "split" (eval only): the head's flat (box logits
        (B, A, 4*reg_max), class logits (B, A, nc)) f32 streams, a dual
        head's main branch (`predict_split`).

        remat (train; eval ignores it): True or "early" runs the chosen
        plan steps (`remat_step`) under torch.utils.checkpoint, so the
        backward recomputes their activations from the step's inputs. The
        recompute updates no running statistic and reduces the batch over
        the `global_batch` group of this call."""
        remat = check_remat(remat)
        if self.training and self.fused:
            raise RuntimeError(
                "a fused model has no BN to train: call .eval(), or train "
                "the unfused model")
        if self.training and main_only:
            raise ValueError("main_only is an eval forward")
        if self.training and head_mode != "full":
            raise ValueError(f"head_mode {head_mode!r} is an eval forward")
        if not self.training:
            remat = False
        if remat:
            group = batch_group()

            def contexts():
                return contextlib.nullcontext(), _recompute(group)
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
            layer = self.layers[step.name]
            kw = {}
            if step.name == self.plan.detect_name:
                if not isinstance(inp, list):
                    inp = [inp]
                kw = {"main_only": main_only, "mode": head_mode}
            if remat and remat_step(step, remat):
                # the forward draws no random numbers: no RNG state kept
                out = checkpoint(layer, inp, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=contexts, **kw)
            else:
                out = layer(inp, **kw)
            if step.name in self._save_names or step.name == last:
                outputs[step.name] = out
        return out

    @torch.no_grad()
    def predict_split(self, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The eval forward's flat raw (box logits, class logits) streams
        for lazy-decode NMS (ops/nms.py: non_max_suppression_raw); a dual
        head's main branch, from its main steps alone. The model must be
        in eval mode."""
        if self.training:
            raise ValueError("predict_split is an eval forward: call "
                             ".eval() first")
        return self.forward(x, main_only=True, head_mode="split")
