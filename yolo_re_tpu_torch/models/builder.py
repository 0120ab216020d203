"""YAML graph -> static execution plan (counterpart of
yolo_re_tpu/models/builder.py).

The plan is built without running anything: channel inference with the
width/depth multipliers (reference src/yolo/model/parser.py:33-62,
217-224) and static spatial-scale tracking, so the detect head's strides
are known up front. One `PlanStep` per layer holds the block type, its
constructor arguments and its input names; `YOLO` turns the steps into
modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.config import (
    LayerDef,
    ModelConfig,
    apply_depth_multiplier,
    apply_width_multiplier,
)

INPUT = "input"


@dataclass(frozen=True)
class PlanStep:
    name: str
    type: str
    kwargs: dict = field(hash=False)    # the block constructor's arguments
    inputs: tuple[str, ...]             # producer names (INPUT = the image)
    scale: float = 0.0                  # output downscale vs the input image


@dataclass(frozen=True)
class Plan:
    steps: tuple[PlanStep, ...]
    detect_name: str | None
    detect_inputs: tuple[str, ...]
    strides: tuple[float, ...]
    num_classes: int


class PlanBuilder:
    def __init__(self, num_classes: int, width_mult: float, depth_mult: float,
                 input_channels: int = 3):
        self.num_classes = num_classes
        self.width_mult = width_mult
        self.depth_mult = depth_mult
        self.channel_map: dict[str, int] = {INPUT: input_channels}
        self.scale_map: dict[str, float] = {INPUT: 1.0}
        self.steps: list[PlanStep] = []
        self.prev_name = INPUT
        self.detect_name: str | None = None
        self.detect_inputs: tuple[str, ...] = ()
        self.strides: tuple[float, ...] = ()

    def add_layer(self, ld: LayerDef) -> None:
        name, btype = ld.name, ld.type
        frm = ld.from_layers if ld.from_layers else self.prev_name
        inputs = tuple(frm) if isinstance(frm, list) else (frm,)
        in_ch = [self.channel_map[n] for n in inputs]
        in_scale = [self.scale_map[n] for n in inputs]
        params = dict(ld.params)

        if btype in ("DetectDFL", "DualDetectDFL"):
            # a dual head's strides come from its main (second) half
            # (reference: src/yolo/model/model.py:147-149)
            n = len(in_ch) // 2 if btype == "DualDetectDFL" else 0
            strides = tuple(float(s) for s in in_scale[n:])
            kwargs = {"num_classes": self.num_classes,
                      "in_channels": tuple(in_ch), "strides": strides}
            out_ch, out_scale = 0, in_scale[-1]
            self.strides = strides
            self.detect_name = name
            self.detect_inputs = inputs
        elif btype == "Concat":
            kwargs = {"dimension": params.get("dimension", 1)}
            out_ch, out_scale = sum(in_ch), in_scale[0]
        elif btype == "Silence":
            kwargs, out_ch, out_scale = {}, in_ch[0], in_scale[0]
        elif btype == "Upsample":
            sf = int(params.get("scale_factor", 2))
            kwargs = {"scale_factor": sf,
                      "mode": params.get("mode", "nearest")}
            out_ch, out_scale = in_ch[0], in_scale[0] / sf
        elif btype == "CBLinear":
            ocl = tuple(apply_width_multiplier(c, self.width_mult)
                        for c in params["out_channels_list"])
            kwargs = {"in_channels": in_ch[0], "out_channels_list": ocl,
                      "kernel_size": params.get("kernel_size", 1),
                      "stride": params.get("stride", 1),
                      "padding": params.get("padding"),
                      "groups": params.get("groups", 1)}
            out_ch, out_scale = ocl[-1], in_scale[0] * kwargs["stride"]
        elif btype == "CBFuse":
            kwargs = {"idx": tuple(params["idx"])}
            out_ch, out_scale = in_ch[-1], in_scale[-1]
        else:
            B.get_block_class(btype)     # unknown: raise
            kwargs, out_ch, out_scale = self._build_standard(
                btype, params, in_ch[0], in_scale[0])

        self.steps.append(PlanStep(name, btype, kwargs, inputs,
                                   scale=float(out_scale)))
        self.channel_map[name] = out_ch
        self.scale_map[name] = out_scale
        self.prev_name = name

    def _build_standard(self, btype, params, in_ch, in_scale):
        for p in ("out_channels", "hidden_channels", "block_channels"):
            if p in params:
                params[p] = apply_width_multiplier(params[p], self.width_mult)
        if "num_repeats" in params:
            params["num_repeats"] = apply_depth_multiplier(
                params["num_repeats"], self.depth_mult)
        params["in_channels"] = in_ch
        stride = 2 if btype == "ADown" else params.get("stride", 1)
        return params, params["out_channels"], in_scale * stride

    def build(self) -> Plan:
        return Plan(
            steps=tuple(self.steps),
            detect_name=self.detect_name,
            detect_inputs=self.detect_inputs,
            strides=self.strides,
            num_classes=self.num_classes,
        )


def build_plan(config: ModelConfig, input_channels: int = 3) -> Plan:
    """Parsed ModelConfig -> static Plan."""
    builder = PlanBuilder(
        num_classes=config.num_classes,
        width_mult=config.width_multiplier,
        depth_mult=config.depth_multiplier,
        input_channels=input_channels,
    )
    for layer_dict in config.layers:
        builder.add_layer(LayerDef.from_dict(layer_dict))
    return builder.build()
