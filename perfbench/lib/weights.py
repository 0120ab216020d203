"""The benchmark's weights: every tensor of a configuration's network (the
reference's list of names and shapes) drawn from the run's seed on the
device, in two large calls of one `torch.Generator`. A configuration's
`init` may change three of the defaults below (`gain`, `cls_gain`, the
range of `bn_weight`): a network trained from random weights with batch
statistics amplifies rounding with depth, and at the default BN scales
a bfloat16 step departs from a float32 one as far as a float8 step does,
so a training configuration takes small BN scales.

- convolution weights: normal, std GAIN / sqrt(fan in), so activations
  keep their scale through the depth and the head's logits spread;
- BN: scale U(0.75, 1.25), shift U(-0.2, 0.2), running mean U(-0.2, 0.2),
  running variance U(0.75, 1.25), so that folding BN changes the weights;
- convolution biases U(-0.1, 0.1); the box head's biases 1.0 (upstream's
  init); the class head's biases by the configuration's rule: "zero"
  (every anchor passes a serving threshold of 0.25, the most NMS work a
  request can carry) or "prior" (upstream's log(5 / nc / (640 / s)^2)).
"""

from __future__ import annotations

import math

import torch

GAIN = 1.5
CLS_GAIN = 6.0


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2 ** 63)


@torch.no_grad()
def make_weights(spec: list, seed: int, device: torch.device,
                 class_bias: str, num_classes: int, strides,
                 init: dict | None = None) -> dict:
    """{name: f32 tensor on `device`} for (name, shape, kind) `spec`.
    `init` may replace the defaults: "gain", "cls_gain", "bn_weight"
    (its range)."""
    init = init or {}
    gain_all = init.get("gain", GAIN)
    cls_gain = init.get("cls_gain", CLS_GAIN)
    bn_lo, bn_hi = init.get("bn_weight", (0.75, 1.25))
    g = generator(seed, device)
    n_normal = sum(math.prod(s) for _, s, k in spec if k.startswith("conv"))
    n_unif = sum(math.prod(s) for _, s, k in spec if not k.startswith("conv"))
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device)
    out, i, j = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind.startswith("conv"):
            gain = cls_gain if kind == "conv.cls" else gain_all
            out[name] = normal[i:i + n].view(shape) * (
                gain / math.sqrt(math.prod(shape[1:])))
            i += n
            continue
        u = unif[j:j + n].view(shape)
        j += n
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        elif kind == "bn_w":
            out[name] = bn_lo + (bn_hi - bn_lo) * u
        elif kind == "bn_var":
            out[name] = 0.75 + 0.5 * u
        elif kind in ("bn_b", "bn_mean"):
            out[name] = 0.4 * u - 0.2
        elif kind == "bias":
            out[name] = 0.2 * u - 0.1
        elif kind == "box_bias":
            out[name] = torch.ones_like(u)
        elif kind.startswith("cls_bias."):
            level = int(kind.split(".")[1])
            if class_bias == "zero":
                out[name] = torch.zeros_like(u)
            elif class_bias == "prior":
                out[name] = torch.full_like(u, math.log(
                    5 / num_classes / (640 / strides[level]) ** 2))
            else:
                raise ValueError(f"unknown class-bias rule {class_bias!r}")
        else:
            raise ValueError(f"unknown tensor kind {kind!r}")
    return {k: v.contiguous() for k, v in out.items()}
