"""Device discovery helpers (counterpart of yolo_re_tpu/utils/devices.py;
reference analogue: src/yolo/utils/device.py).

The JAX package picks the first device of the best backend and falls
through to the CPU. The port has no silent CPU fallback: "auto" means the
first card and raises without one, and the CPU is taken only when it is
asked for, as the port's entry points do.
"""

from __future__ import annotations

import torch


def get_device(prefer: str = "auto") -> torch.device:
    """"auto": the first CUDA card (RuntimeError without one); "cpu",
    "cuda" or "cuda:i": that device, a card only if it exists."""
    if prefer == "auto":
        prefer = "cuda:0"
    if prefer != "cpu" and prefer.split(":")[0] != "cuda":
        raise ValueError(f"get_device: {prefer!r} is not 'auto', 'cpu' or "
                         f"'cuda[:i]'")
    dev = torch.device(prefer)
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = dev.index or 0
        if index >= n:
            raise RuntimeError(
                f"get_device({prefer!r}): {n} CUDA device(s); the port does "
                f"not fall back to the CPU (ask for 'cpu')")
        return torch.device("cuda", index)
    return dev


def device_summary() -> str:
    """The local devices by kind, e.g. "cuda: 1x NVIDIA H100 80GB HBM3";
    "cpu: 1x cpu" on a host without a card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        return "cpu: 1x cpu"
    kinds: dict[str, int] = {}
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_name(i)
        kinds[name] = kinds.get(name, 0) + 1
    return "cuda: " + ", ".join(f"{n}x {k}" for k, n in kinds.items())
