"""Device helpers that also run on the CPU (the tests drive a run there at
a tiny size)."""

from __future__ import annotations

import sys
import time

import torch


def phase(what: str, t0: float | None = None) -> None:
    """A line on standard error: what happened, and when since t0."""
    at = f" at {time.perf_counter() - t0:.3f} s" if t0 is not None else ""
    print(f"perfbench: {what}{at}", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def release() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
