"""Profiling and throughput instrumentation (counterpart of
yolo_re_tpu/utils/profiling.py).

- `trace(logdir)`: a context manager around `torch.profiler`, recording
  the host and, when a card is present, the CUDA activity, and writing a
  Chrome trace (chrome://tracing, Perfetto) to logdir/trace.json;
- `Throughput`: images/s meter with exponential smoothing (a copy of the
  JAX package's; tests/test_torch_tooling.py pins the two equal);
- `device_timer`: seconds per call of a function, after a warm-up call,
  between CUDA events on its tensors' device, or on the host clock for
  CPU tensors. Eager PyTorch runs each call as written, so the JAX
  timer's data-dependency chain (against XLA's loop hoisting) has no
  counterpart.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Iterator
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str | Path = "runs/trace") -> Iterator[torch.profiler.profile]:
    """Profile the block: `with trace("runs/t") as prof: run_step()`. On
    exit logdir/trace.json holds the Chrome trace; `prof` is the profiler
    (`prof.key_averages()` after the block)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


class Throughput:
    """Images/sec meter with exponential smoothing."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.rate = None
        self._t = None

    def update(self, n_images: int) -> float:
        now = time.perf_counter()
        if self._t is not None:
            inst = n_images / max(now - self._t, 1e-9)
            self.rate = (inst if self.rate is None
                         else self.smoothing * self.rate
                         + (1 - self.smoothing) * inst)
        self._t = now
        return self.rate or 0.0


def _tensors(args) -> Iterator[torch.Tensor]:
    """The tensors in `args`, nested in lists, tuples and dict values."""
    for a in args:
        if torch.is_tensor(a):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)
        elif isinstance(a, dict):
            yield from _tensors(a.values())


def device_timer(fn, *args, iters: int = 10) -> float:
    """Seconds per call of `fn(*args)`: one warm-up call, then `iters`
    calls timed between two CUDA events on the tensors' card (the device
    time of the calls' work, host gaps between launches included), or on
    the host clock for CPU tensors."""
    dev = next((t.device for t in _tensors(args)), torch.device("cpu"))
    fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
