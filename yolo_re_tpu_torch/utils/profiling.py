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
  counterpart;
- `layer_ranges`, `traced`, `time_by_layer`: device time by plan
  layer (cli/profile_layers.py, cli/profile_train.py). Forward hooks open
  a `torch.profiler` range around each layer's call; a trace's device
  work goes to the range around the op that launched it (on the CPU, each
  op's own CPU time to the range around the op);
- `span`: the program's own ranges, at the layer boundaries of a
  serving call (`serving.py`: `serve.*`) and of a train step and epoch
  (`train/trainer.py`: `train.*`). They open only while a
  `torch.profiler` is collecting, and cost one flag check otherwise. To
  turn them on, run the work inside `trace(logdir)` (or any
  `torch.profiler.profile`): each span is then a named range of the
  Chrome trace, and the device work launched inside it is linked to it.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections.abc import Iterator
from pathlib import Path

import torch
from torch.autograd import DeviceType


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


LAYER_RANGE = "layer "


@contextlib.contextmanager
def layer_ranges(model: torch.nn.Module, names) -> Iterator[None]:
    """While the block runs, each call of `model.layers[name]` for `name`
    in `names` runs inside a `torch.profiler` range named
    `LAYER_RANGE + name`, opened by a forward pre-hook and closed by a
    forward hook; the hooks are removed on exit. The model's forward is
    not changed."""
    stacks: dict[str, list] = {}

    def opener(name: str):
        def hook(module, args):
            rf = torch.profiler.record_function(LAYER_RANGE + name)
            rf.__enter__()
            stacks.setdefault(name, []).append(rf)
        return hook

    def closer(name: str):
        def hook(module, args, output):
            stacks[name].pop().__exit__(None, None, None)
        return hook

    handles = []
    try:
        for name in names:
            layer = model.layers[name]
            handles.append(layer.register_forward_pre_hook(opener(name)))
            handles.append(layer.register_forward_hook(closer(name)))
        yield
    finally:
        for h in handles:
            h.remove()


def _is_annotation(e) -> bool:
    """A kineto device event that is a profiler range's span on the card's
    timeline (gpu_user_annotation), not work."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith(LAYER_RANGE)


def _device_events(prof) -> list:
    """The kineto events of the card's work in a trace: kernels, copies,
    sets (not the ranges' spans)."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not _is_annotation(e)]


def _cpu_ops(prof) -> list:
    """The CPU ops of a CPU trace, outside the layer ranges themselves."""
    return [e for e in prof.events() if e.device_type == DeviceType.CPU
            and not e.is_async and not e.name.startswith(LAYER_RANGE)]


def traced(fn, device: torch.device, tries: int = 3):
    """A `torch.profiler` trace of fn() (CPU activity, and CUDA activity on
    a card), as the finished profiler. fn runs twice: in a warm-up cycle
    that is dropped, then in the recorded one, 50 ms inside it (the
    profiler drops device activity it dates outside its window, and a
    trace that starts with the calls can miss their first launches, F4).
    A trace that holds no device work is taken again, `tries` times in
    all, then this raises: an empty trace is never returned as a
    measurement."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for _ in range(tries):
        with profile(activities=activities, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _cycle in range(2):
                time.sleep(0.05)
                fn()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                time.sleep(0.05)
                prof.step()
        if (_device_events(prof) if device.type == "cuda"
                else _cpu_ops(prof)):
            return prof
    raise RuntimeError(f"torch.profiler: {tries} traces held no "
                       f"{device.type} activity")


def _layer_at(prof):
    """A function (time in ns) -> the layer whose range (`layer_ranges`)
    was open on the host at that time, or None, from a trace's CPU
    ranges (sibling layers: their ranges do not overlap)."""
    spans = sorted((e.start_ns(), e.end_ns(), e.name()[len(LAYER_RANGE):])
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU
                   and e.name().startswith(LAYER_RANGE))
    starts = [s[0] for s in spans]

    def layer_at(t: int) -> str | None:
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else None
    return layer_at


def time_by_layer(prof, device: torch.device, kernel: str | None = None
                  ) -> tuple[dict[str | None, float], float]:
    """(microseconds by layer, total microseconds) of the device work in a
    trace (`traced`). On a card each device event (a kernel, a copy, a
    set) counts once: it goes to the layer whose range (`layer_ranges`)
    was open when the op that launched it started (the op its linked
    correlation id names: where a profiler event of its own shares the
    id, the one inside a range), or to None outside every range; the
    total is the sum of every device event, and an event no op launched
    stays out of the layers (the caller sees it as total - sum). A range's
    own span on the card's timeline is not work and counts nowhere.
    `kernel` (a card only) counts only the device events whose name holds
    it. On the CPU each op's self CPU time goes to the layer whose range
    encloses it, and the total is their sum."""
    by: dict[str | None, float] = {}
    if device.type == "cuda":
        layer_at = _layer_at(prof)
        # the ops' start times by their own correlation ids (the CUDA
        # runtime's CPU events link to an op, and number apart)
        starts: dict[int, list[int]] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CPU \
                    and not e.linked_correlation_id():
                starts.setdefault(e.correlation_id(), []).append(
                    e.start_ns())
        total = 0.0
        for e in _device_events(prof):
            if kernel is not None and kernel not in e.name():
                continue
            us = (e.end_ns() - e.start_ns()) / 1e3
            total += us
            ops = starts.get(e.linked_correlation_id())
            if ops:
                key = next((k for k in map(layer_at, ops) if k), None)
                by[key] = by.get(key, 0.0) + us
        return by, total

    def owner(e) -> str | None:
        while e is not None:
            if e.name.startswith(LAYER_RANGE):
                return e.name[len(LAYER_RANGE):]
            e = e.cpu_parent
        return None

    for e in _cpu_ops(prof):
        key = owner(e)
        by[key] = by.get(key, 0.0) + e.self_cpu_time_total
    return by, sum(by.values())


# -- the program's spans ---------------------------------------------------

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that opens the `torch.profiler` range `name`
    around the block while a profiler collects on this thread (the thread
    that started it, and the threads PyTorch starts from it) and no
    `torch.export` or `torch.compile` traces (a graph holds no profiler
    op); otherwise the shared null context, after one flag check. The
    range is a host event of the trace: the device work its ops launch is
    linked to them by correlation id, as with `layer_ranges`."""
    if not _profiler_enabled() or torch.compiler.is_compiling():
        return _OFF
    return torch.profiler.record_function(name)
