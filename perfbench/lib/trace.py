"""Device time by module, from a `torch.profiler` trace kept in memory.

A frozen copy of the attribution of `yolo_re_tpu_torch/utils/profiling.py`
(`layer_ranges`, `time_by_layer`), widened to two sets of ranges: forward
hooks the benchmark installs open a `record_function` range around each
call of a model's layers ("layer <name>") and of its kernel sites ("site
<path>"). Each device event of the trace (a kernel, a copy, a memset)
counts once: for the range of each set that was open on the host when the
op that launched it (its linked correlation id) started. The ranges' own
spans on the device timeline are not work and count nowhere. A
"stretch" range around the whole traced call gives the window.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType

from lib.device import sync

LAYER, SITE, STRETCH = "layer ", "site ", "stretch"
PREFIXES = (LAYER, SITE)


@contextlib.contextmanager
def ranges(model: torch.nn.Module, layers, sites):
    """While the block runs, each call of `model.layers[name]` (name in
    `layers`) and of `model.layers.get_submodule(path)` (path in `sites`)
    runs inside a profiler range; the hooks go on exit."""
    stacks: dict[str, list] = {}

    def opener(label):
        def hook(module, args):
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            stacks.setdefault(label, []).append(rf)
        return hook

    def closer(label):
        def hook(module, args, output):
            stacks[label].pop().__exit__(None, None, None)
        return hook

    handles = []
    try:
        for prefix, names in ((LAYER, layers), (SITE, sites)):
            for name in names:
                mod = model.layers.get_submodule(name)
                handles.append(mod.register_forward_pre_hook(
                    opener(prefix + name)))
                handles.append(mod.register_forward_hook(
                    closer(prefix + name)))
        yield
    finally:
        for h in handles:
            h.remove()


def record(fn, device: torch.device):
    """Run fn() under the profiler, inside the "stretch" range, with the
    device synchronized at both ends; returns (profiler, fn's result)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sync(device)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            result = fn()
            sync(device)
    return prof, result


@dataclass
class Summary:
    """What the readers of per-layer metrics read (all times in us)."""

    window_us: float
    busy_us: float
    untraced_us: float
    device_us: float
    by_layer: dict = field(default_factory=dict)     # name -> us
    by_site: dict = field(default_factory=dict)      # path -> us
    device_ops: list = field(default_factory=list)   # [(name, s)]
    idle_gaps: list = field(default_factory=list)    # [(host op, s)]


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith(PREFIXES) \
        or e.name() == STRETCH


def _spans(cpu_events, prefix):
    """Sorted (start, end, name) of one set's ranges, and the starts."""
    spans = sorted((e.start_ns(), e.end_ns(), e.name()[len(prefix):])
                   for e in cpu_events if e.name().startswith(prefix))
    return spans, [s[0] for s in spans]


def _open_at(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return spans[i][2] if i >= 0 and t <= spans[i][1] else None


def summarize(prof, untraced_s: float) -> Summary:
    """The trace's device time by range, busy time, top device ops and
    idle gaps; `untraced_s`: the wall time of the same stretch run without
    the profiler just before (tracing slows a host-bound stretch)."""
    events = list(prof.profiler.kineto_results.events())
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    dev = [e for e in events if e.device_type() == DeviceType.CUDA
           and not _is_annotation(e)]
    stretch = [e for e in cpu if e.name() == STRETCH]
    if len(stretch) != 1 or not dev:
        raise RuntimeError("the trace holds no stretch or no device work")
    t0, t1 = stretch[0].start_ns(), stretch[0].end_ns()
    starts: dict[int, list[int]] = {}
    for e in cpu:
        if not e.linked_correlation_id():
            starts.setdefault(e.correlation_id(), []).append(e.start_ns())
    sets = {p: _spans(cpu, p) for p in PREFIXES}
    by = {p: {} for p in PREFIXES}
    total, by_name, intervals = 0.0, {}, []
    for e in dev:
        us = (e.end_ns() - e.start_ns()) / 1e3
        total += us
        by_name[e.name()] = by_name.get(e.name(), 0.0) + us
        intervals.append((max(e.start_ns(), t0), min(e.end_ns(), t1)))
        for p, (spans, st) in sets.items():
            key = next((k for k in (_open_at(spans, st, t) for t in
                                    starts.get(e.linked_correlation_id(),
                                               ())) if k), None)
            if key is not None:
                by[p][key] = by[p].get(key, 0.0) + us
    # busy time: the union of the device intervals inside the window
    busy, gaps, end = 0, [], t0
    for s, f in sorted(i for i in intervals if i[1] > i[0]):
        if s > end:
            gaps.append((s - end, end))
        busy += max(0, f - max(s, end))
        end = max(end, f)
    if t1 > end:
        gaps.append((t1 - end, end))
    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                  if e.name() != STRETCH and not e.name().startswith(PREFIXES))
    host_starts = [h[0] for h in host]

    def host_op(t):
        # the innermost host op open at t: the latest started that spans it
        i = bisect.bisect_right(host_starts, t) - 1
        while i >= 0 and i > bisect.bisect_right(host_starts, t) - 400:
            if host[i][1] >= t:
                return host[i][2]
            i -= 1
        return "(no host op)"

    gaps.sort(reverse=True)
    return Summary(
        window_us=(t1 - t0) / 1e3, busy_us=busy / 1e3,
        untraced_us=untraced_s * 1e6, device_us=total,
        by_layer=by[LAYER], by_site=by[SITE],
        device_ops=[[n, us / 1e6] for n, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[host_op(at), ns / 1e9] for ns, at in gaps[:10]])
