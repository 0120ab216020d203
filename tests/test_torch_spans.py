"""The port's spans (utils/profiling.span) on the CPU: without a profiler
they never enter `record_function`; under one, a Detector call and a
Trainer epoch open their ranges at the layer boundaries, nested and in
order, on the clock of `time.time_ns()`; an export writes no profiler op,
a span is off while a compiler traces, and a thread the profiler does not
trace opens none while the profiler's own thread loses none. The trained
fixture assets/dryrun_tiny.npz with TINY_YAML at 160 px for serving;
TINY_YAML from random weights for training."""

import threading
import time
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer
from yolo_re_tpu_torch.utils import profiling

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / \
    "dryrun_tiny.npz"
SERVE = ["serve.copy", "serve.letterbox", "serve.forward", "serve.nms"]
STEP = ["train.input", "train.forward", "train.loss", "train.backward",
        "train.clip", "train.update", "train.ema"]


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


@pytest.fixture(scope="module")
def detector(tiny_yaml):
    return Detector.from_checkpoint(YOLO.from_yaml(tiny_yaml), str(FIXTURE),
                                    device="cpu", img_size=160,
                                    compute_dtype="float32")


def _trainer(tiny_yaml, tmp_path, n_batches: int) -> Trainer:
    batches = [make_eval_batch(2, 64, seed, max_boxes=3)
               for seed in range(n_batches)]
    cfg = TrainConfig(epochs=1, data_parallel=False, log_interval=1,
                      output_dir=str(tmp_path))
    return Trainer(YOLO.from_yaml(tiny_yaml), config=cfg,
                   train_loader=batches, device="cpu")


def _profiled(fn):
    """fn() under a CPU-activity profiler: (profiler, fn's result)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _ranges(prof, prefix: str) -> list[tuple[int, int, str]]:
    """The trace's host ranges whose names start with `prefix`, as
    (start ns, end ns, name) in order of start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU
                  and e.name().startswith(prefix))


def _inside(outer, ranges) -> list[tuple[int, int, str]]:
    return [r for r in ranges if outer[0] <= r[0] <= r[1] <= outer[1]
            and r != outer]


def _in_turn(ranges) -> bool:
    """Each range ends before the next one starts."""
    return all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


def test_no_profiler_never_enters_record_function(detector, tiny_yaml,
                                                  tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("serve.request") is profiling._OFF
    detector(make_eval_batch(2, 160, 0)["images"])
    tr = _trainer(tiny_yaml, tmp_path, 2)
    tr.train_one_epoch(0)
    b = make_eval_batch(2, 64, 9, max_boxes=3)
    tr.train_step(b["images"], b["targets"])
    assert tr.global_step == 3


def test_detector_call_opens_its_spans(detector):
    images = make_eval_batch(3, 160, 1)["images"]
    prof, out = _profiled(lambda: detector(images))
    assert out["valid"].shape[0] == 3
    ranges = _ranges(prof, "serve.")
    request = [r for r in ranges if r[2] == "serve.request"]
    assert len(request) == 1
    kids = _inside(request[0], ranges)
    assert [r[2] for r in kids] == SERVE
    assert _in_turn(kids)
    # the model's own ops run inside serve.forward
    convs = [r for r in _ranges(prof, "aten::conv")]
    forward = kids[SERVE.index("serve.forward")]
    assert convs and all(forward[0] <= c[0] <= c[1] <= forward[1]
                         for c in convs)


def test_train_epoch_opens_its_spans(tiny_yaml, tmp_path):
    tr = _trainer(tiny_yaml, tmp_path, 2)
    prof, _ = _profiled(lambda: tr.train_one_epoch(0))
    assert tr.global_step == 2
    ranges = _ranges(prof, "train.")
    steps = [r for r in ranges if r[2] == "train.step"]
    assert len(steps) == 2
    for step in steps:
        kids = _inside(step, ranges)
        assert [r[2] for r in kids] == STEP
        assert _in_turn(kids)
    top = [r for r in ranges if not any(_inside(s, [r]) for s in steps)]
    # the first two puts, a step, its log line (log_interval 1), the
    # loader's end, the last step and its log line, then the epoch's mean
    assert [r[2] for r in top] == [
        "train.next_batch", "train.next_batch", "train.step", "train.log",
        "train.next_batch", "train.step", "train.log", "train.epoch_end"]
    assert _in_turn(top)


def test_spans_lie_on_the_clock_of_time_ns():
    """A span's range in the trace starts after a `time.time_ns()` read
    before it and ends before one read after it: host times taken with
    that clock sit on the trace's timeline. Spans nest as opened."""
    clocks = []

    def work():
        for _ in range(3):
            before = time.time_ns()
            with profiling.span("t.a"):
                torch.ones(64).sum()
                with profiling.span("t.b"):
                    torch.ones(64).mul(2)
                    with profiling.span("t.c"):
                        torch.ones(8).add(1)
            clocks.append((before, time.time_ns()))
    prof, _ = _profiled(work)
    ranges = _ranges(prof, "t.")
    a = [r for r in ranges if r[2] == "t.a"]
    assert len(a) == len(clocks) == 3
    for (before, after), outer in zip(clocks, a):
        assert before <= outer[0] <= outer[1] <= after
        assert [r[2] for r in _inside(outer, ranges)] == ["t.b", "t.c"]
        b, c = _inside(outer, ranges)
        assert b[0] <= c[0] <= c[1] <= b[1]


def test_export_under_a_profiler_writes_no_profiler_op(detector, tmp_path):
    path = str(tmp_path / "tiny.pt2")
    prof, _ = _profiled(lambda: detector.export(path, 2, height=96,
                                                width=128))
    assert _ranges(prof, "serve.") == []
    run = Detector.load_exported(path)
    targets = [str(n.target) for n in run.program.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]
    frames = make_eval_batch(2, 128, 3)["images"][:, :96]
    prof, _ = _profiled(lambda: run(frames))
    ranges = _ranges(prof, "serve.")
    assert [r[2] for r in ranges] == ["serve.request", "serve.copy",
                                      "serve.program"]
    assert [r[2] for r in _inside(ranges[0], ranges)] == [
        "serve.copy", "serve.program"]


def test_a_span_is_off_while_a_compiler_traces(monkeypatch):
    def work():
        with profiling.span("c.traced"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("c.on") is not profiling._OFF
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert profiling.span("c.traced") is profiling._OFF
        work()
        monkeypatch.undo()
        work()
    assert [r[2] for r in _ranges(prof, "c.")] == ["c.traced"]


def test_a_thread_the_profiler_does_not_trace_opens_no_span():
    """A profiler traces the thread that started it (and the threads
    PyTorch starts from it): its spans are all in the trace while a plain
    thread's spans, run at the same time, are the null context."""
    n = 200
    start = threading.Barrier(2)
    seen = []

    def worker():
        start.wait()
        for _ in range(n):
            seen.append(profiling.span("th.other") is profiling._OFF)
            with profiling.span("th.other"):
                torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = threading.Thread(target=worker)
        t.start()
        start.wait()
        for _ in range(n):
            with profiling.span("th.main"):
                with profiling.span("th.inner"):
                    torch.ones(4).sum()
        t.join(timeout=60)
    assert not t.is_alive() and seen == [True] * n
    ranges = _ranges(prof, "th.")
    assert sum(r[2] == "th.main" for r in ranges) == n
    assert sum(r[2] == "th.inner" for r in ranges) == n
    assert not [r for r in ranges if r[2] == "th.other"]
