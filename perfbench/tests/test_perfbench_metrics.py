"""The benchmark's arithmetic: operations, bytes and bounds from the
configurations' shapes, the trace's reduction, the tail and the rates."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

import run
from lib import readers
from lib.flops import forward_flops, site_bound_s
from lib.trace import Summary, summarize
from reference.model import Network
from torch.autograd import DeviceType


def _net(name):
    return Network(run.load(run.HERE / "configs" / f"{name}.json"))


def test_forward_flops_from_the_configurations():
    # gelan-c deployed: upstream's table gives 102.1 GFLOPs at 640 px
    assert forward_flops(_net("gelan-c"), 640, True) == 102_136_217_600
    # yolov9-c serves its main branch, which is gelan-c
    assert forward_flops(_net("yolov9-c"), 640, True) == 102_136_217_600
    # the train forward: both RepConv branches and both heads
    assert forward_flops(_net("yolov9-c"), 640, False) == 238_652_620_800
    assert forward_flops(_net("gelan-c"), 640, False) > 102_136_217_600


def test_site_bounds_match_the_kernel_tables_bound_column():
    net = _net("gelan-c")
    # PERF.md's kernel table (bf16, 640 px, batch 32): stem 0.1487 ms,
    # the five ADowns summed 0.3144 ms, both bound by bytes
    assert site_bound_s(net, "stem1", 32, 640) * 1e3 == pytest.approx(
        0.1487, abs=5e-5)
    adowns = ("down1", "down2", "down3", "pan_down1", "pan_down2")
    assert sum(site_bound_s(net, s, 32, 640) for s in adowns) * 1e3 == \
        pytest.approx(0.3144, abs=5e-5)
    # the 64-channel 3x3 conv at 160 x 160: 0.0626 ms (bytes)
    assert site_bound_s(net, "stage1.block1.1", 32, 640) * 1e3 == \
        pytest.approx(0.0626, abs=5e-5)


class _Event:
    def __init__(self, name, device, start, end, corr=0, linked=0,
                 annotation=False):
        self._n, self._d, self._s, self._e = name, device, start, end
        self._c, self._l, self._a = corr, linked, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def is_user_annotation(self):
        return self._a


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


CPU, GPU = DeviceType.CPU, DeviceType.CUDA
US = 1000          # ns


def _trace():
    return _prof([
        _Event("stretch", CPU, 0, 1000 * US),
        _Event("layer a", CPU, 100 * US, 300 * US),
        _Event("site a.x", CPU, 150 * US, 250 * US),
        _Event("layer b", CPU, 400 * US, 600 * US),
        _Event("aten::conv", CPU, 160 * US, 170 * US, corr=1),
        _Event("aten::add", CPU, 420 * US, 430 * US, corr=2),
        _Event("aten::copy_", CPU, 700 * US, 710 * US, corr=3),
        _Event("cudaLaunchKernel", CPU, 161 * US, 162 * US, corr=9,
               linked=1),
        _Event("conv_kernel", GPU, 200 * US, 260 * US, linked=1),
        _Event("add_kernel", GPU, 450 * US, 550 * US, linked=2),
        _Event("Memcpy HtoD", GPU, 700 * US, 900 * US, linked=3),
        _Event("layer a", GPU, 200 * US, 260 * US, annotation=True),
    ])


def test_each_device_event_counts_once_for_the_range_open_at_its_launch():
    s = summarize(_trace(), untraced_s=800e-6)
    assert s.device_us == pytest.approx(360)
    assert s.by_layer == pytest.approx({"a": 60, "b": 100})
    assert s.by_site == pytest.approx({"a.x": 60})
    assert s.window_us == pytest.approx(1000)
    assert s.busy_us == pytest.approx(360)
    assert s.untraced_us == pytest.approx(800)
    assert s.device_ops[0] == ["Memcpy HtoD", pytest.approx(200e-6)]
    # the longest idle gaps, each named by the host op open at its start
    assert [g[1] for g in s.idle_gaps] == pytest.approx(
        [200e-6, 190e-6, 150e-6, 100e-6])
    assert s.idle_gaps[2][0] == "(no host op)"


def _ctx(summary, units=2, images=32):
    cell = SimpleNamespace(cfg=run.load(run.HERE / "configs" /
                                        "gelan-c.json"))
    return readers.Context(cell=cell, summary=summary, units=units,
                           images_per_unit=images)


def _reader(name):
    return run.module(run.HERE / "metrics" / f"{name}.py").read


def _sites():
    cfg = run.load(run.HERE / "configs" / "gelan-c.json")
    return [s for group in cfg["kernel_sites"].values() for s in group]


def test_readers_of_the_serving_metrics():
    sites = _sites()
    s = Summary(window_us=1.2e6, busy_us=0.6e6, untraced_us=1.0e6,
                device_us=0.7e6, by_layer={"stem1": 0.4e6},
                by_site={n: 1e3 * (i + 1) for i, n in enumerate(sites)})
    ctx = _ctx(s, units=20, images=32)
    assert _reader("serve.forward_ms")(ctx) == pytest.approx(20.0)
    assert _reader("serve.outside_model_ms")(ctx) == pytest.approx(15.0)
    assert _reader("serve.idle_share")(ctx) == pytest.approx(40.0)
    flops = forward_flops(ctx.net, 640, True) * 32 * 20
    assert _reader("serve.mfu")(ctx) == pytest.approx(
        100 * flops / 1.0 / 989e12)
    bound = sum(site_bound_s(ctx.net, n, 32, 640) for n in sites)
    assert _reader("serve.kernel_roofline")(ctx) == pytest.approx(
        100 * bound * 1e6 * 20 / sum(s.by_site.values()))


def test_a_reader_with_nothing_to_read_returns_nothing():
    s = Summary(window_us=1e6, busy_us=1e5, untraced_us=1e6, device_us=1e5)
    ctx = _ctx(s)
    assert _reader("serve.forward_ms")(ctx) is None
    assert _reader("train.rest_ms")(ctx) is None
    ctx.cell.cfg.pop("kernel_sites")
    assert _reader("serve.kernel_roofline")(ctx) is None


def test_a_kernel_site_the_trace_never_entered_fails():
    sites = _sites()
    s = Summary(window_us=1e6, busy_us=1e5, untraced_us=1e6, device_us=1e5,
                by_site={n: 1e3 for n in sites[1:]})
    with pytest.raises(RuntimeError, match=sites[0]):
        _reader("serve.kernel_roofline")(_ctx(s))


def test_busy_time_over_the_untraced_wall_fails():
    s = Summary(window_us=2e6, busy_us=1.2e6, untraced_us=1e6,
                device_us=1.2e6)
    with pytest.raises(RuntimeError, match="busy time"):
        _reader("serve.idle_share")(_ctx(s))


def test_a_metric_a_cell_reports_that_reads_nothing_fails_the_run():
    bench = run.load(run.ROOT / "BENCHMARK.json")
    cell = SimpleNamespace(name="gelan-c.serve.device",
                           cfg=run.load(run.HERE / "configs" /
                                        "gelan-c.json"))
    s = Summary(window_us=1e6, busy_us=1e5, untraced_us=1e6, device_us=1e5,
                by_site={n: 1e3 for n in _sites()})
    out = {"summary": s, "units": 2, "images_per_unit": 32}
    with pytest.raises(RuntimeError, match="read nothing"):
        run.per_layer(bench, cell, out)
    # a metric is read in the cells that report it, and only there
    train = next(m for m in bench["per_layer"]
                 if m["name"] == "train.rest_ms")
    assert not run.reports(bench, train, cell.name)
    assert run.reports(bench, {k: v for k, v in train.items()
                               if k != "workloads"}, "yolov9-c.train.bf16")


def test_a_stretch_too_short_for_a_share_fails():
    s = Summary(window_us=1e4, busy_us=1e3, untraced_us=1e4, device_us=1e3)
    with pytest.raises(RuntimeError):
        _ctx(s)


def test_the_tail_is_of_every_request():
    serve = run.module(run.HERE / "traffic" / "serve.py")
    lat = [0.010] * 94 + [0.100] * 6
    assert serve.p95_ms(lat) == pytest.approx(100 * 0.95 - 0.05 * 10 * 9,
                                              rel=0.2)
    assert serve.p95_ms(lat) > serve.p95_ms(lat[:94])


def test_a_rate_is_all_the_work_over_the_whole_window():
    serve = run.module(run.HERE / "traffic" / "serve.py")
    s = object.__new__(serve.Serve)
    s.cell = SimpleNamespace(mix={"batch": 8})
    s.latency, s.outputs, s.n = [], [], 0

    def request():
        time.sleep(0.02)
        s.latency.append(0.02)
        s.n += 1
    s.request = request
    t0 = time.perf_counter()
    out = s.window(0.25)
    elapsed = time.perf_counter() - t0
    assert out["serve.images_per_s"] == pytest.approx(
        8 * s.n / elapsed, rel=0.05)
    assert s.n * 0.02 >= 0.25
