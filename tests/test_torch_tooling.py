"""The port's copies of the JAX package's host tooling on the CPU:
`data/voc.py` (the VOC -> YOLO conversion) pinned to the original's
output on a synthetic VOC tree, `utils/profiling.Throughput` pinned to
the original's rates, and `utils/profiling.trace` / `device_timer` run on
CPU tensors (their CUDA side: tests/test_torch_cuda.py, chip_smoke.py
phase 16 (d))."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_re_tpu.data import voc as jvoc
from yolo_re_tpu.utils.profiling import Throughput as JThroughput
from yolo_re_tpu_torch.data import voc
from yolo_re_tpu_torch.utils.profiling import Throughput, device_timer, \
    trace


def _write_xml(path, w, h, objects):
    """objects: (name, xmin, ymin, xmax, ymax, difficult)."""
    objs = "".join(
        f"<object><name>{n}</name><difficult>{d}</difficult>"
        f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
        f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
        for n, x1, y1, x2, y2, d in objects)
    size = "" if w is None else \
        f"<size><width>{w}</width><height>{h}</height></size>"
    path.write_text(f"<annotation>{size}{objs}</annotation>")


def _devkit(root, rng):
    """A VOCdevkit tree: VOC2007 (a test split) and VOC2012, random boxes
    of known, unknown and difficult classes, one image without an
    annotation, one annotation without a size and one with no kept
    object."""
    names = voc.VOC_CLASSES + ["unicorn"]
    for year, n in (("VOC2007", 6), ("VOC2012", 4)):
        (root / year / "JPEGImages").mkdir(parents=True)
        (root / year / "Annotations").mkdir(parents=True)
        for i in range(n):
            img_id = f"{year[-4:]}_{i:03d}"
            (root / year / "JPEGImages" / f"{img_id}.jpg").write_bytes(
                bytes(rng.integers(0, 256, 16, dtype=np.uint8)))
            if i == 1:
                continue
            w, h = (None, None) if i == 2 else \
                (int(rng.integers(100, 640)), int(rng.integers(100, 480)))
            objs = []
            for _ in range(int(rng.integers(0 if i == 3 else 1, 5))):
                x1, y1 = rng.uniform(0, 50, 2).round(1)
                bw, bh = rng.uniform(5, 50, 2).round(1)
                objs.append((names[rng.integers(len(names))], x1, y1,
                             x1 + bw, y1 + bh, int(rng.random() < 0.3)))
            _write_xml(root / year / "Annotations" / f"{img_id}.xml", w, h,
                       objs)
    main = root / "VOC2007" / "ImageSets" / "Main"
    main.mkdir(parents=True)
    (main / "test.txt").write_text("2007_000\n2007_004\n\n")


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_voc_copy_matches_the_original(tmp_path, capsys):
    """convert_voc_devkit and voc_xml_to_yolo of the copy write the same
    files (names and bytes) and return the same paths' tails as the
    JAX package's, with copied and with symlinked images."""
    devkit = tmp_path / "VOCdevkit"
    _devkit(devkit, np.random.default_rng(0))
    assert voc.VOC_CLASSES == jvoc.VOC_CLASSES
    for xml in sorted(devkit.rglob("*.xml")):
        for keep in (False, True):
            assert voc.voc_xml_to_yolo(xml, keep) == \
                jvoc.voc_xml_to_yolo(xml, keep)
    for copy_images in (True, False):
        outs = []
        for name, mod in (("port", voc), ("jax", jvoc)):
            out = tmp_path / f"{name}_{copy_images}"
            dirs = mod.convert_voc_devkit(devkit, out,
                                          copy_images=copy_images)
            outs.append(([str(Path(p).relative_to(out)) for p in dirs],
                         _tree(out), capsys.readouterr().out
                         .replace(str(out), "OUT")))
        assert outs[0] == outs[1]
        labels = [k for k in outs[0][1] if k.startswith("labels/val")]
        assert labels and outs[0][0] == ["images/train", "images/val"]


def test_throughput_copy_matches_the_original(monkeypatch):
    """The same clock gives the same smoothed rates."""
    clock = list(np.cumsum([0.0, 0.5, 0.25, 1.0, 0.125, 2.0]))
    got = []
    for cls in (Throughput, JThroughput):
        it = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        meter = cls(smoothing=0.8)
        got.append([meter.update(n) for n in (32, 32, 16, 64, 32, 8)])
    assert got[0] == got[1]
    assert got[0][0] == 0.0 and got[0][1] == 64.0


def test_trace_and_device_timer_on_the_cpu(tmp_path):
    """trace() writes a Chrome trace holding the traced ops; device_timer
    returns seconds per call on the host clock for CPU tensors, after one
    warm-up call."""
    a = torch.randn(64, 64)
    with trace(tmp_path / "t") as prof:
        torch.mm(a, a)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())
    calls = []

    def fn(x, pair):
        calls.append(1)
        return x @ pair[0]

    s = device_timer(fn, a, (a,), iters=5)
    assert len(calls) == 6 and 0 < s < 10
    with pytest.raises(TypeError):
        device_timer(fn, a)
