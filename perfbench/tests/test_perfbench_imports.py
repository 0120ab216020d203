"""What the benchmark may import, and that its data files agree."""

from __future__ import annotations

import ast
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "yolo_re_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names (before the first dot, whole) of every import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & JAX, f


def test_the_port_passes_the_check_by_its_whole_name():
    assert "yolo_re_tpu_torch" in _imports(HERE / "traffic" / "serve.py")
    assert "yolo_re_tpu_torch".split(".")[0] not in JAX


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "yolo_re_tpu_torch" not in _imports(f), f
        assert not _imports(f) & JAX, f


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_names_files_that_exist():
    bench = _bench()
    for w in bench["workloads"]:
        work = json.loads((HERE / "workloads" /
                           f"{w['name']}.json").read_text())
        assert work["config"] == w["config"]
        assert work["traffic"] == w["traffic"]
        assert (HERE / "configs" / f"{w['config']}.json").is_file()
        mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json")
                         .read_text())
        assert (HERE / "traffic" / f"{mix['kind']}.py").is_file()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]


def test_each_metric_has_a_reader_and_its_cells_report_its_moves():
    bench = _bench()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        moves = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moves.get("workloads", cells)


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    bench = _bench()
    for w in bench["workloads"]:
        names = {m["name"] for m in bench["end_to_end"]
                 if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in names and len(names) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])


def test_benchmark_json_keeps_to_the_format():
    import re

    bench = _bench()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] == 1
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "bound" not in m
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
