"""The port's profile_layers, profile_train and visualize_augment CLIs
(yolo_re_tpu_torch/cli/), run on TINY_YAML with `--device cpu` (the
kernels' plain versions) in one subprocess with jax and the JAX package
blocked and no card visible: the per-layer rows are the JAX plan's steps
in order and sum to the TOTAL, profile_train prints its six stages and
the deltas (and, `--per-layer`, a forward row for each plan step), and
visualize_augment writes the files scripts/visualize_augment.py writes,
byte for byte. Without `--device cpu` and without a card the profilers
exit with 2 and say why, and run nothing on the CPU.
"""

import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu_torch.data import synth

ROOT = Path(__file__).resolve().parent.parent
BLOCK_JAX = ("import contextlib, io, json, runpy, sys\n"
             "for m in ('jax', 'jaxlib', 'yolo_re_tpu'):\n"
             "    sys.modules[m] = None\n")
RUN = ("def run(mod, argv):\n"
       "    out, err = io.StringIO(), io.StringIO()\n"
       "    sys.argv = [mod] + argv\n"
       "    with contextlib.redirect_stdout(out), "
       "contextlib.redirect_stderr(err):\n"
       "        try:\n"
       "            runpy.run_module('yolo_re_tpu_torch.cli.' + mod,\n"
       "                             run_name='__main__')\n"
       "            rc = 0\n"
       "        except SystemExit as e:\n"
       "            rc = e.code or 0\n"
       "    return {'rc': rc, 'out': out.getvalue(), 'err': err.getvalue()}\n")
JAX_LOADED = ("print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]"
              " in ('jax', 'jaxlib', 'yolo_re_tpu') and sys.modules[m] is "
              "not None))\n")
TOTAL = "TOTAL"
STAGES = ("fwd", "fwd_bwd", "fwd_loss", "fwd_loss_bwd", "full", "tal_only")
DELTAS = ("model forward", "model backward", "TAL loss forward",
          "TAL fwd+bwd in-ctx", "clip + SGD + EMA", "TOTAL")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CLI run of this module, in one subprocess: {key: {"rc", "out",
    "err"}}, plus the tiny config, the data and output directories."""
    root = tmp_path_factory.mktemp("profile")
    cfg = root / "tiny.yaml"
    cfg.write_text(synth.TINY_YAML)
    data = synth.write_dataset(str(root / "data"), "train", 4, seed=0)
    small = ["--model", str(cfg), "--batch", "1", "--size", "64",
             "--iters", "1", "--dtype", "float32"]
    cases = {
        "layers": ("profile_layers", small + ["--device", "cpu"]),
        "train": ("profile_train", small + ["--device", "cpu"]),
        "per_layer": ("profile_train", small + ["--device", "cpu",
                                                "--per-layer"]),
        "visualize": ("visualize_augment", [
            "--data", data, "--img-size", "96", "--n-train", "3",
            "--n-val", "2", "--out", str(root / "port")]),
        "layers_no_card": ("profile_layers", small),
        "train_no_card": ("profile_train", small),
    }
    code = BLOCK_JAX + RUN + "".join(
        f"print('RESULT', {key!r}, json.dumps(run({mod!r}, {argv!r})))\n"
        for key, (mod, argv) in cases.items()) + JAX_LOADED
    # no card, on any machine: the runs without --device must refuse
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = {}
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            _, key, blob = line.split(" ", 2)
            res[key] = json.loads(blob)
        elif line.startswith("LOADED "):
            res["loaded"] = line[len("LOADED "):]
    return {"res": res, "config": str(cfg), "data": data, "root": root}


def _table(out: str, width: int) -> list[tuple[str, list[str]]]:
    """The rows of a layer table, up to and with TOTAL: (name, the other
    fields); names are left-aligned in `width` columns."""
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("layer "))
    rows = []
    for line in lines[start + 1:]:
        rows.append((line[:width].rstrip(), line[width:].split()))
        if line.startswith(TOTAL):
            return rows
    raise AssertionError(f"no TOTAL row in\n{out}")


def test_no_jax_is_imported(runs):
    assert runs["res"]["loaded"] == "[]"


def test_profile_layers_rows_are_the_plan_steps_and_sum_to_total(runs):
    r = runs["res"]["layers"]
    assert r["rc"] == 0, r["err"]
    rows = _table(r["out"], 18)
    names = [s.name for s in JYOLO.from_yaml(runs["config"]).plan.steps]
    assert [n for n, _ in rows] == names + ["(outside layers)", TOTAL]
    ms = [float(f[-2]) for _, f in rows[:-1]]
    total = rows[-1][1]
    assert float(total[0]) > 0 and all(m >= 0 for m in ms)
    # printed to 4 decimals
    assert abs(sum(ms) - float(total[0])) <= 1e-4 * len(ms)
    assert "idle share" in r["out"] and "without the hooks" in r["out"]


def test_profile_train_prints_the_stages_and_deltas(runs):
    r = runs["res"]["train"]
    assert r["rc"] == 0, r["err"]
    lines = r["out"].splitlines()
    for stage in STAGES:
        row = next(line for line in lines if line.split()[:1] == [stage])
        assert float(row.split()[1]) > 0, row
    deltas = lines[lines.index("stage deltas:") + 1:]
    assert [next(d for d in DELTAS if line.strip().startswith(d))
            for line in deltas] == list(DELTAS)


def test_profile_train_per_layer_has_a_row_per_plan_step(runs):
    r = runs["res"]["per_layer"]
    assert r["rc"] == 0, r["err"]
    rows = _table(r["out"], 12)
    names = [s.name for s in JYOLO.from_yaml(runs["config"]).plan.steps]
    assert [n for n, _ in rows] == names + [TOTAL]
    fwd = [float(fields[1]) for _, fields in rows[:-1]]
    total = float(rows[-1][1][0])
    # the rows hold the ops inside the layers' ranges, the TOTAL every op
    # of the trace; printed to 3 decimals
    assert total > 0 and all(f >= 0 for f in fwd)
    assert sum(fwd) <= total + 1e-3 * len(fwd)
    assert "fwd stage" in r["out"]
    assert "f+b" not in r["out"] and "bwd ms" not in r["out"]


def test_visualize_augment_matches_the_jax_script(runs, monkeypatch):
    r = runs["res"]["visualize"]
    assert r["rc"] == 0, r["err"]
    jax_out = runs["root"] / "jax"
    monkeypatch.setattr(sys, "argv", [
        "visualize_augment.py", "--data", runs["data"], "--img-size", "96",
        "--n-train", "3", "--n-val", "2", "--out", str(jax_out)])
    runpy.run_path(str(ROOT / "scripts" / "visualize_augment.py"),
                   run_name="__main__")
    want = sorted(p.name for p in jax_out.iterdir())
    assert want == ["train0.jpg", "train1.jpg", "train2.jpg", "val0.jpg",
                    "val1.jpg"]
    port = runs["root"] / "port"
    assert sorted(p.name for p in port.iterdir()) == want
    for name in want:
        assert (port / name).read_bytes() == (jax_out / name).read_bytes()


@pytest.mark.parametrize("key", ["layers_no_card", "train_no_card"])
def test_profilers_refuse_without_a_card(runs, key):
    r = runs["res"][key]
    assert r["rc"] == 2
    assert "does not fall back to the CPU" in r["err"]
    assert "TOTAL" not in r["out"]
