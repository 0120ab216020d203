"""The benchmark of the PyTorch/CUDA port (`yolo_re_tpu_torch`).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json on the card(s) of this machine and prints,
as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics) and `device`, then `breakdown` (traced
runs) and `checks`, each number compared beside its limit.

Everything is found by name: the cell in perfbench/workloads/<cell>.json
names its configuration (perfbench/configs/<config>.json), its traffic
mix (perfbench/mixes/<traffic>.json, whose `kind` names the generator
perfbench/traffic/<kind>.py) and the limits of its correctness check; a
per-layer metric <name> is read by perfbench/metrics/<name>.py.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_re_tpu")


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, one
    host thread for PyTorch's CPU operations (the host's cores are shared;
    idle worker threads only take turns from the thread that launches the
    kernels), and no JAX loaded by a library."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    cache = ROOT / ".perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(cache / sub))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: int
    trace: bool
    device: object
    t0: float


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 1):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def reports(bench: dict, metric: dict, cell: str) -> bool:
    """Whether `cell` reports the per-layer `metric`: the cells under its
    `workloads`, or else every cell that reports the end-to-end metric
    it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = next(m for m in bench["end_to_end"]
                 if m["name"] == metric["moves"])
    return cell in moves.get("workloads", [cell])


def per_layer(bench: dict, cell: Cell, out: dict) -> dict:
    """The cell's per-layer metrics, each read by its own reader. A reader
    that finds nothing to read in a cell that reports its metric fails
    the run: the yardstick no longer reads what it did."""
    from lib import readers

    ctx = readers.Context(cell=cell, summary=out["summary"],
                          units=out["units"],
                          images_per_unit=out["images_per_unit"])
    metrics = {}
    for m in bench["per_layer"]:
        if not reports(bench, m, cell.name):
            continue
        value = module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is None:
            raise RuntimeError(f"per-layer metric {m['name']} read nothing "
                               f"in {cell.name}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def execute(name: str, seed: int, seconds: int, trace: bool, device,
            bench: dict, cfg: dict | None = None,
            mix: dict | None = None) -> dict:
    """One run of cell `name` on `device`; returns the result's object.
    `cfg` and `mix` replace the cell's configuration and traffic mix (the
    tests run a tiny one on the CPU)."""
    import torch

    work = load(HERE / "workloads" / f"{name}.json")
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    cell = Cell(name=name,
                cfg=cfg or load(HERE / "configs" / f"{work['config']}.json"),
                mix=mix or load(HERE / "mixes" / f"{work['traffic']}.json"),
                limits=work["limits"], seed=seed % 2 ** 63,
                seconds=seconds, trace=trace, device=device, t0=T0)
    out = module(HERE / "traffic" / f"{cell.mix['kind']}.py").run(cell)
    if trace:
        metrics = per_layer(bench, cell, out)
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"] if m["name"] != "setup_s"
                   and name in m.get("workloads", [name])}
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in out["checks"].items()}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else
                   device.type,
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": entry["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace:
        s = out["summary"]
        result["device"].update(busy_s=s.busy_us / 1e6,
                                window_s=s.window_us / 1e6)
        result["breakdown"] = {"device_ops": s.device_ops,
                               "idle_gaps": s.idle_gaps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path[:0] = [str(HERE), str(ROOT)]
    bench = load(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)

    import torch

    torch.set_num_threads(1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        fail(f"needs {entry['chips']} CUDA device(s); found {found}", 3)
    # the reference computes in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from lib.device import phase

    phase("torch and the card ready", T0)
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), device, bench)
    leaked = forbidden_modules()
    if leaked:
        fail(f"modules of the JAX package or JAX are loaded: {leaked}", 4)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'OVER'}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
