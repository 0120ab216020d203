"""Per-layer device time of a model's forward (counterpart of
scripts/profile_layers.py).

    python -m yolo_re_tpu_torch.cli.profile_layers [--model gelan-c]
        [--batch 32] [--size 640] [--dtype bfloat16|float32] [--iters 5]
        [--no-fuse] [--device cuda]

The model (`--model`: a file of configs/models/, or a path to a YAML)
gets random weights from seed 0, is fused unless `--no-fuse`, cast to
`--dtype` and run in eval mode on one batch of random pixels
(numpy default_rng(0)), through `YOLO.forward(main_only=True)`, the
forward the Detector and the Evaluator run. After a warm-up forward,
`--iters` forwards are traced with `torch.profiler`, each plan step's
layer inside a range opened and closed by forward hooks
(`utils/profiling.layer_ranges`; `models/yolo.py` is not changed). A
layer's time is the device time of the kernels launched inside its range;
kernels outside every range (the input's channels_last copy) get the row
"(outside layers)", so the rows sum to the forward's kernel time. Eager
PyTorch runs each layer's kernels as its own launches and fuses nothing
across layers, so the JAX script's cumulative truncation (which reads a
layer as the difference of two compiled prefixes, XLA fusing across their
boundary) is not needed here: every row is the layer's own kernels.

The TOTAL line gives the kernel time, the forward's wall time between
CUDA events (`--iters` forwards before the traces, without the profiler
or the hooks) and
their difference as a share of the wall time, the forward's idle share
(the card waiting on the host's launches). Beside it the kernel time of a
second trace of the same forwards without the hooks shows what the hooks
cost. A trace with no device activity is taken again, up to three times,
then the run fails (`utils/profiling.traced`).

It runs on the card (`--device cuda`, the default; without a card it
exits with 2 and says so) or, when asked, on the CPU (`--device cpu`: the
kernels' plain versions; a row is then the CPU time of the layer's ops,
the wall time the host clock's). The run is under
`utils/precision.full_f32` (TF32 off, as the port's entry points run).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.serving import DTYPES
from yolo_re_tpu_torch.utils.devices import get_device
from yolo_re_tpu_torch.utils.precision import full_f32
from yolo_re_tpu_torch.utils.profiling import (
    device_timer,
    layer_ranges,
    time_by_layer,
    traced,
)

CONFIGS = Path(__file__).resolve().parents[2] / "configs" / "models"
OUTSIDE = "(outside layers)"
UNLINKED = "(no launching op)"


def config_path(model: str) -> Path:
    """A name of configs/models/ (gelan-c, ...) or a path to a YAML."""
    path = Path(model)
    return path if path.suffix in (".yaml", ".yml") else \
        CONFIGS / f"{model}.yaml"


def random_batch(batch: int, size: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(batch, 3, size, size) pixels in [0, 1) from numpy default_rng(0),
    as the JAX script draws them (NHWC), in channels_last memory."""
    x = np.random.default_rng(0).random((batch, size, size, 3), np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype).permute(
        0, 3, 1, 2)


def build_model(model: str, dtype: torch.dtype, device: torch.device,
                fuse: bool = True) -> YOLO:
    """`model` with random weights from seed 0, fused unless asked not to,
    in eval mode on `device` in `dtype`."""
    m = YOLO.from_yaml(config_path(model))
    m.init_parameters(torch.Generator().manual_seed(0))
    if fuse:
        m.fuse()
    return m.eval().to(device=device, dtype=dtype)


@full_f32()
@torch.no_grad()
def profile_forward(model: YOLO, x: torch.Tensor, iters: int = 5) -> dict:
    """The per-layer profile of `model(x, main_only=True)` (module
    docstring). Returns {"rows": [(layer, type, ms per forward)] in plan
    order, then OUTSIDE (and UNLINKED where a device event has no
    launching op), "kernel_ms": their sum, "hookless_kernel_ms",
    "wall_ms", "idle_share", "device", "forwards": the forwards run in
    all (the wall timing and its warm-up, three traces' worth at most)}."""
    device = x.device
    steps = model.main_steps
    names = [s.name for s in steps]
    forwards = 0

    def run(n: int) -> None:
        nonlocal forwards
        for _ in range(n):
            model(x, main_only=True)
        forwards += n

    # timed (after a warm-up forward) before the traces: a process that
    # has traced may launch slower
    wall = device_timer(lambda x: run(1), x, iters=iters) * 1e3
    with layer_ranges(model, names):
        prof = traced(lambda: run(iters), device)
    by, total = time_by_layer(prof, device)
    _, hookless = time_by_layer(traced(lambda: run(iters), device),
                                device)
    rows = [(s.name, s.type, by.get(s.name, 0.0) / iters / 1e3)
            for s in steps]
    rows.append((OUTSIDE, "", by.get(None, 0.0) / iters / 1e3))
    unlinked = total - sum(by.values())
    if device.type == "cuda" and unlinked > 0:
        rows.append((UNLINKED, "", unlinked / iters / 1e3))
    kernel = total / iters / 1e3
    return {"rows": rows, "kernel_ms": kernel,
            "hookless_kernel_ms": hookless / iters / 1e3, "wall_ms": wall,
            "idle_share": (wall - kernel) / wall, "device": device,
            "forwards": forwards}


def print_table(res: dict, batch: int) -> None:
    kernel = res["kernel_ms"]
    what = "kernel" if res["device"].type == "cuda" else "CPU op"
    print(f"\n{'layer':<18} {'type':<16} {'ms/batch':>9}   % of total")
    for name, type_, ms in res["rows"]:
        print(f"{name:<18} {type_:<16} {ms:9.4f}   {100 * ms / kernel:5.1f}%")
    print(f"{'TOTAL':<18} {'':<16} {kernel:9.4f}   ({what} time; wall "
          f"{res['wall_ms']:.4f} ms, idle share {res['idle_share']:.4f}; "
          f"{batch / res['wall_ms'] * 1e3:.0f} img/s, forward only, batch "
          f"{batch}; without the hooks {res['hookless_kernel_ms']:.4f} ms "
          f"of {what} time)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gelan-c")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--no-fuse", action="store_true",
                    help="profile the unfused (training-numerics) model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback")
    args = ap.parse_args(argv)
    try:
        device = get_device(args.device)
    except RuntimeError as e:
        print(f"profile_layers: {e}", file=sys.stderr)
        return 2
    dtype = DTYPES[args.dtype]
    model = build_model(args.model, dtype, device, fuse=not args.no_fuse)
    x = random_batch(args.batch, args.size, dtype, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"{args.model}, {'unfused' if args.no_fuse else 'fused'} "
          f"{args.dtype}, batch {args.batch}, {args.size} px, main-only "
          f"forward on {name}, {args.iters} traced forwards")
    print_table(profile_forward(model, x, args.iters), args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
