"""Train-step stage profile (counterpart of scripts/profile_train.py).

    python -m yolo_re_tpu_torch.cli.profile_train [--model gelan-c]
        [--batch 32] [--size 640] [--dtype bfloat16|float32] [--iters 5]
        [--remat off|true|early] [--gt 8] [--per-layer] [--device cuda]

A Trainer of `--model` (a file of configs/models/, or a path to a YAML;
random weights from seed 0) in `--dtype`, with `--remat`, on one
synthetic batch on the device (data/synth.make_eval_batch, numpy seed 0,
uint8 images, `--gt` padded GT rows an image). Each stage runs the
Trainer's own pieces on that batch, as `Trainer._step` runs them (uint8
cast and / 255, NCHW in channels_last memory), and is timed between CUDA
events over `--iters` calls after a warm-up call
(`utils/profiling.device_timer`):

    fwd            the train forward, a surrogate sum of the predictions
    fwd_bwd        that, plus torch.autograd.grad  -> the model's backward
    fwd_loss       the forward plus TALoss, no grad  -> the loss's forward
    fwd_loss_bwd   the real objective's gradients
    full           Trainer._step itself: + clip, the update rule, EMA
    tal_only       TALoss on fixed predictions (a cross-check)

Stage costs are the deltas between consecutive rows (printed as the JAX
script prints them); in eager PyTorch nothing fuses across a stage's
boundary, so the deltas are each piece's own time.

`--per-layer`: the forward by plan step, in train mode. A layer's
forward ("fwd") is the device time of the kernels launched inside its
range (forward hooks, as cli/profile_layers.py), from one trace of
`--iters` train forwards; the TOTAL row gives the forward's kernel time
beside the `fwd` stage.

It runs on the card (`--device cuda`, the default; without a card it
exits with 2 and says so) or, when asked, on the CPU (`--device cpu`:
the kernels' plain versions, host clock; a layer's time is its ops' CPU
time). Everything runs under `utils/precision.full_f32` (TF32 off), as
the Trainer's step does.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from yolo_re_tpu_torch.cli.profile_layers import config_path
from yolo_re_tpu_torch.data.synth import make_eval_batch
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.serving import DTYPES
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer
from yolo_re_tpu_torch.utils.devices import get_device
from yolo_re_tpu_torch.utils.precision import full_f32
from yolo_re_tpu_torch.utils.profiling import (
    device_timer,
    layer_ranges,
    time_by_layer,
    traced,
)

STAGES = ("fwd", "fwd_bwd", "fwd_loss", "fwd_loss_bwd", "full", "tal_only")
REMAT = {"off": False, "true": True, "early": "early"}


def _leaves(tree) -> list[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [leaf for t in tree for leaf in _leaves(t)]


def surrogate(preds) -> torch.Tensor:
    """The f32 sum of every prediction tensor: a "loss" that reads all of
    the forward's outputs."""
    return sum(p.float().sum() for p in _leaves(preds))


def make_trainer(model: str, dtype: str, remat, device: torch.device,
                 output_dir: str) -> Trainer:
    """A Trainer of `model` (random weights from seed 0) in `dtype` with
    `remat`, no data parallelism, no device augmentation."""
    cfg = TrainConfig(epochs=1, compute_dtype=dtype, remat=remat,
                      data_parallel=False, output_dir=output_dir)
    return Trainer(YOLO.from_yaml(config_path(model)), config=cfg,
                   train_loader=[None], device=device)


def device_batch(batch: int, size: int, gt: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(uint8 NHWC images, (batch, gt, 5) f32 targets) on `device`."""
    b = make_eval_batch(batch, size, 0, max_boxes=gt)
    return (torch.from_numpy(b["images"]).to(device),
            torch.from_numpy(b["targets"]).to(device))


class Stages:
    """The stage functions of one Trainer on one batch (module
    docstring)."""

    def __init__(self, trainer: Trainer, x: torch.Tensor, t: torch.Tensor):
        self.tr, self.x, self.t = trainer, x, t
        self.params = list(trainer.params.values())

    def inputs(self) -> torch.Tensor:
        return self.tr._normalized(self.x).contiguous().permute(0, 3, 1, 2)

    def preds(self):
        return self.tr.model(self.inputs(), remat=self.tr._remat)

    def grad(self, total: torch.Tensor) -> None:
        torch.autograd.grad(total, self.params, allow_unused=True)

    def fwd(self):
        return surrogate(self.preds())

    def fwd_bwd(self):
        self.grad(self.fwd())

    def fwd_loss(self):
        return self.tr.loss_fn(self.preds(), self.t)

    def fwd_loss_bwd(self):
        self.grad(self.fwd_loss()[0])

    def full(self):
        return self.tr._step(self.x, self.t)

    def fixed_preds(self):
        """One forward's predictions, detached, f32: tal_only's input."""
        with torch.no_grad():
            preds = self.preds()
        return [(b.float(), c.float()) for b, c in preds] \
            if isinstance(preds, list) else \
            {k: [(b.float(), c.float()) for b, c in v]
             for k, v in preds.items()}


@full_f32()
def stage_times(stages: Stages, iters: int,
                names=STAGES) -> dict[str, float]:
    """ms per call of each stage in `names`, in order; printed as they
    come."""
    times: dict[str, float] = {}
    batch = stages.x.shape[0]
    for name in names:
        if name == "tal_only":
            preds0 = stages.fixed_preds()
            ms = device_timer(lambda p, t: stages.tr.loss_fn(p, t), preds0,
                              stages.t, iters=iters) * 1e3
            print(f"{name:14s} {ms:8.2f} ms", flush=True)
        else:
            fn = getattr(stages, name)
            ms = device_timer(lambda x: fn(), stages.x, iters=iters) * 1e3
            print(f"{name:14s} {ms:8.2f} ms ({batch / ms * 1e3:7.1f} img/s)",
                  flush=True)
        times[name] = ms
    return times


def print_deltas(times: dict[str, float], batch: int) -> None:
    print("\nstage deltas:")
    print(f"  model forward        {times['fwd']:8.2f} ms")
    print(f"  model backward       {times['fwd_bwd'] - times['fwd']:8.2f} ms")
    print(f"  TAL loss forward     {times['fwd_loss'] - times['fwd']:8.2f} ms"
          f"   (tal_only cross-check {times['tal_only']:.2f} ms)")
    print(f"  TAL fwd+bwd in-ctx   "
          f"{times['fwd_loss_bwd'] - times['fwd_bwd']:8.2f} ms")
    print(f"  clip + SGD + EMA     "
          f"{times['full'] - times['fwd_loss_bwd']:8.2f} ms")
    print(f"  TOTAL                {times['full']:8.2f} ms  "
          f"= {batch / times['full'] * 1e3:.1f} img/s")


@full_f32()
def per_layer(stages: Stages, iters: int) -> dict:
    """Per-layer forward (hook ranges, kernel time) of the train step
    (module docstring). Returns {"rows": [(layer, type, fwd ms)] in plan
    order, "fwd_ms": the sum of the trace's forward time, and the `fwd`
    stage's time}."""
    model, device = stages.tr.model, stages.x.device
    steps = model.plan.steps
    times = stage_times(stages, iters, ("fwd",))
    stages.fwd()
    with layer_ranges(model, [s.name for s in steps]):
        prof = traced(lambda: [stages.fwd() for _ in range(iters)], device)
    by, fwd_total = time_by_layer(prof, device)
    rows = [(s.name, s.type, by.get(s.name, 0.0) / iters / 1e3)
            for s in steps]
    return {"rows": rows, "fwd_ms": fwd_total / iters / 1e3,
            "stage_fwd_ms": times["fwd"], "device": device}


def print_per_layer(res: dict, batch: int) -> None:
    total = res["fwd_ms"]
    what = "kernel" if res["device"].type == "cuda" else "CPU op"
    print(f"\n{'layer':<12} {'type':<16} {'fwd ms':>8}   % of total")
    for name, type_, f in res["rows"]:
        print(f"{name:<12} {type_:<16} {f:8.3f}   {100 * f / total:5.1f}%")
    print(f"{'TOTAL':<12} {'':<16} {total:8.3f}   (fwd: {what} time beside "
          f"the fwd stage's {res['stage_fwd_ms']:.3f} ms; surrogate loss, "
          f"batch {batch})")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gelan-c")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--remat", default="off", choices=sorted(REMAT))
    ap.add_argument("--gt", type=int, default=8,
                    help="padded GT boxes per image")
    ap.add_argument("--per-layer", action="store_true",
                    help="per-layer forward attribution")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback")
    args = ap.parse_args(argv)
    try:
        device = get_device(args.device)
    except RuntimeError as e:
        print(f"profile_train: {e}", file=sys.stderr)
        return 2
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"{args.model} train step, {args.dtype}, batch {args.batch}, "
          f"{args.size} px, remat {args.remat}, {args.gt} GT rows an image, "
          f"on {name}; ms per call over {args.iters} after a warm-up")
    with tempfile.TemporaryDirectory(prefix="profile_train_") as td:
        trainer = make_trainer(args.model, args.dtype, REMAT[args.remat],
                               device, td)
        stages = Stages(trainer, *device_batch(args.batch, args.size,
                                               args.gt, device))
        if args.per_layer:
            print_per_layer(per_layer(stages, args.iters), args.batch)
        else:
            print_deltas(stage_times(stages, args.iters), args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
