"""Device time of each launch inside one call of a train kernel's wrapper,
and of one gelan-c train step.

    python -m yolo_re_tpu_torch.cli.profile_launches [kernels|train]

`kernels` (the default): a wrapper such as `adown_bwd` makes several
launches from one C entry point; `chip_smoke.py` times the call as a
whole. This traces a few calls with `torch.profiler` and prints, per
call, each kernel's device time: the bf16 ADown backward at gelan-c's
down1 and down3 shapes (640 px, batch 32) and the bf16 stem weight
gradient at (32, 3, 640, 640) -> 64.

`train`: gelan-c, bf16, batch 32, 640 px, random weights and synthetic
batches (as chip_smoke.py's phase 8): after a warm-up step, the host
clock over five steps, then the device time per step over five traced
steps (after three more), in all and by kernel (the largest first).

Random inputs from a fixed seed. It needs a CUDA card and exits with 2
without one; the first lines are the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from yolo_re_tpu_torch.ops.kernels import adown, stem

BATCH = 32
# (Cin, H, W) -> Cout of gelan-c's down1 and down3 at 640 px
ADOWN_SHAPES = {"down1": (256, 160, 160, 256), "down3": (512, 40, 40, 512)}
REPS = 5


def launch_times(fn) -> list[tuple[float, int, str]]:
    """(ms per call, launches per call, kernel name) of each kernel that
    `fn` launches, from REPS traced calls after three warm-up calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    rows = [(ev.device_time_total / REPS / 1e3, ev.count // REPS, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.device_time_total > 0]
    return sorted(rows, reverse=True)


def report(title: str, rows: list[tuple[float, int, str]]) -> None:
    print(title)
    for ms, n, name in rows:
        print(f"  {ms:.4f} ms  x{n}  {name[:100]}")
    print(f"  total {sum(r[0] for r in rows):.4f} ms")


def train_step() -> None:
    import tempfile
    import time
    from pathlib import Path

    from yolo_re_tpu_torch.data.synth import make_eval_batch
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.train.config import TrainConfig
    from yolo_re_tpu_torch.train.trainer import Trainer

    root = Path(__file__).resolve().parents[2]
    model = YOLO.from_yaml(root / "configs" / "models" / "gelan-c.yaml")
    batches = [make_eval_batch(BATCH, 640, seed) for seed in range(4)]
    cfg = TrainConfig(epochs=1, compute_dtype="bfloat16",
                      data_parallel=False,
                      output_dir=tempfile.mkdtemp(prefix="profile_"))
    trainer = Trainer(model, config=cfg, train_loader=batches, device="cuda")

    def step(i: int) -> None:
        b = batches[i % len(batches)]
        trainer.train_step(b["images"], b["targets"])

    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5):
        step(i)
    torch.cuda.synchronize()
    print(f"gelan-c bf16 train step, batch {BATCH}, 640 px: host clock "
          f"{(time.perf_counter() - t0) / 5 * 1e3:.1f} ms per step over 5")
    rows = launch_times(lambda: step(1))
    report("device time per step, by kernel (largest 15 of "
           f"{len(rows)})", rows[:15])
    print(f"  all kernels {sum(r[0] for r in rows):.4f} ms per step")


def main(argv: list[str] | None = None) -> int:
    what = (sys.argv[1:] if argv is None else argv) or ["kernels"]
    if what[0] not in ("kernels", "train"):
        print("usage: profile_launches [kernels|train]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_launches: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    if what[0] == "train":
        train_step()
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0, cl=True):
        t = (torch.randn(*shape, generator=gen, device=dev) * scale).bfloat16()
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    for name, (cin, h, w, cout) in ADOWN_SHAPES.items():
        x = rand(BATCH, cin, h, w)
        w1 = rand(cout // 2, cin // 2, 3, 3, scale=0.03, cl=False)
        w2 = rand(cout // 2, cin // 2, 1, 1, scale=0.06, cl=False)
        g = rand(BATCH, cout, h // 2, w // 2)
        report(f"adown_bwd {name} bf16 x {tuple(x.shape)} -> {cout}, per "
               f"call", launch_times(lambda: adown.adown_bwd(x, g, w1, w2)))
        del x, g
    x = rand(BATCH, 3, 640, 640)
    g = rand(BATCH, 64, 320, 320)
    report(f"stem_wgrad bf16 x {tuple(x.shape)} -> 64, per call",
           launch_times(lambda: stem.stem_wgrad(x, g)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
