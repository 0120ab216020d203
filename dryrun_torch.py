"""The PyTorch port's dry run: a compile-free entry point and a
multi-process run over every data-parallel surface (counterpart of
__graft_entry__.py, which drives the JAX package).

    python dryrun_torch.py            # 2 processes, one card each (NCCL)
    python dryrun_torch.py 4          # 4 processes, one card each
    python dryrun_torch.py 2 cpu      # 2 processes on the CPU (gloo)

`entry()` gives the fused gelan-c eval forward and an example input.
`dryrun_multichip(n)` starts n processes joined by torch.distributed over a
`tcp://` rendezvous on a free localhost port (NCCL on cards, one card per
process, fewer cards than n raising; gloo on the CPU, only when asked for
with device="cpu") and runs in each,
with jax and the JAX package blocked, the JAX dry run's phases in order:

1. three data-parallel Trainer steps (f32, TrainConfig's default) at
   160 px on a global batch of 2n random images (each process its rows),
   the third with the "full" device augmentation;
2. the training state saved by process 0 as an .npz and as a checkpoint
   directory, restored by a fresh Trainer in every process, one more step
   from each;
3. serving at 320 px of n + 3 random frames (padded to a multiple of n)
   through `Detector(mesh=)`, then `Evaluator(mesh=)`, on the trained
   weights;
4. the trained fixture assets/dryrun_tiny.npz on TINY_YAML through the
   mesh Detector and Evaluator: more than 0 detections and mAP50 above
   0.2.

Serving and eval in the port are one process over a `Mesh` of local
devices (parallel/mesh.py), so process 0 runs phases 3 and 4 over the n
devices the processes train on while the others wait. Every loss must be
finite. Process 0 prints one OK line with the numbers and returns them
with its kernel launches; a failure raises with every process's stderr.
The processes are what JAX's `dryrun_multihost` starts as hosts: here the
same function covers both.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

GELAN_C = ROOT / "configs" / "models" / "gelan-c.yaml"
FIXTURE = ROOT / "assets" / "dryrun_tiny.npz"
TRAIN_SIZE, SERVE_SIZE = 160, 320
RESULT = "DRYRUN_RESULT "
BLOCK_JAX = ("import sys\n"
             "for m in ('jax', 'jaxlib', 'yolo_re_tpu'):\n"
             "    sys.modules[m] = None\n")


def entry(device: str = "auto"):
    """(fn, example_args): the fused gelan-c eval forward (random weights
    from seed 0) on the first card, or on `device` ("cpu" only when asked:
    `utils.devices.get_device`). fn(images) takes (B, 3, H, W) float32 and
    returns (decoded (B, A, 4 + nc), raw levels)."""
    import torch

    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.utils.devices import get_device

    dev = get_device(device)
    model = YOLO.from_yaml(GELAN_C)
    model.init_parameters(torch.Generator().manual_seed(0))
    model.fuse()
    model.eval().to(dev)

    @torch.no_grad()
    def fn(images):
        # the kernels read NHWC memory (channels_last)
        return model(images.contiguous(memory_format=torch.channels_last))

    example_args = (torch.zeros((1, 3, 640, 640), dtype=torch.float32,
                                device=dev),)
    return fn, example_args


class _Rows(list):
    """This process's slices of the global batches, marked as the Trainer
    requires of a data-parallel loader."""

    def __init__(self, items, shard, batch_size):
        super().__init__(items)
        self.shard = shard
        self.batch_size = batch_size
        self.drop_last = True


def run_worker(rank: int, world: int, port: int, device: str,
               model_yaml: str, root: str, started: float) -> dict:
    """One process of `dryrun_multichip`: the phases of the module
    docstring. Returns the numbers process 0 reports, with the seconds of
    each stage on the wall clock: "start" from `started` (the parent's
    `time.time()` at the spawn) to Python, torch and the port imported,
    then "train" (the group's rendezvous and three steps), "resume" and
    "serve_eval" (process 0)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from yolo_re_tpu_torch.convert import load_weights
    from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
    from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch
    from yolo_re_tpu_torch.eval.evaluator import Evaluator
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.ops.kernels import (
        adown,
        conv3,
        csp_chain,
        nms,
        stem,
    )
    from yolo_re_tpu_torch.parallel.mesh import (
        Mesh,
        init_distributed,
        local_rows,
    )
    from yolo_re_tpu_torch.serving import Detector
    from yolo_re_tpu_torch.train.config import TrainConfig
    from yolo_re_tpu_torch.train.schedule import WarmupCosineSchedule
    from yolo_re_tpu_torch.train.trainer import Trainer

    seconds: dict[str, float] = {}
    last = started

    def mark(name: str) -> None:
        nonlocal last
        now = time.time()
        seconds[name] = now - last
        last = now

    mark("start")
    init_distributed(f"127.0.0.1:{port}", world, rank, device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    root = Path(root)
    batch = 2 * world
    rows = local_rows(batch, rank, world)
    rng = np.random.default_rng(0)     # the global batches, in every process
    targets = np.zeros((batch, 4, 5), np.float32)
    targets[:, 0] = [1, 0.5, 0.5, 0.4, 0.4]

    def trainer() -> Trainer:
        model = YOLO.from_yaml(model_yaml)
        data = DataConfig(num_classes=model.num_classes, img_size=TRAIN_SIZE,
                          batch_size=batch, augment=AugmentConfig("full"))
        cfg = TrainConfig(epochs=1, data_parallel=True,
                          device_augment="full", output_dir=str(root / "run"),
                          seed=0)
        return Trainer(
            model, data=data, config=cfg, device=dev,
            train_loader=_Rows([None], (rank, world), batch),
            schedule=WarmupCosineSchedule(base_lr=0.01, total_steps=100,
                                          warmup_steps=10))

    def step(tr: Trainer, augment: bool = False) -> float:
        images = rng.random((batch, TRAIN_SIZE, TRAIN_SIZE, 3), np.float32)
        loss, items, _ = tr.train_step(images[rows], targets[rows],
                                       augment=augment)
        loss, items = float(loss), items.detach().cpu().numpy()
        if not (np.isfinite(loss) and np.all(np.isfinite(items))):
            raise AssertionError(f"process {rank}, step {tr.global_step}: "
                                 f"loss {loss}, items {items}")
        return loss

    # 1. three steps, the third augmented on the device ("full": mosaic,
    #    mixup, HSV, flips over the gathered global batch), as the JAX dry
    #    run's train_step(..., augment=step == 2)
    tr = trainer()
    losses = [step(tr, augment=i == 2) for i in range(3)]
    mark("train")

    # 2. save from process 0 (the Trainer writes only there), restore in
    #    every process, one more step each
    resumed = {}
    for fmt, path in (("npz", root / "ckpt.npz"), ("orbax", root / "ckpt")):
        tr.save(root / "ckpt.npz", format=fmt)
        dist.barrier()
        fresh = trainer()
        fresh.load_checkpoint(path)
        if fresh.global_step != 3:
            raise AssertionError(f"{fmt}: restored step {fresh.global_step}")
        resumed[fmt] = step(fresh)
        del fresh
    dist.barrier()
    mark("resume")

    out = {"losses": losses, "resumed": resumed, "phase_seconds": seconds}
    if rank == 0:
        # 3. and 4.: one process over the mesh of the group's devices
        mesh = Mesh(tuple(torch.device("cuda", i) for i in range(world))
                    if device == "cuda" else ("cpu",) * world)
        frames = rng.integers(0, 255, (world + 3, SERVE_SIZE, SERVE_SIZE, 3)
                              ).astype(np.uint8)
        weights = tr.model.state_dict()
        det = Detector(tr.model, weights, img_size=SERVE_SIZE, mesh=mesh)
        res = det(frames)
        if tuple(res["boxes"].shape) != (world + 3, det.max_det, 4) or \
                not torch.isfinite(res["boxes"]).all():
            raise AssertionError(f"mesh serving: boxes "
                                 f"{tuple(res['boxes'].shape)}")
        out["n_det"] = int(res["valid"].sum())
        eval_targets = np.zeros((world + 3, 4, 5), np.float32)
        eval_targets[:, 0] = [1, 0.5, 0.5, 0.4, 0.4]
        batches = [{"images": rng.integers(
                        0, 255, (world + 3, TRAIN_SIZE, TRAIN_SIZE, 3)
                    ).astype(np.uint8),
                    "targets": eval_targets,
                    "nboxes": np.ones((world + 3,), np.int32)}]
        out["map50"] = Evaluator(tr.model, batches, mesh=mesh).evaluate(
            weights)["map50"]
        if not np.isfinite(out["map50"]):
            raise AssertionError(f"mesh eval: mAP50 {out['map50']}")

        tiny_yaml = root / "tiny.yaml"
        tiny_yaml.write_text(TINY_YAML)
        tiny = YOLO.from_yaml(tiny_yaml)
        fixture = make_eval_batch(world + 3, TRAIN_SIZE, seed=5)
        det2 = Detector.from_checkpoint(tiny, str(FIXTURE),
                                        img_size=TRAIN_SIZE,
                                        conf_thres=0.25, mesh=mesh)
        out["fixture_det"] = int(det2(fixture["images"])["valid"].sum())
        if out["fixture_det"] <= 0:
            raise AssertionError("mesh serving gave no detections from the "
                                 "trained fixture")
        out["fixture_map50"] = Evaluator(tiny, [fixture], mesh=mesh).evaluate(
            load_weights(FIXTURE))["map50"]
        if not out["fixture_map50"] > 0.2:
            raise AssertionError(f"mesh eval mAP50 {out['fixture_map50']} "
                                 f"<= 0.2 on the trained fixture")
        mark("serve_eval")
    dist.barrier()
    dist.destroy_process_group()
    # this process's kernel launches (the plain versions on the CPU count
    # none)
    out["launches"] = {
        "stem": stem.launches, "stem_raw": stem.raw_launches,
        "stem_wgrad": stem.wgrad_launches, "adown": adown.launches,
        "adown_raw": adown.raw_launches, "adown_bwd": adown.bwd_launches,
        "csp_chain": csp_chain.launches, "conv3": conv3.launches,
        "nms": nms.launches}
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, *, device: str = "auto",
                     model_yaml: str | os.PathLike = GELAN_C,
                     timeout: float = 1800.0) -> dict:
    """Run the dry run in `n_devices` processes (the module docstring) on
    cards ("auto" or "cuda": NCCL, one card each; RuntimeError with fewer
    cards than processes, and no fallback to the CPU) or, when asked, on
    "cpu" (gloo). Prints and returns process 0's numbers with the seconds
    the run took. Every process is waited for within `timeout` seconds in
    all, and killed after it; a process that fails or times out raises
    with every process's stderr."""
    import torch

    from yolo_re_tpu_torch.utils.devices import device_summary, get_device

    if device not in ("auto", "cpu", "cuda"):
        raise ValueError(f"device must be 'auto', 'cpu' or 'cuda', got "
                         f"{device!r}")
    if device != "cpu":
        device = get_device("auto").type    # raises without a card
        cards = torch.cuda.device_count()
        if cards < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {cards} "
                               f"card(s)")

    t0 = time.perf_counter()
    port = _free_port()
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // n_devices)))
    with tempfile.TemporaryDirectory() as root:
        procs = []
        for rank in range(n_devices):
            code = (BLOCK_JAX + "import json\n"
                    f"sys.path.insert(0, {str(ROOT)!r})\n"
                    "import dryrun_torch as d\n"
                    f"out = d.run_worker({rank}, {n_devices}, {port}, "
                    f"{device!r}, {str(model_yaml)!r}, {root!r}, "
                    f"{time.time()!r})\n"
                    f"print({RESULT!r} + json.dumps(out), flush=True)\n")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            tails = [p.communicate(timeout=30)[1][-3000:] for p in procs]
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): not done within "
                f"{timeout} s\n" + "\n---\n".join(tails)) from None
    if any(p.returncode for p in procs):
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) failed (return codes "
            f"{[p.returncode for p in procs]}):\n" + "\n---\n".join(
                f"process {i}:\n{err[-3000:]}"
                for i, (_, err) in enumerate(outs)))
    line = next(ln for ln in outs[0][0].splitlines()
                if ln.startswith(RESULT))
    out = json.loads(line[len(RESULT):])
    out["seconds"] = time.perf_counter() - t0
    print(f"dryrun_multichip({n_devices}, {device}): OK on "
          f"{device_summary() if device == 'cuda' else 'cpu'} in "
          f"{out['seconds']:.1f} s | trained fixture: {out['fixture_det']} "
          f"mesh detections, mesh eval mAP50 {out['fixture_map50']:.3f} | "
          f"ckpt/resume ok (npz + checkpoint directory, resumed-step losses "
          f"{out['resumed']['npz']:.4f}/{out['resumed']['orbax']:.4f}) | "
          f"random-init {Path(model_yaml).stem} program checks: 3-step "
          f"losses {[round(v, 4) for v in out['losses']]} (step 3 "
          f"device-augmented), serve batch {n_devices + 3} @ {SERVE_SIZE} px "
          f"({out['n_det']} det, random init), eval mAP50 "
          f"{out['map50']:.3f} (random init)", flush=True)
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dryrun_multichip(n, device=sys.argv[2] if len(sys.argv) > 2 else "auto")
