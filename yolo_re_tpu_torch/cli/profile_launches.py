"""Device time of each launch inside one call of a train kernel's wrapper,
of one train step or eval batch of gelan-c or yolov9-c, and of the device
augmentation.

    python -m yolo_re_tpu_torch.cli.profile_launches \
        [kernels|train [f32] [aug] [MODEL]|eval [bf16] [MODEL]|
         bn [f32] [MODEL]|augment [f32]|ddp [f32]|roof]

MODEL names a file of configs/models/ (`gelan-c`, the default, or
`yolov9-c`, whose train step runs both branches and the dual loss and
whose eval batch the main branch alone).

`kernels` (the default): a wrapper such as `adown_bwd` makes several
launches from one C entry point; `chip_smoke.py` times the call as a
whole. This traces a few calls with `torch.profiler` and prints, per
call, each kernel's device time: the bf16 ADown forward at gelan-c's five
ADown shapes (640 px, batch 32), as a fused ADown calls it (weights
packed beforehand) and as the train forward calls it (`adown_raw`, which
packs on every call), each shape's sum and the sums over the five, with
the forward's bound (x, the weights and y once each at 3.35 TB/s, or its
products at 989 TFLOP/s, the H100 SXM data sheet's rates) and bound /
time, and the fused call in f32 (the Evaluator's default dtype); the
ADown backward at the same shapes in bf16 and in f32 (the default dtype
of `TrainConfig`), each shape's sum and the sums over the five, per
launch; and the bf16 stem weight gradient at (32, 3, 640, 640) -> 64. For
the ADown backward's two memory-bound passes, the dx pass and the
pool/avg pass, it also prints the bytes they must move (each input read
once, each output written once; the pool/avg pass counts the branch-1
avg it writes for the weight-gradient products), that over 3.35 TB/s as
their bound, and bound / time. The ADown tables run on older trees too
(their `adown` permutes the weights on every call).

`train`: gelan-c (or MODEL), bf16 (`train f32`: f32, the `TrainConfig`
default),
batch 32 (f32: 16 if 32 does not fit in the card's memory; the batch used
is printed), 640 px, random weights and synthetic batches (as
chip_smoke.py's phase 8): after a warm-up step, the host clock over five
steps, then the device time per step over five traced steps (after three
more), in all and by kernel (the largest first); and, from a chrome
trace of three steps, the streams on which the batches' copies from
pinned memory ran and those of the package's kernels
(`Trainer._put_batch` copies on a stream of its own). `train ... aug`: the same with
device_augment="full" (the "full" preset's hyperparameters: the
separable mosaic, mixup, HSV and flips run in each step; max_boxes 32).

`eval`: gelan-c (or MODEL), fused, f32 (the Evaluator's default dtype;
`eval bf16`:
bf16), random weights from seed 0 with the class biases at 0 (as
chip_smoke.py's phase 5, so that the all-anchor NMS keeps its full 300),
one batch of 32 random uint8 images at 640 px, made on the card and
handed over as the loader hands a batch (on the host), through
`Evaluator._dispatch`: the copy to the card, the forward, all-anchor
NMS and the copy of the padded detections back. It prints the device
time per batch of the 15 largest kernels, of the package's own kernels
and of all, and the NMS kernel's time and share of all.

`bn`: the train BN + activation of a MODEL train step (default
yolov9-c), bf16 (`bn f32`: f32), batch 32, 640 px: every site's shape
from one train forward (`ops/conv.batch_norm_act`), then at each distinct
shape the device time (`launch_times`) and launches of the kernels,
together and each (`bn_silu.forward`: `moments` + `affine_act`;
`bn_silu.backward`: `grad_sums` + `grad_input`), of their plain versions,
of the
eager chain they replace (`batch_moments`, `update_running_stats`,
`bn_affine`, the activation, and autograd's backward of them) and of the
library's `F.batch_norm(training=True)` + `F.silu` (the yardstick; the
port never calls it), with the bounds (bytes at 3.35 TB/s: y and z once
forward, g, y and dx once backward; each kernel's own: the reduction
reads y, then g and y; the pointwise pass reads y and writes z, then
reads g and y and writes dx), each summed over the step's sites.

`augment`: the device time by kernel of one call of augment_batch_full
(fast and general path) and of augment_batch at gelan-c's train shape,
bf16 (`augment f32`: f32), as chip_smoke.py's phase 11 (a) calls them.

`ddp`: gelan-c, bf16 (`ddp f32`: f32), batch 32, 640 px, one batch on
the card: a plain Trainer and a data-parallel one in a one-process NCCL
group (`parallel.mesh.init_distributed` on a free localhost port), two
warm-up steps each, then the host time of one step of each by op
(torch.profiler, CPU activity only: the largest self CPU times and their
calls), which shows where the host time of a DDP step's collectives goes
at world size 1. The steps' ms/step are chip_smoke.py's phase 15 (a).

`roof`: the memory rate the card reaches on the stem's output at 640 px,
batch 32 ((32, 64, 320, 320), bf16 and f32): `fill_` (writes only) and
`copy_` (a read and a write), CUDA events over 20 calls after a warm-up,
as bytes/s beside the data sheet's 3.35 TB/s: the roof a memory-bound
kernel such as the stem can reach.

`train` and `eval` time the entry points' own calls (`Trainer.train_step`,
`Evaluator._dispatch`), so their f32 library convs run as the entry
points run them: with TF32 off (`utils/precision.full_f32`).

Random inputs from a fixed seed. It needs a CUDA card and exits with 2
without one; the first lines are the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from yolo_re_tpu_torch.ops.kernels import adown, stem

BATCH = 32
CONFIGS = Path(__file__).resolve().parents[2] / "configs" / "models"
# gelan-c's five ADown inputs at 640 px: (Cin, H, W) -> Cout
ADOWN_SHAPES = {"down1": (256, 160, 160, 256), "down2": (512, 80, 80, 512),
                "down3": (512, 40, 40, 512), "pan_down1": (256, 80, 80, 256),
                "pan_down2": (512, 40, 40, 512)}
REPS = 5
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# the ADown backward's memory-bound passes, by kernel names of this tree
# and of the trees before it
PASSES = {"dx": ("dx_strips", "adown_dx"),
          "pool/avg": ("pool_avg", "pool_argmax", "avg_bf16")}


def launch_times(fn) -> list[tuple[float, int, str]]:
    """(ms per call, launches per call, kernel name) of each kernel that
    `fn` launches, from REPS recorded calls after a warm-up step of three
    calls, traced and dropped (a trace that starts with the calls can miss
    their first launches); the step's device-side range, "ProfilerStep*",
    is left out."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for calls in (3, REPS):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    rows = [(ev.device_time_total / REPS / 1e3, ev.count // REPS, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.device_time_total > 0
            and not ev.key.startswith("ProfilerStep")]
    return sorted(rows, reverse=True)


def report(title: str, rows: list[tuple[float, int, str]]) -> None:
    print(title)
    for ms, n, name in rows:
        print(f"  {ms:.4f} ms  x{n}  {name[:100]}")
    print(f"  total {sum(r[0] for r in rows):.4f} ms")


def pass_bytes(cin: int, h: int, w: int, elem: int) -> dict[str, int]:
    """Bytes each memory-bound pass of the ADown backward must move, x in
    `elem`-byte elements: the dx pass reads dA1, dM (f32) and idx (uint8)
    and writes dx (like x); the pool/avg pass reads x and writes M and the
    branch-1 avg (like x) and idx."""
    ch, n = cin // 2, BATCH * (h // 2) * (w // 2) * (cin // 2)
    x = BATCH * h * w * cin * elem
    avg = BATCH * (h - 1) * (w - 1) * ch
    return {"dx": avg * 4 + n * 4 + n + x,
            "pool/avg": x + n * elem + n + avg * elem}


def pass_ms(rows: list[tuple[float, int, str]]) -> dict[str, float]:
    return {p: sum(ms for ms, _, name in rows
                   if any(k in name for k in keys))
            for p, keys in PASSES.items()}


def fused_adown(x, w1, b1, w2, b2):
    """The call a fused ADown makes (weights packed beforehand; older
    trees' `adown` permutes them on every call)."""
    packed = getattr(adown, "adown_packed", None)   # absent in older trees
    if packed is None:
        return lambda: adown.adown(x, w1, b1, w2, b2)
    w1p, w2p = adown.pack_weights(w1, w2)
    return lambda: packed(x, w1p, b1, w2p, b2)


def adown_fwd_shapes(rand) -> None:
    """Per-launch times of the bf16 ADown forward at the five shapes: the
    fused block's call and the train forward's, each against the
    forward's bound, and the sums over the shapes; then the fused call in
    f32."""
    sums = {"adown": [0.0, 0.0], "adown_raw": [0.0, 0.0]}   # ms, bound ms
    f32_ms = 0.0
    for name, (cin, h, w, cout) in ADOWN_SHAPES.items():
        x = rand(BATCH, cin, h, w)
        w1 = rand(cout // 2, cin // 2, 3, 3, scale=0.03, cl=False)
        b1 = rand(cout // 2, cl=False)
        w2 = rand(cout // 2, cin // 2, 1, 1, scale=0.06, cl=False)
        b2 = rand(cout // 2, cl=False)
        fused = fused_adown(x, w1, b1, w2, b2)
        # x, the weights and y (half of x's pixels' channels: Cout over
        # the quarter-size output) once each; the two convs' products
        n_bytes = 2 * (x.numel() + w1.numel() + w2.numel() + 2 * cout // 2
                       + BATCH * cout * (h // 2) * (w // 2))
        ops = (9 + 1) * 2.0 * (cin // 2) * (cout // 2) * BATCH * (h // 2) \
            * (w // 2)
        bound = max(n_bytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
        for what, fn in (("adown", fused),
                         ("adown_raw", lambda: adown.adown_raw(x, w1, w2))):
            rows = launch_times(fn)
            ms = sum(r[0] for r in rows)
            report(f"{what} {name} bf16 x {tuple(x.shape)} -> {cout}, per "
                   f"call", rows)
            print(f"  bound {bound:.4f} ms, fraction {bound / ms:.3f}")
            sums[what][0] += ms
            sums[what][1] += bound
        rows = launch_times(fused_adown(*(t.float()
                                          for t in (x, w1, b1, w2, b2))))
        report(f"adown {name} f32, per call", rows)
        f32_ms += sum(r[0] for r in rows)
        del x
    for what, (ms, bound) in sums.items():
        print(f"{what}, five shapes: {ms:.4f} ms, bound {bound:.4f} ms, "
              f"fraction {bound / ms:.3f}")
    print(f"adown f32, five shapes: {f32_ms:.4f} ms")


def adown_bwd_shapes(rand, dtype: torch.dtype) -> None:
    """Per-launch times of the ADown backward at the five shapes in one
    dtype, the two passes against their bytes bound, and the sums over
    the shapes."""
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    elem = 2 if dtype == torch.bfloat16 else 4
    per_launch: dict[str, float] = {}
    sums = {p: [0.0, 0] for p in PASSES}     # ms, bytes
    total = 0.0
    for name, (cin, h, w, cout) in ADOWN_SHAPES.items():
        x = rand(BATCH, cin, h, w).to(dtype)
        w1 = rand(cout // 2, cin // 2, 3, 3, scale=0.03, cl=False)
        w2 = rand(cout // 2, cin // 2, 1, 1, scale=0.06, cl=False)
        g = rand(BATCH, cout, h // 2, w // 2).to(dtype)
        rows = launch_times(lambda: adown.adown_bwd(x, g, w1, w2))
        report(f"adown_bwd {name} {tag} x {tuple(x.shape)} -> {cout}, per "
               f"call", rows)
        for ms, _, kname in rows:
            key = kname.replace("(anonymous namespace)::", "").split("(")[0]
            per_launch[key] = per_launch.get(key, 0.0) + ms
        total += sum(r[0] for r in rows)
        nb, ms = pass_bytes(cin, h, w, elem), pass_ms(rows)
        for p in PASSES:
            bound = nb[p] / HBM_BYTES_PER_S * 1e3
            sums[p][0] += ms[p]
            sums[p][1] += nb[p]
            print(f"  {p} pass: {ms[p]:.4f} ms, {nb[p] / 1e6:.1f} MB, bound "
                  f"{bound:.4f} ms, fraction {bound / ms[p]:.3f}")
        del x, g
    print(f"adown_bwd {tag}, sums over the five shapes, per launch")
    for key, ms in sorted(per_launch.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:.4f} ms  {key}")
    print(f"  total {total:.4f} ms")
    for p, (ms, nb) in sums.items():
        bound = nb / HBM_BYTES_PER_S * 1e3
        print(f"  {p} pass, five shapes: {ms:.4f} ms, {nb / 1e6:.1f} MB, "
              f"bound {bound:.4f} ms, fraction {bound / ms:.3f}")


def random_model(name: str):
    """`name`'s model at full width with random weights from seed 0 and
    the class biases at 0 instead of the prior's -8.8: random weights then
    score near 0.5, so NMS keeps full candidate sets (chip_smoke.py's
    phases 5 and 10 serve and evaluate this model too)."""
    from yolo_re_tpu_torch.models.yolo import YOLO

    model = YOLO.from_yaml(CONFIGS / f"{name}.yaml")
    model.init_parameters(torch.Generator().manual_seed(0))
    head = model.layers[model.plan.detect_name]
    with torch.no_grad():
        for n, p in head.named_parameters():
            if "cls_convs" in n and n.endswith(".2.bias"):
                p.zero_()
    return model


def copy_streams(fn) -> tuple[int, float, set, set]:
    """(copies, their device time in ms, their streams, the streams of the
    package's kernels) of the host-to-device copies from pinned memory in
    a chrome trace of fn(). fn runs 50 ms inside the trace (the profiler drops device
    activity it dates outside its window, and a copy is the first thing
    a step enqueues), and the trace is taken again, up to three times,
    when it holds no such copy."""
    import json
    import tempfile
    import time

    from torch.profiler import ProfilerActivity, profile

    def stream(e: dict):
        return e.get("args", {}).get("stream", e.get("tid"))

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        with tempfile.TemporaryDirectory() as td:
            path = Path(td) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                  and "HtoD" in e.get("name", "") and "Pinned" in e["name"]]
        if copies:
            break
    kernels = {stream(e) for e in events
               if e.get("cat") == "kernel" and "yolo" in e.get("name", "")}
    ms = sum(e.get("dur", 0) for e in copies) / 1e3
    return len(copies), ms, {stream(e) for e in copies}, kernels


def augment_calls(dtype: str) -> None:
    """Device time by kernel of augment_batch_full (the "full" preset's
    fast path, and the general path at degrees 10, shear 2, perspective
    1e-4) and of augment_batch, at gelan-c's train shape (32, 640, 640, 3)
    in `dtype`, 32 target rows (chip_smoke.py's phase 11 (a) inputs)."""
    import numpy as np

    from yolo_re_tpu_torch.data import device_pipeline as dp
    from yolo_re_tpu_torch.data.config import AugmentConfig
    from yolo_re_tpu_torch.data.synth import make_eval_batch

    batch = make_eval_batch(BATCH, 640, 0, max_boxes=32)
    x = torch.from_numpy(batch["images"]).cuda().to(getattr(torch, dtype))
    x = x / 255.0
    t = torch.from_numpy(batch["targets"]).cuda()
    preset = AugmentConfig()
    full = {k: getattr(preset, f) for k, f in dp.FULL_FIELDS.items()}
    general = {"degrees": 10.0, "shear": 2.0, "perspective": 1e-4}
    for name, fn, hyps in (
            ("augment_batch_full, fast path", dp.augment_batch_full, full),
            ("augment_batch_full, general path", dp.augment_batch_full,
             {**full, **general}),
            ("augment_batch", dp.augment_batch,
             {k: full[k] for k in dp.BATCH_FIELDS})):
        draws = dp.draws_to(dp.draw_augment(np.random.default_rng([1, 0]),
                                            BATCH, 640, **hyps), "cuda")
        kw = {k: v for k, v in hyps.items() if k not in dp.DRAW_ONLY}
        rows = launch_times(lambda: fn(x, t, draws, **kw))
        report(f"{name}, {dtype}, ({BATCH}, 640, 640, 3): device time by "
               f"kernel (largest 12 of {len(rows)})", rows[:12])
        print(f"  all kernels {sum(r[0] for r in rows):.4f} ms per call")


def train_step(dtype: str, name: str, aug: bool = False) -> None:
    import gc
    import tempfile
    import time

    from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
    from yolo_re_tpu_torch.data.synth import make_eval_batch
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.train.config import TrainConfig
    from yolo_re_tpu_torch.train.trainer import Trainer

    # f32 steps hold twice bf16's activations: half the batch if 32 does
    # not fit
    for batch in (BATCH, BATCH // 2) if dtype == "float32" else (BATCH,):
        model = YOLO.from_yaml(CONFIGS / f"{name}.yaml")
        batches = [make_eval_batch(batch, 640, seed,
                                   max_boxes=32 if aug else 8)
                   for seed in range(4)]
        cfg = TrainConfig(epochs=1, compute_dtype=dtype,
                          data_parallel=False,
                          device_augment="full" if aug else False,
                          output_dir=tempfile.mkdtemp(prefix="profile_"))
        data = DataConfig(augment=AugmentConfig()) if aug else None
        trainer = Trainer(model, data=data, config=cfg,
                          train_loader=batches, device="cuda")

        def step(i: int) -> None:
            b = batches[i % len(batches)]
            trainer.train_step(b["images"], b["targets"])

        try:
            step(0)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if batch == BATCH // 2:
                raise
        # outside the handler, so that its traceback frees the tensors
        print(f"{name} {dtype} train step: batch {batch} does not fit")
        del model, trainer, batches, step
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for i in range(5):
        step(i)
    torch.cuda.synchronize()
    what = f"{name} {dtype} train step{' (device_augment=full)' * aug}"
    print(f"{what}, batch {batch}, 640 px: host clock "
          f"{(time.perf_counter() - t0) / 5 * 1e3:.1f} ms per step over 5; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rows = launch_times(lambda: step(1))
    report("device time per step, by kernel (largest 15 of "
           f"{len(rows)})", rows[:15])
    print(f"  all kernels {sum(r[0] for r in rows):.4f} ms per step, "
          f"{sum(r[1] for r in rows)} launches")
    n, ms, copies, kernels = copy_streams(
        lambda: [step(i) for i in range(3)])
    print(f"  batch copies from pinned memory over 3 steps: {n}, {ms:.4f} "
          f"ms in all, on stream(s) "
          f"{sorted(copies)}; the package's kernels on stream(s) "
          f"{sorted(kernels)}; the copies off the compute stream: "
          f"{bool(n) and not copies & kernels}")


def ddp_step(dtype: str) -> None:
    import socket
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from yolo_re_tpu_torch.data.synth import make_eval_batch
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.parallel.mesh import init_distributed
    from yolo_re_tpu_torch.train.config import TrainConfig
    from yolo_re_tpu_torch.train.trainer import Trainer

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        b = make_eval_batch(BATCH, 640, 0)
        x = torch.as_tensor(b["images"]).cuda()
        t = torch.as_tensor(b["targets"]).cuda()
        trainers = {}
        for mode in ("plain", "ddp"):
            cfg = TrainConfig(epochs=1, compute_dtype=dtype,
                              data_parallel=mode == "ddp",
                              output_dir=tempfile.mkdtemp(prefix="profile_"))
            trainers[mode] = Trainer(YOLO.from_yaml(CONFIGS / "gelan-c.yaml"),
                                     config=cfg, train_loader=[None],
                                     device="cuda")
            for _ in range(2):
                trainers[mode].train_step(x, t)
        torch.cuda.synchronize()
        print(f"gelan-c {dtype} train step, batch {BATCH}, 640 px, the batch "
              f"on the card; DDP at world size 1 (NCCL)")
        for mode, trainer in trainers.items():
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                trainer.train_step(x, t)
                torch.cuda.synchronize()
            rows = sorted(prof.key_averages(),
                          key=lambda e: -e.self_cpu_time_total)
            total = sum(e.self_cpu_time_total for e in rows) / 1e3
            print(f"  {mode}: host time of one profiled step {total:.1f} ms;"
                  f" by op (self CPU ms, calls):")
            for e in rows[:12]:
                print(f"    {e.self_cpu_time_total / 1e3:9.3f} "
                      f"{e.count:6d}  {e.key}")
    finally:
        dist.destroy_process_group()


def eval_batch(dtype: str, name: str) -> None:
    from yolo_re_tpu_torch.eval.evaluator import Evaluator
    from yolo_re_tpu_torch.serving import inference_model

    model = random_model(name)
    ev = Evaluator(model, None, compute_dtype=dtype, device="cuda")
    fused = inference_model(model, model.state_dict(), ev.device, ev.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"images": torch.randint(
        0, 256, (BATCH, 640, 640, 3), generator=gen, device="cuda",
        dtype=torch.uint8).cpu().numpy()}
    rows = launch_times(lambda: ev._dispatch(fused, batch))
    report(f"{name} {dtype} eval batch of {BATCH} at 640 px, device time "
           f"by kernel (largest 15 of {len(rows)})", rows[:15])
    own = sum(r[0] for r in rows if "yolo" in r[2])
    total = sum(r[0] for r in rows)
    nms_ms = sum(r[0] for r in rows if "yolo" in r[2] and "nms" in r[2])
    print(f"  the package's kernels {own:.4f} ms, all kernels "
          f"{total:.4f} ms per batch; the NMS kernel {nms_ms:.4f} ms, "
          f"{nms_ms / total:.4f} of all")


def bn_sites(dtype: torch.dtype, name: str) -> dict:
    """(C, H, W, modules, act) -> sites of a train forward at batch 32,
    640 px, recorded at ops/conv.batch_norm_act."""
    from yolo_re_tpu_torch.models import blocks
    from yolo_re_tpu_torch.models.yolo import YOLO
    from yolo_re_tpu_torch.ops import adown_train, conv

    sites: dict = {}
    real = conv.batch_norm_act

    def record(y, bns, act):
        key = (*y.shape[1:], len(bns), act)
        sites[key] = sites.get(key, 0) + 1
        return real(y, bns, act)

    model = YOLO.from_yaml(CONFIGS / f"{name}.yaml").cuda().train()
    x = torch.rand(BATCH, 3, 640, 640, device="cuda", dtype=dtype)
    mods = (conv, blocks, adown_train)
    try:
        for m in mods:
            m.batch_norm_act = record
        with torch.no_grad():
            model(x.contiguous(memory_format=torch.channels_last))
    finally:
        for m in mods:
            m.batch_norm_act = real
    del model, x
    torch.cuda.empty_cache()
    return sites


def device_ms(fn) -> tuple[float, int]:
    """(device ms, launches) of one call of fn (`launch_times`)."""
    return rows_ms(launch_times(fn))


def rows_ms(rows, kernel: str = "") -> tuple[float, int]:
    """(device ms, launches) of the `launch_times` rows whose kernel name
    holds `kernel`."""
    rows = [r for r in rows if kernel in r[2]]
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def bn_shape_ms(c: int, h: int, w: int, modules: int, act: str,
                dtype: torch.dtype) -> dict[str, tuple]:
    """name -> (forward ms, backward ms, forward launches, backward
    launches) of one site of this shape, device time (`launch_times`):
    the kernels together ("kernels") and each ("reduction": moments, the
    backward's sums; "pointwise": affine + activation, dx), their plain
    versions likewise, the eager chain, the library, and the bounds (bytes
    at 3.35 TB/s: the op's inputs and outputs once, "bound"; each kernel's
    own, "bound reduction", "bound pointwise")."""
    import torch.nn.functional as F

    from yolo_re_tpu_torch.ops import conv
    from yolo_re_tpu_torch.ops.kernels import bn_silu

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (BATCH, c, h, w)

    def rand(scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale) \
            .to(dtype).contiguous(memory_format=torch.channels_last)

    y, g = rand(1.5), rand()
    wt = torch.rand(c, generator=gen, device="cuda") + 0.5
    bs = torch.randn(c, generator=gen, device="cuda") * 0.3
    bns = [torch.nn.BatchNorm2d(c // modules, eps=conv.BN_EPS,
                                momentum=conv.BN_MOMENTUM).cuda()
           for _ in range(modules)]
    running = [(b.running_mean, b.running_var, b.num_batches_tracked)
               for b in bns]
    fn = F.silu if act == "silu" else (lambda t: t)
    eps, mom = conv.BN_EPS, conv.BN_MOMENTUM
    _, stats = bn_silu.forward(y, wt, bs, act, running, True, eps, mom)
    sums = bn_silu.grad_sums_plain(g, y, stats, act)
    out = {}
    rows_f = launch_times(lambda: bn_silu.forward(y, wt, bs, act, running,
                                                  True, eps, mom))
    rows_b = launch_times(lambda: bn_silu.backward(g, y, stats, act))
    for name, kernel in (("kernels", ""), ("reduction", "bn_reduce_kernel"),
                         ("pointwise", "bn_pointwise_kernel")):
        fwd, bwd = rows_ms(rows_f, kernel), rows_ms(rows_b, kernel)
        out[name] = (fwd[0], bwd[0], fwd[1], bwd[1])
    plain = {
        "plain reduction": (
            lambda: bn_silu.moments_plain(y, wt, bs, running, True, eps, mom),
            lambda: bn_silu.grad_sums_plain(g, y, stats, act)),
        "plain pointwise": (
            lambda: bn_silu.affine_act_plain(y, stats, act),
            lambda: bn_silu.grad_input_plain(g, y, stats, sums, act))}
    for name, (f_call, b_call) in plain.items():
        fwd, bwd = device_ms(f_call), device_ms(b_call)
        out[name] = (fwd[0], bwd[0], fwd[1], bwd[1])

    def autograd_ms(forward) -> tuple:
        yr = y.detach().requires_grad_()
        params = (wt.detach().requires_grad_(), bs.detach().requires_grad_())
        fwd = device_ms(lambda: forward(yr, *params))
        z = forward(yr, *params)
        bwd = device_ms(lambda: torch.autograd.grad(z, (yr, *params), g,
                                                    retain_graph=True))
        return fwd[0], bwd[0], fwd[1], bwd[1]

    def eager(yr, w_, b_):
        mean, var = conv.batch_moments(yr)
        conv.update_running_stats(bns[0], mean[:c // modules],
                                  var[:c // modules], yr.numel() // c)
        return fn(conv.bn_affine(yr, mean, var, w_, b_))

    out["eager"] = autograd_ms(eager)
    out["library"] = autograd_ms(lambda yr, w_, b_: fn(F.batch_norm(
        yr, None, None, w_, b_, training=True, momentum=mom, eps=eps)))
    ms = y.numel() * y.element_size() / HBM_BYTES_PER_S * 1e3
    out["bound"] = (2 * ms, 3 * ms, 0, 0)
    out["bound reduction"] = (ms, 2 * ms, 0, 0)
    out["bound pointwise"] = (2 * ms, 3 * ms, 0, 0)
    return out


def bn_step(dtype: torch.dtype, name: str) -> None:
    from yolo_re_tpu_torch.utils.precision import full_f32

    with full_f32():
        sites = bn_sites(dtype, name)
        print(f"{name} {dtype} train BN + activation, batch {BATCH}, 640 "
              f"px: {sum(sites.values())} sites at {len(sites)} shapes")
        total: dict[str, list[float]] = {}
        for key, count in sorted(sites.items()):
            ms = bn_shape_ms(*key, dtype)
            print(f"  {key} x{count}: " + ", ".join(
                f"{k} {v[0]:.4f}+{v[1]:.4f}" for k, v in ms.items()))
            for k, v in ms.items():
                acc = total.setdefault(k, [0.0] * 4)
                for i, x in enumerate(v):
                    acc[i] += count * x
    print("  summed over the step's sites, device ms forward + backward = "
          "all (launches forward + backward):")
    for k, (f, b, nf, nb) in total.items():
        print(f"    {k:16s} {f:.4f} + {b:.4f} = {f + b:.4f} ({nf} + {nb})")


def memory_roof() -> None:
    for dtype in (torch.bfloat16, torch.float32):
        y = torch.empty(BATCH, 64, 320, 320, dtype=dtype, device="cuda")
        src = torch.empty_like(y)
        nb = y.numel() * y.element_size()
        for name, fn, moved in (("fill_", lambda: y.fill_(1.0), nb),
                                ("copy_", lambda: y.copy_(src), 2 * nb)):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            print(f"{name} {dtype} {tuple(y.shape)}: {ms:.4f} ms, "
                  f"{moved / ms / 1e9:.3f} TB/s moved "
                  f"({moved / ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.3f} of "
                  f"{HBM_BYTES_PER_S / 1e12:.2f})")
        del y, src


def parse(what: list[str]) -> tuple[str, str, bool, str] | None:
    """argv -> (mode, dtype word or "", aug, model name), None if
    malformed."""
    if what in (["kernels"], ["roof"]):
        return what[0], "", False, ""
    flag = {"train": "f32", "eval": "bf16", "bn": "f32", "augment": "f32",
            "ddp": "f32"}.get(what[0])
    if flag is None:
        return None
    if what[0] in ("augment", "ddp"):
        if what[1:] not in ([], [flag]):
            return None
        return what[0], "".join(what[1:]), False, ""
    rest = what[1:]
    dtype = rest.pop(0) if rest[:1] == [flag] else ""
    aug = what[0] == "train" and rest[:1] == ["aug"]
    if aug:
        rest.pop(0)
    name = rest.pop(0) if rest else \
        "yolov9-c" if what[0] == "bn" else "gelan-c"
    if rest or not (CONFIGS / f"{name}.yaml").is_file():
        return None
    return what[0], dtype, aug, name


def main(argv: list[str] | None = None) -> int:
    parsed = parse((sys.argv[1:] if argv is None else argv) or ["kernels"])
    if parsed is None:
        print("usage: profile_launches [kernels|train [f32] [aug] [MODEL]|"
              "eval [bf16] [MODEL]|bn [f32] [MODEL]|augment [f32]|ddp "
              "[f32]|roof]",
              file=sys.stderr)
        return 2
    what, dtype, aug, name = parsed
    if not torch.cuda.is_available():
        print("profile_launches: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    if what == "train":
        train_step("float32" if dtype else "bfloat16", name, aug)
        return 0
    if what == "eval":
        eval_batch("bfloat16" if dtype else "float32", name)
        return 0
    if what == "bn":
        bn_step(torch.float32 if dtype else torch.bfloat16, name)
        return 0
    if what == "augment":
        augment_calls("float32" if dtype else "bfloat16")
        return 0
    if what == "ddp":
        ddp_step("float32" if dtype else "bfloat16")
        return 0
    if what == "roof":
        memory_roof()
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0, cl=True):
        t = (torch.randn(*shape, generator=gen, device=dev) * scale).bfloat16()
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    adown_fwd_shapes(rand)
    for dtype in (torch.bfloat16, torch.float32):
        adown_bwd_shapes(rand, dtype)
    x = rand(BATCH, 3, 640, 640)
    g = rand(BATCH, 64, 320, 320)
    report(f"stem_wgrad bf16 x {tuple(x.shape)} -> 64, per call",
           launch_times(lambda: stem.stem_wgrad(x, g)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
