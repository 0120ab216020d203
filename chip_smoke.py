"""Smoke run of the PyTorch/CUDA port (yolo_re_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero (no phase is caught):

1. environment: Python, torch, CUDA, the card (nvidia-smi name, power limit);
2. build: nvcc compiles yolo_re_tpu_torch/csrc/*.cu (cached by source hash);
3. every kernel of the serving path against its plain PyTorch version on the
   card, at gelan-c's shapes at 640 px and batch 32, in bf16 and f32:
   max abs difference (against the tolerance stated below) and time;
4. the trained tiny fixture (assets/dryrun_tiny.npz, TINY_YAML, 160 px)
   served on cuda and on the CPU (plain versions) in f32: equal detections;
5. gelan-c at full width: random weights from seed 0, fused, bf16, four
   requests of 32 frames of 720x1280 uint8 through Detector, with the
   kernels' launch counters held to the path's layout;
6. the four train kernels (stem raw + weight grad, ADown raw + backward)
   against their plain versions at gelan-c's 640 px, batch 32 train
   shapes, in f32 and bf16: outputs and dx within `tolerance`, weight
   gradients within a relative L2 of 1e-5 (f32) / 2e-2 (bf16), and times;
7. TINY_YAML, f32: 12 Trainer steps on cuda (kernels) and on the CPU
   (plain versions) from the same init; the loss curves must track within
   the bounds of scripts/validate_loss_curve.py (2% relative for the first
   half, 8% after);
8. gelan-c training at full width, 640 px, batch 32, bf16: synthetic uint8
   batches (data/synth.py, numpy seed 0), one warm-up Trainer step, then
   five through Trainer.train_one_epoch with the train kernels' launch
   counters held to one stem pair and five ADown pairs per step.

The last three lines are the card's nvidia-smi line, a JSON line with one
entry per kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.kernels import adown, build, nms, stem
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent
BATCH, SIZE, FRAME_HW, REQUESTS = 32, 640, (720, 1280), 4
# gelan-c's five ADown inputs at 640 px: (Cin, H, W) -> Cout
ADOWN_SHAPES = {"down1": (256, 160, 160, 256), "down2": (512, 80, 80, 512),
                "down3": (512, 40, 40, 512), "pan_down1": (256, 80, 80, 256),
                "pan_down2": (512, 40, 40, 512)}
NMS_SHAPES = (512, 8400)   # serving candidates; all anchors at 640 px
TRAIN_STEPS = 5            # counted gelan-c train steps (after one warm-up)
# weight gradients, kernel vs plain: relative L2 (both sum f32 products in
# another order; bf16 inputs are exact in f32)
WGRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def tolerance(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """Kernel vs plain version. Both accumulate in f32 in another order,
    then round once: f32 agrees to ~1e-6 relative (2e-5 allowed), bf16 to
    one ulp of the output's largest value (4 ulps allowed: 2^-6 relative)."""
    scale = max(1.0, float(ref.abs().max()))
    return (2.0 ** -6 if dtype == torch.bfloat16 else 2e-5) * scale


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_close(name: str, y: torch.Tensor, ref: torch.Tensor,
                dtype: torch.dtype) -> float:
    err = float((y.float() - ref.float()).abs().max())
    tol = tolerance(dtype, ref)
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) {status}")
    if err > tol or not torch.isfinite(y).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns the bf16 (serving dtype) numbers per kernel; these launches are
    outside the counted run of phase 5."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32, cl=False):
        t = (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    res = {"stem": {}, "adown": {}, "nms": {}}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        x = rand(BATCH, 3, SIZE, SIZE, dtype=dtype, cl=True)
        w, b = rand(64, 3, 3, 3, scale=0.3, dtype=dtype), rand(64, dtype=dtype)
        err = check_close(f"stem {tag} {tuple(x.shape)}->64",
                          stem.stem_conv(x, w, b),
                          stem.stem_conv_plain(x, w, b), dtype)
        ms = cuda_ms(lambda: stem.stem_conv(x, w, b))
        plain_ms = cuda_ms(lambda: stem.stem_conv_plain(x, w, b))
        print(f"  stem {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        res["stem"][tag] = {"err": err, "ms": ms, "plain_ms": plain_ms}
        del x

        tot = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
        for name, (cin, h, wd, cout) in ADOWN_SHAPES.items():
            x = rand(BATCH, cin, h, wd, dtype=dtype, cl=True)
            args = (rand(cout // 2, cin // 2, 3, 3, scale=0.03, dtype=dtype),
                    rand(cout // 2, dtype=dtype),
                    rand(cout // 2, cin // 2, 1, 1, scale=0.06, dtype=dtype),
                    rand(cout // 2, dtype=dtype))
            err = check_close(f"adown {name} {tag} {tuple(x.shape)}->{cout}",
                              adown.adown(x, *args),
                              adown.adown_plain(x, *args), dtype)
            ms = cuda_ms(lambda: adown.adown(x, *args), 5)
            plain_ms = cuda_ms(lambda: adown.adown_plain(x, *args), 5)
            print(f"  adown {name} {tag}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
            tot["err"] = max(tot["err"], err)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            del x
        res["adown"][tag] = tot

    for k in NMS_SHAPES:
        xy = torch.rand(BATCH, k, 2, generator=g, device=dev) * 600
        wh = torch.rand(BATCH, k, 2, generator=g, device=dev) * 60 + 5
        cls = torch.randint(0, 80, (BATCH, k, 1), generator=g,
                            device=dev).float()
        boxes = (torch.cat([xy, xy + wh], -1) + cls * 7680).contiguous()
        scores = torch.rand(BATCH, k, generator=g, device=dev)
        # bf16-rounded scores, so equal scores (ties) are common
        scores = torch.where(scores > 0.2, scores, 0.0).bfloat16().float()
        idx = nms.nms_select(boxes, scores, 0.45, 300)
        ref = nms.nms_select_plain(boxes, scores, 0.45, 300)
        equal = torch.equal(idx, ref)
        print(f"  nms ({BATCH}, {k}) max_det 300: indices equal {equal}, "
              f"{int((idx >= 0).sum())} kept")
        if not equal:
            raise AssertionError(f"nms K={k}: kernel indices differ")
        ms = cuda_ms(lambda: nms.nms_select(boxes, scores, 0.45, 300))
        plain_ms = cuda_ms(
            lambda: nms.nms_select_plain(boxes, scores, 0.45, 300), 2)
        print(f"  nms K={k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        res["nms"][k] = {"err": 0.0, "ms": ms, "plain_ms": plain_ms}
    return res


def check_rel(name: str, y: torch.Tensor, ref: torch.Tensor,
              dtype: torch.dtype) -> float:
    rel = float((y.float() - ref.float()).norm() / ref.float().norm())
    tol = WGRAD_REL[dtype]
    print(f"  {name}: rel L2 {rel:.3e} (tolerance {tol:.0e}) "
          f"{'ok' if rel <= tol else 'FAIL'}")
    if rel > tol or not torch.isfinite(y).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({rel} > {tol})")
    return float((y.float() - ref.float()).abs().max())


def phase_train_kernels(dev) -> dict:
    """The four train kernels against their plain versions at gelan-c's
    train shapes. Returns the bf16 numbers per kernel (ADown: summed over
    the five shapes); these launches are outside phase 8's counted run."""
    g = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape, scale=1.0, dtype=torch.float32, cl=False):
        t = (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    res = {k: {} for k in ("stem_raw", "stem_wgrad", "adown_raw",
                           "adown_bwd")}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        x = rand(BATCH, 3, SIZE, SIZE, dtype=dtype, cl=True)
        w = rand(64, 3, 3, 3, scale=0.3, dtype=dtype)
        err = check_close(f"stem_raw {tag} {tuple(x.shape)}->64",
                          stem.stem_conv_raw(x, w),
                          stem.stem_conv_raw_plain(x, w), dtype)
        ms = cuda_ms(lambda: stem.stem_conv_raw(x, w))
        plain_ms = cuda_ms(lambda: stem.stem_conv_raw_plain(x, w))
        print(f"  stem_raw {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        res["stem_raw"][tag] = {"err": err, "ms": ms, "plain_ms": plain_ms}
        gy = rand(BATCH, 64, SIZE // 2, SIZE // 2, dtype=dtype, cl=True)
        err = check_rel(f"stem_wgrad {tag} g {tuple(gy.shape)}",
                        stem.stem_wgrad(x, gy), stem.stem_wgrad_plain(x, gy),
                        dtype)
        ms = cuda_ms(lambda: stem.stem_wgrad(x, gy))
        plain_ms = cuda_ms(lambda: stem.stem_wgrad_plain(x, gy))
        print(f"  stem_wgrad {tag}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        res["stem_wgrad"][tag] = {"err": err, "ms": ms, "plain_ms": plain_ms}
        del x, gy

        tot = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in ("adown_raw", "adown_bwd")}
        for name, (cin, h, wd, cout) in ADOWN_SHAPES.items():
            x = rand(BATCH, cin, h, wd, dtype=dtype, cl=True)
            w1 = rand(cout // 2, cin // 2, 3, 3, scale=0.03, dtype=dtype)
            w2 = rand(cout // 2, cin // 2, 1, 1, scale=0.06, dtype=dtype)
            err = check_close(f"adown_raw {name} {tag} {tuple(x.shape)}",
                              adown.adown_raw(x, w1, w2),
                              adown.adown_raw_plain(x, w1, w2), dtype)
            ms = cuda_ms(lambda: adown.adown_raw(x, w1, w2), 5)
            plain_ms = cuda_ms(lambda: adown.adown_raw_plain(x, w1, w2), 5)
            print(f"  adown_raw {name} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms")
            t = tot["adown_raw"]
            t["err"], t["ms"], t["plain_ms"] = (
                max(t["err"], err), t["ms"] + ms, t["plain_ms"] + plain_ms)

            gy = rand(BATCH, cout, h // 2, wd // 2, dtype=dtype, cl=True)
            dx, dw1, dw2 = adown.adown_bwd(x, gy, w1, w2)
            rdx, rdw1, rdw2 = adown.adown_bwd_plain(x, gy, w1, w2)
            # max_abs_err is dx's; the weight gradients (sums over ~1e5
            # pixels, values up to ~1e4) are held by relative L2
            err = check_close(f"adown_bwd {name} {tag} dx", dx, rdx, dtype)
            check_rel(f"adown_bwd {name} {tag} dW1", dw1, rdw1, dtype)
            check_rel(f"adown_bwd {name} {tag} dW2", dw2, rdw2, dtype)
            del dx, dw1, dw2, rdx, rdw1, rdw2
            ms = cuda_ms(lambda: adown.adown_bwd(x, gy, w1, w2), 5)
            plain_ms = cuda_ms(lambda: adown.adown_bwd_plain(x, gy, w1, w2),
                               5)
            print(f"  adown_bwd {name} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms")
            t = tot["adown_bwd"]
            t["err"], t["ms"], t["plain_ms"] = (
                max(t["err"], err), t["ms"] + ms, t["plain_ms"] + plain_ms)
            del x, gy
        for k, v in tot.items():
            res[k][tag] = v
    torch.cuda.empty_cache()
    return res


def phase_tiny_train(dev, tmp: Path) -> None:
    """12 f32 TINY_YAML Trainer steps on cuda and on the CPU, same init
    (seed 0) and batches; bounds of scripts/validate_loss_curve.py."""
    path = tmp / "tiny.yaml"
    path.write_text(TINY_YAML)
    batches = [make_eval_batch(2, 96, 11 + i) for i in range(3)]
    loader = [batches[i % 3] for i in range(12)]
    curves = []
    for d in (dev, torch.device("cpu")):
        cfg = TrainConfig(epochs=1, data_parallel=False,
                          output_dir=str(tmp / d.type))
        tr = Trainer(YOLO.from_yaml(path), config=cfg, train_loader=loader,
                     device=d)
        curves.append([float(tr.train_step(b["images"], b["targets"])[0])
                       for b in loader])
    ok = True
    for s, (a, b) in enumerate(zip(*curves)):
        rel = abs(a - b) / max(abs(b), 1e-9)
        bound = 0.02 if s < 6 else 0.08
        ok &= rel < bound
        print(f"  step {s:2d}: cuda {a:.5f} cpu {b:.5f} rel {rel:.2e} "
              f"(bound {bound})")
    if not ok:
        raise AssertionError("tiny train: cuda and cpu loss curves diverge")


def phase_gelan_c_train(dev, tmp: Path) -> dict:
    model = YOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    batches = [make_eval_batch(BATCH, SIZE, seed)
               for seed in range(TRAIN_STEPS + 1)]
    cfg = TrainConfig(epochs=1, compute_dtype="bfloat16", data_parallel=False,
                      output_dir=str(tmp / "gelan-c"), log_interval=1)
    trainer = Trainer(model, config=cfg, train_loader=batches[1:],
                      device=dev)
    before = {"params": {k: v.clone() for k, v in trainer.params.items()},
              "stats": {k: v.clone() for k, v in trainer.stats.items()},
              "ema": {k: v.clone() for k, v in trainer.ema["params"].items()}}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _, _ = trainer.train_step(batches[0]["images"],
                                    batches[0]["targets"])     # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"  warm-up step {warm * 1e3:.1f} ms, loss {float(loss):.4f}")

    stem.raw_launches = stem.wgrad_launches = 0
    adown.raw_launches = adown.bwd_launches = 0
    t0 = time.perf_counter()
    items = trainer.train_one_epoch(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"stem_raw": stem.raw_launches,
              "stem_wgrad": stem.wgrad_launches,
              "adown_raw": adown.raw_launches, "adown_bwd": adown.bwd_launches}
    print(f"  launches {counts} over {TRAIN_STEPS} steps")
    want = {"stem_raw": TRAIN_STEPS, "stem_wgrad": TRAIN_STEPS,
            "adown_raw": 5 * TRAIN_STEPS, "adown_bwd": 5 * TRAIN_STEPS}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if not np.isfinite(items).all():
        raise AssertionError(f"gelan-c train: loss items {items}")
    changed = {
        "params": sum(not torch.equal(v, trainer.params[k])
                      for k, v in before["params"].items()),
        "stats": sum(not torch.equal(v, trainer.stats[k])
                     for k, v in before["stats"].items()),
        "ema": sum(not torch.equal(v, trainer.ema["params"][k])
                   for k, v in before["ema"].items())}
    total = {k: len(v) for k, v in before.items()}
    same = [k for k, v in before["params"].items()
            if torch.equal(v, trainer.params[k])]
    print(f"  tensors changed {changed} of {total}; mean items box/cls/dfl "
          f"{[round(float(v), 4) for v in items]}")
    if same:
        # an update below the f32 resolution of the value leaves it as is
        print(f"  unchanged parameters: {same}")
    # every BN buffer moves with its batch statistics; a parameter can keep
    # its value when its six updates stay below its f32 resolution
    if changed["stats"] != total["stats"] or any(
            changed[k] < 0.95 * total[k] for k in ("params", "ema")):
        raise AssertionError("gelan-c train: state did not change")
    ms = dt / TRAIN_STEPS * 1e3
    print(f"  {ms:.1f} ms/step, {BATCH * TRAIN_STEPS / dt:.1f} images/s "
          f"(bf16, batch {BATCH}, {SIZE} px, {TRAIN_STEPS} steps); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def phase_tiny_fixture(dev, tmp: Path) -> None:
    path = tmp / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = YOLO.from_yaml(path)
    fixture = str(ROOT / "assets" / "dryrun_tiny.npz")
    kw = {"img_size": 160, "compute_dtype": "float32"}
    gpu = Detector.from_checkpoint(model, fixture, device=dev, **kw)
    cpu = Detector.from_checkpoint(model, fixture, device="cpu", **kw)
    images = make_eval_batch(4, 160, 0)["images"]
    a = {k: v.cpu() for k, v in gpu(images).items()}
    b = cpu(images)
    n = a["valid"].sum(dim=1).tolist()
    box_err = float((a["boxes"] - b["boxes"]).abs().max())
    score_err = float((a["scores"] - b["scores"]).abs().max())
    print(f"  detections per image {n}; valid/classes equal "
          f"{torch.equal(a['valid'], b['valid'])}/"
          f"{torch.equal(a['classes'], b['classes'])}; boxes max diff "
          f"{box_err:.3e} px (tol 1e-2), scores {score_err:.3e} (tol 1e-4)")
    if not (torch.equal(a["valid"], b["valid"])
            and torch.equal(a["classes"], b["classes"])
            and box_err <= 1e-2 and score_err <= 1e-4 and min(n) >= 1):
        raise AssertionError("tiny fixture: cuda and cpu detections differ")


def phase_gelan_c(dev) -> dict:
    model = YOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    model.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        # class biases 0 instead of the prior's -8.8: random weights then
        # score near 0.5, so NMS serves full 512-candidate sets
        for seq in model.layers["detect"].cls_convs:
            seq[2].bias.zero_()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  gelan-c: {n_params} parameters, strides {model.strides}")

    # full-width f32 check: the fused model on cuda (kernels) against the
    # same fused model on the CPU (plain versions), decoded output
    f32 = copy.deepcopy(model).fuse()
    x = torch.rand(1, 3, 256, 256, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref, _ = f32(x)
        out, _ = f32.to(dev)(x.to(dev))
    box_err = float((out[..., :4].cpu() - ref[..., :4]).abs().max())
    cls_err = float((out[..., 4:].cpu() - ref[..., 4:]).abs().max())
    print(f"  f32 decoded (1, 3, 256, 256): cuda vs cpu boxes {box_err:.3e} "
          f"px (tol 1e-2), scores {cls_err:.3e} (tol 1e-4)")
    if not (box_err <= 1e-2 and cls_err <= 1e-4):
        raise AssertionError("gelan-c f32: cuda and cpu decoded differ")
    del f32

    det = Detector(model, model.state_dict(), device=dev, img_size=SIZE,
                   compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (BATCH, *FRAME_HW, 3), dtype=np.uint8)
              for _ in range(REQUESTS)]
    det(frames[0])                        # warm-up (cuDNN algorithm choice)
    torch.cuda.synchronize()

    stem.launches = adown.launches = nms.launches = 0
    lat = []
    t_all = time.perf_counter()
    for f in frames:
        t0 = time.perf_counter()
        out = det(f)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    total = time.perf_counter() - t_all
    counts = {"stem": stem.launches, "adown": adown.launches,
              "nms": nms.launches}

    print(f"  launches {counts} over {REQUESTS} requests")
    want = {"stem": REQUESTS, "adown": 5 * REQUESTS, "nms": REQUESTS}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    valid = out["valid"]
    if not (out["boxes"].shape == (BATCH, 300, 4)
            and torch.isfinite(out["boxes"]).all()
            and torch.isfinite(out["scores"]).all()
            and int(valid.sum()) > 0
            and bool(((out["scores"] >= 0) & (out["scores"] <= 1)).all())):
        raise AssertionError("gelan-c: malformed detections")
    print(f"  request latency ms {[round(v, 3) for v in lat]}; "
          f"{BATCH * REQUESTS / total:.1f} images/s over {REQUESTS} "
          f"requests of {BATCH} frames {FRAME_HW[0]}x{FRAME_HW[1]}; "
          f"{int(valid.sum())} detections in the last request")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()

    print("phase 1: environment")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}")
    print(f"  nvidia-smi: {smi}")

    print("phase 2: build")
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"  {lib.relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{'ran' if build.last_build_seconds is not None else 'cached'})")

    print("phase 3: kernels against their plain versions")
    res = phase_kernels(dev)

    print("phase 4: trained tiny fixture, cuda against cpu")
    with tempfile.TemporaryDirectory() as td:
        phase_tiny_fixture(dev, Path(td))

    print("phase 5: gelan-c serving")
    counts = phase_gelan_c(dev)

    print("phase 6: train kernels against their plain versions")
    tres = phase_train_kernels(dev)

    with tempfile.TemporaryDirectory() as td:
        print("phase 7: TINY_YAML training, cuda against cpu")
        phase_tiny_train(dev, Path(td))
        print("phase 8: gelan-c training")
        tcounts = phase_gelan_c_train(dev, Path(td))

    kernels = [
        {"name": "stem_conv", "route": "cuda",
         "source": "yolo_re_tpu_torch/csrc/stem.cu",
         "replaces": "yolo_re_tpu/ops/pallas/stem_kernel.py:265",
         "launches": counts["stem"],
         "max_abs_err": res["stem"]["bf16"]["err"],
         "ms": res["stem"]["bf16"]["ms"],
         "plain_ms": res["stem"]["bf16"]["plain_ms"]},
        {"name": "adown", "route": "cuda",
         "source": "yolo_re_tpu_torch/csrc/adown.cu",
         "replaces": "yolo_re_tpu/ops/pallas/adown_kernel.py:233",
         "launches": counts["adown"],
         "max_abs_err": res["adown"]["bf16"]["err"],
         "ms": res["adown"]["bf16"]["ms"],
         "plain_ms": res["adown"]["bf16"]["plain_ms"]},
        {"name": "nms_select", "route": "cuda",
         "source": "yolo_re_tpu_torch/csrc/nms.cu",
         "replaces": "yolo_re_tpu/ops/pallas/nms_kernel.py:98",
         "launches": counts["nms"],
         "max_abs_err": res["nms"][512]["err"],
         "ms": res["nms"][512]["ms"],
         "plain_ms": res["nms"][512]["plain_ms"]},
    ]
    train_kernels = (
        ("stem_conv_raw", "stem_raw", "stem.cu",
         "stem_kernel.py:265"),
        ("stem_wgrad", "stem_wgrad", "stem_wgrad.cu", "stem_kernel.py:331"),
        ("adown_raw", "adown_raw", "adown.cu", "adown_kernel.py:233"),
        ("adown_bwd", "adown_bwd", "adown_bwd.cu",
         "adown_train_kernel.py:366"))
    for name, key, src, tpu in train_kernels:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"yolo_re_tpu_torch/csrc/{src}",
            "replaces": f"yolo_re_tpu/ops/pallas/{tpu}",
            "launches": tcounts[key],
            "max_abs_err": tres[key]["bf16"]["err"],
            "ms": tres[key]["bf16"]["ms"],
            "plain_ms": tres[key]["bf16"]["plain_ms"]})
    print("(kernel ms/plain_ms: bf16 at the serving and train shapes; adown "
          "kernels are the sum of gelan-c's five ADown shapes, nms is K=512; "
          "adown_bwd's max_abs_err is dx's, stem_wgrad's dW's; train "
          "launches are from phase 8's counted steps)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
