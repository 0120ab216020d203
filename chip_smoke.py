"""Smoke run of the PyTorch/CUDA port (yolo_re_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero (no phase is caught):

1. environment: Python, torch, CUDA, the card (nvidia-smi name, power limit);
2. build: nvcc compiles yolo_re_tpu_torch/csrc/*.cu (cached by source hash);
3. every kernel of the serving and eval path against its plain PyTorch
   version on the card, at gelan-c's shapes at 640 px and batch 32, in
   bf16 and f32: max abs difference (against the tolerance stated below;
   bf16 also in ulps of |ref| where |ref| >= 1), time, and the time of
   one PyTorch call computing the same function where there is one
   (`library_ms`, bf16: F.conv2d with bias, no SiLU; for the chain one
   conv's call times the 2n convs); the stage1 kernels through
   the packed calls a fused model makes (weights packed outside the timed
   calls, as `fuse()` packs them once; conv3 equal across two calls), at
   m (32, 32, 160, 160) for n = 1 and 2 (gelan-c, gelan-c-d2) and
   x (32, 64, 160, 160) and (32, 64, 80, 80); ADown at gelan-c's five
   sites through `adown` (packs, then the kernel) and through the packed
   call a fused ADown makes (timed), each site's time beside its bound and
   beside the time of its cuDNN composite (avg_pool2d, the two F.conv2d
   with bias, max_pool2d, silu, cat, TF32 off: a composite of library
   calls, not one call, so not the kernel's `library_ms`); the stem
   (like conv3) equal across two calls; greedy NMS at K = 512 and 8400 in
   random order (iou 0.45) and at K = 8400 in the Evaluator's order (by
   score, the zeros last; iou 0.6), indices equal to the plain version's,
   each with the cluster size the wrapper picks, the greedy steps of the
   image with the most, the time a step and the time beside its bound;
4. the trained tiny fixture (assets/dryrun_tiny.npz, TINY_YAML, 160 px)
   served on cuda and on the CPU (plain versions) in f32: equal detections;
   phases 4, 7 and 9 (a) run with PyTorch's default TF32 flags, so that
   they fail if an entry point leaves TF32 on for its f32 work (every
   other phase runs with TF32 off: full f32 plain references);
5. gelan-c at full width: random weights from seed 0, fused, bf16, four
   requests of 32 frames of 720x1280 uint8 through Detector, with the
   kernels' launch counters held to the path's layout; first the fused
   model in f32 on cuda against the CPU (every serving kernel in f32);
6. the four train kernels (stem raw + weight grad, ADown raw + backward)
   against their plain versions at gelan-c's 640 px, batch 32 train
   shapes, in f32 and bf16 (the bf16 stem weight gradient also at batch
   8, with its fraction of the bound and its bytes/s; ADown raw, which
   packs its weights on every call, per site beside its bound and its
   cuDNN composite without bias and SiLU; the ADown backward per site
   beside its bound): outputs and dx within `tolerance`, weight gradients
   within a relative L2 of 1e-5 (f32) / 2e-2 (bf16), the raw stem, the
   stem weight gradient and the ADown backward equal across two calls,
   and times;
7. TINY_YAML, f32: 12 Trainer steps on cuda (kernels) and on the CPU
   (plain versions) from the same init; the loss curves must track within
   the bounds of scripts/validate_loss_curve.py (2% relative for the first
   half, 8% after);
8. gelan-c training at full width, 640 px, batch 32, bf16: synthetic uint8
   batches (data/synth.py, numpy seed 0), one warm-up Trainer step, then
   five through Trainer.train_one_epoch with the train kernels' launch
   counters held to one stem pair and five ADown pairs per step;
9. eval: (a) the trained tiny fixture at 160 px, f32, on its synthetic val
   set through the Evaluator on cuda and on the CPU: mAP50 and mAP within
   1e-3, mAP50 > 0.5; (b) gelan-c at full width (phase 5's weights),
   fused, bf16, 64 synthetic images letterboxed to 640 px by the port's
   val loader, batch 32: one warm-up pass, then a counted one with the
   launch counts held to the fused model's kernel sites per batch (gelan-c:
   stem 1, ADown 5, chain 2, conv3 6, NMS 1);
10. yolov9-c at full width (random weights from seed 0, class biases 0):
   (a) the fused model in f32 on cuda against the CPU at (1, 3, 256, 256),
   decoded aux and main, the full forward's launches held to the fused
   model's kernel sites (stem 2, ADown 8, chain 4, conv3 10) and the
   main-only forward's to those of its main steps (1, 5, 2, 6); (b)
   serving as phase 5 (the Detector runs the main-only forward): launches
   held to the main sites x 4 plus NMS 4; (c) eval as phase 9 (b) on the
   same 64 images; (d) training, bf16, 640 px, batch 32 (16 if 32 does not
   fit; the batch and the peak memory printed): one warm-up step, then
   three through Trainer.train_one_epoch with two stem pairs and eight
   ADown pairs a step, a finite loss, and every bias of the aux branch
   changed (cb_route*, aux_*, the aux towers: only a gradient moves a
   bias; in a tower, wherever its main-branch twin changed); (e)
   TINY_DUAL_YAML, f32, phase 7's batches and TF32 flags: 12 Trainer steps
   on cuda and on the CPU, each from one state (the CPU trainer takes the
   cuda trainer's state before every step) within phase 7's bounds; the
   free curves, chaotic for this model (a 1e-6 change of the weights moves
   them further on the CPU alone), are printed;
11. device augmentation (data/device_pipeline.py): (a) at gelan-c's train
   shape (32, 640, 640, 3), uint8 synthetic images normalized in bf16 and
   in f32, 32 target rows: augment_batch_full on the fast path (the "full"
   preset: separable mosaic, mixup, HSV, flips), on the general path
   (degrees 10, shear 2, perspective 1e-4: the gather warp) and
   augment_batch (HSV, flips), on the card and on the CPU from the same
   draws (draw_augment, numpy seed), stage by stage on identical inputs
   (augment_batch_full's mosaic, then the rest on the card's mosaic:
   `augment_stages`): images within 1e-6 (fast path, augment_batch) or
   1e-4 (general) plus, in bf16, one ulp of |ref| (2^-7), the same boxes
   kept, targets within the same bounds; the card's time (CUDA events)
   and the CPU side's; (b) gelan-c at full width, 640 px,
   batch 32, bf16 and f32, through Trainer(data=..., device_augment="full")
   from an on-disk synthetic set (data/synth.write_dataset, 4 batches of
   32): the loader's rate alone (one pass, images/s), one warm-up
   train_step on a synthetic batch, then the 4 on-disk batches through
   Trainer.train_one_epoch (uint8 from the loader, staged
   in pinned memory and copied a batch ahead on the copy stream,
   normalized and augmented on the card) with the train kernels' launch
   counters held to one stem pair and five ADown pairs per step, a finite
   loss, and ms/step, images/s and peak memory printed beside phase 8's.

`bound_ms` in the kernels line is the least time the card could take for
the work: the larger of the bytes each function must move (inputs read
once, outputs written once) over 3.35 TB/s, and its operations at the
card's fastest rate for them (`ops_rate`): 989 TFLOP/s for bf16 products
(tensor cores), three TF32 products per operation at 495 TFLOP/s for f32
products (3xTF32, the card's fastest f32-accurate products, whether a
kernel runs them so or on the CUDA cores) and 67 TFLOP/s for NMS (f32
comparisons, no products: CUDA cores), the H100 SXM data sheet's rates,
computed from this run's inputs; `bound_fraction` is bound_ms / ms. Each
kernel's entry holds its bf16 numbers and, under "f32", its f32 ones (NMS
runs in f32 only: the same numbers); the stage1 kernels, the stem weight
gradient and ADown (forward, raw forward and backward) carry their
numbers at each shape phase 3 or 6 ran under `shapes` (NMS at K = 512 and
8400, and 8400 in the Evaluator's order, with the cluster size and the
time a greedy step). The last three lines are the card's nvidia-smi line, a
JSON line with one entry per kernel (`launches_device_augment`: phase
11 (b)'s launches per dtype), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import torch.nn.functional as F

from yolo_re_tpu_torch.convert import load_weights
from yolo_re_tpu_torch.cli.profile_launches import random_model
from yolo_re_tpu_torch.data import device_pipeline
from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
from yolo_re_tpu_torch.data.dataset import create_dataloader
from yolo_re_tpu_torch.data.synth import (
    TINY_DUAL_YAML,
    TINY_YAML,
    make_eval_batch,
    write_dataset,
)
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.models import blocks
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.kernels import (
    adown,
    build,
    conv3,
    csp_chain,
    nms,
    stem,
)
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent
BATCH, SIZE, FRAME_HW, REQUESTS = 32, 640, (720, 1280), 4
# gelan-c's five ADown inputs at 640 px: (Cin, H, W) -> Cout
ADOWN_SHAPES = {"down1": (256, 160, 160, 256), "down2": (512, 80, 80, 512),
                "down3": (512, 40, 40, 512), "pan_down1": (256, 80, 80, 256),
                "pan_down2": (512, 40, 40, 512)}
# (K, sorted, iou): serving candidates; all anchors at 640 px; all anchors
# in the Evaluator's order (by score, the zeros last) at its iou 0.6
NMS_CASES = ((512, False, 0.45), (8400, False, 0.45), (8400, True, 0.6))
STAGE1_HW = (160, 160)     # stage1 at 640 px: the chain (32 ch), conv3 (64)
CONV3_HW = (STAGE1_HW, (80, 80))   # conv3 also runs stage2's bottlenecks
CHAIN_DEPTHS = (1, 2)      # gelan-c, gelan-c-d2
TRAIN_STEPS = 5            # counted gelan-c train steps (after one warm-up)
WGRAD_BATCHES = (BATCH, 8)   # the stem weight gradient's bf16 shapes
EVAL_IMAGES = 64           # phase 9 (b): two batches of 32
V9C_TRAIN_STEPS = 3        # counted yolov9-c train steps (after one warm-up)
# phase 11: the general warp's hyperparameters; target rows (mosaic x4 and
# mixup x2 of the synthetic sets' 1-3 boxes fit); on-disk train batches;
# tolerances of tests/test_torch_augment.py (bf16 also one ulp of |ref|)
AUG_GENERAL = {"degrees": 10.0, "shear": 2.0, "perspective": 1e-4}
AUG_MAX_BOXES = 32
AUG_TRAIN_BATCHES = 4
AUG_ATOL = {"full fast": 1e-6, "full general": 1e-4, "batch": 1e-6}
# weight gradients, kernel vs plain: relative L2 (both sum f32 products in
# another order; bf16 inputs are exact in f32)
WGRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# H100 SXM data sheet: HBM3 bytes/s; dense bf16 tensor-core, f32 (CUDA-
# core) operations/s, and f32 operations/s in 3xTF32 (three TF32 products
# per operation at 495 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "3xtf32": 495e12 / 3}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, peak: str = "bf16") -> dict:
    """The least time for the work: bytes at HBM rate or operations at the
    peak rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[peak] * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"}) | {
                "ops_rate": peak}


def rate(tag: str) -> str:
    """The PEAK_OPS key that bounds a dtype's products: f32-accurate
    products run fastest in 3xTF32 on the tensor cores, whichever unit a
    kernel runs them on."""
    return "3xtf32" if tag == "f32" else tag


def add_bounds(parts: list[dict]) -> dict:
    """Several launches: the sum of their bounds, named by the largest."""
    top = max(parts, key=lambda b: b["bound_ms"])
    return {"bound_ms": sum(b["bound_ms"] for b in parts),
            "bound_by": top["bound_by"], "ops_rate": top["ops_rate"]}


def conv_flops(x: torch.Tensor, y: torch.Tensor, k: int) -> float:
    """2 * k * k * Cin * (output elements): a dense conv's operations."""
    return 2.0 * k * k * x.shape[1] * y.numel()


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


def bf16_ulps(y: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |y - ref| in bf16 ulps of |ref| over the outputs with
    |ref| >= 1 (one ulp there, at least 2^-7, lies far above the f32 sums'
    order); 0 if there are none."""
    r = ref.float()
    big = r.abs() >= 1
    if not big.any():
        return 0.0
    _, e = torch.frexp(r[big])              # |r| = f 2^e, f in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(r[big]), e - 8)
    return float(((y.float()[big] - r[big]).abs() / ulp).max())


def check_close(name: str, y: torch.Tensor, ref: torch.Tensor,
                dtype: torch.dtype) -> float:
    err = float((y.float() - ref.float()).abs().max())
    tol = tolerance(dtype, ref)
    status = "ok" if err <= tol else "FAIL"
    ulps = (f", {bf16_ulps(y, ref):.3f} bf16 ulps of |ref| >= 1"
            if dtype == torch.bfloat16 else "")
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}{ulps}) "
          f"{status}")
    if err > tol or not torch.isfinite(y).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


def adown_composite(x, w1, b1, w2, b2):
    """ADown as a composite of PyTorch library calls (cuDNN convolutions),
    the yardstick of its kernel: no single call computes it. b1 = b2 =
    None gives the pre-BN train forward (no bias, no SiLU)."""
    a1, a2 = F.avg_pool2d(x, 2, 1, 0).chunk(2, dim=1)
    y1 = F.conv2d(a1, w1, b1, stride=2, padding=1)
    y2 = F.conv2d(F.max_pool2d(a2, 3, 2, 1), w2, b2)
    if b1 is not None:
        y1, y2 = F.silu(y1), F.silu(y2)
    return torch.cat([y1, y2], dim=1)


def adown_site(name: str, tag: str, x: torch.Tensor, y: torch.Tensor,
               ms: float, plain_ms: float, raw: bool, args) -> dict:
    """One ADown site's numbers: its bound (x, the weights and y once; the
    3x3 and the 1x1 conv, each writing half of y's channels, at the
    dtype's product rate), its cuDNN composite's time, and the printed
    line."""
    cin = x.shape[1]
    ops = (9 + 1) * 2.0 * (cin // 2) * y.numel() / 2
    kernel = "adown_raw" if raw else "adown"
    r = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
         **bound(nbytes(x, *args, y), ops, rate(tag))}
    comp = (lambda: adown_composite(x, args[0], None, args[1], None)) \
        if raw else (lambda: adown_composite(x, *args))
    r["composite_ms"] = cuda_ms(comp, 5)
    print(f"  {kernel} {name} {tag}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, {r['ops_rate']}), fraction "
          f"{r['bound_ms'] / ms:.3f}; cuDNN composite (a composite of "
          f"library calls) {r['composite_ms']:.4f} ms")
    return r


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns the numbers per kernel and dtype; these launches are outside
    the counted runs of phases 5 and 9."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32, cl=False):
        t = (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    res = {k: {} for k in ("stem", "adown", "nms", "csp_chain", "conv3")}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        x = rand(BATCH, 3, SIZE, SIZE, dtype=dtype, cl=True)
        w, b = rand(64, 3, 3, 3, scale=0.3, dtype=dtype), rand(64, dtype=dtype)
        y = stem.stem_conv(x, w, b)
        err = check_close(f"stem {tag} {tuple(x.shape)}->64", y,
                          stem.stem_conv_plain(x, w, b), dtype)
        if not torch.equal(y, stem.stem_conv(x, w, b)):
            raise AssertionError(f"stem {tag}: two calls differ")
        ms = cuda_ms(lambda: stem.stem_conv(x, w, b))
        plain_ms = cuda_ms(lambda: stem.stem_conv_plain(x, w, b))
        lib_ms = cuda_ms(lambda: F.conv2d(x, w, b, stride=2, padding=1))
        print(f"  stem {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.conv2d {lib_ms:.4f} ms")
        res["stem"][tag] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, **bound(
                                nbytes(x, w, b, y), conv_flops(x, y, 3),
                                rate(tag))}
        del x, y

        tot = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bounds": [],
               "sites": {}}
        for name, (cin, h, wd, cout) in ADOWN_SHAPES.items():
            x = rand(BATCH, cin, h, wd, dtype=dtype, cl=True)
            args = (rand(cout // 2, cin // 2, 3, 3, scale=0.03, dtype=dtype),
                    rand(cout // 2, dtype=dtype),
                    rand(cout // 2, cin // 2, 1, 1, scale=0.06, dtype=dtype),
                    rand(cout // 2, dtype=dtype))
            ref = adown.adown_plain(x, *args)
            err = check_close(f"adown {name} {tag} {tuple(x.shape)}->{cout}",
                              adown.adown(x, *args), ref, dtype)
            # the fused block's call: weights packed once, as ADown.fuse()
            w1p, w2p = adown.pack_weights(args[0], args[2])
            y = adown.adown_packed(x, w1p, args[1], w2p, args[3])
            err = max(err, check_close(f"adown_packed {name} {tag}", y, ref,
                                       dtype))
            ms = cuda_ms(lambda: adown.adown_packed(x, w1p, args[1], w2p,
                                                    args[3]), 5)
            plain_ms = cuda_ms(lambda: adown.adown_plain(x, *args), 5)
            r = adown_site(name, tag, x, y, ms, plain_ms, False, args)
            tot["err"] = max(tot["err"], err)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bounds"].append(r)
            tot["sites"][name] = r
            del x, y, ref
        res["adown"][tag] = {**tot, **add_bounds(tot.pop("bounds")),
                             "library_ms": None}

        for n in CHAIN_DEPTHS:
            m = rand(BATCH, 32, *STAGE1_HW, dtype=dtype, cl=True)
            args = (rand(n, 32, 32, 3, 3, scale=0.06, dtype=dtype),
                    rand(n, 32, dtype=dtype) * 0.5 + 0.5,
                    rand(n, 32, 32, 3, 3, scale=0.06, dtype=dtype),
                    rand(n, 32, dtype=dtype) * 0.5 + 0.5)
            # the packed call of a fused RepNCSP; packing is fuse-time work
            wp, bias = csp_chain.pack_weights(*args)
            y = csp_chain.bottleneck_chain_packed(m, wp, bias)
            err = check_close(f"csp_chain n={n} {tag} {tuple(m.shape)}", y,
                              csp_chain.bottleneck_chain_plain(m, *args),
                              dtype)
            ms = cuda_ms(
                lambda: csp_chain.bottleneck_chain_packed(m, wp, bias))
            plain_ms = cuda_ms(
                lambda: csp_chain.bottleneck_chain_plain(m, *args))
            w0, b0 = args[0][0], args[1][0]
            lib_ms = 2 * n * cuda_ms(lambda: F.conv2d(m, w0, b0, padding=1))
            print(f"  csp_chain n={n} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, {2 * n} x F.conv2d {lib_ms:.4f} ms")
            res["csp_chain"][(n, tag)] = {
                "err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms,
                **bound(nbytes(m, *args, y), 2 * n * conv_flops(m, y, 3),
                        rate(tag))}
            del m, y

        for hw in CONV3_HW:
            x = rand(BATCH, 64, *hw, dtype=dtype, cl=True)
            w = rand(64, 64, 3, 3, scale=0.05, dtype=dtype)
            b = rand(64, dtype=dtype)
            # the packed call of a fused Conv; packing is fuse-time work
            wp = conv3.pack_weights(w)
            y = conv3.conv3_silu_packed(x, wp, b)
            err = check_close(f"conv3 {tag} {tuple(x.shape)}", y,
                              conv3.conv3_silu_plain(x, w, b), dtype)
            if not torch.equal(y, conv3.conv3_silu_packed(x, wp, b)):
                raise AssertionError(f"conv3 {tag} {hw}: two calls differ")
            ms = cuda_ms(lambda: conv3.conv3_silu_packed(x, wp, b))
            plain_ms = cuda_ms(lambda: conv3.conv3_silu_plain(x, w, b))
            lib_ms = cuda_ms(lambda: F.conv2d(x, w, b, padding=1))
            print(f"  conv3 {hw} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms")
            res["conv3"][(hw, tag)] = {
                "err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms,
                **bound(nbytes(x, w, b, y), conv_flops(x, y, 3),
                        rate(tag))}
            del x, y

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k, sort, iou in NMS_CASES:
        xy = torch.rand(BATCH, k, 2, generator=g, device=dev) * 600
        wh = torch.rand(BATCH, k, 2, generator=g, device=dev) * 60 + 5
        cls = torch.randint(0, 80, (BATCH, k, 1), generator=g,
                            device=dev).float()
        boxes = (torch.cat([xy, xy + wh], -1) + cls * 7680).contiguous()
        scores = torch.rand(BATCH, k, generator=g, device=dev)
        # bf16-rounded scores, so equal scores (ties) are common
        scores = torch.where(scores > 0.2, scores, 0.0).bfloat16().float()
        if sort:
            # the Evaluator's order: by score, descending, the zeros last
            scores, order = torch.sort(scores, dim=1, descending=True,
                                       stable=True)
            boxes = torch.gather(boxes, 1, order[..., None].expand(
                -1, -1, 4)).contiguous()
        name = f"K={k}" + (f" sorted, iou {iou}" if sort else "")
        idx = nms.nms_select(boxes, scores, iou, 300)
        ref = nms.nms_select_plain(boxes, scores, iou, 300)
        equal = torch.equal(idx, ref)
        print(f"  nms ({BATCH}, {k}) {name} max_det 300: indices equal "
              f"{equal}, {int((idx >= 0).sum())} kept")
        if not equal:
            raise AssertionError(f"nms {name}: kernel indices differ")
        ms = cuda_ms(lambda: nms.nms_select(boxes, scores, iou, 300))
        plain_ms = cuda_ms(
            lambda: nms.nms_select_plain(boxes, scores, iou, 300), 2)
        # this run's greedy steps: one per kept box, plus the step that
        # finds nothing live where fewer than max_det are kept; each step
        # ~16 f32 operations per candidate (IoU, compare, argmax). The
        # images run side by side, so the one with the most steps sets
        # the kernel's time: us_per_step is that time over its steps.
        kept = (idx >= 0).sum(1)
        steps = kept + (kept < 300)
        c = nms.cluster_size(BATCH, k, sms)
        res["nms"][name] = r = {
            "err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "cluster": c, "us_per_step": 1e3 * ms / int(steps.max()),
            **bound(nbytes(boxes, scores, idx), 16.0 * int(steps.sum()) * k,
                    "f32")}
        print(f"  nms {name}: {c} CTA(s) an image, kernel {ms:.4f} ms over "
              f"{int(steps.max())} greedy steps ({r['us_per_step']:.3f} us a"
              f" step), bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{int(steps.sum())} greedy steps), fraction "
              f"{r['bound_ms'] / ms:.4f}; plain {plain_ms:.4f} ms")
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
        y = stem.stem_conv_raw(x, w)
        err = check_close(f"stem_raw {tag} {tuple(x.shape)}->64", y,
                          stem.stem_conv_raw_plain(x, w), dtype)
        if not torch.equal(y, stem.stem_conv_raw(x, w)):
            raise AssertionError(f"stem_raw {tag}: two calls differ")
        ms = cuda_ms(lambda: stem.stem_conv_raw(x, w))
        plain_ms = cuda_ms(lambda: stem.stem_conv_raw_plain(x, w))
        lib_ms = cuda_ms(lambda: F.conv2d(x, w, None, stride=2, padding=1))
        print(f"  stem_raw {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, F.conv2d {lib_ms:.4f} ms")
        res["stem_raw"][tag] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                "library_ms": lib_ms, **bound(
                                    nbytes(x, w, y), conv_flops(x, y, 3),
                                    rate(tag))}
        del y
        # bf16 also at a quarter of the batch: fewer rows per CTA of the
        # persistent grid
        for bsz in WGRAD_BATCHES if dtype == torch.bfloat16 else (BATCH,):
            xb = x[:bsz]
            gy = rand(bsz, 64, SIZE // 2, SIZE // 2, dtype=dtype, cl=True)
            dw = stem.stem_wgrad(xb, gy)
            err = check_rel(f"stem_wgrad {tag} g {tuple(gy.shape)}", dw,
                            stem.stem_wgrad_plain(xb, gy), dtype)
            if not torch.equal(dw, stem.stem_wgrad(xb, gy)):
                raise AssertionError("stem_wgrad: two calls differ")
            ms = cuda_ms(lambda: stem.stem_wgrad(xb, gy))
            plain_ms = cuda_ms(lambda: stem.stem_wgrad_plain(xb, gy))
            lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                xb, w.shape, gy, stride=2, padding=1))
            r = {"err": err, "ms": ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, **bound(
                     nbytes(xb, gy, dw), conv_flops(xb, gy, 3),
                     rate(tag))}
            print(f"  stem_wgrad {tag} {tuple(xb.shape)}: kernel {ms:.4f} "
                  f"ms, plain {plain_ms:.4f} ms, conv2d_weight "
                  f"{lib_ms:.4f} ms; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), fraction {r['bound_ms'] / ms:.3f}, "
                  f"{nbytes(xb, gy) / ms / 1e9:.3f} TB/s")
            res["stem_wgrad"][(bsz, tag)] = r
            del gy
        del x

        tot = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bounds": [],
                   "sites": {}} for k in ("adown_raw", "adown_bwd")}
        for name, (cin, h, wd, cout) in ADOWN_SHAPES.items():
            x = rand(BATCH, cin, h, wd, dtype=dtype, cl=True)
            w1 = rand(cout // 2, cin // 2, 3, 3, scale=0.03, dtype=dtype)
            w2 = rand(cout // 2, cin // 2, 1, 1, scale=0.06, dtype=dtype)
            y = adown.adown_raw(x, w1, w2)
            err = check_close(f"adown_raw {name} {tag} {tuple(x.shape)}", y,
                              adown.adown_raw_plain(x, w1, w2), dtype)
            # the two convs (3x3 and 1x1), each writing half of y
            ops = (9 + 1) * 2.0 * (cin // 2) * y.numel() / 2
            # the pack launch and the kernel, as the train forward calls it
            ms = cuda_ms(lambda: adown.adown_raw(x, w1, w2), 5)
            plain_ms = cuda_ms(lambda: adown.adown_raw_plain(x, w1, w2), 5)
            r = adown_site(name, tag, x, y, ms, plain_ms, True, (w1, w2))
            t = tot["adown_raw"]
            t["err"], t["ms"], t["plain_ms"] = (
                max(t["err"], err), t["ms"] + ms, t["plain_ms"] + plain_ms)
            t["bounds"].append(r)
            t["sites"][name] = r
            del y

            gy = rand(BATCH, cout, h // 2, wd // 2, dtype=dtype, cl=True)
            dx, dw1, dw2 = adown.adown_bwd(x, gy, w1, w2)
            rdx, rdw1, rdw2 = adown.adown_bwd_plain(x, gy, w1, w2)
            # max_abs_err is dx's; the weight gradients (sums over ~1e5
            # pixels, values up to ~1e4) are held by relative L2
            err = check_close(f"adown_bwd {name} {tag} dx", dx, rdx, dtype)
            check_rel(f"adown_bwd {name} {tag} dW1", dw1, rdw1, dtype)
            check_rel(f"adown_bwd {name} {tag} dW2", dw2, rdw2, dtype)
            if not all(torch.equal(a, b) for a, b in zip(
                    (dx, dw1, dw2), adown.adown_bwd(x, gy, w1, w2))):
                raise AssertionError(f"adown_bwd {name} {tag}: two calls "
                                     f"differ")
            # the input and the weight gradients of both convs: twice the
            # forward's products
            bwd_bound = bound(nbytes(x, gy, w1, w2, dx, dw1, dw2), 2 * ops,
                              rate(tag))
            del dx, dw1, dw2, rdx, rdw1, rdw2
            ms = cuda_ms(lambda: adown.adown_bwd(x, gy, w1, w2), 5)
            plain_ms = cuda_ms(lambda: adown.adown_bwd_plain(x, gy, w1, w2),
                               5)
            print(f"  adown_bwd {name} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bwd_bound['bound_ms']:.4f} ms "
                  f"({bwd_bound['bound_by']}, {bwd_bound['ops_rate']}), "
                  f"fraction {bwd_bound['bound_ms'] / ms:.3f}")
            t = tot["adown_bwd"]
            t["err"], t["ms"], t["plain_ms"] = (
                max(t["err"], err), t["ms"] + ms, t["plain_ms"] + plain_ms)
            t["bounds"].append(bwd_bound)
            t["sites"][name] = {"ms": ms, "plain_ms": plain_ms,
                                "library_ms": None, **bwd_bound}
            del x, gy
        for k, v in tot.items():
            res[k][tag] = {**v, **add_bounds(v.pop("bounds")),
                           "library_ms": None}
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


def phase_tiny_dual_train(dev, tmp: Path) -> None:
    """Phase 10 (e): 12 f32 TINY_DUAL_YAML Trainer steps on cuda and on
    the CPU, phase 7's init, batches and bounds. The dual model's free
    curve is chaotic: a 1e-6 relative change of the weights moves it by
    far more than the bounds within a few steps, on the CPU alone. So the
    three free curves (cuda, CPU, CPU from weights times 1 + 1e-6 N(0, 1))
    are printed, and the bounds hold each step taken from one state: the
    CPU trainer takes the cuda trainer's whole state (parameters, BN
    statistics, momentum, EMA, step) before every step."""
    path = tmp / "tiny_dual.yaml"
    path.write_text(TINY_DUAL_YAML)
    batches = [make_eval_batch(2, 96, 11 + i) for i in range(3)]
    loader = [batches[i % 3] for i in range(12)]
    cpu = torch.device("cpu")

    def trainer(d) -> Trainer:
        cfg = TrainConfig(epochs=1, data_parallel=False,
                          output_dir=str(tmp / d.type))
        return Trainer(YOLO.from_yaml(path), config=cfg, train_loader=loader,
                       device=d)

    curves = []
    for d, eps in ((dev, 0.0), (cpu, 0.0), (cpu, 1e-6)):
        tr = trainer(d)
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for v in tr.params.values():
                v.mul_(1 + eps * torch.randn(v.shape, generator=g).to(d))
        curves.append([float(tr.train_step(b["images"], b["targets"])[0])
                       for b in loader])
    gpu_c, cpu_c, eps_c = curves
    print("  free curves, rel to the CPU's: cuda " + " ".join(
        f"{abs(a - c) / c:.1e}" for a, c in zip(gpu_c, cpu_c)) +
        "; CPU from weights x (1 + 1e-6 N(0, 1)) " + " ".join(
        f"{abs(e - c) / c:.1e}" for e, c in zip(eps_c, cpu_c)))

    gpu, host = trainer(dev), trainer(cpu)
    ok = True
    for s, b in enumerate(loader):
        with torch.no_grad():
            for src, dst in ((gpu.params, host.params),
                             (gpu.stats, host.stats),
                             (gpu.opt_bufs, host.opt_bufs),
                             (gpu.ema["params"], host.ema["params"]),
                             (gpu.ema["stats"], host.ema["stats"])):
                for k, v in src.items():
                    dst[k].copy_(v)
        host.ema["updates"] = gpu.ema["updates"]
        host.global_step = gpu.global_step
        a = float(gpu.train_step(b["images"], b["targets"])[0])
        c = float(host.train_step(b["images"], b["targets"])[0])
        rel = abs(a - c) / max(abs(c), 1e-9)
        bound = 0.02 if s < 6 else 0.08
        ok &= rel < bound
        print(f"  step {s:2d} from one state: cuda {a:.5f} cpu {c:.5f} "
              f"rel {rel:.2e} (bound {bound})")
    if not ok:
        raise AssertionError("tiny dual train: cuda and cpu steps differ")


def train_full(dev, tmp: Path, name: str, steps: int, batch_sizes,
               pairs: dict, groups: tuple[str, ...] = ()
               ) -> tuple[dict, dict]:
    """`name` at full width, 640 px, bf16: synthetic uint8 batches (numpy
    seeds 0...), one warm-up Trainer step, then `steps` through
    Trainer.train_one_epoch, the train kernels' launches held to `pairs`
    (stem and ADown kernel pairs) a step. The first batch size of
    `batch_sizes` whose warm-up step fits is used. Every BN buffer and
    95% of the parameters and EMA tensors must change, and of each
    group of parameters named by a prefix in `groups` every bias (the
    tensors only a gradient moves). Returns the launch counts and
    `counted_epoch`'s ms/step, images/s and peak memory."""
    for batch in batch_sizes:
        model = YOLO.from_yaml(ROOT / "configs" / "models" / f"{name}.yaml")
        batches = [make_eval_batch(batch, SIZE, seed)
                   for seed in range(steps + 1)]
        cfg = TrainConfig(epochs=1, compute_dtype="bfloat16",
                          data_parallel=False, output_dir=str(tmp / name),
                          log_interval=1)
        trainer = Trainer(model, config=cfg, train_loader=batches[1:],
                          device=dev)
        before = {
            "params": {k: v.clone() for k, v in trainer.params.items()},
            "stats": {k: v.clone() for k, v in trainer.stats.items()},
            "ema": {k: v.clone() for k, v in trainer.ema["params"].items()}}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            loss, _, _ = trainer.train_step(batches[0]["images"],
                                            batches[0]["targets"])  # warm-up
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if batch == batch_sizes[-1]:
                raise
        # outside the handler, so that its traceback frees the tensors
        print(f"  batch {batch} does not fit in the card's memory")
        del model, batches, trainer, before
        torch.cuda.empty_cache()
    warm = time.perf_counter() - t0
    print(f"  warm-up step {warm * 1e3:.1f} ms, loss {float(loss):.4f}")

    items, counts, perf = counted_epoch(trainer, name, steps, batch, pairs)
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
    # its value when its updates stay below its f32 resolution
    if changed["stats"] != total["stats"] or any(
            changed[k] < 0.95 * total[k] for k in ("params", "ema")):
        raise AssertionError(f"{name} train: state did not change")
    for prefix in groups:
        names = [k for k in before["params"] if k.startswith(prefix)]
        # biases (BN shifts, from 0, and conv biases) take no weight decay:
        # only a gradient moves them. One stays only where its main-branch
        # twin stayed too: a box tower whose level holds no assigned
        # anchor gets no gradient (stride 32 in these synthetic batches)
        idle = [k for k in names if k.endswith(".bias") and k in same
                and not (k.replace(".aux_", ".main_") != k
                         and k.replace(".aux_", ".main_") in same)]
        print(f"  {prefix}*: {sum(k not in same for k in names)} of "
              f"{len(names)} parameters changed; biases without a "
              f"gradient: {idle}")
        if not names or idle:
            raise AssertionError(f"{name} train: {prefix}* did not change")
    return counts, perf


def counted_epoch(trainer: Trainer, name: str, steps: int, batch: int,
                  pairs: dict) -> tuple[np.ndarray, dict, dict]:
    """One Trainer.train_one_epoch of `steps` steps, the train kernels'
    launch counters set to 0 just before and read just after, held to
    `pairs` (stem and ADown kernel pairs) a step, with finite mean loss
    items. Returns (items, counts, {ms_per_step, images_per_s, peak_gib})
    and prints them (the host clock over the epoch; the peak since the
    caller's reset)."""
    stem.raw_launches = stem.wgrad_launches = 0
    adown.raw_launches = adown.bwd_launches = 0
    t0 = time.perf_counter()
    items = trainer.train_one_epoch(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"stem_raw": stem.raw_launches,
              "stem_wgrad": stem.wgrad_launches,
              "adown_raw": adown.raw_launches, "adown_bwd": adown.bwd_launches}
    print(f"  launches {counts} over {steps} steps")
    want = {"stem_raw": pairs["stem"] * steps,
            "stem_wgrad": pairs["stem"] * steps,
            "adown_raw": pairs["adown"] * steps,
            "adown_bwd": pairs["adown"] * steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if not np.isfinite(items).all():
        raise AssertionError(f"{name} train: loss items {items}")
    perf = {"ms_per_step": dt / steps * 1e3,
            "images_per_s": batch * steps / dt,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"  {perf['ms_per_step']:.1f} ms/step, {perf['images_per_s']:.1f} "
          f"images/s ({trainer.config.compute_dtype}, batch {batch}, {SIZE} "
          f"px, {steps} steps); peak memory {perf['peak_gib']:.2f} GiB")
    return items, counts, perf


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


def counts_now() -> dict:
    return {"stem": stem.launches, "adown": adown.launches,
            "csp_chain": csp_chain.launches, "conv3": conv3.launches,
            "nms": nms.launches}


def reset_counts() -> None:
    stem.launches = adown.launches = nms.launches = 0
    csp_chain.launches = conv3.launches = 0


def kernel_sites(fused: YOLO, steps=None) -> dict:
    """Launches of each inference kernel in one forward of a fused model
    (or of its `steps`, such as its `main_steps`), from its blocks' kernel
    gates (gelan-c: the stem, five ADowns, stage1's two bottleneck chains,
    six 64 -> 64 3x3 convs: stage1's two block convs and the bottleneck
    convs of stage2's and fpn2's RepNCSPs; yolov9-c's aux branch adds a
    stem, three ADowns, aux_stage1's two chains and four convs)."""
    layers = [fused.layers[s.name] for s in steps] if steps is not None \
        else [fused]
    mods = [m for layer in layers for m in layer.modules()]
    sites = {
        "stem": sum(isinstance(m, blocks.Conv) and m.is_stem for m in mods),
        "adown": sum(isinstance(m, blocks.ADown) for m in mods),
        "csp_chain": sum(isinstance(m, blocks.RepNCSP) and m.chain
                         for m in mods),
        "conv3": sum(isinstance(m, blocks.Conv) and m.is_conv3
                     for m in mods)}
    if min(sites.values()) < 1:
        raise AssertionError(f"a kernel has no site in the model: {sites}")
    return sites


def phase_gelan_c(dev) -> tuple[dict, YOLO, dict]:
    """Returns the launch counts of the four requests, the model (phase 9
    evaluates its weights) and its kernel sites per forward."""
    model = random_model("gelan-c")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  gelan-c: {n_params} parameters, strides {model.strides}")

    # full-width f32 check: the fused model on cuda (kernels) against the
    # same fused model on the CPU (plain versions), decoded output
    f32 = copy.deepcopy(model).fuse()
    x = torch.rand(1, 3, 256, 256, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref, _ = f32(x)
        reset_counts()
        out, _ = f32.to(dev)(x.to(dev))
    f32_counts = counts_now()
    box_err = float((out[..., :4].cpu() - ref[..., :4]).abs().max())
    cls_err = float((out[..., 4:].cpu() - ref[..., 4:]).abs().max())
    print(f"  f32 decoded (1, 3, 256, 256): cuda vs cpu boxes {box_err:.3e} "
          f"px (tol 1e-2), scores {cls_err:.3e} (tol 1e-4); launches "
          f"{f32_counts}")
    if not (box_err <= 1e-2 and cls_err <= 1e-4):
        raise AssertionError("gelan-c f32: cuda and cpu decoded differ")
    sites = kernel_sites(f32)
    print(f"  kernel launches per forward: {sites}")
    if f32_counts != {**sites, "nms": 0}:
        raise AssertionError(f"gelan-c f32: launch counts {f32_counts}")
    del f32

    counts = serve_requests(dev, model, sites, "gelan-c")
    return counts, model, sites


def serve_requests(dev, model: YOLO, sites: dict, name: str) -> dict:
    """A bf16 Detector of `model`'s weights: one warm-up request, then
    REQUESTS requests of BATCH uint8 frames of FRAME_HW, the launches held
    to `sites` per request plus one NMS; latency and images/s printed.
    Returns the launch counts."""
    det = Detector(model, model.state_dict(), device=dev, img_size=SIZE,
                   compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (BATCH, *FRAME_HW, 3), dtype=np.uint8)
              for _ in range(REQUESTS)]
    det(frames[0])                        # warm-up (cuDNN algorithm choice)
    torch.cuda.synchronize()

    reset_counts()
    lat = []
    t_all = time.perf_counter()
    for f in frames:
        t0 = time.perf_counter()
        out = det(f)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    total = time.perf_counter() - t_all
    counts = counts_now()

    print(f"  launches {counts} over {REQUESTS} requests")
    want = {k: v * REQUESTS for k, v in {**sites, "nms": 1}.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    valid = out["valid"]
    if not (out["boxes"].shape == (BATCH, 300, 4)
            and torch.isfinite(out["boxes"]).all()
            and torch.isfinite(out["scores"]).all()
            and int(valid.sum()) > 0
            and bool(((out["scores"] >= 0) & (out["scores"] <= 1)).all())):
        raise AssertionError(f"{name}: malformed detections")
    print(f"  request latency ms {[round(v, 3) for v in lat]}; "
          f"{BATCH * REQUESTS / total:.1f} images/s over {REQUESTS} "
          f"requests of {BATCH} frames {FRAME_HW[0]}x{FRAME_HW[1]}; "
          f"{int(valid.sum())} detections in the last request")
    return counts


def phase_eval(dev, tmp: Path, gelan_c: YOLO, sites: dict,
               defaults: tuple[bool, bool]) -> dict:
    """(a) the trained tiny fixture, cuda against the CPU, under the TF32
    flags `defaults`; (b) gelan-c eval at 640 px. Returns (b)'s launch
    counts."""
    path = tmp / "tiny.yaml"
    path.write_text(TINY_YAML)
    val = write_dataset(str(tmp / "tiny"), "val", 16, seed=1)
    data = DataConfig(val_path=val, num_classes=4, img_size=160,
                      batch_size=8, workers=4)
    weights = load_weights(str(ROOT / "assets" / "dryrun_tiny.npz"))
    with tf32_flags(defaults):
        gpu, cpu = (Evaluator(YOLO.from_yaml(path),
                              create_dataloader(val, data, "val"), device=d)
                    .evaluate(weights) for d in (dev, torch.device("cpu")))
    gap = {k: abs(gpu[k] - cpu[k]) for k in ("map50", "map")}
    print(f"  tiny fixture, 160 px f32, 16 images: cuda mAP50 "
          f"{gpu['map50']:.4f} mAP {gpu['map']:.4f}; cpu mAP50 "
          f"{cpu['map50']:.4f} mAP {cpu['map']:.4f}; gap {gap} (tol 1e-3)")
    if max(gap.values()) > 1e-3 or gpu["map50"] <= 0.5:
        raise AssertionError("tiny fixture eval: cuda and cpu disagree")

    return eval_launches(dev, tmp, gelan_c, sites, "gelan-c")


def eval_launches(dev, tmp: Path, model: YOLO, sites: dict,
                  name: str) -> dict:
    """`model`'s weights, fused, bf16, over EVAL_IMAGES synthetic images
    letterboxed to SIZE by the val loader, batch BATCH: a warm-up pass,
    then a counted one with the launches held to `sites` plus one NMS per
    batch. Returns the launch counts."""
    val = write_dataset(str(tmp / name), "val", EVAL_IMAGES, seed=2)
    data = DataConfig(val_path=val, num_classes=model.num_classes,
                      img_size=SIZE, batch_size=BATCH, workers=8)
    t0 = time.perf_counter()
    n = sum(len(batch["images"]) for batch in
            create_dataloader(val, data, "val"))
    print(f"  val loader alone (decode, letterbox, f32 batches): "
          f"{n / (time.perf_counter() - t0):.1f} images/s")
    ev = Evaluator(model, create_dataloader(val, data, "val"),
                   compute_dtype="bfloat16", device=dev)
    sd = model.state_dict()
    ev.evaluate(sd)                       # warm-up (cuDNN algorithm choice)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = ev.evaluate(sd)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = counts_now()
    batches = EVAL_IMAGES // BATCH
    want = {k: v * batches for k, v in {**sites, "nms": 1}.items()}
    print(f"  {name} bf16 eval, {EVAL_IMAGES} images at {SIZE} px, batch "
          f"{BATCH}: {EVAL_IMAGES / dt:.1f} images/s (host clock, loader "
          f"included), Evaluator images_per_sec "
          f"{out['images_per_sec']:.1f}; mAP50 {out['map50']:.4f} mAP "
          f"{out['map']:.4f} (random weights); launches {counts}")
    if counts != want:
        raise AssertionError(f"eval launch counts {counts}, expected {want}")
    if not all(np.isfinite(v) and v >= 0 for v in out.values()):
        raise AssertionError(f"{name} eval: results {out}")
    return counts


def phase_yolov9c(dev, tmp: Path, defaults: tuple[bool, bool]) -> dict:
    """Phase 10: yolov9-c served, evaluated and trained (the module
    docstring's (a)-(e)). Returns the launch counts of (b), (c) and
    (d)."""
    model = random_model("yolov9-c")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  (a) yolov9-c: {n_params} parameters, strides {model.strides}")
    f32 = copy.deepcopy(model).fuse()
    sites = kernel_sites(f32)
    main_sites = kernel_sites(f32, f32.main_steps)
    print(f"  kernel launches per forward: {sites}; main-only forward "
          f"(serving, eval) {main_sites}")
    x = torch.rand(1, 3, 256, 256, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref, _ = f32(x)
        f32 = f32.to(dev)
        reset_counts()
        out, _ = f32(x.to(dev))
        full_counts = counts_now()
        reset_counts()
        main, _ = f32(x.to(dev), main_only=True)
        main_counts = counts_now()
    ok = torch.equal(main, out["main"])
    for k in ("aux", "main"):
        box_err = float((out[k][..., :4].cpu() - ref[k][..., :4]).abs().max())
        cls_err = float((out[k][..., 4:].cpu() - ref[k][..., 4:]).abs().max())
        print(f"  f32 decoded {k} (1, 3, 256, 256): cuda vs cpu boxes "
              f"{box_err:.3e} px (tol 1e-2), scores {cls_err:.3e} (tol 1e-4)")
        ok &= box_err <= 1e-2 and cls_err <= 1e-4
    print(f"  launches: full forward {full_counts}, main-only "
          f"{main_counts}; main-only equals the full forward's main: "
          f"{torch.equal(main, out['main'])}")
    if not ok:
        raise AssertionError("yolov9-c f32: cuda and cpu decoded differ")
    if full_counts != {**sites, "nms": 0} or \
            main_counts != {**main_sites, "nms": 0}:
        raise AssertionError(f"yolov9-c f32: launch counts {full_counts}, "
                             f"{main_counts}")
    del f32

    print("  (b) serving")
    counts = {"serving": serve_requests(dev, model, main_sites, "yolov9-c")}
    print("  (c) eval")
    counts["eval"] = eval_launches(dev, tmp, model, main_sites, "yolov9-c")
    del model
    print("  (d) training")
    counts["train"], _ = train_full(
        dev, tmp, "yolov9-c", V9C_TRAIN_STEPS, (BATCH, BATCH // 2),
        {"stem": 2, "adown": 8},
        ("layers.cb_route", "layers.aux_", "layers.detect.aux_"))
    print("  (e) TINY_DUAL_YAML training, cuda against cpu")
    with tf32_flags(defaults):
        phase_tiny_dual_train(dev, tmp)
    return counts


def augment_stages(fn, card: tuple, host: tuple, out: tuple,
                   kw: dict) -> list[tuple[str, tuple, tuple]]:
    """(stage, card's output, CPU's output) of each stage of `fn` on
    identical inputs: augment_batch as a whole; augment_batch_full as its
    mosaic (the card's and the CPU's from the same inputs), then the rest
    (mixup, compaction, HSV, flips: the card's whole output against the
    CPU's rest on the card's mosaic). HSV does not keep a one-ulp input
    difference within one ulp of its output (a pixel's channels feed each
    other through v and s), so a difference the general warp leaves is
    held where it arises, not downstream."""
    if fn is device_pipeline.augment_batch:
        return [("whole", out, fn(*host, **kw))]
    mos = {k: kw[k] for k in ("degrees", "shear", "perspective", "mosaic_p")}
    card_mos = device_pipeline.mosaic_affine(*card, **mos)
    ref_mos = device_pipeline.mosaic_affine(*host, **mos)
    rest = fn(card_mos[0].cpu(), card_mos[1].cpu(), host[2],
              **{**kw, "mosaic_p": 0.0}, max_out=host[1].shape[1])
    return [("mosaic", card_mos, ref_mos), ("rest", out, rest)]


def check_augment(name: str, got: tuple, ref: tuple, atol: float,
                  dtype: torch.dtype) -> None:
    """Images within atol (plus one bf16 ulp of |ref| in bf16), the same
    boxes kept, targets within atol; raises otherwise."""
    img, tgt = got[0].cpu(), got[1].cpu()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    diff = (img.float() - ref[0].float()).abs()
    excess = float((diff - atol - rtol * ref[0].float().abs()).max())
    kept, ref_kept = tgt[..., 3] > 0, ref[1][..., 3] > 0
    t_err = float((tgt - ref[1]).abs().max())
    ok = (excess <= 0 and torch.equal(kept, ref_kept) and t_err <= atol
          and img.dtype == dtype and bool(torch.isfinite(img).all()))
    print(f"      {name}: images max |err| {float(diff.max()):.3e} "
          f"(tolerance {atol:g} + {rtol:g} |ref|), {int(ref_kept.sum())} "
          f"boxes kept (equal {torch.equal(kept, ref_kept)}), targets max "
          f"|err| {t_err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"augmentation {name}: the card disagrees "
                             f"with the CPU")


def phase_augment(dev) -> None:
    """Phase 11 (a): each augmentation case on the card against the CPU
    from the same draws, in bf16 and f32 (the module docstring)."""
    batch = make_eval_batch(BATCH, SIZE, 0, max_boxes=AUG_MAX_BOXES)
    preset = AugmentConfig()                     # "full"
    full = {k: getattr(preset, f)
            for k, f in device_pipeline.FULL_FIELDS.items()}
    cases = {
        "full fast": (device_pipeline.augment_batch_full, full),
        "full general": (device_pipeline.augment_batch_full,
                         {**full, **AUG_GENERAL}),
        "batch": (device_pipeline.augment_batch,
                  {k: full[k] for k in device_pipeline.BATCH_FIELDS})}
    cpu = torch.device("cpu")
    for dtype in (torch.bfloat16, torch.float32):
        for name, (fn, hyps) in cases.items():
            draws = device_pipeline.draw_augment(
                np.random.default_rng([1, 0]), BATCH, SIZE, **hyps)
            kw = {k: v for k, v in hyps.items()
                  if k not in device_pipeline.DRAW_ONLY}
            card, host = (
                (torch.from_numpy(batch["images"]).to(d).to(dtype) / 255.0,
                 torch.from_numpy(batch["targets"]).to(d),
                 device_pipeline.draws_to(draws, d)) for d in (dev, cpu))
            out = fn(*card, **kw)
            ms = cuda_ms(lambda: fn(*card, **kw))
            print(f"  (a) {name} {dtype}: {ms:.4f} ms on the card")
            t0 = time.perf_counter()
            for stage, got, ref in augment_stages(fn, card, host, out, kw):
                check_augment(f"{name} {dtype} {stage}", got, ref,
                              AUG_ATOL[name], dtype)
            print(f"      the CPU's side {time.perf_counter() - t0:.2f} s")
            del card, host, out
    torch.cuda.empty_cache()


def phase_augment_train(dev, tmp: Path, phase8: dict) -> dict:
    """Phase 11 (b): gelan-c trained from disk with device_augment="full"
    in bf16 and f32 (the module docstring). Returns the launch counts per
    dtype."""
    train_dir = write_dataset(str(tmp / "aug"), "train",
                              AUG_TRAIN_BATCHES * BATCH, seed=0)
    counts = {}
    for tag, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        data = DataConfig(train_path=train_dir, img_size=SIZE,
                          batch_size=BATCH, workers=8,
                          max_boxes=AUG_MAX_BOXES, augment=AugmentConfig())
        cfg = TrainConfig(epochs=1, compute_dtype=dtype, data_parallel=False,
                          output_dir=str(tmp / f"aug_{tag}"), log_interval=1,
                          device_augment="full")
        trainer = Trainer(
            YOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml"),
            data=data, config=cfg, device=dev)
        if tag == "bf16":
            t0 = time.perf_counter()
            n = sum(len(b["images"]) for b in trainer.train_loader)
            print(f"  (b) the loader alone (uint8, {SIZE} px letterbox): "
                  f"{n / (time.perf_counter() - t0):.1f} images/s")
        warm = make_eval_batch(BATCH, SIZE, 0, max_boxes=AUG_MAX_BOXES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _, _ = trainer.train_step(warm["images"], warm["targets"])
        torch.cuda.synchronize()
        print(f"  (b) gelan-c {tag}, device_augment='full', "
              f"{len(trainer.train_loader)} on-disk batches of {BATCH}: "
              f"warm-up step "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, loss "
              f"{float(loss):.4f}")
        _, counts[tag], _ = counted_epoch(
            trainer, f"gelan-c {tag} augmented", AUG_TRAIN_BATCHES, BATCH,
            {"stem": 1, "adown": 5})
        print(f"  phase 8 (bf16, synthetic batches, no augmentation): "
              f"{phase8['ms_per_step']:.1f} ms/step, "
              f"{phase8['images_per_s']:.1f} images/s, peak memory "
              f"{phase8['peak_gib']:.2f} GiB")
        del trainer
        torch.cuda.empty_cache()
    return counts


def kernels_line(res: dict, tres: dict, counts: dict, tcounts: dict,
                 v9c: dict, aug: dict) -> list[dict]:
    """The kernels JSON line's entries from phases 3 and 6's numbers and
    the launch counts of phases 5 and 8 (`launches`, gelan-c), of phase
    10 (`launches_yolov9_c`: serving, eval and train) and of phase 11 (b)
    (`launches_device_augment`, per dtype); prints each dtype's fractions
    of the bound."""
    # (name, source, TPU kernel, launches, {dtype: numbers}); NMS runs in
    # f32 only
    rows = (
        ("stem_conv", "stem.cu", "stem_kernel.py:265", counts["stem"],
         res["stem"]),
        ("adown", "adown.cu", "adown_kernel.py:233", counts["adown"],
         res["adown"]),
        ("nms_select", "nms.cu", "nms_kernel.py:98", counts["nms"],
         {"bf16": res["nms"]["K=512"], "f32": res["nms"]["K=512"]}),
        ("stem_conv_raw", "stem.cu", "stem_kernel.py:265",
         tcounts["stem_raw"], tres["stem_raw"]),
        ("stem_wgrad", "stem_wgrad.cu", "stem_kernel.py:331",
         tcounts["stem_wgrad"], {t: tres["stem_wgrad"][(BATCH, t)]
                                 for t in ("bf16", "f32")}),
        ("adown_raw", "adown.cu", "adown_kernel.py:233",
         tcounts["adown_raw"], tres["adown_raw"]),
        ("adown_bwd", "adown_bwd.cu", "adown_train_kernel.py:366",
         tcounts["adown_bwd"], tres["adown_bwd"]),
        ("bottleneck_chain", "csp_chain.cu", "csp_chain_kernel.py:231",
         counts["csp_chain"], {t: res["csp_chain"][(1, t)]
                               for t in ("bf16", "f32")}),
        ("conv3_silu", "conv3.cu", "conv3_kernel.py:170", counts["conv3"],
         {t: res["conv3"][(STAGE1_HW, t)] for t in ("bf16", "f32")}),
    )

    def numbers(r: dict) -> dict:
        return {"max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "ops_rate": r["ops_rate"],
                "library_ms": r["library_ms"],
                "bound_fraction": r["bound_ms"] / r["ms"]}

    # phase 10's counters by kernel name (the train counters: train only)
    v9c_key = {"stem_conv": "stem", "adown": "adown", "nms_select": "nms",
               "bottleneck_chain": "csp_chain", "conv3_silu": "conv3",
               "stem_conv_raw": "stem_raw", "stem_wgrad": "stem_wgrad",
               "adown_raw": "adown_raw", "adown_bwd": "adown_bwd"}

    def v9c_launches(name: str) -> dict:
        key = v9c_key[name]
        return {path: v9c[path].get(key, 0)
                for path in ("serving", "eval", "train")}

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"yolo_re_tpu_torch/csrc/{src}",
        "replaces": f"yolo_re_tpu/ops/pallas/{tpu}", "launches": launches,
        "launches_yolov9_c": v9c_launches(name),
        "launches_device_augment": {
            tag: aug[tag].get(v9c_key[name], 0) for tag in aug},
        **numbers(r["bf16"]), "f32": numbers(r["f32"])}
        for name, src, tpu, launches, r in rows]

    # the stage1 kernels, the stem weight gradient and ADown at every shape
    # phases 3 and 6 ran
    def per_shape(tag: str) -> dict:
        return {
            "bottleneck_chain": {f"n={n} {STAGE1_HW[0]}x{STAGE1_HW[1]}":
                                 res["csp_chain"][(n, tag)]
                                 for n in CHAIN_DEPTHS},
            "conv3_silu": {f"{hw[0]}x{hw[1]}": res["conv3"][(hw, tag)]
                           for hw in CONV3_HW},
            "nms_select": res["nms"],
            "stem_wgrad": {f"{b}x3x{SIZE}x{SIZE}":
                           tres["stem_wgrad"][(b, tag)]
                           for b in WGRAD_BATCHES
                           if (b, tag) in tres["stem_wgrad"]},
            "adown": res["adown"][tag]["sites"],
            "adown_raw": tres["adown_raw"][tag]["sites"],
            "adown_bwd": tres["adown_bwd"][tag]["sites"]}

    for tag in ("bf16", "f32"):
        shapes = per_shape(tag)
        for k in kernels:
            if k["name"] in shapes:
                (k if tag == "bf16" else k["f32"])["shapes"] = {
                    shape: {key: r[key] for key in (
                        "ms", "library_ms", "bound_ms", "bound_by",
                        "ops_rate", "composite_ms", "cluster",
                        "us_per_step") if key in r}
                    for shape, r in shapes[k["name"]].items()}
        print(f"fraction of the bound (bound_ms / ms, {tag}): " + ", ".join(
            f"{k['name']} "
            f"{(k if tag == 'bf16' else k['f32'])['bound_fraction']:.3f}"
            for k in kernels) + "; " + ", ".join(
            f"{name} {shape} {r['bound_ms'] / r['ms']:.3f}"
            for name, sh in shapes.items() for shape, r in sh.items()))
    return kernels


@contextlib.contextmanager
def tf32_flags(flags: tuple[bool, bool]):
    """Run the block with (cudnn.allow_tf32, cuda.matmul.allow_tf32) set to
    `flags`, then turn both off again (the kernel phases' setting)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32, matmul.allow_tf32 = flags
    print(f"  (cudnn.allow_tf32 {flags[0]}, cuda.matmul.allow_tf32 "
          f"{flags[1]}: PyTorch's defaults; the entry points turn TF32 off)")
    try:
        yield
    finally:
        cudnn.allow_tf32 = matmul.allow_tf32 = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # PyTorch's defaults, for the phases that compare an entry point's f32
    # work on cuda with the CPU (4, 7, 9 (a)); the others run with TF32 off,
    # so that the plain references of phases 3 and 6 are full f32
    defaults = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
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
    with tempfile.TemporaryDirectory() as td, tf32_flags(defaults):
        phase_tiny_fixture(dev, Path(td))

    print("phase 5: gelan-c serving")
    counts, gelan_c, sites = phase_gelan_c(dev)

    print("phase 6: train kernels against their plain versions")
    tres = phase_train_kernels(dev)

    with tempfile.TemporaryDirectory() as td:
        print("phase 7: TINY_YAML training, cuda against cpu")
        with tf32_flags(defaults):
            phase_tiny_train(dev, Path(td))
        print("phase 8: gelan-c training")
        tcounts, phase8 = train_full(dev, Path(td), "gelan-c", TRAIN_STEPS,
                                     (BATCH,), {"stem": 1, "adown": 5})

    with tempfile.TemporaryDirectory() as td:
        print("phase 9: eval")
        ecounts = phase_eval(dev, Path(td), gelan_c, sites, defaults)
    del gelan_c

    with tempfile.TemporaryDirectory() as td:
        print("phase 10: yolov9-c")
        v9c = phase_yolov9c(dev, Path(td), defaults)

    with tempfile.TemporaryDirectory() as td:
        print("phase 11: device augmentation")
        phase_augment(dev)
        aug = phase_augment_train(dev, Path(td), phase8)

    kernels = kernels_line(res, tres, counts, tcounts, v9c, aug)
    print(f"(kernel ms/plain_ms/library_ms: bf16, and f32 under 'f32', at "
          f"the serving, eval and train shapes, library calls with TF32 "
          f"off; adown kernels are the sum of gelan-c's five ADown shapes "
          f"(adown: the packed call of a fused ADown; adown_raw: its pack "
          f"launch and the kernel, as the train forward calls it), each also "
          f"under 'shapes' with composite_ms, the time of its cuDNN "
          f"composite (a composite of library calls, not one call), nms is "
          f"K=512 (K=8400, all anchors, in random and in the Evaluator's "
          f"order, under 'shapes' with the cluster size and us a greedy "
          f"step), bottleneck_chain "
          f"n=1 with library_ms two F.conv2d calls (one per conv; no SiLU, "
          f"no residual), conv3_silu at 160x160 with "
          f"library_ms one F.conv2d with bias (no SiLU), both also under "
          f"'shapes' at each shape phase 3 ran (chain n=2: four F.conv2d "
          f"calls; conv3 80x80), stem_wgrad at x ({BATCH}, 3, {SIZE}, "
          f"{SIZE}) (bf16 also at {WGRAD_BATCHES[1]} images under 'shapes'), "
          f"stem_conv's likewise, stem_wgrad's torch.nn.grad.conv2d_weight; "
          f"no PyTorch call computes ADown, its backward or greedy NMS: "
          f"null; adown_bwd's max_abs_err is dx's, stem_wgrad's dW's; "
          f"serving launches from phase 5's {REQUESTS} requests, train "
          f"launches from phase 8's counted steps; phase 9 eval launches "
          f"{ecounts}; launches_yolov9_c: phase 10's {REQUESTS} requests, "
          f"{EVAL_IMAGES // BATCH} eval batches and {V9C_TRAIN_STEPS} "
          f"counted train steps; launches_device_augment: phase 11 (b)'s "
          f"{AUG_TRAIN_BATCHES} counted steps per dtype)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
