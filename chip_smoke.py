"""Smoke run of the PyTorch/CUDA port (yolo_re_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero (no phase is caught):

1. environment: Python, torch, CUDA, the card (nvidia-smi name, power limit);
2. build: nvcc compiles yolo_re_tpu_torch/csrc/*.cu (cached by source hash);
3. every kernel of the serving and eval path against its plain PyTorch
   version on the card, at gelan-c's shapes at 640 px and batch 32, in
   bf16 and f32: max abs difference (against the tolerance stated below),
   time, and the time of one PyTorch call computing the same function where
   there is one (`library_ms`, bf16: F.conv2d with bias, no SiLU; for the
   chain one conv's call times the 2n convs); the stage1 kernels through
   the packed calls a fused model makes (weights packed outside the timed
   calls, as `fuse()` packs them once), at
   m (32, 32, 160, 160) for n = 1 and 2 (gelan-c, gelan-c-d2) and
   x (32, 64, 160, 160) and (32, 64, 80, 80); ADown at gelan-c's five
   sites through `adown` (packs, then the kernel) and through the packed
   call a fused ADown makes (timed), each site's time beside its bound and
   beside the time of its cuDNN composite (avg_pool2d, the two F.conv2d
   with bias, max_pool2d, silu, cat, TF32 off: a composite of library
   calls, not one call, so not the kernel's `library_ms`);
4. the trained tiny fixture (assets/dryrun_tiny.npz, TINY_YAML, 160 px)
   served on cuda and on the CPU (plain versions) in f32: equal detections;
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
   beside its bound): outputs and dx within `tolerance`, weight gradients within a relative L2 of 1e-5
   (f32) / 2e-2 (bf16), the stem weight gradient and the ADown backward
   equal across two calls, and times;
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
   stem 1, ADown 5, chain 2, conv3 6, NMS 1).

`bound_ms` in the kernels line is the least time the card could take for
the work: the larger of the bytes each function must move (inputs read
once, outputs written once) over 3.35 TB/s, and its operations at the rate
of the arithmetic the kernel issues (`ops_rate`): 989 TFLOP/s (bf16 tensor
cores), three TF32 products per operation at 495 TFLOP/s (3xTF32: the f32
chain, the f32 stem weight gradient, the f32 ADown forward and raw
forward, and the f32 ADown backward's products) or 67 TFLOP/s (the other
f32 kernels and NMS, on the CUDA cores), the H100 SXM data sheet's rates,
computed from this run's inputs; `bound_fraction` is bound_ms / ms. Each
kernel's entry holds its bf16 numbers and, under "f32", its f32 ones (NMS
runs in f32 only: the same numbers); the stage1 kernels, the stem weight
gradient and ADown (forward, raw forward and backward) carry their
numbers at each shape phase 3 or 6 ran under `shapes`. The last three lines are the card's nvidia-smi line, a
JSON line with one entry per kernel, and {"ok": true, "device": {...}}.
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

import torch.nn.functional as F

from yolo_re_tpu_torch.convert import load_weights
from yolo_re_tpu_torch.data.config import DataConfig
from yolo_re_tpu_torch.data.dataset import create_dataloader
from yolo_re_tpu_torch.data.synth import (
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
NMS_SHAPES = (512, 8400)   # serving candidates; all anchors at 640 px
STAGE1_HW = (160, 160)     # stage1 at 640 px: the chain (32 ch), conv3 (64)
CONV3_HW = (STAGE1_HW, (80, 80))   # conv3 also runs stage2's bottlenecks
CHAIN_DEPTHS = (1, 2)      # gelan-c, gelan-c-d2
TRAIN_STEPS = 5            # counted gelan-c train steps (after one warm-up)
WGRAD_BATCHES = (BATCH, 8)   # the stem weight gradient's bf16 shapes
EVAL_IMAGES = 64           # phase 9 (b): two batches of 32
# weight gradients, kernel vs plain: relative L2 (both sum f32 products in
# another order; bf16 inputs are exact in f32)
WGRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# H100 SXM data sheet: HBM3 bytes/s; dense bf16 tensor-core, f32 (CUDA-
# core) operations/s, and f32 operations/s in 3xTF32 (three TF32 products
# per operation at 495 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "3xtf32": 495e12 / 3}
# the f32 kernels whose products run in 3xTF32 on the tensor cores
F32_3XTF32 = ("csp_chain", "stem_wgrad", "adown", "adown_raw", "adown_bwd")


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


def rate(kernel: str, tag: str) -> str:
    """The arithmetic a kernel issues in a dtype (a PEAK_OPS key)."""
    return "3xtf32" if tag == "f32" and kernel in F32_3XTF32 else tag


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
    3x3 and the 1x1 conv, each writing half of y's channels, at the rate
    of the arithmetic the kernel issues), its cuDNN composite's time, and
    the printed line."""
    cin = x.shape[1]
    ops = (9 + 1) * 2.0 * (cin // 2) * y.numel() / 2
    kernel = "adown_raw" if raw else "adown"
    r = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
         **bound(nbytes(x, *args, y), ops, rate(kernel, tag))}
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
        ms = cuda_ms(lambda: stem.stem_conv(x, w, b))
        plain_ms = cuda_ms(lambda: stem.stem_conv_plain(x, w, b))
        lib_ms = cuda_ms(lambda: F.conv2d(x, w, b, stride=2, padding=1))
        print(f"  stem {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.conv2d {lib_ms:.4f} ms")
        res["stem"][tag] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, **bound(
                                nbytes(x, w, b, y), conv_flops(x, y, 3), tag)}
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
                        rate("csp_chain", tag))}
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
            ms = cuda_ms(lambda: conv3.conv3_silu_packed(x, wp, b))
            plain_ms = cuda_ms(lambda: conv3.conv3_silu_plain(x, w, b))
            lib_ms = cuda_ms(lambda: F.conv2d(x, w, b, padding=1))
            print(f"  conv3 {hw} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms")
            res["conv3"][(hw, tag)] = {
                "err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms,
                **bound(nbytes(x, w, b, y), conv_flops(x, y, 3), tag)}
            del x, y

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
        # this run's greedy steps: one per kept box, plus the step that
        # finds nothing live where fewer than max_det are kept; each step
        # ~16 f32 operations per candidate (IoU, compare, argmax)
        kept = (idx >= 0).sum(1)
        steps = int(kept.sum() + (kept < 300).sum())
        res["nms"][k] = {"err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": None, **bound(
                             nbytes(boxes, scores, idx), 16.0 * steps * k,
                             "f32")}
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
        ms = cuda_ms(lambda: stem.stem_conv_raw(x, w))
        plain_ms = cuda_ms(lambda: stem.stem_conv_raw_plain(x, w))
        lib_ms = cuda_ms(lambda: F.conv2d(x, w, None, stride=2, padding=1))
        print(f"  stem_raw {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, F.conv2d {lib_ms:.4f} ms")
        res["stem_raw"][tag] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                "library_ms": lib_ms, **bound(
                                    nbytes(x, w, y), conv_flops(x, y, 3), tag)}
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
                     rate("stem_wgrad", tag))}
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
                              rate("adown_bwd", tag))
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


def counts_now() -> dict:
    return {"stem": stem.launches, "adown": adown.launches,
            "csp_chain": csp_chain.launches, "conv3": conv3.launches,
            "nms": nms.launches}


def reset_counts() -> None:
    stem.launches = adown.launches = nms.launches = 0
    csp_chain.launches = conv3.launches = 0


def kernel_sites(fused: YOLO) -> dict:
    """Launches of each inference kernel in one forward of a fused model,
    from its blocks' kernel gates (gelan-c: the stem, five ADowns, stage1's
    two bottleneck chains, six 64 -> 64 3x3 convs: stage1's two block
    convs and the bottleneck convs of stage2's and fpn2's RepNCSPs)."""
    mods = list(fused.modules())
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
        raise AssertionError("gelan-c: malformed detections")
    print(f"  request latency ms {[round(v, 3) for v in lat]}; "
          f"{BATCH * REQUESTS / total:.1f} images/s over {REQUESTS} "
          f"requests of {BATCH} frames {FRAME_HW[0]}x{FRAME_HW[1]}; "
          f"{int(valid.sum())} detections in the last request")
    return counts, model, sites


def phase_eval(dev, tmp: Path, gelan_c: YOLO, sites: dict) -> dict:
    """(a) the trained tiny fixture, cuda against the CPU; (b) gelan-c
    eval at 640 px. Returns (b)'s launch counts."""
    path = tmp / "tiny.yaml"
    path.write_text(TINY_YAML)
    val = write_dataset(str(tmp / "tiny"), "val", 16, seed=1)
    data = DataConfig(val_path=val, num_classes=4, img_size=160,
                      batch_size=8, workers=4)
    weights = load_weights(str(ROOT / "assets" / "dryrun_tiny.npz"))
    gpu, cpu = (Evaluator(YOLO.from_yaml(path),
                          create_dataloader(val, data, "val"), device=d)
                .evaluate(weights) for d in (dev, torch.device("cpu")))
    gap = {k: abs(gpu[k] - cpu[k]) for k in ("map50", "map")}
    print(f"  tiny fixture, 160 px f32, 16 images: cuda mAP50 "
          f"{gpu['map50']:.4f} mAP {gpu['map']:.4f}; cpu mAP50 "
          f"{cpu['map50']:.4f} mAP {cpu['map']:.4f}; gap {gap} (tol 1e-3)")
    if max(gap.values()) > 1e-3 or gpu["map50"] <= 0.5:
        raise AssertionError("tiny fixture eval: cuda and cpu disagree")

    val = write_dataset(str(tmp / "gelan-c"), "val", EVAL_IMAGES, seed=2)
    data = DataConfig(val_path=val, num_classes=gelan_c.num_classes,
                      img_size=SIZE, batch_size=BATCH, workers=8)
    t0 = time.perf_counter()
    n = sum(len(batch["images"]) for batch in
            create_dataloader(val, data, "val"))
    print(f"  val loader alone (decode, letterbox, f32 batches): "
          f"{n / (time.perf_counter() - t0):.1f} images/s")
    ev = Evaluator(gelan_c, create_dataloader(val, data, "val"),
                   compute_dtype="bfloat16", device=dev)
    sd = gelan_c.state_dict()
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
    print(f"  gelan-c bf16 eval, {EVAL_IMAGES} images at {SIZE} px, batch "
          f"{BATCH}: {EVAL_IMAGES / dt:.1f} images/s (host clock, loader "
          f"included), Evaluator images_per_sec "
          f"{out['images_per_sec']:.1f}; mAP50 {out['map50']:.4f} mAP "
          f"{out['map']:.4f} (random weights); launches {counts}")
    if counts != want:
        raise AssertionError(f"eval launch counts {counts}, expected {want}")
    if not all(np.isfinite(v) and v >= 0 for v in out.values()):
        raise AssertionError(f"gelan-c eval: results {out}")
    return counts


def kernels_line(res: dict, tres: dict, counts: dict,
                 tcounts: dict) -> list[dict]:
    """The kernels JSON line's entries from phases 3 and 6's numbers and
    the launch counts of phases 5 and 8; prints each dtype's fractions of
    the bound."""
    # (name, source, TPU kernel, launches, {dtype: numbers}); NMS runs in
    # f32 only
    rows = (
        ("stem_conv", "stem.cu", "stem_kernel.py:265", counts["stem"],
         res["stem"]),
        ("adown", "adown.cu", "adown_kernel.py:233", counts["adown"],
         res["adown"]),
        ("nms_select", "nms.cu", "nms_kernel.py:98", counts["nms"],
         {"bf16": res["nms"][512], "f32": res["nms"][512]}),
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

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"yolo_re_tpu_torch/csrc/{src}",
        "replaces": f"yolo_re_tpu/ops/pallas/{tpu}", "launches": launches,
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
                        "ops_rate", "composite_ms") if key in r}
                    for shape, r in shapes[k["name"]].items()}
        print(f"fraction of the bound (bound_ms / ms, {tag}): " + ", ".join(
            f"{k['name']} "
            f"{(k if tag == 'bf16' else k['f32'])['bound_fraction']:.3f}"
            for k in kernels) + "; " + ", ".join(
            f"{name} {shape} {r['bound_ms'] / r['ms']:.3f}"
            for name, sh in shapes.items() for shape, r in sh.items()))
    return kernels


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
    counts, gelan_c, sites = phase_gelan_c(dev)

    print("phase 6: train kernels against their plain versions")
    tres = phase_train_kernels(dev)

    with tempfile.TemporaryDirectory() as td:
        print("phase 7: TINY_YAML training, cuda against cpu")
        phase_tiny_train(dev, Path(td))
        print("phase 8: gelan-c training")
        tcounts = phase_gelan_c_train(dev, Path(td))

    with tempfile.TemporaryDirectory() as td:
        print("phase 9: eval")
        ecounts = phase_eval(dev, Path(td), gelan_c, sites)

    kernels = kernels_line(res, tres, counts, tcounts)
    print(f"(kernel ms/plain_ms/library_ms: bf16, and f32 under 'f32', at "
          f"the serving, eval and train shapes, library calls with TF32 "
          f"off; adown kernels are the sum of gelan-c's five ADown shapes "
          f"(adown: the packed call of a fused ADown; adown_raw: its pack "
          f"launch and the kernel, as the train forward calls it), each also "
          f"under 'shapes' with composite_ms, the time of its cuDNN "
          f"composite (a composite of library calls, not one call), nms is "
          f"K=512, bottleneck_chain n=1 with library_ms two F.conv2d calls "
          f"(one per conv; no SiLU, no residual), conv3_silu at 160x160 with "
          f"library_ms one F.conv2d with bias (no SiLU), both also under "
          f"'shapes' at each shape phase 3 ran (chain n=2: four F.conv2d "
          f"calls; conv3 80x80), stem_wgrad at x ({BATCH}, 3, {SIZE}, "
          f"{SIZE}) (bf16 also at {WGRAD_BATCHES[1]} images under 'shapes'), "
          f"stem_conv's likewise, stem_wgrad's torch.nn.grad.conv2d_weight; "
          f"no PyTorch call computes ADown, its backward or greedy NMS: "
          f"null; adown_bwd's max_abs_err is dx's, stem_wgrad's dW's; "
          f"serving launches from phase 5's {REQUESTS} requests, train "
          f"launches from phase 8's counted steps; phase 9 eval launches "
          f"{ecounts})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
