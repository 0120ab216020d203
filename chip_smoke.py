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
   x (32, 64, 160, 160) and (32, 64, 80, 80); ADown at gelan-c's and at
   gelan-e's five sites (gelan-e: Co = 160 and 320 a branch, a zero tail
   in the last packed N block) through `adown` (packs, then the kernel)
   and through the packed
   call a fused ADown makes (timed), each site's time beside its bound and
   beside the time of its cuDNN composite (avg_pool2d, the two F.conv2d
   with bias, max_pool2d, silu, cat, TF32 off: a composite of library
   calls, not one call, so not the kernel's `library_ms`); the stem
   at C = 64 and 80 (gelan-e)
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
   shapes and at gelan-e's (the stem at C = 80, the five ADown sites at
   Co = 160 and 320), in f32 and bf16 (the bf16 stem weight gradient also
   at batch
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
   loss, and ms/step, images/s and peak memory printed beside phase 8's;
12. the serving export: phase 5's gelan-c weights in a bf16 Detector
   (fused, 640 px) written by Detector.export for (32, 720, 1280, 3) uint8
   frames to a torch.export archive in a temporary directory (its size and
   the seconds to export), loaded by Detector.load_exported (the seconds
   to load), then one warm-up request each and four passes of phase 5's
   REQUESTS requests, live, loaded, loaded, live, then four more with
   the frames already on the card (the host's enqueue then sets a
   request's time): the loaded program's launches held to the fused
   model's kernel sites per request plus one NMS (stem 1, ADown 5, chain
   2, conv3 6, NMS 1), every request of every pass torch.equal to the
   first live pass's, and each pass's images/s and request latency
   printed with the nvidia-smi line;
13. gelan-e and gelan-c-d2 at full width and depth (random weights from
   seed 0, class biases 0): (a) the fused model in f32 on cuda against the
   CPU at (1, 3, 256, 256), the launches held to its kernel sites (gelan-e:
   stem 1, ADown 5, chain 0, conv3 0; gelan-c-d2: 1, 5, 2 (n = 2), 10);
   (b) serving as phase 5, images/s and launches a request; (c) eval as
   phase 9 (b), bf16 and f32; (d) gelan-e training in bf16 and f32 at
   batch 32 (16 if 32 does not fit; the batch and the peak memory
   printed): a warm-up and three counted steps of one stem pair and five
   ADown pairs;
14. the CLIs on the card: the trained tiny fixture written as an
   upstream-schema `.pt` (upstream.reference_to_upstream_sd), turned into
   an .npz by cli.convert_weights; cli.detect on six synthetic images with
   --device cuda (launches held to the fused model's sites and one NMS an
   image) and --device cpu (no launch), equal detections; cli.train, one
   epoch of four steps on the card (a stem pair and four ADown pairs a
   step) with validation; cli.val, fused, on the checkpoint it wrote;
15. data parallelism (parallel/mesh.py): (a) gelan-c at full width and
   depth, 640 px, batch 32, bf16 and f32, from one saved state (the
   seed-0 init written by Trainer._save, loaded by load_checkpoint): a
   warm-up and DDP_STEPS counted Trainer steps on synthetic batches in a
   subprocess (`chip_smoke.py ddp-worker`) that joined a one-process NCCL
   group on a free localhost port (init_distributed): twice with the plain
   Trainer (the first run saves its state before each step), then with
   Trainer(data_parallel=True), whose step runs the collectives (global
   BN moments, the loss's global scale, the flat gradient all-reduce). The second plain run and the DDP run then take
   each step again from the first run's state before it (the f32 free
   curve is chaotic: two plain f32 runs part by ~1% in four steps, as
   phase 10 (e) found for yolov9-c): their loss items and final
   parameters and BN statistics are held against the first run, DDP
   within the second plain run's spread (or DDP_FLOOR, tests/
   test_parallel.py's tolerances, where that spread is smaller); the
   train kernels' launches to one stem pair and five ADown pairs a step;
   ms/step of both printed; (b) phase 5's bf16
   gelan-c request (32 frames 720x1280) through Detector(mesh=Mesh((cuda:0,
   cuda:0))) (two replicas, each packed buffer on the card) beside the
   single Detector: f32 detections on 32 and 29 frames (padded to 30)
   held to phase 5's cuda-against-cpu bounds, bf16 images/s of both and
   the mesh's launches (twice the sites and NMS a request); (c) the
   trained tiny fixture through Evaluator(mesh=) against the single
   Evaluator (batches of 5: the last padded), mAP50 and mAP within phase 9
   (a)'s 1e-3;
16. train tooling and lazy-decode NMS: (a) gelan-c bf16, batch 32, 640
   px, from the seed-0 state: remat off (twice: the spread), True and
   "early", each a warm-up and REMAT_STEPS counted steps every one from
   that state, loss items and the BN running statistics after a step
   held to remat off's within the two remat-off runs' spread (or
   REMAT_FLOOR), ms/step, peak memory and the train kernels' launches a
   step held to REMAT_PAIRS; one "early" step at batch 64 (peak memory);
   an f32 "early" step against f32 without remat; (b) two steps with a
   torch.optim.Adam factory (finite losses) and two with a hand-written
   SGD (init_fn, step_fn) pair (stem1's weight moved by exactly -lr *
   the gradient handed to step_fn); (c) (a)'s "early" Trainer saved as a
   checkpoint directory (checkpoint_format "orbax": torch.distributed.
   checkpoint; seconds and bytes) and as an .npz, loaded by a fresh
   Trainer (every tensor equal), the next step's items of both within
   (a)'s bound, Detector.from_checkpoint of the directory and of the .npz
   serving phase 5's first request torch.equal; (d) phase 5's bf16
   Detector model (its weights with unit-scale BN statistics: at the
   init's (0, 1) every score is 0.5) on phase 5's first request
   letterboxed: predict_split + non_max_suppression_raw against the
   decoded forward + non_max_suppression at conf 0.25 (K = 512) and 1e-3
   (all 8400 anchors), detections equal within tests/test_torch_nms_raw.
   py's tolerance with the anchors whose largest logit and largest
   rounded sigmoid disagree left out of both (printed), the lazy path's
   launches held to the fused sites plus one NMS, the device ms of both
   post-processing paths (utils.profiling.device_timer); (e)
   run by phase 15's ddp-worker in its one-process NCCL group: the DDP
   Trainer in bf16 with remat "early", each step from one state against
   the plain Trainer within phase 15's bound, its launches held to (a)'s
   "early" ones, and its BN all-reduces to one a BN call of the forward
   and one of each recomputed block's (the recompute reduces over the
   group, from autograd's device thread). Phase 16's seconds are printed;
17. the last modules: (a) the native host library (utils/native.py)
   built on this machine's host, the train loader's images/s with cv2
   and with the native kernels (cli/bench_loader.loader_rates: phase 11's
   128 on-disk images at 640 px, batch 32, 8 workers, the "full" host
   augmentation, LOADER_EPOCHS after a warm-up), and phase 9 (a)'s tiny
   fixture eval from disk under YOLO_TPU_NATIVE 0 and 1 (one pass each:
   images/s, mAP50 > 0.5); (b) a gelan-c bf16 Detector (phase 5's random weights)
   on the card exported with `device="cpu"` for XDEV_BATCH frames of 640 x
   640, loaded on the CPU: every weight and constant on the CPU, no
   launch, detections matching the live CPU Detector's
   (`detections_match`); (c) the same Detector on the CPU exported with
   `device="cuda"`, and (b)'s archive loaded with `device=` the card, each
   loaded on the card: launches 1/5/2/6/1 a request and every output
   torch.equal to the live card Detector's; (d) dryrun_torch.
   dryrun_multichip(1, device="cuda"): gelan-c over NCCL in one process,
   its seconds by stage and every kernel counter of that process above 0. Phase
   17's seconds are printed;
18. per-layer and per-stage profiles (cli/profile_layers.py,
   cli/profile_train.py): (a) gelan-c at full width and depth (random
   weights from seed 0), fused, 640 px, batch 32, bf16 then f32: the
   main-only forward's device time by layer (forward-hook ranges in
   torch.profiler traces of PROFILE_ITERS forwards), its rows the main
   steps in order and summing to the TOTAL kernel time within
   PROFILE_SUM_RTOL, the kernel counters one forward's sites a forward
   run (stem 1, ADown 5, chain 2, conv3 6), the table, the ten largest
   layers and the forward's idle share (CUDA-event wall time against the
   kernel time) printed; (b) profile_train's stages (fwd, fwd_bwd,
   fwd_loss, fwd_loss_bwd, full, tal_only) on gelan-c at 640 px, batch 32,
   bf16 and f32, CUDA events over PROFILE_TRAIN_ITERS calls, every time
   finite and above 0, a `full` stage (Trainer._step) launching a stem
   pair and five ADown pairs, printed beside phase 8's ms/step; (c)
   `--per-layer` on TINY_YAML at 160 px, batch 8, on the card, a finite
   row for each plan step. (b) runs first, before the process's first
   torch.profiler trace. Phase 18's seconds are printed.
The total seconds are printed before the last three lines. Phase 1 also
prints `utils.devices.device_summary()`.

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
runs in f32 only: the same numbers); the stage1 kernels, the stem
kernels and ADown (forward, raw forward and backward) carry their
numbers at each shape phase 3 or 6 ran under `shapes` (NMS at K = 512 and
8400, and 8400 in the Evaluator's order, with the cluster size and the
time a greedy step; ADown at gelan-c's and gelan-e's sites, gelan-e's
sums under `gelan_e`). The last three lines are the card's nvidia-smi
line, a JSON line with one entry per kernel (`launches_device_augment`:
phase 11 (b)'s launches per dtype; `launches_exported`: phase 12's
launches from the loaded archive; `launches_gelan_e`,
`launches_gelan_c_d2`: phase 13's; `launches_cli`: phase 14's;
`launches_data_parallel`: phase 15's DDP train steps and mesh serving
requests; `launches_remat`, `launches_lazy_nms`: phase 16's; `launches_profile`:
phase 18's), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist
import torch.nn.functional as F

import dryrun_torch
from yolo_re_tpu_torch import upstream
from yolo_re_tpu_torch.cli import (
    bench_loader,
    convert_weights,
    detect,
    profile_layers,
    profile_train,
)
from yolo_re_tpu_torch.cli import train as train_cli
from yolo_re_tpu_torch.cli import val as val_cli
from yolo_re_tpu_torch.cli.profile_launches import random_model
from yolo_re_tpu_torch.convert import load_weights, state_dict_from_jax
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
from yolo_re_tpu_torch.models.yolo import YOLO, remat_step
from yolo_re_tpu_torch.ops import conv as conv_ops
from yolo_re_tpu_torch.ops.boxes import dfl_decode, dist2bbox, make_anchors_np
from yolo_re_tpu_torch.ops.kernels import (
    adown,
    build,
    conv3,
    csp_chain,
    nms,
    stem,
)
from yolo_re_tpu_torch.ops.nms import (
    nms_to_list,
    non_max_suppression,
    non_max_suppression_raw,
)
from yolo_re_tpu_torch.parallel.mesh import Mesh, init_distributed
from yolo_re_tpu_torch.serving import DTYPES, Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer
from yolo_re_tpu_torch.utils import native
from yolo_re_tpu_torch.utils.devices import device_summary
from yolo_re_tpu_torch.utils.profiling import device_timer

ROOT = Path(__file__).resolve().parent
BATCH, SIZE, FRAME_HW, REQUESTS = 32, 640, (720, 1280), 4
# gelan-c's five ADown inputs at 640 px: (Cin, H, W) -> Cout
ADOWN_SHAPES = {"down1": (256, 160, 160, 256), "down2": (512, 80, 80, 512),
                "down3": (512, 40, 40, 512), "pan_down1": (256, 80, 80, 256),
                "pan_down2": (512, 40, 40, 512)}
# gelan-e's (width 1.25): Co = 160 and 320 a branch, packed to N = 256 and
# 512 with a zero tail in the last n-block
GELAN_E_ADOWN_SHAPES = {
    "down1": (320, 160, 160, 320), "down2": (640, 80, 80, 640),
    "down3": (640, 40, 40, 640), "pan_down1": (320, 80, 80, 320),
    "pan_down2": (640, 40, 40, 640)}
ADOWN_MODELS = {"gelan-c": ADOWN_SHAPES, "gelan-e": GELAN_E_ADOWN_SHAPES}
STEM_WIDTHS = (64, 80)     # the stem's C: gelan-c (and yolov9-c), gelan-e
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
# phase 13: the kernel sites of the fused gelan-e and gelan-c-d2 (gelan-e's
# 40-channel bottlenecks and 80-channel 3x3 convs are outside the chain's
# and conv3's geometry; gelan-c-d2 runs stage1's chains at n = 2 and eight
# bottlenecks' convs in stage2 and fpn2); counted gelan-e train steps
GELAN_E_SITES = {"stem": 1, "adown": 5, "csp_chain": 0, "conv3": 0}
GELAN_C_D2_SITES = {"stem": 1, "adown": 5, "csp_chain": 2, "conv3": 10}
GELAN_E_TRAIN_STEPS = 3
# phase 14: detect and val images, train images and batch of the CLIs
CLI_IMAGES, CLI_TRAIN_IMAGES, CLI_BATCH = 6, 32, 8
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
# phase 15: counted DDP steps (after one warm-up) per dtype; the mesh
# Detector's batches (29: padded to 30 over two replicas); the mesh
# Evaluator's batch (16 images: batches of 5, 5, 5, 1); DDP against the
# plain Trainer where the two plain runs agree closer than this:
# tests/test_parallel.py's N-process against 1-process tolerances (loss
# items rtol 2e-3; parameters and BN statistics rtol 5e-3, atol 3e-4,
# `excess` <= 1)
DDP_STEPS = 3
DDP_DTYPES = ("bfloat16", "float32")
MESH_BATCHES = (BATCH, 29)
MESH_EVAL_BATCH = 5
DDP_FLOOR = {"items": 2e-3, "state": 1.0}
DDP_STATE_TOL = (5e-3, 3e-4)
# phase 16: counted steps per remat mode (after one warm-up), each from the
# seed-0 state; the train kernels' launches a step per mode (stem raw,
# stem weight gradient, ADown raw, ADown backward): the recomputed blocks
# launch their forward kernels again (stem1 under both modes, the five
# ADowns under True, down1 under "early"), the backward kernels once;
# (a)'s larger batch; the injected rules' lr; the floor of (a)'s parity
# bound where two remat-off runs agree closer; (d)'s confidences (K = 512,
# every anchor) and tolerance (tests/test_torch_nms_raw.py's 1e-4, plus
# 1e-6 of the coordinate: a few f32 ulps at 640 px, where the DFL GEMM
# over K or over every anchor sums in another order)
REMAT_STEPS = 3
REMAT_MODES = {"off": False, "True": True, "early": "early"}
REMAT_PAIRS = {"off": (1, 1, 5, 5), "True": (2, 1, 10, 5),
               "early": (2, 1, 6, 5)}
REMAT_BIG_BATCH = 64
REMAT_FLOOR = 1e-6
OPT_LR = 1e-3
LAZY_NMS_CONFS = (0.25, 1e-3)
# phase 17: the loader benchmark's epochs after its warm-up (phase 11's
# on-disk set, SIZE px, batch BATCH); the cross-device export's batch of
# SIZE x SIZE frames
LOADER_EPOCHS = 2
XDEV_BATCH = 2
# phase 18: profile_layers' traced forwards a trace, profile_train's timed
# calls a stage (after one warm-up), the per-layer run's TINY_YAML size and
# calls; the layer rows' sum against the TOTAL kernel time
PROFILE_ITERS = 3
PROFILE_TRAIN_ITERS = 3
PROFILE_TINY = (8, 160, 1)      # batch, px, calls
PROFILE_SUM_RTOL = 1e-3
NMS_RAW_ATOL, NMS_RAW_RTOL = 1e-4, 1e-6
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


def adown_sites(rand, dtype: torch.dtype, tag: str, model: str,
                shapes: dict) -> dict:
    """ADown (`adown`, then the packed call a fused ADown makes, timed) at
    `model`'s sites against the plain version. Returns the sums over the
    sites, their summed bound and each site's numbers under "sites"."""
    tot = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bounds": [],
           "sites": {}}
    for name, (cin, h, wd, cout) in shapes.items():
        x = rand(BATCH, cin, h, wd, dtype=dtype, cl=True)
        args = (rand(cout // 2, cin // 2, 3, 3, scale=0.03, dtype=dtype),
                rand(cout // 2, dtype=dtype),
                rand(cout // 2, cin // 2, 1, 1, scale=0.06, dtype=dtype),
                rand(cout // 2, dtype=dtype))
        ref = adown.adown_plain(x, *args)
        err = check_close(f"adown {model} {name} {tag} {tuple(x.shape)}->"
                          f"{cout}", adown.adown(x, *args), ref, dtype)
        # the fused block's call: weights packed once, as ADown.fuse()
        w1p, w2p = adown.pack_weights(args[0], args[2])
        y = adown.adown_packed(x, w1p, args[1], w2p, args[3])
        err = max(err, check_close(f"adown_packed {model} {name} {tag}", y,
                                   ref, dtype))
        ms = cuda_ms(lambda: adown.adown_packed(x, w1p, args[1], w2p,
                                                args[3]), 5)
        plain_ms = cuda_ms(lambda: adown.adown_plain(x, *args), 5)
        r = adown_site(f"{model} {name}", tag, x, y, ms, plain_ms, False,
                       args)
        tot["err"] = max(tot["err"], err)
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bounds"].append(r)
        tot["sites"][name] = r
        del x, y, ref
    print(f"  adown {model} {tag}, sum of {len(shapes)} sites: kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
          f"{sum(b['bound_ms'] for b in tot['bounds']):.4f} ms")
    return {**tot, **add_bounds(tot.pop("bounds")), "library_ms": None}


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns the numbers per kernel and dtype; these launches are outside
    the counted runs of phases 5 and 9."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32, cl=False):
        t = (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    res = {k: {} for k in ("stem", "stem_shapes", "adown", "nms",
                           "csp_chain", "conv3")}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        x = rand(BATCH, 3, SIZE, SIZE, dtype=dtype, cl=True)
        for c in STEM_WIDTHS:
            w, b = rand(c, 3, 3, 3, scale=0.3, dtype=dtype), \
                rand(c, dtype=dtype)
            y = stem.stem_conv(x, w, b)
            err = check_close(f"stem {tag} {tuple(x.shape)}->{c}", y,
                              stem.stem_conv_plain(x, w, b), dtype)
            if not torch.equal(y, stem.stem_conv(x, w, b)):
                raise AssertionError(f"stem {tag} C={c}: two calls differ")
            ms = cuda_ms(lambda: stem.stem_conv(x, w, b))
            plain_ms = cuda_ms(lambda: stem.stem_conv_plain(x, w, b))
            lib_ms = cuda_ms(lambda: F.conv2d(x, w, b, stride=2, padding=1))
            r = {"err": err, "ms": ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, **bound(
                     nbytes(x, w, b, y), conv_flops(x, y, 3), rate(tag))}
            print(f"  stem C={c} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            res["stem_shapes"][(c, tag)] = r
            del y
        res["stem"][tag] = res["stem_shapes"][(STEM_WIDTHS[0], tag)]
        del x

        for model, shapes in ADOWN_MODELS.items():
            res["adown"][(model, tag)] = adown_sites(rand, dtype, tag,
                                                     model, shapes)
        res["adown"][tag] = res["adown"][("gelan-c", tag)]


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


def adown_train_sites(rand, dtype: torch.dtype, tag: str, model: str,
                      shapes: dict) -> dict:
    """adown_raw (its pack launch and the kernel, as the train forward
    calls it) and adown_bwd at `model`'s sites against their plain
    versions. Returns {"adown_raw": sums, "adown_bwd": sums}, each with
    its summed bound and each site's numbers under "sites"."""
    tot = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bounds": [],
               "sites": {}} for k in ("adown_raw", "adown_bwd")}
    for name, (cin, h, wd, cout) in shapes.items():
        site = f"{model} {name}"
        x = rand(BATCH, cin, h, wd, dtype=dtype, cl=True)
        w1 = rand(cout // 2, cin // 2, 3, 3, scale=0.03, dtype=dtype)
        w2 = rand(cout // 2, cin // 2, 1, 1, scale=0.06, dtype=dtype)
        y = adown.adown_raw(x, w1, w2)
        err = check_close(f"adown_raw {site} {tag} {tuple(x.shape)}", y,
                          adown.adown_raw_plain(x, w1, w2), dtype)
        # the two convs (3x3 and 1x1), each writing half of y
        ops = (9 + 1) * 2.0 * (cin // 2) * y.numel() / 2
        ms = cuda_ms(lambda: adown.adown_raw(x, w1, w2), 5)
        plain_ms = cuda_ms(lambda: adown.adown_raw_plain(x, w1, w2), 5)
        r = adown_site(site, tag, x, y, ms, plain_ms, True, (w1, w2))
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
        err = check_close(f"adown_bwd {site} {tag} dx", dx, rdx, dtype)
        check_rel(f"adown_bwd {site} {tag} dW1", dw1, rdw1, dtype)
        check_rel(f"adown_bwd {site} {tag} dW2", dw2, rdw2, dtype)
        if not all(torch.equal(a, b) for a, b in zip(
                (dx, dw1, dw2), adown.adown_bwd(x, gy, w1, w2))):
            raise AssertionError(f"adown_bwd {site} {tag}: two calls "
                                 f"differ")
        # the input and the weight gradients of both convs: twice the
        # forward's products
        bwd_bound = bound(nbytes(x, gy, w1, w2, dx, dw1, dw2), 2 * ops,
                          rate(tag))
        del dx, dw1, dw2, rdx, rdw1, rdw2
        ms = cuda_ms(lambda: adown.adown_bwd(x, gy, w1, w2), 5)
        plain_ms = cuda_ms(lambda: adown.adown_bwd_plain(x, gy, w1, w2), 5)
        print(f"  adown_bwd {site} {tag}: kernel {ms:.4f} ms, plain "
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
    for k, t in tot.items():
        print(f"  {k} {model} {tag}, sum of {len(shapes)} sites: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{sum(b['bound_ms'] for b in t['bounds']):.4f} ms")
    return {k: {**v, **add_bounds(v.pop("bounds")), "library_ms": None}
            for k, v in tot.items()}


def phase_train_kernels(dev) -> dict:
    """The four train kernels against their plain versions at gelan-c's
    train shapes. Returns the bf16 numbers per kernel (ADown: summed over
    the five shapes); these launches are outside phase 8's counted run."""
    g = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape, scale=1.0, dtype=torch.float32, cl=False):
        t = (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    res = {k: {} for k in ("stem_raw", "stem_raw_shapes", "stem_wgrad",
                           "adown_raw", "adown_bwd")}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        x = rand(BATCH, 3, SIZE, SIZE, dtype=dtype, cl=True)
        for c in STEM_WIDTHS:
            w = rand(c, 3, 3, 3, scale=0.3, dtype=dtype)
            y = stem.stem_conv_raw(x, w)
            err = check_close(f"stem_raw {tag} {tuple(x.shape)}->{c}", y,
                              stem.stem_conv_raw_plain(x, w), dtype)
            if not torch.equal(y, stem.stem_conv_raw(x, w)):
                raise AssertionError(f"stem_raw {tag} C={c}: two calls "
                                     f"differ")
            ms = cuda_ms(lambda: stem.stem_conv_raw(x, w))
            plain_ms = cuda_ms(lambda: stem.stem_conv_raw_plain(x, w))
            lib_ms = cuda_ms(lambda: F.conv2d(x, w, None, stride=2,
                                              padding=1))
            r = {"err": err, "ms": ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, **bound(
                     nbytes(x, w, y), conv_flops(x, y, 3), rate(tag))}
            print(f"  stem_raw C={c} {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            res["stem_raw_shapes"][(c, tag)] = r
            del y
            # gelan-c's width in bf16 also at a quarter of the batch: fewer
            # rows per CTA of the persistent grid
            batches = WGRAD_BATCHES if dtype == torch.bfloat16 and \
                c == STEM_WIDTHS[0] else (BATCH,)
            for bsz in batches:
                xb = x[:bsz]
                gy = rand(bsz, c, SIZE // 2, SIZE // 2, dtype=dtype, cl=True)
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
                print(f"  stem_wgrad C={c} {tag} {tuple(xb.shape)}: kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, conv2d_weight "
                      f"{lib_ms:.4f} ms; bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), fraction "
                      f"{r['bound_ms'] / ms:.3f}, "
                      f"{nbytes(xb, gy) / ms / 1e9:.3f} TB/s")
                res["stem_wgrad"][(bsz, c, tag)] = r
                del gy
        res["stem_raw"][tag] = res["stem_raw_shapes"][(STEM_WIDTHS[0], tag)]
        del x

        for model, shapes in ADOWN_MODELS.items():
            tot = adown_train_sites(rand, dtype, tag, model, shapes)
            for k, v in tot.items():
                res[k][(model, tag)] = v
        for k in ("adown_raw", "adown_bwd"):
            res[k][tag] = res[k][("gelan-c", tag)]
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
               pairs: dict, groups: tuple[str, ...] = (),
               dtype: str = "bfloat16") -> tuple[dict, dict]:
    """`name` at full width, 640 px, in `dtype`: synthetic uint8 batches
    (numpy seeds 0...), one warm-up Trainer step, then `steps` through
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
        cfg = TrainConfig(epochs=1, compute_dtype=dtype,
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
    reset_train_counts()
    t0 = time.perf_counter()
    items = trainer.train_one_epoch(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = train_counts()
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


def train_counts() -> dict:
    return {"stem_raw": stem.raw_launches, "stem_wgrad": stem.wgrad_launches,
            "adown_raw": adown.raw_launches, "adown_bwd": adown.bwd_launches}


def reset_train_counts() -> None:
    stem.raw_launches = stem.wgrad_launches = 0
    adown.raw_launches = adown.bwd_launches = 0


def reset_counts() -> None:
    stem.launches = adown.launches = nms.launches = 0
    csp_chain.launches = conv3.launches = 0


def kernel_sites(fused: YOLO, steps=None, expect: dict | None = None
                 ) -> dict:
    """Launches of each inference kernel in one forward of a fused model
    (or of its `steps`, such as its `main_steps`), from its blocks' kernel
    gates (gelan-c: the stem, five ADowns, stage1's two bottleneck chains,
    six 64 -> 64 3x3 convs: stage1's two block convs and the bottleneck
    convs of stage2's and fpn2's RepNCSPs; yolov9-c's aux branch adds a
    stem, three ADowns, aux_stage1's two chains and four convs). Every
    kernel must have a site, or the sites must equal `expect` (gelan-e
    runs no chain and no conv3)."""
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
    if expect is not None and sites != expect:
        raise AssertionError(f"kernel sites {sites}, expected {expect}")
    if expect is None and min(sites.values()) < 1:
        raise AssertionError(f"a kernel has no site in the model: {sites}")
    return sites


def f32_forward(dev, model: YOLO, name: str, expect: dict | None = None
                ) -> dict:
    """Full-width f32 check: the fused `model` on cuda (kernels) against
    the same fused model on the CPU (plain versions), decoded output at
    one 256 px image, the launches held to its kernel sites. Returns the
    sites."""
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {name}: {n_params} parameters, strides {model.strides}")
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
        raise AssertionError(f"{name} f32: cuda and cpu decoded differ")
    sites = kernel_sites(f32, expect=expect)
    print(f"  kernel launches per forward: {sites}")
    if f32_counts != {**sites, "nms": 0}:
        raise AssertionError(f"{name} f32: launch counts {f32_counts}")
    return sites


def phase_gelan_c(dev) -> tuple[dict, YOLO, dict]:
    """Returns the launch counts of the four requests, the model (phase 9
    evaluates its weights) and its kernel sites per forward."""
    model = random_model("gelan-c")
    sites = f32_forward(dev, model, "gelan-c")
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
                  name: str, dtype: str = "bfloat16") -> dict:
    """`model`'s weights, fused, in `dtype`, over EVAL_IMAGES synthetic
    images letterboxed to SIZE by the val loader, batch BATCH: a warm-up
    pass, then a counted one with the launches held to `sites` plus one
    NMS per batch. Returns the launch counts."""
    val = write_dataset(str(tmp / name), "val", EVAL_IMAGES, seed=2)
    data = DataConfig(val_path=val, num_classes=model.num_classes,
                      img_size=SIZE, batch_size=BATCH, workers=8)
    t0 = time.perf_counter()
    n = sum(len(batch["images"]) for batch in
            create_dataloader(val, data, "val"))
    print(f"  val loader alone (decode, letterbox, f32 batches): "
          f"{n / (time.perf_counter() - t0):.1f} images/s")
    ev = Evaluator(model, create_dataloader(val, data, "val"),
                   compute_dtype=dtype, device=dev)
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
    print(f"  {name} {dtype} eval, {EVAL_IMAGES} images at {SIZE} px, batch "
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


def phase_export(dev, tmp: Path, model: YOLO, sites: dict) -> dict:
    """Phase 12: phase 5's bf16 gelan-c Detector exported to a torch.export
    archive, loaded, and served next to the live Detector on the same
    frames (live, loaded, loaded, live; then so again with the frames
    already on the card, where the host's enqueue sets a request's time):
    the loaded program's launches held to `sites` per request plus one
    NMS, each output equal to the live one. Returns the loaded program's
    launch counts over REQUESTS requests."""
    det = Detector(model, model.state_dict(), device=dev, img_size=SIZE,
                   compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (BATCH, *FRAME_HW, 3), dtype=np.uint8)
              for _ in range(REQUESTS)]
    path = tmp / "gelan-c.pt2"
    t0 = time.perf_counter()
    det.export(str(path), BATCH, height=FRAME_HW[0], width=FRAME_HW[1])
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = Detector.load_exported(str(path))
    t_load = time.perf_counter() - t0
    consts = [s.target for s in run.program.graph_signature.input_specs
              if s.kind.name == "CONSTANT_TENSOR"]
    print(f"  exported ({BATCH}, {FRAME_HW[0]}, {FRAME_HW[1]}, 3) uint8 -> "
          f"padded NMS dict: {path.stat().st_size} bytes in {t_export:.2f} "
          f"s; loaded in {t_load:.2f} s; {len(run.program.graph.nodes)} "
          f"graph nodes, constants made at trace time {consts}")
    for fn in (det, run):                 # warm-up (cuDNN algorithm choice)
        fn(frames[0])
    torch.cuda.synchronize()

    def serve(fn, frames=frames) -> tuple[list, list, float]:
        outs, lat = [], []
        t_all = time.perf_counter()
        for f in frames:
            t0 = time.perf_counter()
            outs.append(fn(f))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return outs, lat, time.perf_counter() - t_all

    passes = {"live": serve(det)}
    reset_counts()
    passes["loaded"] = serve(run)
    counts = counts_now()
    passes["loaded again"] = serve(run)
    passes["live again"] = serve(det)
    on_card = [torch.as_tensor(f).to(dev) for f in frames]
    for name, fn in (("live", det), ("loaded", run), ("loaded", run),
                     ("live", det)):
        key = f"{name}, frames on the card"
        passes[key if key not in passes else key + " again"] = serve(
            fn, on_card)

    print(f"  loaded program: launches {counts} over {REQUESTS} requests")
    want = {k: v * REQUESTS for k, v in {**sites, "nms": 1}.items()}
    if counts != want:
        raise AssertionError(f"exported: launch counts {counts}, expected "
                             f"{want}")
    for name in list(passes)[1:]:
        for i, (a, b) in enumerate(zip(passes["live"][0], passes[name][0])):
            for k in ("boxes", "scores", "classes", "valid"):
                if not torch.equal(a[k], b[k]):
                    raise AssertionError(f"exported: request {i} of the "
                                         f"{name} pass: {k} differs from "
                                         f"the live Detector's")
    print(f"  every request of the loaded passes equal to the live "
          f"Detector's (torch.equal, 4 keys); "
          f"{int(passes['live'][0][-1]['valid'].sum())} detections in the "
          f"last request")
    for name, (_, lat, total) in passes.items():
        print(f"  {name}: {BATCH * REQUESTS / total:.1f} images/s, request "
              f"latency ms {[round(v, 3) for v in lat]} ({REQUESTS} "
              f"requests of {BATCH} frames {FRAME_HW[0]}x{FRAME_HW[1]}, "
              f"bf16; {nvidia_smi()})")
    return counts


def phase_more_configs(dev, tmp: Path) -> dict:
    """Phase 13: gelan-e and gelan-c-d2 at full width and depth (random
    weights from seed 0, class biases 0): (a) phase 5's f32 check, the
    launches held to the sites of GELAN_E_SITES / GELAN_C_D2_SITES; (b)
    serving as phase 5; (c) eval as phase 9 (b), bf16 and f32; (d)
    gelan-e training, bf16 and f32, batch 32 (16 if 32 does not fit), a
    warm-up and GELAN_E_TRAIN_STEPS counted steps of one stem pair and
    five ADown pairs. Returns the launch counts by model and path."""
    counts = {}
    for name, expect in (("gelan-e", GELAN_E_SITES),
                         ("gelan-c-d2", GELAN_C_D2_SITES)):
        print(f"  {name} (a): f32, cuda against the CPU")
        model = random_model(name)
        sites = f32_forward(dev, model, name, expect)
        print(f"  {name} (b): serving")
        c = {"serving": serve_requests(dev, model, sites, name)}
        print(f"  {name}: launches per request "
              f"{ {k: v // REQUESTS for k, v in c['serving'].items()} }")
        print(f"  {name} (c): eval")
        for dtype in ("bfloat16", "float32"):
            c[f"eval {dtype}"] = eval_launches(dev, tmp, model, sites, name,
                                               dtype)
        del model
        if name == "gelan-e":
            for dtype in ("bfloat16", "float32"):
                print(f"  {name} (d): training, {dtype}")
                c[f"train {dtype}"], _ = train_full(
                    dev, tmp, name, GELAN_E_TRAIN_STEPS, (BATCH, BATCH // 2),
                    {"stem": 1, "adown": 5}, dtype=dtype)
                torch.cuda.empty_cache()
        counts[name] = c
        torch.cuda.empty_cache()
    return counts


def phase_clis(dev, tmp: Path) -> dict:
    """Phase 14: the CLIs on the card. The trained tiny fixture written as
    an upstream-schema `.pt` (TINY_YAML in a file named gelan-c.yaml: its
    layers are a subset of gelan-c's, by name, so gelan-c's layer map
    places them); cli.convert_weights to an .npz; cli.detect on
    CLI_IMAGES synthetic images with --device cuda (launches held to the
    fused model's sites and one NMS an image) and --device cpu (none),
    equal detections; cli.train, one epoch on the card from a written set
    (the train launches held to a stem pair and four ADown pairs a step);
    cli.val on the checkpoint it wrote, fused (held to the sites and one
    NMS a batch). Returns the launch counts of the three."""
    cfg = str(tmp / "gelan-c.yaml")
    Path(cfg).write_text(TINY_YAML)
    tiny = YOLO.from_yaml(cfg)
    sd = state_dict_from_jax(tiny.plan, *load_weights(
        str(ROOT / "assets" / "dryrun_tiny.npz")))
    torch.save(upstream.reference_to_upstream_sd(sd, "gelan-c"),
               tmp / "up.pt")
    convert_weights.main(["--weights", str(tmp / "up.pt"), "--config", cfg,
                          "--output", str(tmp / "up.npz")])
    sites = kernel_sites(tiny.fuse(), expect={"stem": 1, "adown": 4,
                                              "csp_chain": 0, "conv3": 1})
    val_dir = write_dataset(str(tmp / "data"), "val", CLI_IMAGES, seed=3)
    found, counts = {}, {}
    for d in ("cuda", "cpu"):
        reset_counts()
        detect.main(["--weights", str(tmp / "up.npz"), "--config", cfg,
                     "--source", val_dir, "--output", str(tmp / d),
                     "--img-size", "160", "--num-classes", "4", "--device",
                     d, "--json", str(tmp / f"{d}.json")])
        found[d] = json.loads((tmp / f"{d}.json").read_text())
        counts[f"detect {d}"] = counts_now()
    print(f"  detect launches: {counts}")
    want = {k: v * CLI_IMAGES for k, v in {**sites, "nms": 1}.items()}
    if counts["detect cuda"] != want or any(counts["detect cpu"].values()):
        raise AssertionError(f"detect launch counts {counts}, expected "
                             f"{want} on cuda and none on the CPU")
    n, box_err, score_err = 0, 0.0, 0.0
    for name, ref in found["cpu"].items():
        got = np.asarray(found["cuda"][name], np.float32).reshape(-1, 6)
        ref = np.asarray(ref, np.float32).reshape(-1, 6)
        if got.shape != ref.shape or not np.array_equal(got[:, 5],
                                                        ref[:, 5]):
            raise AssertionError(f"detect {name}: cuda {got} against cpu "
                                 f"{ref}")
        n += len(ref)
        if len(ref):
            box_err = max(box_err, float(np.abs(got[:, :4] - ref[:, :4])
                                         .max()))
            score_err = max(score_err, float(np.abs(got[:, 4] - ref[:, 4])
                                             .max()))
    print(f"  detect: {n} detections on {CLI_IMAGES} images, cuda against "
          f"cpu: classes equal, boxes {box_err:.3e} px (tol 1e-2), scores "
          f"{score_err:.3e} (tol 1e-4)")
    if n == 0 or found["cpu"].keys() != found["cuda"].keys() or \
            box_err > 1e-2 or score_err > 1e-4:
        raise AssertionError("detect: cuda and cpu detections differ")

    train_dir = write_dataset(str(tmp / "data"), "train", CLI_TRAIN_IMAGES,
                              seed=4)
    reset_train_counts()
    t0 = time.perf_counter()
    train_cli.main(["--data", train_dir, "--val", val_dir, "--num-classes",
                    "4", "--config", cfg, "--epochs", "1", "--batch",
                    str(CLI_BATCH), "--img-size", "160", "--workers", "4",
                    "--augment", "minimal", "--output", str(tmp / "train"),
                    "--device", "cuda"])
    steps = CLI_TRAIN_IMAGES // CLI_BATCH
    counts["train"] = train_counts()
    print(f"  train: {steps} steps and validation in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts['train']}")
    if counts["train"] != {"stem_raw": steps, "stem_wgrad": steps,
                           "adown_raw": 4 * steps, "adown_bwd": 4 * steps}:
        raise AssertionError(f"train launch counts {counts['train']}")

    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        val_cli.main(["--weights", str(tmp / "train" / "last.npz"),
                      "--config", cfg, "--data", val_dir, "--num-classes",
                      "4", "--img-size", "160", "--batch", str(CLI_BATCH),
                      "--workers", "4", "--device", "cuda", "--fuse"])
    counts["val"] = counts_now()
    line = out.getvalue().strip().splitlines()[-1]
    print(f"  val of the trained checkpoint: {line}; launches "
          f"{counts['val']}")
    values = dict(kv.split("=") for kv in line.split())
    batches = -(-CLI_IMAGES // CLI_BATCH)
    if counts["val"] != {k: v * batches for k, v in
                         {**sites, "nms": 1}.items()} or \
            not all(np.isfinite(float(v)) for v in values.values()):
        raise AssertionError(f"val: {line}, launches {counts['val']}")
    return counts


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


_DDP_BATCHES: list = []


def ddp_batches() -> list[dict]:
    """Phase 15 (a)'s synthetic batches (numpy seeds 20...), made once per
    process: a warm-up batch and DDP_STEPS counted ones."""
    if not _DDP_BATCHES:
        _DDP_BATCHES.extend(make_eval_batch(BATCH, SIZE, 20 + i)
                            for i in range(DDP_STEPS + 1))
    return _DDP_BATCHES


def ddp_state(tmp: Path, dtype: str, k: int) -> Path:
    """The saved state before step k of phase 15 (a)'s first plain run
    (k = 0: the seed-0 init, the same for both dtypes)."""
    return tmp / ("ddp_init.npz" if k == 0 else f"ddp_{dtype}_{k}.npz")


def ddp_run(tmp: Path, dtype: str, data_parallel: bool,
            record: bool = False, remat=False) -> dict:
    """gelan-c in `dtype` from the saved state `ddp_state(tmp, dtype, 0)`:
    a warm-up Trainer.train_step, then DDP_STEPS counted ones (the free
    run), the train kernels' launch counters (and `ALLREDUCES`) set to 0
    just before the counted steps and read just after. `record`: save the
    state before each later step (`ddp_state`; the saves are left out of
    the clock). Otherwise each step is taken again from the recorded state
    before it (`load_checkpoint`, so that a chaotic f32 curve is compared
    a step at a time, as in phase 10 (e)). Returns the free run's loss
    items, ms/step (host clock over the counted steps), launches and BN
    all-reduces, and, the steps from the recorded states' items (or,
    recording, the free run's again) and the parameters and BN statistics
    after the last step (f32, host). `remat`: the Trainer's remat mode;
    the BN calls a forward of the whole model and of the recomputed steps
    come back under "bn_calls"."""
    batches = ddp_batches()
    model = YOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    cfg = TrainConfig(epochs=1, compute_dtype=dtype,
                      data_parallel=data_parallel, log_interval=1,
                      output_dir=str(tmp / "ddp_out"), remat=remat)
    trainer = Trainer(model, config=cfg, train_loader=batches[1:],
                      device="cuda")
    if data_parallel != (trainer._group is not None):
        raise AssertionError(f"data_parallel={data_parallel}: the trainer's "
                             f"group is {trainer._group}")
    trainer.load_checkpoint(ddp_state(tmp, dtype, 0))

    def step(b: dict) -> torch.Tensor:
        return trainer.train_step(b["images"], b["targets"])[1]

    def save(k: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._save(ddp_state(tmp, dtype, k), k - 1)
        return time.perf_counter() - t0

    items = [step(batches[0])]
    if record:
        save(1)
    torch.cuda.synchronize()
    reset_train_counts()
    ALLREDUCES.update(dict.fromkeys(ALLREDUCES, 0))
    t0, paused = time.perf_counter(), 0.0
    for k, b in enumerate(batches[1:], 1):
        items.append(step(b))
        if record and k < DDP_STEPS:
            paused += save(k + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0 - paused
    out = {"items": [[float(v) for v in it] for it in items],
           "ms_per_step": dt / DDP_STEPS * 1e3, "counts": train_counts(),
           "allreduces": dict(ALLREDUCES),
           "bn_calls": {"all": bn_calls(model, model.plan.steps),
                        "recomputed": bn_calls(model, [
                            s for s in model.plan.steps
                            if remat and remat_step(s, remat)])}}
    if not record:
        items = []
        for k, b in enumerate(batches):
            trainer.load_checkpoint(ddp_state(tmp, dtype, k))
            items.append(step(b))
    out["one_state_items"] = [[float(v) for v in it] for it in items]
    out["state"] = {k: v.detach().float().cpu() for k, v in
                    {**trainer.params, **trainer.stats}.items()}
    del trainer, model
    torch.cuda.empty_cache()
    return out


# phase 16 (e): calls of the BN moments' all-reduce (ops/conv.py), in the
# forward and in a recompute of the backward (the latter also counted when
# off the calling thread: autograd's device thread, where the caller's
# `global_batch` is not set); counted by `count_allreduces`
ALLREDUCES = {"forward": 0, "recompute": 0, "recompute_off_thread": 0}


def count_allreduces() -> None:
    """Count each call of ops/conv.py's all_reduce_sum in ALLREDUCES."""
    import threading

    inner = conv_ops.all_reduce_sum

    def counted(x, group):
        if conv_ops._RECOMPUTING.get():
            ALLREDUCES["recompute"] += 1
            if threading.current_thread() is not threading.main_thread():
                ALLREDUCES["recompute_off_thread"] += 1
        else:
            ALLREDUCES["forward"] += 1
        return inner(x, group)

    conv_ops.all_reduce_sum = counted


def bn_calls(model: YOLO, steps) -> int:
    """batch_moments calls of a train forward of `steps`: one a BN, one for
    an ADown's two."""
    n = 0
    for step in steps:
        mods = list(model.layers[step.name].modules())
        n += sum(isinstance(m, torch.nn.BatchNorm2d) for m in mods) - \
            sum(isinstance(m, blocks.ADown) for m in mods)
    return n


def rel_items(a: list, b: list) -> float:
    """Largest relative difference of the loss items, step by step."""
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-12)).max())


def excess(a: dict, b: dict) -> float:
    """Largest |a - b| / (atol + rtol |b|) over every element of the
    tensors (DDP_STATE_TOL): at most 1 within the tolerances."""
    rtol, atol = DDP_STATE_TOL
    return max(float(((a[k] - v).abs() / (atol + rtol * v.abs())).max())
               for k, v in b.items())


def ddp_worker(tmp: Path, port: int) -> int:
    """`chip_smoke.py ddp-worker TMP PORT`: phase 15 (a) in a process that
    joined a one-process NCCL group. Per dtype a recording plain run (A),
    a second plain run (B) and the data-parallel run (DDP), one after the
    other in this process; B and DDP each step again from A's state
    before it. DDP's loss items and final state are held against A
    within B's spread (or DDP_FLOOR), every run's launches to a stem pair
    and five ADown pairs a step. Then phase 16 (e): the data-parallel run
    in bf16 with remat "early", held so against bf16's A, its launches
    to (a)'s "early" ones, and its BN all-reduces to one a BN call of the
    forward and one of each recomputed block's (the recompute's moments
    are the group's). Writes the DDP runs' launches per dtype and (e)'s
    results to tmp/ddp.json."""
    rank, world = init_distributed(f"127.0.0.1:{port}", 1, 0,
                                   device="cuda")
    print(f"  ddp-worker: process {rank}/{world}, backend "
          f"{dist.get_backend()}")
    count_allreduces()

    def want(pairs: tuple) -> dict:
        return {k: n * DDP_STEPS for k, n in zip(
            ("stem_raw", "stem_wgrad", "adown_raw", "adown_bwd"), pairs)}

    def rounded(items: list) -> list:
        return [[round(v, 5) for v in it] for it in items]

    try:
        launches, ref = {}, {}
        for dtype in DDP_DTYPES:
            a = ddp_run(tmp, dtype, False, record=True)
            b = ddp_run(tmp, dtype, False)
            d = ddp_run(tmp, dtype, True)
            spread = {"items": rel_items(b["one_state_items"], a["items"]),
                      "state": excess(b["state"], a["state"])}
            gap = {"items": rel_items(d["one_state_items"], a["items"]),
                   "state": excess(d["state"], a["state"])}
            bound = {k: max(spread[k], DDP_FLOOR[k]) for k in spread}
            print(f"  (a) gelan-c {dtype}, batch {BATCH}, {SIZE} px, a "
                  f"warm-up + {DDP_STEPS} steps from one saved state: "
                  f"ms/step plain {b['ms_per_step']:.1f} (recording run, "
                  f"saves left out: {a['ms_per_step']:.1f}), DDP (world "
                  f"size 1, NCCL) {d['ms_per_step']:.1f}; loss items plain "
                  f"{rounded(a['items'])}, DDP from the same states "
                  f"{rounded(d['one_state_items'])}; relative difference "
                  f"of the items and excess of the final parameters and BN "
                  f"statistics, each step from one state: plain-plain "
                  f"{spread}, DDP-plain {gap} (bound {bound}); the free "
                  f"curves' items: plain-plain "
                  f"{rel_items(b['items'], a['items']):.3e}, DDP-plain "
                  f"{rel_items(d['items'], a['items']):.3e}; DDP launches "
                  f"{d['counts']}", flush=True)
            if any(r["counts"] != want(REMAT_PAIRS["off"])
                   for r in (a, b, d)):
                raise AssertionError(
                    f"DDP {dtype}: launch counts {d['counts']} (plain "
                    f"{a['counts']}, {b['counts']}), expected "
                    f"{want(REMAT_PAIRS['off'])}")
            if not all(np.isfinite(d["one_state_items"]).ravel()) or any(
                    gap[k] > bound[k] for k in gap):
                raise AssertionError(f"DDP {dtype}: differs from the plain "
                                     f"Trainer by {gap}, bound {bound}")
            launches[dtype] = d["counts"]
            ref[dtype] = (a, bound)
        remat = ddp_remat(tmp, *ref["bfloat16"], want(REMAT_PAIRS["early"]))
        (tmp / "ddp.json").write_text(json.dumps({"launches": launches,
                                                  "remat": remat}))
    finally:
        dist.destroy_process_group()
    return 0


def ddp_remat(tmp: Path, a: dict, bound: dict, want: dict) -> dict:
    """Phase 16 (e) in the ddp-worker (see there). Returns its counts and
    the line phase 16 prints."""
    e = ddp_run(tmp, "bfloat16", True, remat="early")
    gap = {"items": rel_items(e["one_state_items"], a["items"]),
           "state": excess(e["state"], a["state"])}
    calls = {"forward": e["bn_calls"]["all"] * DDP_STEPS,
             "recompute": e["bn_calls"]["recomputed"] * DDP_STEPS}
    got = {k: e["allreduces"][k] for k in calls}
    line = (f"DDP (world size 1, NCCL) bf16 with remat 'early', "
            f"{DDP_STEPS} steps: {e['ms_per_step']:.1f} ms/step; against "
            f"the plain Trainer each step from one state: {gap} (phase 15's "
            f"bound {bound}); launches {e['counts']}; BN all-reduces "
            f"{e['allreduces']} (expected {calls}: the recomputed blocks' "
            f"moments over the group)")
    print(f"  phase 16 (e): {line}", flush=True)
    if e["counts"] != want:
        raise AssertionError(f"DDP remat: launches {e['counts']}, "
                             f"expected {want}")
    if got != calls or not calls["recompute"]:
        raise AssertionError(f"DDP remat: BN all-reduces {got}, "
                             f"expected {calls}")
    if not all(np.isfinite(e["one_state_items"]).ravel()) or any(
            gap[k] > bound[k] for k in gap):
        raise AssertionError(f"DDP remat: differs from the plain Trainer "
                             f"by {gap}, bound {bound}")
    return {"counts": e["counts"], "line": line}


def phase_ddp(tmp: Path) -> dict:
    """Phase 15 (a): the seed-0 gelan-c state saved here, then
    `ddp_worker` in a subprocess. Returns {"launches": the DDP runs'
    launches per dtype, "remat": phase 16 (e)'s counts and line}."""
    model = YOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    cfg = TrainConfig(epochs=1, data_parallel=False,
                      output_dir=str(tmp / "ddp_out"))
    Trainer(model, config=cfg, train_loader=[None], device="cuda")._save(
        ddp_state(tmp, "", 0), -1)
    del model
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "ddp-worker",
         str(tmp), str(free_port())], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    print(proc.stdout.rstrip())
    if proc.returncode:
        raise AssertionError(f"ddp-worker exited {proc.returncode}: "
                             f"{proc.stderr[-4000:]}")
    return json.loads((tmp / "ddp.json").read_text())


def detections_match(a: np.ndarray, b: np.ndarray) -> bool:
    """Two images' (n, 6) detections [xyxy, score, class] are the same
    set: each one of a has a twin in b and each one of b in a (the class
    equal, the box within 1e-2 px, the score within 1e-4)."""
    if len(a) != len(b):
        return False
    twin = ((np.abs(a[:, None, :4] - b[None, :, :4]).max(-1) <= 1e-2)
            & (np.abs(a[:, None, 4] - b[None, :, 4]) <= 1e-4)
            & (a[:, None, 5] == b[None, :, 5]))
    return bool(twin.any(1).all() and twin.any(0).all())


def phase_mesh_serving(dev, model: YOLO, sites: dict) -> dict:
    """Phase 15 (b). Returns the mesh Detector's bf16 launch counts over
    REQUESTS requests."""
    mesh = Mesh((torch.device("cuda", 0), torch.device("cuda", 0)))
    sd = model.state_dict()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (BATCH, *FRAME_HW, 3), dtype=np.uint8)
              for _ in range(REQUESTS)]
    kw = {"img_size": SIZE, "compute_dtype": "float32"}
    single = Detector(model, sd, device=dev, **kw)
    meshed = Detector(model, sd, mesh=mesh, **kw)
    for program in meshed.programs:
        where = {str(t.device) for t in (*program.model.parameters(),
                                         *program.model.buffers())}
        if where != {"cuda:0"}:
            raise AssertionError(f"a replica's tensors on {where}")
    for n in MESH_BATCHES:
        a = {k: v.cpu() for k, v in single(frames[0][:n]).items()}
        b = {k: v.cpu() for k, v in meshed(frames[0][:n]).items()}
        same_order = torch.equal(a["valid"], b["valid"]) and \
            torch.equal(a["classes"], b["classes"])
        box_err = float((a["boxes"] - b["boxes"]).abs().max())
        score_err = float((a["scores"] - b["scores"]).abs().max())
        # detections whose scores sit within f32 noise of each other may
        # come out in another order: then every detection of each image
        # must have its twin (class, box within 1e-2 px, score within 1e-4)
        matched = same_order and box_err <= 1e-2 and score_err <= 1e-4
        if not matched:
            matched = all(detections_match(x, y) for x, y in zip(
                Detector.to_list(single, a), Detector.to_list(single, b)))
        print(f"  (b) f32, {n} frames: mesh against single, valid/classes "
              f"equal {same_order}, boxes {box_err:.3e} px (tol 1e-2), "
              f"scores {score_err:.3e} (tol 1e-4), each detection matched "
              f"{matched}; {int(a['valid'].sum())} detections")
        if not (a["boxes"].shape == b["boxes"].shape == (n, 300, 4)
                and matched and int(a["valid"].sum()) > 0):
            raise AssertionError(f"mesh Detector, {n} frames: differs from "
                                 f"the single Detector")
    del single, meshed
    torch.cuda.empty_cache()

    kw["compute_dtype"] = "bfloat16"
    rates, counts = {}, {}
    for name, det in (("single", Detector(model, sd, device=dev, **kw)),
                      ("mesh", Detector(model, sd, mesh=mesh, **kw))):
        det(frames[0])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for f in frames:
            out = det(f)
        torch.cuda.synchronize()
        rates[name] = BATCH * REQUESTS / (time.perf_counter() - t0)
        counts[name] = counts_now()
        if int(out["valid"].sum()) == 0:
            raise AssertionError(f"{name} bf16 Detector: no detections")
    want = {k: v * REQUESTS * mesh.size
            for k, v in {**sites, "nms": 1}.items()}
    print(f"  (b) bf16, {REQUESTS} requests of {BATCH} frames "
          f"{FRAME_HW[0]}x{FRAME_HW[1]}: single {rates['single']:.1f} "
          f"images/s, mesh (two replicas on one card) {rates['mesh']:.1f}; "
          f"mesh launches {counts['mesh']}")
    if counts["mesh"] != want:
        raise AssertionError(f"mesh launch counts {counts['mesh']}, "
                             f"expected {want}")
    return counts["mesh"]


def phase_mesh_eval(dev, tmp: Path) -> None:
    """Phase 15 (c)."""
    path = tmp / "tiny.yaml"
    path.write_text(TINY_YAML)
    val = write_dataset(str(tmp / "tiny"), "val", 16, seed=1)
    data = DataConfig(val_path=val, num_classes=4, img_size=160,
                      batch_size=MESH_EVAL_BATCH, workers=4)
    weights = load_weights(str(ROOT / "assets" / "dryrun_tiny.npz"))
    mesh = Mesh((torch.device("cuda", 0), torch.device("cuda", 0)))
    single, meshed = (Evaluator(YOLO.from_yaml(path),
                                create_dataloader(val, data, "val"), **kw)
                      .evaluate(weights)
                      for kw in ({"device": dev}, {"mesh": mesh}))
    gap = {k: abs(single[k] - meshed[k]) for k in ("map50", "map")}
    print(f"  (c) tiny fixture, 160 px f32, 16 images in batches of "
          f"{MESH_EVAL_BATCH}: single mAP50 {single['map50']:.4f} mAP "
          f"{single['map']:.4f}; mesh mAP50 {meshed['map50']:.4f} mAP "
          f"{meshed['map']:.4f}; gap {gap} (tol 1e-3)")
    if max(gap.values()) > 1e-3 or meshed["map50"] <= 0.5:
        raise AssertionError("mesh eval: differs from the single Evaluator")


# -- phase 16: train tooling and lazy-decode NMS ------------------------------

def snapshot(trainer: Trainer) -> dict:
    """The Trainer's state as copies on its device: parameters, BN
    statistics, the default SGD's buffers, the EMA and the step."""
    return {"params": {k: v.detach().clone()
                       for k, v in trainer.params.items()},
            "stats": {k: v.clone() for k, v in trainer.stats.items()},
            "opt": {k: v.clone() for k, v in trainer.opt_bufs.items()},
            "ema_params": {k: v.clone()
                           for k, v in trainer.ema["params"].items()},
            "ema_stats": {k: v.clone()
                          for k, v in trainer.ema["stats"].items()},
            "updates": trainer.ema["updates"], "step": trainer.global_step}


@torch.no_grad()
def restore(trainer: Trainer, snap: dict) -> None:
    """`snapshot`'s state back into a Trainer of the same model."""
    for key, dst in (("params", trainer.params), ("stats", trainer.stats),
                     ("opt", trainer.opt_bufs),
                     ("ema_params", trainer.ema["params"]),
                     ("ema_stats", trainer.ema["stats"])):
        for k, v in dst.items():
            v.copy_(snap[key][k])
    trainer.ema["updates"], trainer.global_step = snap["updates"], snap["step"]


def gelan_c_trainer(dev, tmp: Path, batches: list, dtype: str = "bfloat16",
                    optimizer=None, **config) -> Trainer:
    """gelan-c at full width from the seed-0 init (every Trainer of phase
    16 starts from the same state); `config`: more TrainConfig fields."""
    cfg = TrainConfig(epochs=1, compute_dtype=dtype, data_parallel=False,
                      output_dir=str(tmp / "tooling"), log_interval=1,
                      **config)
    return Trainer(YOLO.from_yaml(ROOT / "configs" / "models" /
                                  "gelan-c.yaml"), config=cfg,
                   train_loader=batches[1:], device=dev,
                   optimizer=optimizer)


def items_of(trainer: Trainer, b: dict) -> list[float]:
    return [float(v) for v in trainer.train_step(b["images"],
                                                 b["targets"])[1]]


def remat_run(trainer: Trainer, batches: list, snap: dict, steps: int
              ) -> dict:
    """A warm-up step, then `steps` counted steps, every one from `snap`
    (the launch counters set to 0 just before the counted steps and read
    just after; the peak memory over the counted steps). Returns the
    items, ms/step (host clock around each step), the peak GiB, the
    launches a step and the BN running statistics after the first
    counted step."""
    restore(trainer, snap)
    items_of(trainer, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    items, seconds, stats = [], 0.0, None
    for b in batches[1:steps + 1]:
        restore(trainer, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items.append(items_of(trainer, b))
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        if stats is None:
            stats = {k: v.clone() for k, v in trainer.stats.items()}
    total = train_counts()
    if any(v % steps for v in total.values()):
        raise AssertionError(f"remat launches {total} over {steps} steps")
    return {"items": items, "ms": seconds / steps * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "counts": {k: v // steps for k, v in total.items()},
            "stats": stats}


def stats_gap(a: dict, b: dict) -> float:
    """Largest |a - b| over the BN statistics, relative to the tensor's
    largest |b| (at least 1)."""
    return max(float((a[k] - v).abs().max()) / max(float(v.abs().max()), 1.0)
               for k, v in b.items())


def check_remat(name: str, run: dict, ref: dict, bound: dict,
                pairs: tuple) -> dict:
    """One remat run against remat off's: its launches a step (stem raw,
    stem weight gradient, ADown raw, ADown backward) `pairs`, its loss
    items and statistics within `bound`. Returns the gaps."""
    want = dict(zip(("stem_raw", "stem_wgrad", "adown_raw", "adown_bwd"),
                    pairs))
    gap = {"items": rel_items(run["items"], ref["items"]),
           "stats": stats_gap(run["stats"], ref["stats"])}
    print(f"  (a) {name}: {run['ms']:.1f} ms/step, peak "
          f"{run['peak_gib']:.2f} GiB, launches a step {run['counts']}; "
          f"against remat off: items {gap['items']:.3e}, BN statistics "
          f"{gap['stats']:.3e} (bound {bound})", flush=True)
    if run["counts"] != want:
        raise AssertionError(f"remat {name}: launches {run['counts']}, "
                             f"expected {want}")
    if not np.isfinite(run["items"]).all() or any(
            gap[k] > bound[k] for k in gap):
        raise AssertionError(f"remat {name}: differs from remat off by {gap}")
    return gap


def phase_remat(dev, tmp: Path) -> tuple[dict, Trainer, dict, dict]:
    """Phase 16 (a). Returns the launches a step per mode, the "early"
    Trainer (for (c)), the seed-0 snapshot and the parity bound."""
    batches = [make_eval_batch(BATCH, SIZE, 50 + i)
               for i in range(REMAT_STEPS + 1)]
    runs, snap, keep = {}, None, None
    for name, mode in (("off", False), ("off, again", False),
                       *((k, v) for k, v in REMAT_MODES.items() if v)):
        trainer = gelan_c_trainer(dev, tmp, batches, remat=mode)
        snap = snap or snapshot(trainer)
        runs[name] = remat_run(trainer, batches, snap, REMAT_STEPS)
        if mode == "early":
            keep = trainer
        else:
            del trainer
        torch.cuda.empty_cache()
    off = runs["off"]
    spread = {"items": rel_items(runs["off, again"]["items"], off["items"]),
              "stats": stats_gap(runs["off, again"]["stats"], off["stats"])}
    bound = {k: max(v, REMAT_FLOOR) for k, v in spread.items()}
    print(f"  (a) gelan-c bf16, batch {BATCH}, {SIZE} px, a warm-up and "
          f"{REMAT_STEPS} counted steps, each from the seed-0 state; loss "
          f"items of remat off {[[round(v, 5) for v in it] for it in off['items']]}; "
          f"two remat-off runs apart by {spread}")
    counts = {}
    for name in ("off", "off, again", *[k for k in REMAT_MODES if k != "off"]):
        key = "off" if name.startswith("off") else name
        check_remat(name, runs[name], off, bound, REMAT_PAIRS[key])
        counts[key] = runs[name]["counts"]

    big = [make_eval_batch(REMAT_BIG_BATCH, SIZE, 60 + i) for i in range(2)]
    trainer = gelan_c_trainer(dev, tmp, big, remat="early")
    run = remat_run(trainer, big, snap, 1)
    print(f"  (a) batch {REMAT_BIG_BATCH}, remat 'early': {run['ms']:.1f} "
          f"ms/step, peak {run['peak_gib']:.2f} GiB, launches "
          f"{run['counts']}, items {[round(v, 5) for v in run['items'][0]]}")
    if run["counts"] != counts["early"] or not np.isfinite(
            run["items"]).all():
        raise AssertionError(f"remat batch {REMAT_BIG_BATCH}: {run}")
    del trainer
    torch.cuda.empty_cache()
    f32 = {}
    for name, mode in (("off", False), ("early", "early")):
        trainer = gelan_c_trainer(dev, tmp, batches, "float32", remat=mode)
        f32[name] = remat_run(trainer, batches, snap, 1)
        del trainer
        torch.cuda.empty_cache()
    check_remat("f32 early", f32["early"], f32["off"], bound,
                REMAT_PAIRS["early"])
    print(f"  (a) f32 remat off: {f32['off']['ms']:.1f} ms/step, peak "
          f"{f32['off']['peak_gib']:.2f} GiB")
    return counts, keep, snap, bound


def phase_injected(dev, tmp: Path) -> None:
    """Phase 16 (b): two steps with a torch.optim.Adam factory (finite
    losses), two with a hand-written SGD (init_fn, step_fn) pair (stem1's
    weight moved by exactly -lr * the gradient handed to step_fn)."""
    batches = [make_eval_batch(BATCH, SIZE, 70 + i) for i in range(3)]
    trainer = gelan_c_trainer(
        dev, tmp, batches,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=OPT_LR))
    items = [items_of(trainer, b) for b in batches[1:]]
    steps = {float(st["step"]) for st in trainer._torch_opt.state.values()}
    print(f"  (b) torch.optim.Adam factory, 2 steps: items "
          f"{[[round(v, 5) for v in it] for it in items]}, Adam's step "
          f"{steps}")
    if not np.isfinite(items).all() or steps != {2.0}:
        raise AssertionError("injected Adam: non-finite loss or no step")
    del trainer
    torch.cuda.empty_cache()
    key, seen = "layers.stem1.conv.weight", []

    def step_fn(params, grads, state, step):
        seen.append((params[key].detach().clone(), grads[key].clone()))
        return {k: p - OPT_LR * grads[k] for k, p in params.items()}, state

    trainer = gelan_c_trainer(dev, tmp, batches,
                              optimizer=(lambda params: {}, step_fn))
    moved = []
    for b in batches[1:]:
        items_of(trainer, b)
        p0, g = seen[-1]
        moved.append(torch.equal(trainer.params[key].detach(),
                                 p0 - OPT_LR * g))
    print(f"  (b) SGD (init_fn, step_fn) pair, 2 steps: stem1's weight "
          f"moved by exactly -lr * grad: {moved}")
    if not all(moved):
        raise AssertionError("injected pair: stem1 did not move by -lr*grad")
    del trainer
    torch.cuda.empty_cache()


def trainer_tensors(trainer: Trainer) -> dict:
    return {**{f"p/{k}": v.detach() for k, v in trainer.params.items()},
            **{f"s/{k}": v for k, v in trainer.stats.items()},
            **{f"o/{k}": v for k, v in trainer.opt_bufs.items()},
            **{f"e/{k}": v for k, v in trainer.ema["params"].items()},
            **{f"es/{k}": v for k, v in trainer.ema["stats"].items()}}


def phase_checkpoint_dir(dev, tmp: Path, trainer: Trainer, bound: dict
                         ) -> None:
    """Phase 16 (c): (a)'s "early" Trainer saved as a checkpoint directory
    (seconds, bytes) and as an .npz, the directory loaded by a fresh
    Trainer (every tensor equal), the next step's items of both within
    (a)'s bound, and Detectors from the directory and from the .npz
    serving phase 5's first request alike (at conf 0: the prior's class
    biases keep every score of these few steps' EMA weights below 1e-4)."""
    trainer.config.checkpoint_format = "orbax"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._save(tmp / "ckpt.npz", 0)
    seconds = time.perf_counter() - t0
    path = tmp / "ckpt"
    size = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    trainer.config.checkpoint_format = "npz"
    trainer._save(tmp / "ckpt.npz", 0)
    batches = [make_eval_batch(BATCH, SIZE, 80 + i) for i in range(2)]
    fresh = gelan_c_trainer(dev, tmp, batches, remat="early")
    t0 = time.perf_counter()
    fresh.load_checkpoint(path)
    load_s = time.perf_counter() - t0
    a, b = trainer_tensors(trainer), trainer_tensors(fresh)
    equal = a.keys() == b.keys() and all(torch.equal(v, b[k])
                                         for k, v in a.items())
    equal = equal and (trainer.global_step, trainer.ema["updates"]) == \
        (fresh.global_step, fresh.ema["updates"])
    items = [items_of(t, batches[1]) for t in (trainer, fresh)]
    gap = rel_items([items[1]], [items[0]])
    print(f"  (c) checkpoint directory {path.name}/: {len(list(path.iterdir()))} "
          f"files, {size} bytes, saved in {seconds:.2f} s, loaded on the "
          f"card in {load_s:.2f} s; {len(a)} tensors equal: {equal}; the "
          f"next step's items apart by {gap:.3e} (bound {bound['items']})")
    if not equal or gap > bound["items"]:
        raise AssertionError("checkpoint directory: resume differs")
    del fresh
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (BATCH, *FRAME_HW, 3), dtype=np.uint8)
    model = YOLO.from_yaml(ROOT / "configs" / "models" / "gelan-c.yaml")
    outs = [Detector.from_checkpoint(model, str(p), device=dev,
                                     img_size=SIZE, conf_thres=0.0)(frames)
            for p in (path, tmp / "ckpt.npz")]
    same = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    print(f"  (c) Detector.from_checkpoint: directory against .npz, phase "
          f"5's request: equal {same}, {int(outs[0]['valid'].sum())} "
          f"detections")
    if not same:
        raise AssertionError("checkpoint directory: Detector differs")
    torch.cuda.empty_cache()


def phase_lazy_nms(dev, sites: dict) -> dict:
    """Phase 16 (d): phase 5's bf16 gelan-c Detector model on phase 5's
    first request, letterboxed: predict_split + non_max_suppression_raw
    against the decoded forward + non_max_suppression at conf 0.25 (K =
    512) and 1e-3 (every anchor), the launches of the lazy path held to
    the model's kernel sites and one NMS; the device ms of both
    post-processing paths from the same streams
    (utils.profiling.device_timer). Phase 5's weights take unit-scale BN
    statistics (`unit_scale_stats`): with the init's (0, 1) every class
    logit of the random model is ~1e-7, every score 0.5, and the two
    paths part by design on such ties (the dense argmax of the sigmoids
    takes the first class, the lazy one the largest logit); the few
    anchors where the two still disagree are left out of both (printed).
    Returns the launches per setting."""
    model = unit_scale_stats(random_model("gelan-c"))
    det = Detector(model, model.state_dict(), device=dev, img_size=SIZE,
                   compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.integers(0, 256, (BATCH, *FRAME_HW, 3), dtype=np.uint8)).to(dev)
    x = device_pipeline.batched_letterbox(frames, SIZE, dtype=torch.bfloat16) \
        .permute(0, 3, 1, 2)
    fused = det.model
    shapes = [(SIZE // int(s), SIZE // int(s)) for s in fused.strides]
    pts, col = (torch.from_numpy(v).to(dev)
                for v in make_anchors_np(shapes, fused.strides))

    def decode(box, cls):
        dbox = dist2bbox(dfl_decode(box, 16), pts[None], xywh=True) * \
            col[None]
        return torch.cat([dbox, torch.sigmoid(cls.float())], -1)

    def dense_post(box, cls, conf):
        return non_max_suppression(decode(box, cls), conf_thres=conf)

    def lazy_post(box, cls, conf):
        return non_max_suppression_raw(box, cls, pts, col, conf_thres=conf)

    counts = {}
    for conf in LAZY_NMS_CONFS:
        with torch.no_grad():
            reset_counts()
            box, cls = fused.predict_split(x)
            lazy = lazy_post(box, cls, conf)
            torch.cuda.synchronize()
            counts[f"conf {conf}"] = counts_now()
            decoded, _ = fused(x, main_only=True)
            dense = non_max_suppression(decoded, conf_thres=conf)
            stream_err = float((decode(box, cls) - decoded).abs().max())
            # an anchor whose largest logit and largest rounded sigmoid
            # disagree (the class, or the score by an ulp) is ranked by
            # each path's own definition, and NMS then parts in a cascade:
            # the comparison leaves such anchors out of both paths
            scores = torch.sigmoid(cls)
            ties = (scores.argmax(-1) != cls.argmax(-1)) | \
                (scores.amax(-1) != torch.sigmoid(cls.amax(-1)))
            if ties.any():
                held = cls.masked_fill(ties[..., None], -1e4)
                lazy, dense = (lazy_post(box, held, conf),
                               dense_post(box, held, conf))
            dense_ms = device_timer(dense_post, box, cls, conf,
                                    iters=20) * 1e3
            lazy_ms = device_timer(lazy_post, box, cls, conf,
                                   iters=20) * 1e3
        box_err = float((lazy["boxes"] - dense["boxes"]).abs().max())
        tol = NMS_RAW_ATOL + NMS_RAW_RTOL * float(dense["boxes"].abs().max())
        score_err = float((lazy["scores"] - dense["scores"]).abs().max())
        same = torch.equal(lazy["valid"], dense["valid"]) and \
            torch.equal(lazy["classes"], dense["classes"])
        n = int(lazy["valid"].sum())
        k = 512 if conf >= 0.1 else box.shape[1]
        print(f"  (d) conf {conf} (K = {k}): the streams decoded against "
              f"the decoded forward {stream_err:.3e}; {int(ties.sum())} of "
              f"{ties.numel()} anchors whose largest logit and largest "
              f"sigmoid disagree, left out of both paths; {n} detections, "
              f"valid and classes equal {same}, boxes {box_err:.3e} px (tol "
              f"{tol:.3e}), scores {score_err:.3e} (tol {NMS_RAW_ATOL}); "
              f"post-processing of the {tuple(box.shape)} and "
              f"{tuple(cls.shape)} streams, device ms: decode + "
              f"non_max_suppression {dense_ms:.4f}, non_max_suppression_raw "
              f"{lazy_ms:.4f}; launches {counts[f'conf {conf}']}", flush=True)
        if not (same and box_err <= tol and score_err <= NMS_RAW_ATOL
                and stream_err <= tol and n > 0):
            raise AssertionError(f"lazy-decode NMS at conf {conf} differs "
                                 f"from the dense path")
        if counts[f"conf {conf}"] != {**sites, "nms": 1}:
            raise AssertionError(f"lazy NMS launches {counts}")
    del det, model
    torch.cuda.empty_cache()
    return counts


@torch.no_grad()
def unit_scale_stats(model: YOLO) -> YOLO:
    """BN running statistics at the scale the init's convs give
    (tests/test_torch_dual.py: a U(-1/sqrt(fan_in), +) conv divides its
    input's variance by 3, so var ~ U(0.25, 0.4), mean ~ U(-0.1, 0.1)
    keeps the activations at unit scale through the depth), from seed 0.
    Returns the model."""
    g = torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.rand(m.running_mean.shape,
                                            generator=g) * 0.2 - 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=g) * 0.15 + 0.25)
    return model


def phase_tooling(dev, tmp: Path, sites: dict, ddp_remat: dict
                  ) -> tuple[dict, dict]:
    """Phase 16 (module docstring). Returns the launches a step per remat
    mode and the lazy-decode NMS launches per setting."""
    t0 = time.perf_counter()
    remat, trainer, _, bound = phase_remat(dev, tmp)
    phase_injected(dev, tmp)
    phase_checkpoint_dir(dev, tmp, trainer, bound)
    del trainer
    torch.cuda.empty_cache()
    lazy = phase_lazy_nms(dev, sites)
    print(f"  (e) from phase 15's one-process NCCL group: {ddp_remat['line']}")
    remat["data parallel early"] = {
        k: v // DDP_STEPS for k, v in ddp_remat["counts"].items()}
    print(f"  phase 16: {time.perf_counter() - t0:.1f} s")
    return remat, lazy


# -- phase 17: the native host runtime, export across devices, dry run ------

def phase_native(dev, tmp: Path) -> None:
    """Phase 17 (a): the host library built on this machine, the train
    loader's images/s with cv2 and with the native kernels on phase 11's
    on-disk set, and phase 9 (a)'s tiny-fixture eval from disk under
    YOLO_TPU_NATIVE 0 and 1."""
    t0 = time.perf_counter()
    lib = native.build()
    print(f"  (a) native host library {lib.relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.2f} s")
    train_dir = write_dataset(str(tmp / "aug"), "train",
                              AUG_TRAIN_BATCHES * BATCH, seed=0)
    rates = bench_loader.loader_rates(train_dir, img_size=SIZE, batch=BATCH,
                                      workers=8, epochs=LOADER_EPOCHS)
    print(f"  (a) train loader, {AUG_TRAIN_BATCHES * BATCH} images, {SIZE} "
          f"px, batch {BATCH}, 8 workers, 'full' host augmentation, "
          f"{LOADER_EPOCHS} epochs after a warm-up: cv2 "
          f"{rates['cv2']:.1f} images/s, native {rates['native']:.1f} "
          f"images/s ({rates['native'] / rates['cv2']:.3f}x)")
    path = tmp / "tiny.yaml"
    path.write_text(TINY_YAML)
    val = write_dataset(str(tmp / "tiny"), "val", 16, seed=1)
    data = DataConfig(val_path=val, num_classes=4, img_size=160,
                      batch_size=8, workers=4)
    weights = load_weights(str(ROOT / "assets" / "dryrun_tiny.npz"))
    before = os.environ.get("YOLO_TPU_NATIVE")
    res = {}
    try:
        for mode in ("0", "1"):
            os.environ["YOLO_TPU_NATIVE"] = mode
            res[mode] = Evaluator(
                YOLO.from_yaml(path), create_dataloader(val, data, "val"),
                device=dev).evaluate(weights)
    finally:
        if before is None:
            os.environ.pop("YOLO_TPU_NATIVE", None)
        else:
            os.environ["YOLO_TPU_NATIVE"] = before
    print("  (a) tiny fixture eval from disk, 160 px f32, 16 images, one "
          "pass each (images/s of a 16-image pass is set-up dominated: "
          "the loader's rates are the line above): " + "; ".join(
              f"YOLO_TPU_NATIVE={m}: {r['images_per_sec']:.1f} images/s, "
              f"mAP50 {r['map50']:.4f} mAP {r['map']:.4f}"
              for m, r in res.items()))
    if min(r["map50"] for r in res.values()) <= 0.5:
        raise AssertionError("tiny fixture eval under the native switch: "
                             "mAP50 <= 0.5")


def program_devices(run) -> set[str]:
    """The devices a loaded archive's weights and tensor constants are on."""
    prog = run.program
    return {str(v.device) for v in (*prog.state_dict.values(),
                                    *prog.constants.values())
            if isinstance(v, torch.Tensor)}


def phase_export_devices(dev, tmp: Path, sites: dict) -> None:
    """Phase 17 (b), (c): a gelan-c bf16 Detector (random weights, phase
    5's) on the card exported for the CPU, and one on the CPU exported for
    the card, each loaded and held against the live Detector on its
    device."""
    model = random_model("gelan-c")
    kw = {"img_size": SIZE, "compute_dtype": "bfloat16"}
    card = Detector(model, model.state_dict(), device=dev, **kw)
    host = Detector(model, model.state_dict(), device="cpu", **kw)
    frames = np.random.default_rng(0).integers(
        0, 256, (XDEV_BATCH, SIZE, SIZE, 3), dtype=np.uint8)

    to_cpu = str(tmp / "to_cpu.pt2")
    t0 = time.perf_counter()
    card.export(to_cpu, XDEV_BATCH, device="cpu")
    t_export = time.perf_counter() - t0
    run = Detector.load_exported(to_cpu)
    reset_counts()
    got, want = run(frames), host(frames)
    launched = counts_now()
    same = [detections_match(a, b)
            for a, b in zip(nms_to_list(got), nms_to_list(want))]
    print(f"  (b) exported on the card for the CPU in {t_export:.1f} s: "
          f"archive on {sorted(program_devices(run))}, loaded device "
          f"{run.device}; detections per image "
          f"{got['valid'].sum(1).tolist()} match the live CPU Detector's "
          f"{same}; launches {launched}")
    if run.device.type != "cpu" or program_devices(run) != {"cpu"} or \
            not all(same) or int(got["valid"].sum()) == 0 or \
            any(launched.values()):
        raise AssertionError("export card -> CPU: the archive differs")

    to_card = str(tmp / "to_card.pt2")
    t0 = time.perf_counter()
    host.export(to_card, XDEV_BATCH, device="cuda")
    t_export = time.perf_counter() - t0
    live = card(frames)
    for name, run in (("exported on the CPU for the card",
                       Detector.load_exported(to_card)),
                      ("(b)'s CPU archive moved to the card at load",
                       Detector.load_exported(to_cpu, device=dev))):
        run(frames)                                    # warm-up
        torch.cuda.synchronize()
        reset_counts()
        got = run(frames)
        torch.cuda.synchronize()
        launched = counts_now()
        equal = {k: torch.equal(got[k], live[k]) for k in live}
        print(f"  (c) {name}"
              f"{f' in {t_export:.1f} s' if 'CPU for' in name else ''}: "
              f"archive on {sorted(program_devices(run))}, launches "
              f"{launched} a request of {XDEV_BATCH}; torch.equal to the "
              f"live card Detector {equal}")
        if launched != {**sites, "nms": 1} or not all(equal.values()) or \
                run.device.type != "cuda":
            raise AssertionError(f"export to the card ({name}): launches "
                                 f"{launched} or outputs differ")


def phase_last_modules(dev, tmp: Path, sites: dict) -> None:
    """Phase 17 (module docstring)."""
    t0 = time.perf_counter()
    phase_native(dev, tmp)
    phase_export_devices(dev, tmp, sites)
    torch.cuda.empty_cache()
    out = dryrun_torch.dryrun_multichip(1, device="cuda", timeout=600)
    print(f"  (d) dryrun_torch.dryrun_multichip(1, device='cuda'), gelan-c "
          f"over NCCL: {out['seconds']:.1f} s (stages, s: "
          f"{ {k: round(v, 1) for k, v in out['phase_seconds'].items()} }); "
          f"kernel launches in the process {out['launches']}")
    if not all(out["launches"].values()):
        raise AssertionError(f"the dry run on the card skipped a kernel: "
                             f"{out['launches']}")
    print(f"  phase 17: {time.perf_counter() - t0:.1f} s")


# -- phase 18: per-layer and per-stage profiles ------------------------------

def phase_layer_profiles(dev) -> dict:
    """Phase 18 (a): profile_layers on gelan-c (full width and depth, random
    weights from seed 0), fused, bf16 then f32, BATCH x SIZE: the rows are
    the main steps in order, the kernel counters one forward's sites per
    forward run, the rows sum to the TOTAL kernel time. Returns the
    launches a forward per dtype."""
    launches = {}
    for dtype in ("bfloat16", "float32"):
        model = profile_layers.build_model("gelan-c", DTYPES[dtype], dev)
        sites = kernel_sites(model)
        x = profile_layers.random_batch(BATCH, SIZE, DTYPES[dtype], dev)
        reset_counts()
        res = profile_layers.profile_forward(model, x, PROFILE_ITERS)
        counts = counts_now()
        print(f"  (a) gelan-c fused {dtype}, batch {BATCH}, {SIZE} px, "
              f"main-only forward, {PROFILE_ITERS} traced forwards:")
        profile_layers.print_table(res, BATCH)
        rows = res["rows"]
        names = [s.name for s in model.main_steps]
        top = sorted(rows[:len(names)], key=lambda r: -r[2])[:10]
        print("  the ten largest layers: " + ", ".join(
            f"{n} {ms:.4f} ms" for n, _, ms in top) + f"; idle share "
            f"{res['idle_share']:.4f} (kernel {res['kernel_ms']:.4f} ms, "
            f"wall {res['wall_ms']:.4f} ms, without hooks "
            f"{res['hookless_kernel_ms']:.4f} ms)")
        want = {**{k: v * res["forwards"] for k, v in sites.items()},
                "nms": 0}
        # the layers and the rest of the forward: every kernel launched by
        # an op of the forward (the UNLINKED row, if any, is not)
        total = sum(r[2] for r in rows if r[0] != profile_layers.UNLINKED)
        print(f"  launches {counts} over {res['forwards']} forwards; rows "
              f"sum {total:.4f} ms against the TOTAL {res['kernel_ms']:.4f}")
        if [r[0] for r in rows[:len(names)]] != names:
            raise AssertionError(f"profile_layers {dtype}: rows "
                                 f"{[r[0] for r in rows]}")
        if counts != want:
            raise AssertionError(f"profile_layers {dtype}: launches "
                                 f"{counts}, expected {want}")
        if not (res["kernel_ms"] > 0 and abs(total - res["kernel_ms"])
                <= PROFILE_SUM_RTOL * res["kernel_ms"]):
            raise AssertionError(f"profile_layers {dtype}: rows sum "
                                 f"{total} against {res['kernel_ms']}")
        launches[f"layers {dtype}"] = {k: v // res["forwards"]
                                       for k, v in counts.items()}
        del model, x
        torch.cuda.empty_cache()
    return launches


def phase_train_profiles(dev, tmp: Path, phase8: dict) -> dict:
    """Phase 18 (b): profile_train's six stages on gelan-c at BATCH x
    SIZE, bf16 and f32, printed beside phase 8's ms/step; every stage
    time finite and above 0; one `full` stage (Trainer._step) launching
    the train sites: a stem pair and five ADown pairs. Returns the
    launches of the `full` stage per dtype."""
    launches = {}
    want = {"stem_raw": 1, "stem_wgrad": 1, "adown_raw": 5, "adown_bwd": 5}
    for dtype in ("bfloat16", "float32"):
        trainer = profile_train.make_trainer(
            "gelan-c", dtype, False, dev, str(tmp / f"profile_{dtype}"))
        stages = profile_train.Stages(
            trainer, *profile_train.device_batch(BATCH, SIZE, 8, dev))
        print(f"  (b) gelan-c train step {dtype}, batch {BATCH}, {SIZE} px, "
              f"ms over {PROFILE_TRAIN_ITERS} calls a stage:")
        times = profile_train.stage_times(stages, PROFILE_TRAIN_ITERS)
        profile_train.print_deltas(times, BATCH)
        reset_train_counts()
        stages.full()
        torch.cuda.synchronize()
        counts = train_counts()
        print(f"  full: {times['full']:.2f} ms/step (CUDA events) beside "
              f"phase 8's bf16 {phase8['ms_per_step']:.1f} ms/step (host "
              f"clock); one full stage launches {counts}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if counts != want:
            raise AssertionError(f"profile_train {dtype}: launches {counts}, "
                                 f"expected {want}")
        if not all(np.isfinite(v) and v > 0 for v in times.values()):
            raise AssertionError(f"profile_train {dtype}: stages {times}")
        launches[f"train {dtype}"] = counts
        del trainer, stages
        torch.cuda.empty_cache()
    return launches


def phase_per_layer_train(dev, tmp: Path) -> None:
    """Phase 18 (c): profile_train --per-layer on TINY_YAML at
    PROFILE_TINY's batch and size on the card: a finite row for each plan
    step."""
    batch, size, iters = PROFILE_TINY
    path = tmp / "tiny.yaml"
    path.write_text(TINY_YAML)
    trainer = profile_train.make_trainer(str(path), "bfloat16", False, dev,
                                         str(tmp / "profile_tiny"))
    stages = profile_train.Stages(
        trainer, *profile_train.device_batch(batch, size, 8, dev))
    print(f"  (c) TINY_YAML per layer, bf16, batch {batch}, {size} px:")
    res = profile_train.per_layer(stages, iters)
    profile_train.print_per_layer(res, batch)
    names = [s.name for s in trainer.model.plan.steps]
    if [r[0] for r in res["rows"]] != names or not all(
            np.isfinite(v) for r in res["rows"] for v in r[2:]):
        raise AssertionError(f"profile_train --per-layer: {res['rows']}")


def phase_profiles(dev, tmp: Path, phase8: dict) -> dict:
    """Phase 18 (module docstring): (b) first, before the process's first
    torch.profiler trace, then (a) and (c). Returns the launches of (a)'s
    forwards and (b)'s full stages."""
    t = [time.perf_counter()]
    launches = phase_train_profiles(dev, tmp, phase8)
    t.append(time.perf_counter())
    launches.update(phase_layer_profiles(dev))
    t.append(time.perf_counter())
    phase_per_layer_train(dev, tmp)
    t.append(time.perf_counter())
    print(f"  phase 18: {t[3] - t[0]:.1f} s ((b) {t[1] - t[0]:.1f}, (a) "
          f"{t[2] - t[1]:.1f}, (c) {t[3] - t[2]:.1f})")
    return launches


def kernels_line(res: dict, tres: dict, counts: dict, tcounts: dict,
                 v9c: dict, aug: dict, exported: dict, more: dict,
                 clis: dict, dp: dict, remat: dict, lazy: dict,
                 profiles: dict) -> list[dict]:
    """The kernels JSON line's entries from phases 3 and 6's numbers and
    the launch counts of phases 5 and 8 (`launches`, gelan-c), of phase
    10 (`launches_yolov9_c`: serving, eval and train), of phase 11 (b)
    (`launches_device_augment`, per dtype), of phase 12
    (`launches_exported`: the loaded archive's requests), of phase 13
    (`launches_gelan_e`, `launches_gelan_c_d2`: serving, eval and train
    per dtype), of phase 14 (`launches_cli`: detect on cuda, train,
    val), of phase 15 (`launches_data_parallel`: the DDP train steps
    per dtype, the mesh Detector's requests) and of phase 16
    (`launches_remat`: a step per remat mode, and of the DDP step with
    "early"; `launches_lazy_nms`: predict_split + non_max_suppression_raw
    per confidence) and of phase 18 (`launches_profile`: a profiled
    forward per dtype, a profiled `full` train stage per dtype); prints
    each dtype's fractions of the bound."""
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
         tcounts["stem_wgrad"], {t: tres["stem_wgrad"][(BATCH, 64, t)]
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

    def by_path(paths: dict, name: str) -> dict:
        return {path: c.get(v9c_key[name], 0) for path, c in paths.items()}

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"yolo_re_tpu_torch/csrc/{src}",
        "replaces": f"yolo_re_tpu/ops/pallas/{tpu}", "launches": launches,
        "launches_yolov9_c": v9c_launches(name),
        "launches_device_augment": {
            tag: aug[tag].get(v9c_key[name], 0) for tag in aug},
        "launches_exported": exported.get(v9c_key[name], 0),
        "launches_gelan_e": by_path(more["gelan-e"], name),
        "launches_gelan_c_d2": by_path(more["gelan-c-d2"], name),
        "launches_cli": by_path({k: v for k, v in clis.items()
                                 if k != "detect cpu"}, name),
        "launches_data_parallel": by_path(dp, name),
        "launches_remat": by_path(remat, name),
        "launches_lazy_nms": by_path(lazy, name),
        "launches_profile": by_path(profiles, name),
        **numbers(r["bf16"]), "f32": numbers(r["f32"])}
        for name, src, tpu, launches, r in rows]
    # the ADown kernels' sums over gelan-e's five sites
    for k in kernels:
        if k["name"] in ("adown", "adown_raw", "adown_bwd"):
            src = res if k["name"] == "adown" else tres
            for tag in ("bf16", "f32"):
                (k if tag == "bf16" else k["f32"])["gelan_e"] = numbers(
                    src[k["name"]][("gelan-e", tag)])

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
            "stem_conv": {f"C={c}": res["stem_shapes"][(c, tag)]
                          for c in STEM_WIDTHS},
            "stem_conv_raw": {f"C={c}": tres["stem_raw_shapes"][(c, tag)]
                              for c in STEM_WIDTHS},
            "stem_wgrad": {f"{b}x3x{SIZE}x{SIZE} C={c}": r
                           for (b, c, t), r in tres["stem_wgrad"].items()
                           if t == tag},
            **{k: {f"{model} {site}": r for model in ADOWN_MODELS
                   for site, r in (res if k == "adown" else tres)[k][
                       (model, tag)]["sites"].items()}
               for k in ("adown", "adown_raw", "adown_bwd")}}

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
    t_start = time.perf_counter()
    smi = nvidia_smi()

    print("phase 1: environment")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}")
    print(f"  nvidia-smi: {smi}")
    print(f"  devices: {device_summary()}")

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

    with tempfile.TemporaryDirectory() as td:
        print("phase 10: yolov9-c")
        v9c = phase_yolov9c(dev, Path(td), defaults)

    with tempfile.TemporaryDirectory() as td:
        print("phase 11: device augmentation")
        phase_augment(dev)
        aug = phase_augment_train(dev, Path(td), phase8)

    with tempfile.TemporaryDirectory() as td:
        print("phase 12: the serving export")
        exported = phase_export(dev, Path(td), gelan_c, sites)
    del gelan_c
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as td:
        print("phase 13: gelan-e and gelan-c-d2")
        more = phase_more_configs(dev, Path(td))

    with tempfile.TemporaryDirectory() as td:
        print("phase 14: the CLIs on the card")
        clis = phase_clis(dev, Path(td))

    with tempfile.TemporaryDirectory() as td:
        print("phase 15: data parallelism")
        ddp = phase_ddp(Path(td))
        dp = {f"train {d}": c for d, c in ddp["launches"].items()}
        dp["serving"] = phase_mesh_serving(dev, random_model("gelan-c"),
                                           sites)
        phase_mesh_eval(dev, Path(td))

    with tempfile.TemporaryDirectory() as td:
        print("phase 16: train tooling and lazy-decode NMS")
        remat, lazy = phase_tooling(dev, Path(td), sites, ddp["remat"])

    with tempfile.TemporaryDirectory() as td:
        print("phase 17: the native host runtime, export across devices, "
              "the dry run")
        phase_last_modules(dev, Path(td), sites)

    with tempfile.TemporaryDirectory() as td:
        print("phase 18: per-layer and per-stage profiles")
        profiles = phase_profiles(dev, Path(td), phase8)

    kernels = kernels_line(res, tres, counts, tcounts, v9c, aug, exported,
                           more, clis, dp, remat, lazy, profiles)
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
          f"{AUG_TRAIN_BATCHES} counted steps per dtype; launches_exported: "
          f"phase 12's {REQUESTS} requests through the loaded archive; "
          f"launches_gelan_e, launches_gelan_c_d2: phase 13's {REQUESTS} "
          f"requests, {EVAL_IMAGES // BATCH} eval batches per dtype and "
          f"gelan-e's {GELAN_E_TRAIN_STEPS} counted train steps per dtype; "
          f"launches_cli: phase 14's detect on cuda ({CLI_IMAGES} images), "
          f"train ({CLI_TRAIN_IMAGES // CLI_BATCH} steps) and val; "
          f"launches_data_parallel: phase 15's {DDP_STEPS} counted DDP "
          f"train steps per dtype and {REQUESTS} mesh Detector requests "
          f"(two replicas); launches_remat: phase 16's launches a train "
          f"step per remat mode (and of the DDP step with 'early'); "
          f"launches_lazy_nms: phase 16 (d)'s predict_split + "
          f"non_max_suppression_raw per confidence; launches_profile: "
          f"phase 18's launches a profiled forward (layers) and a profiled "
          f"full train stage (train) per dtype; the ADown "
          f"kernels' sums over gelan-e's five sites under 'gelan_e', and "
          f"the stem kernels at C=64 (gelan-c) and C=80 (gelan-e) under "
          f"'shapes')")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"kernels' build included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["ddp-worker"]:
        sys.exit(ddp_worker(Path(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
