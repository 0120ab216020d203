"""Training traffic: `Trainer.train_one_epoch` over host batches, as the
loader hands them over (uint8 NHWC images, (B, M, 5) targets), so the
trainer's pinned one-ahead copy is in the window.

A mix file (mixes/<traffic>.json) sets:
- `batch`, `size`, `max_boxes`: each batch's images and target rows;
- `pool`: distinct batches drawn from the seed: synthetic scenes of
  solid class-coloured rectangles (1 to 3 an image) on dark noise, the
  distribution of `yolo_re_tpu_torch/data/synth.py:make_eval_batch`,
  drawn in bulk; every seed trains the same sizes, in an order drawn
  from the seed;
- `steps_per_epoch`: the loader's length, which sets the warm-up schedule;
- `check_steps`: the first steps, which set-up runs on distinct batches
  and the reference follows;
- `trace_steps`: the steps of a traced stretch.

Set-up builds the trainer once, runs the check steps through
`train_one_epoch` (one batch an epoch, so each step's loss is the epoch's
mean items) and hands the same trainer to the window.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from lib.device import peak_bytes, phase, release, sync
from lib.judge import judge_training
from lib.trace import record, ranges, summarize
from lib.weights import make_weights
from reference import train as ref
from reference.model import Network, Run

DARK, SCENE_CLASSES = 80, 4
COLORS = np.array([(230, 60, 60), (60, 230, 60), (60, 60, 230),
                   (230, 230, 60)], np.uint8)


def make_batches(seed: int, n: int, batch: int, size: int,
                 max_boxes: int) -> list[dict]:
    """`n` batches of synthetic scenes (uint8 RGB, normalized targets)."""
    rng = np.random.default_rng([seed, 2])
    images = rng.integers(0, DARK, (n, batch, size, size, 3), dtype=np.uint8)
    targets = np.zeros((n, batch, max_boxes, 5), np.float32)
    for b in range(n):
        for i in range(batch):
            for j in range(min(int(rng.integers(1, 4)), max_boxes)):
                cx, cy = rng.uniform(0.25, 0.75, 2)
                bw, bh = rng.uniform(0.15, 0.35, 2)
                cls = int(rng.integers(0, SCENE_CLASSES))
                x1, y1 = int((cx - bw / 2) * size), int((cy - bh / 2) * size)
                x2, y2 = int((cx + bw / 2) * size), int((cy + bh / 2) * size)
                images[b, i, max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = \
                    COLORS[cls]
                targets[b, i, j] = (cls, cx, cy, bw, bh)
    return [{"images": images[b], "targets": targets[b]} for b in range(n)]


class Loader:
    """The trainer's loader: `plan` batches, or batches until `until`
    (a host-clock deadline)."""

    def __init__(self, batches: list, order, steps_per_epoch: int):
        self.batches, self.order = batches, order
        self.steps_per_epoch = steps_per_epoch
        self.plan: list[int] = []
        self.until: float | None = None
        self.served = 0

    def __len__(self) -> int:
        return self.steps_per_epoch

    def __iter__(self):
        i = 0
        while (i < len(self.plan) if self.until is None
               else time.perf_counter() < self.until):
            k = self.plan[i] if self.until is None \
                else self.order[self.served % len(self.order)]
            self.served += 1
            i += 1
            yield self.batches[k]


class Train:
    def __init__(self, cell):
        from yolo_re_tpu_torch.convert import jax_from_state_dict
        from yolo_re_tpu_torch.models.config import ModelConfig
        from yolo_re_tpu_torch.models.yolo import YOLO
        from yolo_re_tpu_torch.train.config import TrainConfig
        from yolo_re_tpu_torch.train.trainer import Trainer

        self.cell, cfg, mix = cell, cell.cfg, cell.mix
        self.dev = cell.device
        self.net = Network(cfg)
        self.sd = make_weights(self.net.spec(), cell.seed, self.dev,
                               cfg["class_bias"], cfg["num_classes"],
                               self.net.strides, cfg.get("init"))
        self.batches = make_batches(cell.seed, mix["pool"], mix["batch"],
                                    mix["size"], mix["max_boxes"])
        order = np.random.default_rng(cell.seed).permutation(mix["pool"])
        self.loader = Loader(self.batches, order, mix["steps_per_epoch"])
        model = YOLO.from_config(ModelConfig(
            cfg["num_classes"], cfg["depth_multiplier"],
            cfg["width_multiplier"], copy.deepcopy(cfg["layers"])))
        params, stats = jax_from_state_dict(model.plan, self.sd)
        self.trainer = Trainer(
            model, config=TrainConfig(compute_dtype=cfg["precision"],
                                      data_parallel=False,
                                      device_augment=False,
                                      remat=cfg.get("remat", False),
                                      seed=cell.seed % 2 ** 31),
            train_loader=self.loader, params=params, stats=stats,
            device=self.dev)
        self.epoch = 0

    def epoch_over(self, plan=None, until=None) -> np.ndarray:
        self.loader.plan, self.loader.until = plan or [], until
        items = self.trainer.train_one_epoch(self.epoch)
        self.epoch += 1
        return items

    @torch.no_grad()
    def _norms(self, tensors: dict) -> dict:
        return {k: float(torch.linalg.vector_norm(v.float()))
                for k, v in tensors.items()}

    def check_steps(self) -> dict:
        """The first steps, each its own epoch of one distinct batch: the
        losses, the first gradient (from the momentum buffers after one
        step: buffer - weight decay x the start for decayed weights) and
        the changes of the weights and their EMA after the last."""
        t = self.trainer
        wd = t.config.weight_decay
        batch = self.cell.mix["batch"]
        out = {"loss": []}
        for step in range(self.cell.mix["check_steps"]):
            items = self.epoch_over(plan=[step])
            out["loss"].append(float(np.float64(items).sum()) * batch)
            if step == 0:
                out["grad"] = self._norms({
                    k: b - wd * self.sd[k] if t.labels[k] == "weight" else b
                    for k, b in t.opt_bufs.items()})
        out["change"] = self._norms({k: p - self.sd[k]
                                     for k, p in t.params.items()})
        out["ema"] = self._norms({k: p - self.sd[k]
                                  for k, p in t.ema["params"].items()})
        return out

    def window(self, seconds: float) -> dict:
        served = self.loader.served
        t0 = time.perf_counter()
        self.epoch_over(until=t0 + seconds)
        elapsed = time.perf_counter() - t0
        steps = self.loader.served - served
        return {"train.images_per_s":
                steps * self.cell.mix["batch"] / elapsed}, steps

    def traced(self) -> tuple:
        k = self.cell.mix["trace_steps"]
        plan = [self.loader.order[i % len(self.loader.order)]
                for i in range(k)]
        layers = [n.name for n in self.net.nodes]

        def hooked():
            with ranges(self.trainer.model, layers, []):
                self.epoch_over(plan=plan)
        t0 = time.perf_counter()
        self.epoch_over(plan=plan)
        untraced_s = time.perf_counter() - t0
        prof, _ = record(hooked, self.dev)
        return summarize(prof, untraced_s), k

    def release(self) -> None:
        del self.trainer
        release()

    def reference(self, precision: str = "f32", rows: int | None = None
                  ) -> dict:
        """The reference's check steps from the same weights and batches
        (`rows`: only the first rows of each batch)."""
        mix, cfg = self.cell.mix, self.cell.cfg
        names = [n for n, _, k in self.net.spec()
                 if k not in ("bn_mean", "bn_var", "count")]
        params = {k: self.sd[k].clone().requires_grad_() for k in names}
        avg = {k: v.detach().clone() for k, v in params.items()}
        bufs: dict = {}
        out = {"loss": []}
        for step in range(mix["check_steps"]):
            b = self.batches[step]
            x = torch.from_numpy(b["images"][:rows]).to(self.dev)
            x = x.permute(0, 3, 1, 2).float() / 255.0
            t = torch.from_numpy(b["targets"][:rows]).to(self.dev)
            maps = self.net.train_maps(Run(params, train=True,
                                           precision=precision),
                                       x, checkpoint=True)
            total, _ = ref.loss(maps, t, self.net.strides, cfg["num_classes"])
            grads = dict(zip(names, torch.autograd.grad(
                total, [params[k] for k in names])))
            grads = ref.clip(grads)
            if step == 0:
                out["grad"] = self._norms(grads)
            lr, bias_lr, momentum = ref.schedule(step,
                                                 mix["steps_per_epoch"])
            ref.sgd(params, grads, bufs, lr, bias_lr, momentum)
            ref.ema(avg, params, step + 1)
            out["loss"].append(float(total.detach()))
        out["change"] = self._norms({k: params[k] - self.sd[k]
                                     for k in names})
        out["ema"] = self._norms({k: avg[k] - self.sd[k] for k in names})
        return out


def run(cell) -> dict:
    s = Train(cell)
    phase("built", cell.t0)
    port = s.check_steps()
    sync(cell.device)
    phase("check steps run", cell.t0)
    out = {"setup_s": time.perf_counter() - cell.t0, "units": 0}
    if cell.trace:
        out["summary"], out["units"] = s.traced()
    else:
        out["end_to_end"], out["units"] = s.window(cell.seconds)
    out["attempted"] = out["units"]
    out["failed"] = 0
    out["memory_peak_bytes"] = peak_bytes(cell.device)
    s.release()
    out["checks"] = judge_training(port, s.reference(), log=phase)
    out["images_per_unit"] = cell.mix["batch"]
    return out
