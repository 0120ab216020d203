"""The training loop on one device (counterpart of
yolo_re_tpu/train/trainer.py; reference src/yolo/train/trainer.py).

One step, as in the JAX package's jitted step, run eagerly:

    train-mode forward (BN batch statistics, running stats updated) ->
    TAL loss -> backward -> global-norm clip -> three-group SGD with the
    warmup-cosine schedule -> EMA of the parameters and BN statistics

On a CUDA device the forward and backward run the train stem and every
ADown through the hand-written kernel pairs (ops/stem_train.py,
ops/adown_train.py). `TrainConfig.compute_dtype` sets the activations'
dtype; the parameters, gradients, optimizer buffers and EMA stay f32.

Batches come from `train_loader`: any iterable (with `len`) of
{"images": (B, H, W, 3) uint8 or float NHWC, "targets": (B, M, 5)} batches,
numpy or torch, the JAX Trainer's batch format; or `data=` (a DataConfig)
builds the train and val loaders from disk (data/dataset.py). An epoch
reads them one batch ahead (`_prefetched`): on a card, batch n + 1 is
staged in pinned memory and copied on a copy stream while batch n
computes. uint8 images are normalized on the device, then, with
`device_augment` (True: HSV + flips; "full": also mosaic, the
random_perspective warp and mixup; data/device_pipeline.py) augmented
there. `validate()` runs the Evaluator (eval/evaluator.py) on the EMA
weights, and `train()` keeps the best map50 in output_dir/best.npz. What
waits for later slices raises NotImplementedError naming the slice:
injected optimizers, multi-card data parallelism, remat and orbax
checkpoints.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from yolo_re_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from yolo_re_tpu_torch.data.dataset import create_dataloader
from yolo_re_tpu_torch.data.device_pipeline import (
    BATCH_FIELDS,
    DRAW_ONLY,
    FULL_FIELDS,
    augment_batch,
    augment_batch_full,
    draw_augment,
    draws_to,
)
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.loss.tal import LossConfig, TALoss
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.serving import DTYPES
from yolo_re_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.ema import ema_update, init_ema
from yolo_re_tpu_torch.train.optimizer import (
    clip_by_global_norm,
    init_sgd_state,
    sgd_step,
)
from yolo_re_tpu_torch.train.schedule import WarmupCosineSchedule
from yolo_re_tpu_torch.utils.precision import full_f32

log = logging.getLogger(__name__)

_STAT_SUFFIXES = (".running_mean", ".running_var")


def detect_info(model: YOLO) -> tuple[int, int, tuple[float, ...]]:
    """(num_classes, reg_max, strides) of the model's detect head; a dual
    head's strides are its main half's (yolo_re_tpu/train/trainer.py:
    55-65). The loss tells the heads apart by their train output."""
    for step in model.plan.steps:
        if step.type in ("DetectDFL", "DualDetectDFL"):
            head = model.layers[step.name]
            return head.num_classes, head.reg_max, head.strides
    raise ValueError("Model has no detect head")


def _not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to yolo_re_tpu_torch yet: it waits for the "
        f"{slice_} slice of the port")


class Trainer:
    """Single-device trainer (reference: src/yolo/train/trainer.py:34-371).

    Example:
        trainer = Trainer(model, config=TrainConfig(compute_dtype="bfloat16",
                          data_parallel=False), train_loader=batches)
        trainer.train()

    `params`/`stats`: the JAX package's (params, stats) pytrees to start
    from; without them the model is initialized from `config.seed`, as the
    JAX Trainer does. `device` defaults to "cuda" and raises without a
    card; pass "cpu" to train on the kernels' plain versions.
    """

    def __init__(self, model: YOLO, data=None,
                 config: TrainConfig | None = None, loss_fn=None,
                 loss_config: LossConfig | None = None, train_loader=None,
                 val_loader=None, params=None, stats=None, optimizer=None,
                 schedule=None, device: str | torch.device = "cuda",
                 **overrides: Any):
        self.model = model
        self.config = config or TrainConfig()
        for k, v in overrides.items():       # kwargs override config fields
            if not hasattr(self.config, k):
                raise TypeError(f"Unknown TrainConfig field {k!r}")
            setattr(self.config, k, v)
        cfg = self.config
        if optimizer is not None:
            raise _not_ported("an injected optimizer", "train tooling")
        if cfg.remat:
            raise _not_ported("remat", "train tooling")
        if cfg.checkpoint_format != "npz":
            raise _not_ported(f"checkpoint_format={cfg.checkpoint_format!r} "
                              f"(orbax)", "train tooling")
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}")
        if model.fused:
            raise ValueError("a fused model has no BN to train")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda'): no CUDA device")
        data = self._setup_device_augment(data)
        if train_loader is None:
            if data is None or not data.train_path:
                raise ValueError(
                    "train_loader (an iterable of {'images', 'targets'} "
                    "batches) or data with a train_path is required")
            train_loader = create_dataloader(data.train_path, data, "train")
        if val_loader is None and data is not None and data.val_path:
            val_loader = create_dataloader(data.val_path, data, "val")
        if cfg.data_parallel and self.device.type == "cuda" and \
                torch.cuda.device_count() > 1:
            raise _not_ported(
                f"data_parallel over {torch.cuda.device_count()} cards "
                f"(set data_parallel=False for one card)", "scale")
        self.dtype = DTYPES[cfg.compute_dtype]

        nc, reg_max, strides = detect_info(model)
        self.loss_fn = loss_fn or TALoss(nc, reg_max, strides,
                                         loss_config or LossConfig())
        self.train_loader = train_loader
        self.val_loader = val_loader
        self._evaluator: Evaluator | None = None
        # the one-batch-ahead copies' stream (`_put_batch`)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

        # -- state ----------------------------------------------------------
        if params is None or stats is None:
            model.init_parameters(torch.Generator().manual_seed(cfg.seed))
        else:
            model.load_state_dict(state_dict_from_jax(model.plan, params,
                                                      stats), strict=True)
        model.to(self.device).train()
        self.params = dict(model.named_parameters())
        self.stats = {k: v for k, v in model.named_buffers()
                      if k.endswith(_STAT_SUFFIXES)}
        self.labels = model.param_labels()
        self.opt_bufs = init_sgd_state(self.params)
        self.ema = init_ema(self.params, self.stats)

        steps_per_epoch = max(len(self.train_loader), 1)
        self.schedule = schedule or WarmupCosineSchedule(
            base_lr=cfg.lr, total_steps=cfg.epochs * steps_per_epoch,
            warmup_steps=int(cfg.warmup_epochs * steps_per_epoch),
            warmup_momentum=cfg.warmup_momentum, base_momentum=cfg.momentum,
            warmup_bias_lr=cfg.warmup_bias_lr, lrf=cfg.lrf)
        self.global_step = 0
        self.start_epoch = 0
        self.best_fitness = 0.0

    # -- device augmentation ---------------------------------------------

    def _setup_device_augment(self, data):
        """yolo_re_tpu/train/trainer.py:112-143: take the augmentation
        hyperparameters from `data.augment` into `self._device_aug`, and
        return a copy of `data` whose host loader skips those stages and
        emits uint8 (normalized on the device). Without `data` there are no
        hyperparameters: nothing is augmented, as in the JAX Trainer."""
        mode = self.config.device_augment
        self._device_aug: dict[str, float] | None = None
        self._device_aug_full = mode == "full"
        if not mode:
            return data
        if data is None:
            log.warning("device_augment=%r has no effect without data=: the "
                        "augmentation hyperparameters come from "
                        "data.augment", mode)
            return data
        fields = FULL_FIELDS if self._device_aug_full else BATCH_FIELDS
        self._device_aug = {k: getattr(data.augment, f)
                            for k, f in fields.items()}
        data = copy.deepcopy(data)
        for f in fields.values():
            setattr(data.augment, f, 0.0)
        data.uint8_images = True
        return data

    def _aug_draws(self, step: int, batch: int,
                   size: int) -> dict[str, np.ndarray]:
        """The augmentation draws of `step`: a function of (seed, step)
        alone, as the JAX Trainer's fold_in(key(seed + 1), step), so a
        resumed run draws what an unbroken one drew, on any device."""
        rng = np.random.default_rng([self.config.seed + 1, step])
        return draw_augment(rng, batch, size, **self._device_aug)

    def _augment(self, x: torch.Tensor,
                 t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Device augmentation of NHWC images in the compute dtype and f32
        targets (the JAX step's `_step_body`, trainer.py:294-308)."""
        draws = draws_to(self._aug_draws(self.global_step, x.shape[0],
                                         x.shape[1]), self.device)
        fn = augment_batch_full if self._device_aug_full else augment_batch
        hyps = {k: v for k, v in self._device_aug.items()
                if k not in DRAW_ONLY}
        return fn(x, t, draws, **hyps)

    # -- one step ------------------------------------------------------------

    def _put_batch(self, images, targets):
        """Host batch -> (images as given, uint8 or float NHWC; targets f32)
        on the device, and the event the compute stream waits on before it
        reads them (None on the CPU, where this is a plain `as_tensor`, and
        for tensors already on a device, which are moved as they are).
        On a card a host batch is staged in pinned memory (PyTorch's caching
        host allocator) and copied without blocking on the copy stream, so
        that, called a batch ahead (`_prefetched`), the copy of batch n + 1
        overlaps batch n's compute; `record_stream` keeps the allocator
        from reusing the device tensors before the compute stream is done
        with them (yolo_re_tpu/train/trainer.py:328-351)."""
        x = torch.as_tensor(images)
        t = torch.as_tensor(targets, dtype=torch.float32)
        if self._copy_stream is None or x.device.type != "cpu":
            return x.to(self.device), t.to(self.device), None
        x, t = x.pin_memory(), t.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            x = x.to(self.device, non_blocking=True)
            t = t.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        compute = torch.cuda.current_stream(self.device)
        x.record_stream(compute)
        t.record_stream(compute)
        return x, t, ready

    def train_step(self, images, targets):
        """One optimizer step on a host batch. Returns (loss, items (3,),
        grad norm) as device tensors (no host sync)."""
        return self._step(*self._put_batch(images, targets))

    @full_f32()
    def _step(self, x: torch.Tensor, t: torch.Tensor,
              ready: torch.cuda.Event | None = None):
        """One optimizer step on a batch `_put_batch` put on the device:
        normalize (uint8: cast to the compute dtype, then / 255, as the JAX
        step does), augment (NHWC), then the forward on NCHW in
        channels_last memory. The whole step, augmentation included, runs
        with TF32 off (`utils.precision.full_f32`)."""
        cfg = self.config
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        x = x.to(self.dtype) / 255.0 if x.dtype == torch.uint8 \
            else x.to(self.dtype)
        if self._device_aug is not None:
            x, t = self._augment(x, t)
        x = x.contiguous().permute(0, 3, 1, 2)
        total, items = self.loss_fn(self.model(x), t)
        names = list(self.params)
        grads = torch.autograd.grad(total, [self.params[k] for k in names])
        grads, gnorm = clip_by_global_norm(dict(zip(names, grads)),
                                           cfg.grad_clip_norm)
        lr, bias_lr, momentum = self.schedule(self.global_step)
        sgd_step(self.params, grads, self.opt_bufs, self.labels, lr=lr,
                 bias_lr=bias_lr, momentum=momentum,
                 weight_decay=cfg.weight_decay)
        ema_update(self.ema, self.params, self.stats, decay=cfg.ema_decay,
                   tau=cfg.ema_tau)
        self.global_step += 1
        return total.detach(), items, gnorm

    # -- epochs --------------------------------------------------------------

    def _prefetched(self):
        """The train loader's batches as (images, targets, ready event,
        host batch) on the device, one batch ahead: batch n + 1 is put
        before batch n is yielded (yolo_re_tpu/train/trainer.py:353-362)."""
        pending = None
        for batch in self.train_loader:
            cur = (*self._put_batch(batch["images"], batch["targets"]), batch)
            if pending is not None:
                yield pending
            pending = cur
        if pending is not None:
            yield pending

    def train_one_epoch(self, epoch: int) -> np.ndarray:
        if hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(epoch)
        cfg = self.config
        t0 = time.perf_counter()
        sum_items = None
        n_batches = n_images = 0
        for x, t, ready, batch in self._prefetched():
            _, items, _ = self._step(x, t, ready)
            sum_items = items if sum_items is None else sum_items + items
            n_batches += 1
            n_images += len(batch["images"])
            if n_batches % cfg.log_interval == 0 or n_batches == 1:
                box, cls_, dfl = items.tolist()
                log.info("epoch %d step %d | box %.4f cls %.4f dfl %.4f | "
                         "%.1f img/s", epoch, self.global_step, box, cls_,
                         dfl, n_images / (time.perf_counter() - t0))
        mean_items = (np.zeros(3) if sum_items is None
                      else sum_items.cpu().numpy() / n_batches)
        dt = time.perf_counter() - t0
        log.info("epoch %d done in %.1fs (%.1f img/s) | box %.4f cls %.4f "
                 "dfl %.4f", epoch, dt, n_images / max(dt, 1e-9), *mean_items)
        return mean_items

    def validate(self, epoch: int = 0) -> dict[str, float]:
        """Validate on the EMA weights (reference: trainer.py:315-334),
        with per-epoch debug images (GT red / preds green) under
        output_dir/debug/."""
        if self.val_loader is None:
            return {}
        if self._evaluator is None:
            self._evaluator = Evaluator(
                self.model, self.val_loader, device=self.device,
                debug_dir=str(Path(self.config.output_dir) / "debug"))
        weights = {**self.model.state_dict(), **self.ema["params"],
                   **self.ema["stats"]}
        return self._evaluator.evaluate(weights, epoch=epoch + 1)

    def train(self) -> dict[str, float]:
        cfg = self.config
        out_dir = Path(cfg.output_dir)
        results: dict[str, float] = {}
        for epoch in range(self.start_epoch, cfg.epochs):
            items = self.train_one_epoch(epoch)
            if self.val_loader is not None and cfg.val_period > 0 \
                    and (epoch + 1) % cfg.val_period == 0:
                results = self.validate(epoch)
                fitness = results.get("map50", 0.0)
                if fitness > self.best_fitness:
                    self.best_fitness = fitness
                    self._save(out_dir / "best.npz", epoch)
                    log.info("new best map50 %.4f -> best.npz", fitness)
            self._log_metrics(out_dir, epoch, items, results)
            if cfg.save_period > 0 and (epoch + 1) % cfg.save_period == 0:
                self._save(out_dir / f"epoch{epoch}.npz", epoch)
        self._save(out_dir / "last.npz", cfg.epochs - 1)
        return results

    def _log_metrics(self, out_dir: Path, epoch: int, items,
                     results: dict[str, float]) -> None:
        """One JSON line per epoch in output_dir/metrics.jsonl."""
        out_dir.mkdir(parents=True, exist_ok=True)
        lr, _, momentum = self.schedule(self.global_step)
        record = {"epoch": epoch, "global_step": self.global_step,
                  "box_loss": float(items[0]), "cls_loss": float(items[1]),
                  "dfl_loss": float(items[2]),
                  **{f"val_{k}": float(v) for k, v in results.items()},
                  "lr": float(lr), "momentum": float(momentum)}
        with open(out_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(record) + "\n")

    # -- checkpointing -------------------------------------------------------

    def _pytrees(self, values: dict[str, torch.Tensor]) -> tuple[dict, dict]:
        """Port tensors by state-dict name (parameters and/or BN stats;
        missing ones taken from the model) -> JAX (params, stats)."""
        sd = {**self.model.state_dict(), **values}
        return jax_from_state_dict(self.model.plan, sd)

    def _save(self, path: Path, epoch: int) -> None:
        params, stats = self._pytrees({})
        ema_params, ema_stats = self._pytrees(
            {**self.ema["params"], **self.ema["stats"]})
        opt, _ = self._pytrees(self.opt_bufs)
        save_checkpoint(
            path, params=params, stats=stats,
            ema={"params": ema_params, "stats": ema_stats,
                 "updates": self.ema["updates"]},
            opt_bufs=opt, epoch=epoch, global_step=self.global_step,
            best_fitness=self.best_fitness, config=vars(self.config))

    @torch.no_grad()
    def load_checkpoint(self, path: str | Path) -> None:
        """Full resume from a checkpoint of either package."""
        ckpt = load_checkpoint(path)
        plan = self.model.plan

        def to_port(params, stats) -> dict[str, torch.Tensor]:
            return state_dict_from_jax(plan, params, stats)

        self.model.load_state_dict(to_port(ckpt["params"], ckpt["stats"]),
                                   strict=True)
        ema = to_port(ckpt["ema"]["params"], ckpt["ema"]["stats"])
        opt = to_port(ckpt["opt"], ckpt["stats"])
        for dst, src in ((self.ema["params"], ema), (self.ema["stats"], ema),
                         (self.opt_bufs, opt)):
            for k, v in dst.items():
                v.copy_(src[k])
        self.ema["updates"] = int(ckpt["ema"]["updates"])
        self.global_step = ckpt["global_step"]
        self.best_fitness = ckpt["best_fitness"]
        self.start_epoch = ckpt["epoch"] + 1
