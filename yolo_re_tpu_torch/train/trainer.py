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
weights, and `train()` keeps the best map50 in output_dir/best.npz.

`remat` (True | "early", `TrainConfig.remat`) runs the train forward with
per-block recomputation (`YOLO.forward(remat=)`): the backward recomputes
the chosen blocks' activations, the stem and ADown kernels included,
instead of keeping them. `optimizer=` replaces the default grouped SGD
(below); `checkpoint_format="orbax"` writes checkpoint directories
(train/checkpoint.py: a torch.distributed.checkpoint directory, not
orbax's).

Data parallelism (`data_parallel=True` after `parallel.mesh.
init_distributed`): one process per card, each stepping on its slice of
every global batch (`data=` builds the loader with `shard=(rank,
world)`). The forward runs inside `global_batch`, so BN moments and the
loss's scale are the global batch's; the gradients are all-reduced (one
flat buffer) and averaged after the backward, so clip, SGD and EMA run
the same on every process. Device augmentation draws for the global
batch on every process; "full" all-gathers the global batch's images and
targets for mosaic and mixup partners and computes the process's own
rows. Process 0 alone validates (its own EMA weights, no mesh) and
writes checkpoints, metrics and debug images.

While a `torch.profiler` collects, steps and epochs open spans
(`utils/profiling.span`): `train.step` holds `train.input` (the wait on
the batch's copy, the cast, augmentation), `train.forward`, `train.loss`,
`train.backward`, `train.allreduce` (data parallel), `train.clip`,
`train.update` and `train.ema`; an epoch adds `train.next_batch` (the
loader's next batch and the put of the batch ahead), `train.log` (the
values a log line reads) and `train.epoch_end` (the epoch's mean items).
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
import torch.distributed as dist

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
from yolo_re_tpu_torch.models.yolo import YOLO, check_remat
from yolo_re_tpu_torch.parallel.mesh import (
    all_gather_rows,
    global_batch,
    local_rows,
    process_count,
    process_index,
)
from yolo_re_tpu_torch.serving import DTYPES
from yolo_re_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    save_checkpoint_dir,
)
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.ema import ema_update, init_ema
from yolo_re_tpu_torch.train.optimizer import (
    clip_by_global_norm,
    init_sgd_state,
    sgd_step,
)
from yolo_re_tpu_torch.train.schedule import WarmupCosineSchedule
from yolo_re_tpu_torch.utils.precision import full_f32
from yolo_re_tpu_torch.utils.profiling import span

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


class Trainer:
    """The trainer, on one device per process (reference:
    src/yolo/train/trainer.py:34-371).

    Example:
        trainer = Trainer(model, config=TrainConfig(compute_dtype="bfloat16",
                          data_parallel=False), train_loader=batches)
        trainer.train()

    `params`/`stats`: the JAX package's (params, stats) pytrees to start
    from; without them the model is initialized from `config.seed`, as the
    JAX Trainer does. `device` defaults to "cuda" (the card
    `init_distributed` chose, in a process group) and raises without a
    card; pass "cpu" to train on the kernels' plain versions.
    `data_parallel` in an initialized process group steps on this
    process's slice of each global batch (module docstring); a custom
    loader must then carry `.shard == (rank, world)`, as in JAX.

    `optimizer` makes the update rule injectable, in the port's forms of
    the JAX Trainer's (yolo_re_tpu/train/trainer.py:86-96):
    - a callable that takes the list of the model's parameters and
      returns a `torch.optim.Optimizer` (the counterpart of an optax
      transformation), e.g. `lambda ps: torch.optim.Adam(ps, lr=1e-3)`:
      each step sets the parameters' `.grad` to the clipped gradients and
      calls its `.step()`;
    - an `(init_fn, step_fn)` pair over the {name: tensor} parameter dict:
      `init_fn(params) -> state`, `step_fn(params, grads, state, step) ->
      (params, state)`, run under no_grad; the returned parameters are
      copied into the model.
    None keeps the default: grouped SGD with the warmup-cosine schedule,
    or `schedule` (step -> (lr, bias_lr, momentum)). An injected rule owns
    its learning rate: `schedule` is unused and metrics.jsonl carries no
    lr. The gradient clip and the EMA run as for SGD.
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
        self._remat = check_remat(cfg.remat)
        if cfg.checkpoint_format not in ("npz", "orbax"):
            raise ValueError(f"checkpoint_format must be 'npz' or 'orbax', "
                             f"got {cfg.checkpoint_format!r}")
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}")
        if model.fused:
            raise ValueError("a fused model has no BN to train")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda'): no CUDA device")
        self._setup_data_parallel()
        data = self._setup_device_augment(data)
        shard = (self.rank, self.world) if self.world > 1 else None
        if train_loader is None:
            if data is None or not data.train_path:
                raise ValueError(
                    "train_loader (an iterable of {'images', 'targets'} "
                    "batches) or data with a train_path is required")
            train_loader = create_dataloader(data.train_path, data, "train",
                                             shard=shard)
        elif shard is not None:
            # a custom loader must yield THIS process's slice; an unsharded
            # one would train on world-times duplicated samples
            # (yolo_re_tpu/train/trainer.py:159-175)
            own = getattr(train_loader, "shard", None)
            if own is None or tuple(own) != shard:
                raise ValueError(
                    f"data-parallel training (process {self.rank}/"
                    f"{self.world}) needs a per-process-sharded loader: "
                    f"construct it with DataLoader(..., shard={shard}), "
                    f"pass data= and let Trainer build it, or mark a custom "
                    f"pre-sharded iterable with loader.shard = {shard}")
        if self._group is not None:
            # padding would enter the global BN statistics and the loss's
            # batch scaling: refuse, and drop the partial last batch
            # (yolo_re_tpu/train/trainer.py:208-228)
            bs = getattr(train_loader, "batch_size", None)
            if bs is not None and bs % self.world:
                raise ValueError(
                    f"batch_size {bs} is not divisible by the {self.world} "
                    f"processes; BN statistics and loss scaling would be "
                    f"computed over zero-padding")
            if not getattr(train_loader, "drop_last", True):
                log.warning("forcing drop_last on the train loader: a "
                            "partial final batch cannot split over %d "
                            "processes", self.world)
                train_loader.drop_last = True
        if val_loader is None and data is not None and data.val_path:
            val_loader = create_dataloader(data.val_path, data, "val")
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
        self._setup_optimizer(optimizer)
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

    def _setup_optimizer(self, optimizer) -> None:
        """`self.optimizer` (as given), and the update rule's state: the
        default SGD's and a pair's in `self.opt_bufs`, a torch optimizer's
        in itself (`self._torch_opt`, `self.opt_bufs` None)."""
        self.optimizer = optimizer
        self._torch_opt = self._step_fn = None
        if optimizer is None:
            self.opt_bufs = init_sgd_state(self.params)
        elif isinstance(optimizer, (tuple, list)):
            if len(optimizer) != 2 or not all(map(callable, optimizer)):
                raise TypeError("an optimizer pair is (init_fn, step_fn)")
            init_fn, self._step_fn = optimizer
            self.opt_bufs = init_fn(self.params)
        elif callable(optimizer):
            self._torch_opt = optimizer(list(self.params.values()))
            if not isinstance(self._torch_opt, torch.optim.Optimizer):
                raise TypeError(
                    f"the optimizer factory returned "
                    f"{type(self._torch_opt).__name__}, not a "
                    f"torch.optim.Optimizer")
            self.opt_bufs = None
        else:
            raise TypeError(
                f"optimizer must be None, a callable taking the parameter "
                f"list and returning a torch.optim.Optimizer, or an "
                f"(init_fn, step_fn) pair; got {type(optimizer).__name__}")

    def _setup_data_parallel(self) -> None:
        """`self._group` (the process group the step spans, or None),
        `self.rank`, `self.world`. One process with several cards and no
        group is refused: the port runs one process per card."""
        self._group, self.rank, self.world = None, 0, 1
        if not self.config.data_parallel:
            return
        if dist.is_available() and dist.is_initialized():
            if dist.get_backend() == "nccl" and self.device.type != "cuda":
                raise ValueError("an NCCL process group needs "
                                 "device='cuda'")
            self._group = dist.group.WORLD
            self.rank, self.world = process_index(), process_count()
            log.info("data parallel: process %d of %d on %s", self.rank,
                     self.world, self.device)
        elif self.device.type == "cuda" and torch.cuda.device_count() > 1:
            raise ValueError(
                f"data_parallel over {torch.cuda.device_count()} cards "
                f"needs one process per card: start them with python -m "
                f"yolo_re_tpu_torch.cli.train --num-processes N "
                f"--coordinator HOST:PORT --process-id I (or torchrun), or "
                f"set data_parallel=False for one card")

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
        targets (the JAX step's `_step_body`, trainer.py:294-308). Data
        parallel: the draws are the global batch's on every process;
        "full" gets the global batch (`_step` gathered it) and returns
        this process's rows, True gets and returns them."""
        n = x.shape[0] * (1 if self._device_aug_full else self.world)
        draws = draws_to(self._aug_draws(self.global_step, n, x.shape[1]),
                         self.device)
        hyps = {k: v for k, v in self._device_aug.items()
                if k not in DRAW_ONLY}
        rows = None if self._group is None \
            else local_rows(n, self.rank, self.world)
        if self._device_aug_full:
            return augment_batch_full(x, t, draws, rows=rows, **hyps)
        if rows is not None:
            draws = {k: v[rows] for k, v in draws.items()}
        return augment_batch(x, t, draws, **hyps)

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

    def train_step(self, images, targets, *, augment: bool = True):
        """One optimizer step on a host batch. Returns (loss, items (3,),
        grad norm) as device tensors (no host sync). `augment=False` skips
        the configured device augmentation for this step (the JAX dry
        run's `train_step(..., augment=False)`)."""
        return self._step(*self._put_batch(images, targets), augment=augment)

    @full_f32()
    def _step(self, x: torch.Tensor, t: torch.Tensor,
              ready: torch.cuda.Event | None = None, augment: bool = True):
        """One optimizer step on a batch `_put_batch` put on the device:
        normalize (uint8: cast to the compute dtype, then / 255, as the JAX
        step does), augment (NHWC), then the forward on NCHW in
        channels_last memory. The whole step, augmentation included, runs
        with TF32 off (`utils.precision.full_f32`). Data parallel: x and t
        are this process's slice; the forward and loss run inside
        `global_batch` and the gradients are averaged over the processes
        before the clip."""
        cfg = self.config
        with span("train.step"):
            with span("train.input"):
                if ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(ready)
                x, t = self._inputs(x, t) if augment \
                    else (self._normalized(x), t)
                x = x.contiguous().permute(0, 3, 1, 2)
            with global_batch(self._group):
                with span("train.forward"):
                    preds = self.model(x, remat=self._remat)
                with span("train.loss"):
                    total, items = self.loss_fn(preds, t)
            del preds
            names = list(self.params)
            with span("train.backward"):
                grads = torch.autograd.grad(
                    total, [self.params[k] for k in names])
            if self._group is not None:
                with span("train.allreduce"):
                    grads = self._mean_over_processes(grads)
            with span("train.clip"):
                grads, gnorm = clip_by_global_norm(dict(zip(names, grads)),
                                                   cfg.grad_clip_norm)
            with span("train.update"):
                self._update(grads)
            with span("train.ema"):
                ema_update(self.ema, self.params, self.stats,
                           decay=cfg.ema_decay, tau=cfg.ema_tau)
            self.global_step += 1
        return total.detach(), items, gnorm

    @torch.no_grad()
    def _update(self, grads: dict[str, torch.Tensor]) -> None:
        """The update rule on the clipped gradients, in place."""
        if self._torch_opt is not None:
            for k, p in self.params.items():
                p.grad = grads[k]
            self._torch_opt.step()
            for p in self.params.values():
                p.grad = None
        elif self._step_fn is not None:
            new, self.opt_bufs = self._step_fn(self.params, grads,
                                               self.opt_bufs, self.global_step)
            for k, p in self.params.items():
                if new[k] is not p:
                    p.copy_(new[k])
        else:
            lr, bias_lr, momentum = self.schedule(self.global_step)
            sgd_step(self.params, grads, self.opt_bufs, self.labels, lr=lr,
                     bias_lr=bias_lr, momentum=momentum,
                     weight_decay=self.config.weight_decay)

    def _normalized(self, x: torch.Tensor) -> torch.Tensor:
        """Images in the compute dtype: uint8 is cast, then / 255, as the
        JAX step does."""
        return x.to(self.dtype) / 255.0 if x.dtype == torch.uint8 \
            else x.to(self.dtype)

    def _inputs(self, x: torch.Tensor,
                t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """A batch on the device -> NHWC images in the compute dtype,
        augmented, and their targets: uint8 is cast, then / 255, as the
        JAX step does. Data parallel with "full" augmentation: the global
        batch is gathered first (mosaic and mixup partners index it), as
        it came from the loader (uint8: 4x fewer bytes than f32), and this
        process's rows come back."""
        if self._group is not None and self._device_aug is not None \
                and self._device_aug_full:
            x = all_gather_rows(x, self._group)
            t = all_gather_rows(t, self._group)
        x = self._normalized(x)
        if self._device_aug is not None:
            x, t = self._augment(x, t)
        return x, t

    def _mean_over_processes(self, grads) -> list[torch.Tensor]:
        """The gradients averaged over the group: one all-reduce of one
        flat f32 buffer, so every process gets the same bits."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self._group)
        flat /= self.world
        return [v.view_as(g) for v, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    # -- epochs --------------------------------------------------------------

    def _prefetched(self):
        """The train loader's batches as (images, targets, ready event,
        host batch) on the device, one batch ahead: batch n + 1 is put
        before batch n is yielded (yolo_re_tpu/train/trainer.py:353-362)."""
        pending, batches = None, iter(self.train_loader)
        while True:
            with span("train.next_batch"):
                batch = next(batches, None)
                cur = None if batch is None else (
                    *self._put_batch(batch["images"], batch["targets"]),
                    batch)
            if cur is None:
                break
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
            n_images += len(batch["images"]) * self.world
            if n_batches % cfg.log_interval == 0 or n_batches == 1:
                with span("train.log"):
                    box, cls_, dfl = items.tolist()
                log.info("epoch %d step %d | box %.4f cls %.4f dfl %.4f | "
                         "%.1f img/s", epoch, self.global_step, box, cls_,
                         dfl, n_images / (time.perf_counter() - t0))
        with span("train.epoch_end"):
            mean_items = (np.zeros(3) if sum_items is None
                          else sum_items.cpu().numpy() / n_batches)
        dt = time.perf_counter() - t0
        log.info("epoch %d done in %.1fs (%.1f img/s) | box %.4f cls %.4f "
                 "dfl %.4f", epoch, dt, n_images / max(dt, 1e-9), *mean_items)
        return mean_items

    def validate(self, epoch: int = 0) -> dict[str, float]:
        """Validate on the EMA weights (reference: trainer.py:315-334),
        with per-epoch debug images (GT red / preds green) under
        output_dir/debug/. Data parallel: process 0's work, on its own
        EMA weights (the same on every process) and device, without a
        mesh; the others return {} and wait at their next collective
        (yolo_re_tpu/train/trainer.py:402-411)."""
        if self.val_loader is None or self.rank:
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
        """One JSON line per epoch in output_dir/metrics.jsonl (process 0
        alone writes); an injected optimizer owns its lr, so none is
        logged (yolo_re_tpu/train/trainer.py:461)."""
        if self.rank:
            return
        out_dir.mkdir(parents=True, exist_ok=True)
        record = {"epoch": epoch, "global_step": self.global_step,
                  "box_loss": float(items[0]), "cls_loss": float(items[1]),
                  "dfl_loss": float(items[2]),
                  **{f"val_{k}": float(v) for k, v in results.items()}}
        if self.optimizer is None:
            lr, _, momentum = self.schedule(self.global_step)
            record["lr"], record["momentum"] = float(lr), float(momentum)
        with open(out_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(record) + "\n")

    # -- checkpointing -------------------------------------------------------

    def _pytrees(self, values: dict[str, torch.Tensor]) -> tuple[dict, dict]:
        """Port tensors by state-dict name (parameters and/or BN stats;
        missing ones taken from the model) -> JAX (params, stats)."""
        sd = {**self.model.state_dict(), **values}
        return jax_from_state_dict(self.model.plan, sd)

    def _per_param(self, value) -> bool:
        """A {parameter name: tensor of the parameter's shape} dict over
        every parameter: saved as a params tree in the JAX layout."""
        return (isinstance(value, dict) and value.keys() == self.params.keys()
                and all(torch.is_tensor(v) and v.shape == self.params[k].shape
                        for k, v in value.items()))

    def _encode(self, value):
        """An update rule's state -> numpy pytree: per-parameter dicts as
        params trees (`_pytrees`), tensors and numbers as arrays."""
        if self._per_param(value):
            return self._pytrees(value)[0]
        if isinstance(value, dict):
            return {k: self._encode(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [self._encode(v) for v in value]
        if torch.is_tensor(value):
            return value.detach().cpu().numpy()
        return np.asarray(value)

    def _opt_tree(self):
        """The checkpoint's opt/ section: the default SGD's momentum
        buffers as a params tree (the layout both packages read), a pair's
        state as `_encode` writes it, a torch optimizer's per-parameter
        state by state name (opt/<state name>/...: tensors of the
        parameter's shape as a params tree, scalars such as Adam's step as
        one array in parameter order)."""
        if self._torch_opt is None:
            return self._encode(self.opt_bufs)
        names = {id(p): k for k, p in self.params.items()}
        by_state: dict[str, dict] = {}
        for p, st in self._torch_opt.state.items():
            for s, v in st.items():
                by_state.setdefault(s, {})[names[id(p)]] = v
        tree = {}
        for s, vals in by_state.items():
            if vals.keys() != self.params.keys():
                raise ValueError(f"the optimizer's state {s!r} does not cover "
                                 f"every parameter")
            if self._per_param(vals):
                tree[s] = self._pytrees(vals)[0]
            else:
                tree[s] = np.stack([np.asarray(torch.as_tensor(vals[k]).cpu())
                                    for k in self.params])
        return tree

    def save(self, path: str | Path, epoch: int = 0, *,
             format: str | None = None) -> None:
        """The full training state to `path` (.npz), or, with format
        (default: config.checkpoint_format) "orbax", to the directory named
        `path` without its suffix (train/checkpoint.py:
        save_checkpoint_dir). Process 0 alone writes; `load_checkpoint`
        reads either."""
        fmt = format or self.config.checkpoint_format
        if fmt not in ("npz", "orbax"):
            raise ValueError(f"format must be 'npz' or 'orbax', got {fmt!r}")
        if self.rank:                   # one writer per group
            return
        save = save_checkpoint
        if fmt == "orbax":
            save, path = save_checkpoint_dir, Path(path).with_suffix("")
        params, stats = self._pytrees({})
        ema_params, ema_stats = self._pytrees(
            {**self.ema["params"], **self.ema["stats"]})
        save(path, params=params, stats=stats,
             ema={"params": ema_params, "stats": ema_stats,
                  "updates": self.ema["updates"]},
             opt_bufs=self._opt_tree(), epoch=epoch,
             global_step=self.global_step, best_fitness=self.best_fitness,
             config=vars(self.config))

    _save = save                        # the JAX Trainer's name

    @torch.no_grad()
    def load_checkpoint(self, path: str | Path) -> None:
        """Full resume from a checkpoint of either package (an .npz), or
        from this package's checkpoint directory. The optimizer state
        must be the update rule's own: the default SGD's buffers, which
        both packages write, or what this package wrote for the injected
        rule; an optax state (the JAX Trainer's injected optimizer) maps
        onto no torch optimizer and raises a ValueError."""
        ckpt = load_checkpoint(path)
        plan = self.model.plan

        def to_port(params, stats) -> dict[str, torch.Tensor]:
            return state_dict_from_jax(plan, params, stats)

        self._load_opt(ckpt["opt"], ckpt["stats"])
        self.model.load_state_dict(to_port(ckpt["params"], ckpt["stats"]),
                                   strict=True)
        ema = to_port(ckpt["ema"]["params"], ckpt["ema"]["stats"])
        for dst in (self.ema["params"], self.ema["stats"]):
            for k, v in dst.items():
                v.copy_(ema[k])
        self.ema["updates"] = int(ckpt["ema"]["updates"])
        self.global_step = ckpt["global_step"]
        self.best_fitness = ckpt["best_fitness"]
        self.start_epoch = ckpt["epoch"] + 1

    def _load_opt(self, tree, stats) -> None:
        """Restore the update rule's state from a checkpoint's opt/."""
        if isinstance(tree, list) and not isinstance(self.opt_bufs,
                                                     (list, tuple)):
            raise ValueError(
                "the checkpoint's optimizer state is an optax state (the "
                "JAX Trainer's injected optimizer): it cannot map onto a "
                "torch optimizer. Resume with the JAX package, or load the "
                "weights alone (convert.load_weights)")
        try:
            if self._torch_opt is not None:
                self._load_torch_opt(tree, stats)
            else:
                self.opt_bufs = self._decode(tree, self.opt_bufs, stats)
        except (KeyError, TypeError, ValueError) as e:
            rule = ("the default SGD" if self.optimizer is None else
                    "the injected optimizer")
            raise ValueError(f"the checkpoint's optimizer state (opt/) is not "
                             f"{rule}'s: {e!r}") from e

    def _decode(self, tree, template, stats):
        """`_encode`'s inverse, shaped by `template` (the rule's current
        state): per-parameter tensors are filled in place."""
        if self._per_param(template):
            sd = state_dict_from_jax(self.model.plan, tree, stats)
            for k, v in template.items():
                v.copy_(sd[k])
            return template
        if isinstance(template, dict):
            if not isinstance(tree, dict) or tree.keys() != template.keys():
                raise KeyError(f"state keys {sorted(template)}")
            return {k: self._decode(tree[k], v, stats)
                    for k, v in template.items()}
        if isinstance(template, (list, tuple)):
            return type(template)(self._decode(a, b, stats)
                                  for a, b in zip(tree, template, strict=True))
        if torch.is_tensor(template):
            return torch.as_tensor(np.asarray(tree), dtype=template.dtype,
                                   device=template.device)
        return type(template)(np.asarray(tree))

    def _load_torch_opt(self, tree, stats) -> None:
        """`_opt_tree`'s inverse for a torch optimizer, through its
        `load_state_dict` (which puts each state where its parameter is)."""
        layers = {step.name for step in self.model.plan.steps}
        if not isinstance(tree, dict) or layers & tree.keys():
            raise ValueError("it holds the default SGD's momentum buffers")
        state: dict[str, dict] = {k: {} for k in self.params}
        for s, sub in tree.items():
            if isinstance(sub, dict):
                sd = state_dict_from_jax(self.model.plan, sub, stats)
                for k in self.params:
                    state[k][s] = sd[k]
            elif np.shape(sub) == (len(self.params),):
                for k, v in zip(self.params, sub):
                    state[k][s] = torch.tensor(v)
            else:
                raise ValueError(f"state {s!r} has shape {np.shape(sub)}")
        names = {id(p): k for k, p in self.params.items()}
        order = [names[id(p)] for g in self._torch_opt.param_groups
                 for p in g["params"]]
        sd = self._torch_opt.state_dict()
        sd["state"] = {i: state[k] for i, k in enumerate(order) if state[k]}
        self._torch_opt.load_state_dict(sd)
