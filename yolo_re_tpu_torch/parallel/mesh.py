"""Data parallelism over torch.distributed (counterpart of
yolo_re_tpu/parallel/mesh.py).

Two forms, as in the JAX package:

- Training: one process per card (`init_distributed`), each with its
  slice of every global batch (the loader's `shard=`). Inside
  `global_batch(group)` the train-mode reductions over the batch, the BN
  moments (ops/conv.py) and the loss's target-score sum (loss/tal.py),
  span every process, as XLA's sharded reductions span the mesh; the
  Trainer all-reduces the gradients after the backward. Every process
  then holds the same parameters, BN statistics, optimizer state and EMA.
- Serving and eval: one process and a `Mesh` of local devices. A batch is
  padded to a multiple of the mesh's size (`pad_batch_to`), split, run on
  one replica of the fused model per device, and the outputs are gathered
  on the first device with the padding sliced off.

Nothing here talks to another host except through the process group.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import datetime
import os
from collections.abc import Callable, Iterator, Sequence
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

# the process group's timeout: a collective waits this long for its peers,
# so it covers a validation pass that process 0 alone runs between two
# steps (Trainer.validate)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: str | torch.device = "cuda",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> tuple[int, int]:
    """Join the training process group, once per process, before the
    Trainer is built. Returns (rank, world size).

    The rendezvous is `tcp://coordinator_address` (host:port, where
    process 0 listens) with `num_processes` and this `process_id`, or,
    without a coordinator, torchrun's environment (`env://`: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE), as the JAX package reads
    JAX_COORDINATOR_ADDRESS. With neither nothing is joined and (0, 1) is
    returned. The backend follows `device`: NCCL for "cuda" (the process
    takes card LOCAL_RANK, or process_id modulo the card count), gloo for
    "cpu"; there is no fallback from one to the other.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and num_processes is None \
            and process_id is None and not env:
        return 0, 1
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        init_method = f"tcp://{coordinator_address}"
        rank, world = process_id, num_processes
    elif env:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if process_id is None else process_id
        world = int(os.environ["WORLD_SIZE"]) if num_processes is None \
            else num_processes
    else:
        raise ValueError(
            "num_processes / process_id need a coordinator address "
            "(host:port of process 0), or torchrun's environment")
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} not in [0, {world})")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): no CUDA "
                               "device")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed(device='cuda'): this "
                               "PyTorch has no NCCL")
        backend = "nccl"
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for {device}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    return rank, world


def process_index() -> int:
    """This process's rank in the training group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The training group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rows(batch_size: int, index: int, count: int) -> slice:
    """Rows of process `index`'s slice of a global batch of `batch_size`
    split over `count` processes, in order. A batch that does not divide
    is refused: training never pads (see `pad_batch_to`)."""
    if not 0 <= index < count:
        raise ValueError(f"shard index {index} not in [0, {count})")
    if batch_size % count:
        raise ValueError(f"global batch_size {batch_size} is not divisible "
                         f"by {count} processes")
    n = batch_size // count
    return slice(index * n, (index + 1) * n)


# -- collectives over the training group ------------------------------------

_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "batch_group", default=None)


@contextlib.contextmanager
def global_batch(group: Any) -> Iterator[None]:
    """Within the block, the train-mode reductions over the batch (BN
    moments, the loss's target-score sum and batch size) span `group`'s
    processes, each holding its slice of the global batch. None: the
    batch is this process's alone."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_group() -> Any:
    """The group `global_batch` set, or None."""
    return _BATCH_GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's processes; the gradient of every process's
    input is the sum of all processes' output gradients (each process's
    loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Differentiable sum of `x` over `group`'s processes."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Every process's `x` (the same shape on each), concatenated along
    dim 0 in rank order: this process's slice of a global batch -> the
    global batch."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


# -- a mesh of local devices (serving and eval) ------------------------------

@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh of this process's devices: a batch is split
    over them in order. A device may repeat (two replicas on one card)."""

    devices: tuple[torch.device, ...]

    def __post_init__(self) -> None:
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None,
              devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """A mesh of `devices`, by default every local card (the first
    `n_devices` of them)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): no CUDA device (pass devices=, "
                               "for example ('cpu', 'cpu'))")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(tuple(devices))


def device_context(device: torch.device):
    """`torch.cuda.device(device)` for a card (the kernels launch on the
    current device's current stream), nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate(module: torch.nn.Module, mesh: Mesh) -> list[torch.nn.Module]:
    """One copy of `module` (on mesh.devices[0]) per mesh device: itself
    first, then deep copies moved by `.to(device)`, which moves the fused
    blocks' packed weights (non-persistent buffers) too."""
    return [module] + [copy.deepcopy(module).to(d) for d in mesh.devices[1:]]


def pad_batch_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """x with its batch axis padded up to `size` with zeros (divisibility
    for a mesh).

    For INFERENCE paths only (serving/eval): BN is frozen there and padded
    rows are sliced off the results. Training must never see padded rows:
    they would enter the global BN batch statistics and the loss's
    `* batch_size` scaling; the Trainer refuses a batch that does not
    divide (and the sharded loader drops the partial last batch) instead.
    """
    if x.shape[0] == size:
        return x
    return torch.cat([x, x.new_zeros((size - x.shape[0], *x.shape[1:]))])


def split_batch(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """x padded to a multiple of the mesh's size and split into one equal
    part per device (still on x's device)."""
    per = -(-x.shape[0] // mesh.size)
    return list(pad_batch_to(x, per * mesh.size).split(per))


def gather_rows(outs: list[dict[str, torch.Tensor]], device: torch.device,
                rows: int) -> dict[str, torch.Tensor]:
    """The replicas' output dicts concatenated along dim 0 on `device`,
    the padding (every row from `rows` on) sliced off."""
    return {k: torch.cat([o[k].to(device) for o in outs])[:rows]
            for k in outs[0]}


def run_replicas(fn: Callable[[Any, torch.Tensor, torch.device],
                              dict[str, torch.Tensor]],
                 replicas: Sequence[Any], mesh: Mesh,
                 x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Serving's and eval's data parallelism: x (a batch on the host)
    padded and split over the mesh, fn(replica, part, device) run for each
    device under its context (the kernels launch on the current device's
    current stream), the output dicts gathered on the first device with
    the padding sliced off."""
    outs = []
    for replica, dev, part in zip(replicas, mesh.devices,
                                  split_batch(x, mesh)):
        with device_context(dev):
            outs.append(fn(replica, part, dev))
    with device_context(mesh.devices[0]):
        return gather_rows(outs, mesh.devices[0], x.shape[0])
