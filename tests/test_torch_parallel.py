"""The port's data parallelism (yolo_re_tpu_torch/parallel/mesh.py) on the
CPU: two gloo processes on 127.0.0.1 against one process of the port, and
through it against the JAX package.

One launch of two worker processes (a script written from `WORKER`, which
imports neither jax nor yolo_re_tpu: both are blocked) carries the
multi-process checks: global BN moments and their gradient, the loss's
scale (`TALoss.forward` and `forward_dual`), a data-parallel Trainer epoch
(custom sharded loader), sharded device augmentation ("full") and its
epoch (`data=`, the loader's `shard=`), a data-parallel epoch with
remat="early", and the refusals; a second launch runs part 1 again, as a
test process that takes the file over from a lost one would launch it
all again. The ranks run on one torch thread each. Each rank writes
what it computed to an .npz; the tests below hold it against the
single-process port and against the JAX package on the whole batch
(`conv_bn_act`, `TALoss`, the JAX Trainer's step from the same init on
the same global batches; the JAX package's own tests/test_parallel.py
holds its data parallelism equal to that), both computed here. The mesh
Detector and Evaluator run in this process on a mesh of two CPU
"devices", against the single-device port and the JAX Detector and
Evaluator; the loader's `shard=` is held byte for byte against the JAX
DataLoader's; the CLIs run in subprocesses with jax blocked.
"""

import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.data.config import DataConfig as JDataConfig
from yolo_re_tpu.data.dataset import create_dataloader as jcreate_dataloader
from yolo_re_tpu.eval.evaluator import Evaluator as JEvaluator
from yolo_re_tpu.loss.tal import TALoss as JTALoss
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.ops.conv import conv_bn_act as jconv_bn_act
from yolo_re_tpu.serving import Detector as JDetector
from yolo_re_tpu.train.checkpoint import load_weights as jload_weights
from yolo_re_tpu.train.config import TrainConfig as JTrainConfig
from yolo_re_tpu.train.trainer import Trainer as JTrainer
from yolo_re_tpu_torch.convert import jax_from_state_dict, load_weights, \
    state_dict_from_jax
from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
from yolo_re_tpu_torch.data.dataset import create_dataloader
from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch, \
    write_dataset
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.loss.tal import TALoss
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.conv import batch_moments, batch_norm
from yolo_re_tpu_torch.parallel import mesh
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "assets" / "dryrun_tiny.npz"
WORLD = 2
# global batch and steps of the Trainer epochs; TINY_YAML at 64 px, f32
BATCH, STEPS, SIZE = 8, 2, 64
# every communicate / join / process-group init of a launch
TIMEOUT_S = 120
# tests/test_parallel.py:113-158: 1 process against N processes
ITEMS_RTOL = 2e-3
PARAM_RTOL, PARAM_ATOL = 5e-3, 3e-4
# global moments: f32 sums in another order (two passes, rtol 1e-6 as
# the f32 BN of the JAX package); bf16 one pass over the same bf16
# values (f32 sums), its dx through bf16 activations: one bf16 ulp of
# |ref| (2^-7, tests/test_torch_augment.py's BF16_RTOL)
MOMENT_RTOL = {"f32": 1e-6, "bf16": 1e-5}
DX_RTOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
# the loss's gradient over 2 processes against 1 (f32 sums in another
# order)
LOSS_RTOL = 1e-5
# the mesh Detector against the single one (tests/test_parallel.py:83-110)
DET_ATOL = 1e-4
MAP_ATOL = 1e-6
# against the JAX package on the whole batch: the port's TALoss gradient
# (tests/test_torch_train.py::test_tal_loss_and_grads_match_jax), the
# Detector (tests/test_torch_serving.py), the Evaluator's mAP
# (tests/test_torch_eval.py)
JAX_GRAD_RTOL, JAX_GRAD_ATOL = 1e-4, 1e-6
JAX_BOX_ATOL, JAX_SCORE_ATOL = 1e-3, 1e-5
JAX_MAP_ATOL = 5e-3
# the loss test's shared "parameters": pred = feat * a + b
THETA = {"box_a": 1.1, "box_b": 0.1, "cls_a": 0.9, "cls_b": -0.2}
LOSS_B, LOSS_NC, LOSS_REG, LOSS_STRIDES = 4, 4, 16, (8, 16, 32)

WORKER = r'''
import sys
import time
for m in ("jax", "jaxlib", "yolo_re_tpu"):
    sys.modules[m] = None
START = time.monotonic()
import datetime
import json
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
from yolo_re_tpu_torch.data.device_pipeline import augment_batch_full, \
    draws_to, DRAW_ONLY
from yolo_re_tpu_torch.loss.tal import TALoss
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.conv import batch_moments, batch_norm
from yolo_re_tpu_torch.parallel import mesh
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

rank, world, port = (int(a) for a in sys.argv[1:4])
root = Path(sys.argv[4])
# "moments": part 1 only
only_moments = sys.argv[5:] == ["moments"]


def done(part):
    """A progress line on stderr: a launch that runs out of time shows
    each rank's last part and when it ended."""
    print(f"rank {rank}: {part} done at {time.monotonic() - START:.1f} s",
          file=sys.stderr, flush=True)


done("imports")
got = mesh.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                            timeout=datetime.timedelta(seconds=60))
assert got == (rank, world) == (mesh.process_index(), mesh.process_count())
done("init_distributed")
group = dist.group.WORLD
inp = dict(np.load(root / "inputs.npz"))
spec = json.loads((root / "spec.json").read_text())
# the JAX package's init of TINY_YAML (numpy trees)
init = pickle.loads((root / "init.pkl").read_bytes())
out = {"threads": np.array(torch.get_num_threads())}


def mine(a):
    return a[mesh.local_rows(len(a), rank, world)]


# 1. global BN moments, dx through a seeded upstream gradient, running stats
for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    y = torch.from_numpy(mine(inp["y"])).to(dtype).requires_grad_()
    bn = torch.nn.BatchNorm2d(y.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn_w"]))
        bn.bias.copy_(torch.from_numpy(inp["bn_b"]))
    with mesh.global_batch(group):
        mean, var = batch_moments(y)
        z = batch_norm(y, bn)
    (z.float() * torch.from_numpy(mine(inp["g"]))).sum().backward()
    out[f"{tag}_z"] = z.detach().float().numpy()
    out[f"{tag}_mean"] = mean.detach().numpy()
    out[f"{tag}_var"] = var.detach().numpy()
    out[f"{tag}_dx"] = y.grad.float().numpy()
    out[f"{tag}_running"] = np.stack([bn.running_mean.numpy(),
                                      bn.running_var.numpy()])
done("1. moments")
if only_moments:
    np.savez(root / f"rank{rank}.npz", **out)
    dist.destroy_process_group()
    sys.exit()

# 2. the loss's scale: the gradient of shared parameters averaged over the
# processes, and of this process's predictions
loss_fn = TALoss(spec["nc"], spec["reg"], spec["strides"])
for kind in ("single", "dual"):
    theta = {k: torch.tensor(v, requires_grad=True)
             for k, v in spec["theta"].items()}
    leaves = []

    def branch(prefix):
        pairs = []
        for i in range(3):
            fb = torch.from_numpy(mine(inp[f"{prefix}box{i}"])).requires_grad_()
            fc = torch.from_numpy(mine(inp[f"{prefix}cls{i}"])).requires_grad_()
            leaves.extend([fb, fc])
            pairs.append((fb * theta["box_a"] + theta["box_b"],
                          fc * theta["cls_a"] + theta["cls_b"]))
        return pairs

    preds = branch("main") if kind == "single" else \
        {"aux": branch("aux"), "main": branch("main")}
    with mesh.global_batch(group):
        total, items = loss_fn(preds, torch.from_numpy(mine(inp["targets"])))
    total.backward()
    g = torch.stack([theta[k].grad for k in sorted(theta)])
    dist.all_reduce(g)
    out[f"{kind}_theta_grad"] = (g / world).numpy()
    out[f"{kind}_items"] = items.numpy()
    for i, leaf in enumerate(leaves):
        out[f"{kind}_feat_grad{i}"] = leaf.grad.numpy()
done("2. loss")


class Sharded(list):
    """A custom loader of this process's slices, marked as such."""


def sharded(batches, batch_size=None):
    loader = Sharded({"images": mine(b["images"]),
                      "targets": mine(b["targets"])} for b in batches)
    loader.shard = (rank, world)
    if batch_size is not None:
        loader.batch_size = batch_size
    return loader


def state(prefix, trainer):
    for k, v in {**trainer.params, **trainer.stats}.items():
        out[f"{prefix}/{k}"] = v.detach().numpy()


# 3. a data-parallel epoch from a custom loader; only process 0 writes
batches = [{"images": inp[f"images{s}"], "targets": inp[f"targets{s}"]}
           for s in range(spec["steps"])]
tiny = str(root / "tiny.yaml")
cfg = TrainConfig(epochs=1, data_parallel=True, log_interval=1,
                  output_dir=str(root / f"ddp{rank}"))
trainer = Trainer(YOLO.from_yaml(tiny), config=cfg, device="cpu",
                  train_loader=sharded(batches, spec["batch"]), **init)
trainer.train()
state("ddp", trainer)
done("3. ddp epoch")

# refusals: a global batch the processes cannot split, an unsharded loader
refused = []
for loader in (sharded(batches, 2 * world + 1),
               [{"images": b["images"], "targets": b["targets"]}
                for b in batches]):
    try:
        Trainer(YOLO.from_yaml(tiny), config=cfg, device="cpu",
                train_loader=loader)
        refused.append("")
    except ValueError as e:
        refused.append(str(e))
(root / f"refused{rank}.json").write_text(json.dumps(refused))

# 4. device_augment="full" from disk: the loader's shard=, this process's
# augmented rows of the first batch, the same draws applied to the
# gathered batch unsharded, then the epoch
data = DataConfig(train_path=spec["train"], img_size=spec["size"],
                  batch_size=spec["batch"], workers=2, max_boxes=16,
                  augment=AugmentConfig("full", mixup=0.5))
cfg = TrainConfig(epochs=1, data_parallel=True, device_augment="full",
                  log_interval=1, output_dir=str(root / f"aug{rank}"))
trainer = Trainer(YOLO.from_yaml(tiny), data=data, config=cfg, device="cpu",
                  **init)
assert trainer.train_loader.shard == (rank, world)
first = next(iter(trainer.train_loader))
x, t, _ = trainer._put_batch(first["images"], first["targets"])
xa, ta = trainer._inputs(x, t)
out["aug_images"], out["aug_targets"] = xa.numpy(), ta.numpy()
xg, tg = mesh.all_gather_rows(x, group), mesh.all_gather_rows(t, group)
draws = draws_to(trainer._aug_draws(0, xg.shape[0], xg.shape[1]), "cpu")
hyps = {k: v for k, v in trainer._device_aug.items() if k not in DRAW_ONLY}
xf, tf = augment_batch_full(xg.to(torch.float32) / 255.0, tg, draws, **hyps)
out["aug_full_images"], out["aug_full_targets"] = xf.numpy(), tf.numpy()
out["aug_loader_images"] = first["images"]
# the epoch, with every step's augmented rows kept
inputs = trainer._inputs


def recorded(x, t):
    xa, ta = inputs(x, t)
    s = trainer.global_step
    out[f"aug_step{s}_images"], out[f"aug_step{s}_targets"] = \
        xa.numpy().copy(), ta.numpy().copy()
    return xa, ta


trainer._inputs = recorded
trainer.train()
state("aug", trainer)
done("4. aug epoch")

# 5. remat="early": the blocks recomputed in the backward take the global
# batch's BN moments too (the group is captured at the forward)
cfg = TrainConfig(epochs=1, data_parallel=True, remat="early",
                  log_interval=1, output_dir=str(root / f"remat{rank}"))
trainer = Trainer(YOLO.from_yaml(tiny), config=cfg, device="cpu",
                  train_loader=sharded(batches, spec["batch"]), **init)
trainer.train()
state("remat", trainer)
done("5. remat epoch")

np.savez(root / f"rank{rank}.npz", **out)
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argvs: list[list[str]]) -> list[str]:
    """Start one process per argv (cwd the repo), wait for all within
    TIMEOUT_S, and return their stdouts. A timeout or a failure fails the
    test with every process's stderr tail; nothing is retried."""
    # one torch thread a process: a rank's tensors are small, and a
    # second thread only adds a wait at every parallel op, between the
    # step's ~300 small collectives. Alone that costs nothing, but on a
    # loaded machine each wait stretches: beside busy processes the ddp
    # launch took twice as long with two threads, and ran out of
    # TIMEOUT_S where one thread passed
    path = [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(path)}
    procs = [subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for argv in argvs]
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate(timeout=10)[1][-2000:] for p in procs]
        pytest.fail(f"processes did not finish within {TIMEOUT_S} s: "
                    + "\n---\n".join(tails))
    failed = [(i, e[-3000:]) for i, (p, (_, e)) in
              enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, failed
    return [o for o, _ in outs]


def _loss_inputs(rng) -> dict[str, np.ndarray]:
    b, nc, reg = LOSS_B, LOSS_NC, LOSS_REG
    out = {}
    for prefix in ("main", "aux"):
        for i, s in enumerate(LOSS_STRIDES):
            hw = SIZE // s
            out[f"{prefix}box{i}"] = rng.standard_normal(
                (b, 4 * reg, hw, hw)).astype(np.float32)
            out[f"{prefix}cls{i}"] = rng.standard_normal(
                (b, nc, hw, hw)).astype(np.float32) - 2.0
    targets = np.zeros((b, 6, 5), np.float32)
    for i in range(b):
        for j in range(1 + i % 4):
            targets[i, j] = [rng.integers(0, nc), *rng.uniform(0.3, 0.7, 2),
                             *rng.uniform(0.1, 0.4, 2)]
    out["targets"] = targets
    return out


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


@pytest.fixture(scope="module")
def init(tiny_yaml):
    """The state every Trainer here (the port's on one and two processes,
    the JAX package's) starts from: TINY_YAML drawn by the port's init
    (the JAX package's scheme) from seed 0, as the JAX package's
    {"params", "stats"} numpy trees."""
    model = YOLO.from_yaml(tiny_yaml)
    model.init_parameters(torch.Generator().manual_seed(0))
    params, stats = jax_from_state_dict(model.plan, model.state_dict())
    return {"params": params, "stats": stats}


@pytest.fixture(scope="module")
def ddp(tmp_path_factory, tiny_yaml, init):
    """One launch of WORLD gloo processes; returns (root, the inputs, each
    rank's results, the spec)."""
    root = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(0)
    inp = {"y": (rng.standard_normal((4, 8, 6, 6))
                 + rng.uniform(-1, 1, (1, 8, 1, 1))).astype(np.float32),
           "g": rng.standard_normal((4, 8, 6, 6)).astype(np.float32),
           "bn_w": rng.uniform(0.5, 1.5, 8).astype(np.float32),
           "bn_b": rng.standard_normal(8).astype(np.float32),
           **_loss_inputs(rng)}
    for s in range(STEPS):
        b = make_eval_batch(BATCH, SIZE, seed=10 + s)
        inp[f"images{s}"], inp[f"targets{s}"] = b["images"], b["targets"]
    np.savez(root / "inputs.npz", **inp)
    (root / "init.pkl").write_bytes(pickle.dumps(init))
    (root / "tiny.yaml").write_text(TINY_YAML)
    spec = {"nc": LOSS_NC, "reg": LOSS_REG, "strides": list(LOSS_STRIDES),
            "theta": THETA, "steps": STEPS, "batch": BATCH, "size": SIZE,
            "train": write_dataset(str(root / "data"), "train",
                                   BATCH * STEPS, seed=5)}
    (root / "spec.json").write_text(json.dumps(spec))
    (root / "worker.py").write_text(WORKER)
    return root, inp, _launch(root), spec


def _launch(root: Path, *mode: str) -> list[dict[str, np.ndarray]]:
    """WORLD processes of root's worker.py on a fresh port; each rank's
    results."""
    port = _free_port()
    _run_ranks([[sys.executable, str(root / "worker.py"), str(r), str(WORLD),
                 str(port), str(root), *mode] for r in range(WORLD)])
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]


def _rows(a, r):
    return a[mesh.local_rows(len(a), r, WORLD)]


def test_second_launch_equals_the_first(ddp, tmp_path):
    """The launch again, as a test process that takes the module over
    from a lost one makes it: in a fresh directory, on a fresh port, part
    1 (the global BN moments) gives every rank the first launch's arrays
    bit for bit, and both launches ran their ranks on one torch thread."""
    root, _, ranks, _ = ddp
    for name in ("worker.py", "inputs.npz", "spec.json", "init.pkl"):
        shutil.copy(root / name, tmp_path / name)
    again = _launch(tmp_path, "moments")
    for first, second in zip(ranks, again):
        assert int(first["threads"]) == int(second["threads"]) == 1
        keys = sorted(set(second) - {"threads"})
        # f32 and bf16: z, mean, var, dx, running stats
        assert len(keys) == 10
        for k in keys:
            np.testing.assert_array_equal(second[k], first[k], err_msg=k)


# ---------------------------------------------------------------------------
# global BN moments and the loss's scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_global_moments_equal_one_process(ddp, tag):
    """batch_moments inside global_batch on two halves: the whole batch's
    mean and var on both ranks, dx equal to the one-process dx rows, the
    running stats the same on every rank and equal to one process's."""
    _, inp, ranks, _ = ddp
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[tag]
    y = torch.from_numpy(inp["y"]).to(dtype).requires_grad_()
    bn = torch.nn.BatchNorm2d(8).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn_w"]))
        bn.bias.copy_(torch.from_numpy(inp["bn_b"]))
    mean, var = batch_moments(y)
    (batch_norm(y, bn).float() * torch.from_numpy(inp["g"])).sum().backward()
    running = np.stack([bn.running_mean.numpy(), bn.running_var.numpy()])
    rtol = MOMENT_RTOL[tag]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{tag}_mean"], mean.detach().numpy(),
                                   rtol=rtol, atol=rtol)
        np.testing.assert_allclose(got[f"{tag}_var"], var.detach().numpy(),
                                   rtol=rtol)
        np.testing.assert_allclose(got[f"{tag}_running"], running,
                                   rtol=rtol, atol=rtol)
        dx = _rows(y.grad.float().numpy(), r)
        np.testing.assert_allclose(got[f"{tag}_dx"], dx, rtol=DX_RTOL[tag],
                                   atol=DX_RTOL[tag] * np.abs(dx).max())
    np.testing.assert_array_equal(ranks[0][f"{tag}_running"],
                                  ranks[1][f"{tag}_running"])


@pytest.mark.parametrize("kind", ["single", "dual"])
def test_loss_scale_gives_the_one_process_gradient(ddp, kind):
    """TALoss inside global_batch: the parameters' gradient averaged over
    the two processes, each process's prediction gradient over the world
    size, and the items equal one process's on the whole batch."""
    _, inp, ranks, _ = ddp
    theta = {k: torch.tensor(v, requires_grad=True) for k, v in THETA.items()}
    leaves = []

    def branch(prefix):
        pairs = []
        for i in range(3):
            fb = torch.from_numpy(inp[f"{prefix}box{i}"]).requires_grad_()
            fc = torch.from_numpy(inp[f"{prefix}cls{i}"]).requires_grad_()
            leaves.extend([fb, fc])
            pairs.append((fb * theta["box_a"] + theta["box_b"],
                          fc * theta["cls_a"] + theta["cls_b"]))
        return pairs

    preds = branch("main") if kind == "single" else \
        {"aux": branch("aux"), "main": branch("main")}
    total, items = TALoss(LOSS_NC, LOSS_REG, LOSS_STRIDES)(
        preds, torch.from_numpy(inp["targets"]))
    total.backward()
    grad = torch.stack([theta[k].grad for k in sorted(theta)]).numpy()
    assert np.abs(grad).min() > 0
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{kind}_theta_grad"], grad,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[f"{kind}_items"], items.numpy(),
                                   rtol=LOSS_RTOL)
        for i, leaf in enumerate(leaves):
            ref = _rows(leaf.grad.numpy(), r)
            np.testing.assert_allclose(
                got[f"{kind}_feat_grad{i}"] / WORLD, ref, rtol=LOSS_RTOL,
                atol=LOSS_RTOL * np.abs(ref).max())


def _nhwc(a: np.ndarray) -> jax.Array:
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _nchw(a) -> np.ndarray:
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_global_moments_match_jax(ddp, tag):
    """Each rank's BN output, dx and running stats against the JAX
    package's train-mode conv_bn_act on the whole batch (a 1x1 identity
    conv, exact in either dtype, then BN without an activation)."""
    _, inp, ranks, _ = ddp
    c = inp["y"].shape[1]
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[tag]
    params = {"w": jnp.eye(c, dtype=dtype)[None, None],
              "scale": jnp.asarray(inp["bn_w"]),
              "bias": jnp.asarray(inp["bn_b"])}
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    z, vjp, new = jax.vjp(
        lambda x: jconv_bn_act(params, stats, x, act="none", train=True),
        _nhwc(inp["y"]).astype(dtype), has_aux=True)
    (dx,) = vjp(_nhwc(inp["g"]).astype(dtype))
    running = np.stack([np.asarray(new["mean"]), np.asarray(new["var"])])
    rtol = DX_RTOL[tag]
    for r, got in enumerate(ranks):
        for key, ref in (("z", _rows(_nchw(z), r)),
                         ("dx", _rows(_nchw(dx), r))):
            np.testing.assert_allclose(got[f"{tag}_{key}"], ref, rtol=rtol,
                                       atol=rtol * np.abs(ref).max(),
                                       err_msg=key)
        np.testing.assert_allclose(got[f"{tag}_running"], running,
                                   rtol=MOMENT_RTOL[tag],
                                   atol=MOMENT_RTOL[tag])


@pytest.mark.parametrize("kind", ["single", "dual"])
def test_loss_scale_matches_jax(ddp, kind):
    """The parameters' gradient averaged over the two processes, each
    process's prediction gradient over the world size, and the items
    against the JAX TALoss on the whole batch."""
    _, inp, ranks, _ = ddp
    # the worker's order of the leaves: aux's before main's
    order = ("main",) if kind == "single" else ("aux", "main")
    feats = {k: [(_nhwc(inp[f"{k}box{i}"]), _nhwc(inp[f"{k}cls{i}"]))
                 for i in range(3)] for k in order}
    jloss = JTALoss(LOSS_NC, LOSS_REG, LOSS_STRIDES)

    def objective(theta, feats):
        preds = {k: [(fb * theta["box_a"] + theta["box_b"],
                      fc * theta["cls_a"] + theta["cls_b"]) for fb, fc in v]
                 for k, v in feats.items()}
        return jloss(preds["main"] if kind == "single" else preds,
                     jnp.asarray(inp["targets"]))

    theta = {k: jnp.float32(v) for k, v in THETA.items()}
    (_, items), (gtheta, gfeats) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(theta, feats)
    grad = np.array([gtheta[k] for k in sorted(THETA)])
    leaves = [g for k in order for pair in gfeats[k] for g in pair]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{kind}_theta_grad"], grad,
                                   rtol=JAX_GRAD_RTOL, atol=JAX_GRAD_ATOL)
        np.testing.assert_allclose(got[f"{kind}_items"], np.asarray(items),
                                   rtol=LOSS_RTOL)
        for i, g in enumerate(leaves):
            np.testing.assert_allclose(
                got[f"{kind}_feat_grad{i}"] / WORLD, _rows(_nchw(g), r),
                rtol=JAX_GRAD_RTOL, atol=JAX_GRAD_ATOL, err_msg=str(i))


# ---------------------------------------------------------------------------
# the data-parallel Trainer
# ---------------------------------------------------------------------------

def _assert_state_close(ranks, prefix, trainer):
    ref = {k: v.detach().numpy()
           for k, v in {**trainer.params, **trainer.stats}.items()}
    for got in ranks:
        for k, v in ref.items():
            np.testing.assert_allclose(got[f"{prefix}/{k}"], v,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)
    # every process holds the same state, bit for bit
    for k in ref:
        np.testing.assert_array_equal(ranks[0][f"{prefix}/{k}"],
                                      ranks[1][f"{prefix}/{k}"], err_msg=k)


def _metrics(path: Path) -> np.ndarray:
    record = json.loads(path.read_text().splitlines()[-1])
    return np.array([record[k] for k in ("box_loss", "cls_loss",
                                         "dfl_loss")])


def _global_batches(inp) -> list[dict[str, np.ndarray]]:
    return [{"images": inp[f"images{s}"], "targets": inp[f"targets{s}"]}
            for s in range(STEPS)]


@pytest.fixture(scope="module")
def jax_epochs(ddp, tiny_yaml, init, tmp_path_factory):
    """The JAX Trainer (one device, the default schedule) stepped from
    `init` over the global batches of each worker epoch: "ddp", the
    custom loader's uint8 batches; "aug", the augmented global batches
    (the ranks' rows in order, float images: the JAX step only casts
    them). Returns {name: (port state dict, mean loss items)}; one jitted
    step serves both (the same config and epoch length)."""
    _, inp, ranks, _ = ddp
    aug = [{key: np.concatenate([got[f"aug_step{s}_{key}"] for got in ranks])
            for key in ("images", "targets")} for s in range(STEPS)]
    plan = YOLO.from_yaml(tiny_yaml).plan
    out_dir = tmp_path_factory.mktemp("jax")
    step, results = None, {}
    for name, batches in (("ddp", _global_batches(inp)), ("aug", aug)):
        jt = JTrainer(JYOLO.from_yaml(tiny_yaml),
                      config=JTrainConfig(epochs=1, data_parallel=False,
                                          output_dir=str(out_dir)),
                      train_loader=batches, **init)
        step = jt._train_step = step or jt._train_step
        items = []
        for s, b in enumerate(batches):
            (jt.params, jt.stats, jt.opt_bufs, jt.ema, _, it, _) = step(
                jt.params, jt.stats, jt.opt_bufs, jt.ema,
                jnp.asarray(b["images"]), jnp.asarray(b["targets"]),
                np.int32(s))
            items.append(np.asarray(it))
        sd = state_dict_from_jax(plan, *jax.device_get((jt.params,
                                                        jt.stats)))
        results[name] = ({k: v.numpy() for k, v in sd.items()},
                         np.mean(items, axis=0))
    return results


def _assert_state_matches_jax(ranks, prefix, ref):
    keys = [k.split("/", 1)[1] for k in ranks[0]
            if k.startswith(prefix + "/")]
    assert len(keys) > 50
    for got in ranks:
        for k in keys:
            np.testing.assert_allclose(got[f"{prefix}/{k}"], ref[k],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("epoch", ["ddp", "aug"])
def test_data_parallel_epoch_matches_jax(ddp, jax_epochs, epoch):
    """Both ranks' parameters and BN statistics after the two-process
    epoch (ddp: the custom sharded loader; aug: data= with
    device_augment="full"), and process 0's logged loss items, against
    the JAX Trainer's steps from the same init on the same global batches
    (tests/test_parallel.py's tolerances)."""
    root, _, ranks, _ = ddp
    ref, items = jax_epochs[epoch]
    _assert_state_matches_jax(ranks, epoch, ref)
    np.testing.assert_allclose(_metrics(root / f"{epoch}0" / "metrics.jsonl"),
                               items, rtol=ITEMS_RTOL)


def test_data_parallel_epoch_matches_one_process(ddp, tiny_yaml, init,
                                                 tmp_path):
    """Trainer(data_parallel=True) on two processes, each with its slice
    of two global batches of 8, against the one-process port Trainer from
    the same init and batches (tests/test_parallel.py's tolerances)."""
    root, inp, ranks, _ = ddp
    batches = _global_batches(inp)
    cfg = TrainConfig(epochs=1, data_parallel=True, log_interval=1,
                      output_dir=str(tmp_path))
    one = Trainer(YOLO.from_yaml(tiny_yaml), config=cfg, device="cpu",
                  train_loader=batches, **init)
    assert one._group is None and one.world == 1
    one.train()
    _assert_state_close(ranks, "ddp", one)
    np.testing.assert_allclose(_metrics(root / "ddp0" / "metrics.jsonl"),
                               _metrics(tmp_path / "metrics.jsonl"),
                               rtol=ITEMS_RTOL)


def test_data_parallel_remat_matches_one_process(ddp, tiny_yaml, init,
                                                tmp_path):
    """Trainer(data_parallel=True, remat="early") on two processes
    against the one-process port Trainer without remat from the same
    init and batches (tests/test_parallel.py's tolerances): the backward
    recomputes the early blocks with the global batch's BN moments and
    leaves the running statistics as the forward set them."""
    root, inp, ranks, _ = ddp
    cfg = TrainConfig(epochs=1, data_parallel=True, log_interval=1,
                      output_dir=str(tmp_path))
    one = Trainer(YOLO.from_yaml(tiny_yaml), config=cfg, device="cpu",
                  train_loader=_global_batches(inp), **init)
    one.train()
    _assert_state_close(ranks, "remat", one)
    np.testing.assert_allclose(
        _metrics(root / "remat0" / "metrics.jsonl"),
        _metrics(tmp_path / "metrics.jsonl"), rtol=ITEMS_RTOL)
    assert not (root / "remat1").exists()


def test_only_process_zero_writes(ddp):
    root = ddp[0]
    assert {p.name for p in (root / "ddp0").iterdir()} == \
        {"last.npz", "metrics.jsonl"}
    assert not (root / "ddp1").exists() and not (root / "aug1").exists()
    assert (root / "aug0" / "last.npz").exists()


def test_several_cards_without_a_group_are_refused(tiny_yaml, monkeypatch):
    """One process that sees several cards and joined no process group:
    data_parallel asks for one process per card (the port has no
    single-process DataParallel)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="one process per card"):
        Trainer(YOLO.from_yaml(tiny_yaml), config=TrainConfig(),
                train_loader=[None], device="cuda")


def test_batches_that_do_not_divide_are_refused(ddp, synthetic_dataset):
    """A custom loader's global batch of 5 over 2 processes and an
    unsharded loader are refused by the Trainer; the loader refuses a
    global batch of 6 over 4 processes."""
    root = ddp[0]
    for r in range(WORLD):
        odd, unsharded = json.loads((root / f"refused{r}.json").read_text())
        assert "not divisible" in odd
        assert "per-process-sharded loader" in unsharded
    with pytest.raises(ValueError, match="not divisible"):
        create_dataloader(synthetic_dataset, DataConfig(batch_size=6),
                          "train", shard=(1, 4))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.local_rows(6, 0, 4)


def test_sharded_full_augmentation_rows(ddp, init, tmp_path):
    """device_augment="full" on two processes: each process's augmented
    rows of the first batch equal (torch.equal) the same rows of the
    gathered batch augmented unsharded with the same draws, which equals
    the one-process Trainer's augmented batch; the loader's shards make up
    the one-process batch."""
    _, _, ranks, spec = ddp
    data = DataConfig(train_path=spec["train"], img_size=SIZE,
                      batch_size=BATCH, workers=2, max_boxes=16,
                      augment=AugmentConfig("full", mixup=0.5))
    cfg = TrainConfig(epochs=1, data_parallel=True, device_augment="full",
                      log_interval=1, output_dir=str(tmp_path))
    one = Trainer(YOLO.from_yaml(_tiny_path(tmp_path)), data=data,
                  config=cfg, device="cpu", **init)
    first = next(iter(one.train_loader))
    np.testing.assert_array_equal(
        np.concatenate([got["aug_loader_images"] for got in ranks]),
        first["images"])
    x, t, _ = one._put_batch(first["images"], first["targets"])
    xa, ta = one._inputs(x, t)
    mixed = one._aug_draws(0, BATCH, SIZE)["mixup"]
    assert mixed.any() and not mixed.all()
    for r, got in enumerate(ranks):
        for key, ref in (("images", xa), ("targets", ta)):
            assert torch.equal(torch.from_numpy(got[f"aug_{key}"]),
                               _rows(torch.from_numpy(
                                   got[f"aug_full_{key}"]), r)), (r, key)
            assert torch.equal(torch.from_numpy(got[f"aug_full_{key}"]),
                               ref), (r, key)
            # the epoch's first step augmented the same rows
            np.testing.assert_array_equal(got[f"aug_step0_{key}"],
                                          got[f"aug_{key}"])
    one.train()
    _assert_state_close(ranks, "aug", one)


def _tiny_path(tmp_path: Path) -> str:
    p = tmp_path / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


# ---------------------------------------------------------------------------
# the loader's shard= against the JAX DataLoader's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [0, 1])
def test_loader_shard_matches_jax(synthetic_dataset, index):
    """Seeded train-mode batches through the full preset, two epochs:
    shard=(index, 2) equals the JAX loader's shard byte for byte, and the
    two shards make up the unsharded global batches."""
    kw = {"img_size": 96, "batch_size": 4, "workers": 2}
    aug = {"preset": "full", "mixup": 0.5}
    from yolo_re_tpu.data.config import AugmentConfig as JAugmentConfig

    mine = create_dataloader(
        synthetic_dataset, DataConfig(**kw, augment=AugmentConfig(**aug)),
        "train", shard=(index, 2))
    ref = jcreate_dataloader(
        synthetic_dataset, JDataConfig(**kw, augment=JAugmentConfig(**aug)),
        "train", shard=(index, 2))
    whole = create_dataloader(
        synthetic_dataset, DataConfig(**kw, augment=AugmentConfig(**aug)),
        "train")
    assert mine.shard == tuple(ref.shard) == (index, 2)
    assert len(mine) == len(ref) == len(whole)
    for epoch in (0, 1):
        for loader in (mine, ref, whole):
            loader.set_epoch(epoch)
        got, want, full = list(mine), list(ref), list(whole)
        assert len(got) == len(want) == len(full) > 0
        for a, b, c in zip(got, want, full):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                np.testing.assert_array_equal(a[k], _rows(c[k], index),
                                              err_msg=k)


# ---------------------------------------------------------------------------
# mesh serving and eval
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_weights(tiny_yaml):
    model = YOLO.from_yaml(tiny_yaml)
    return model, state_dict_from_jax(model.plan, *load_weights(str(FIXTURE)))


# the mesh Detector's settings, here and in the JAX Detector
DET_KW = {"img_size": 160, "compute_dtype": "float32", "conf_thres": 0.01}


@pytest.mark.parametrize("n", [8, 5])
def test_mesh_detector_equals_single(fixture_weights, n):
    """Detector(mesh=Mesh(("cpu", "cpu"))) on n frames (5: padded to 6)
    against the single Detector; the replicas are copies with their packed
    weights."""
    model, sd = fixture_weights
    kw = DET_KW
    single = Detector(model, sd, device="cpu", **kw)
    meshed = Detector(model, sd, mesh=mesh.Mesh(("cpu", "cpu")), **kw)
    assert meshed.device == torch.device("cpu") and len(meshed.programs) == 2
    a, b = (m.model for m in meshed.programs)
    assert a is meshed.model and b is not a
    frames = make_eval_batch(n, 200, seed=3)["images"]
    want, got = single(frames), meshed(frames)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert int(want["valid"].sum()) > 0
    assert torch.equal(got["valid"], want["valid"])
    assert torch.equal(got["classes"], want["classes"])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=DET_ATOL, err_msg=k)


def test_mesh_detector_matches_jax(fixture_weights, tiny_yaml):
    """The mesh Detector on 5 frames (padded to 6) against the JAX
    Detector at tests/test_torch_serving.py's bounds."""
    model, sd = fixture_weights
    meshed = Detector(model, sd, mesh=mesh.Mesh(("cpu", "cpu")), **DET_KW)
    jdet = JDetector(JYOLO.from_yaml(tiny_yaml), *jload_weights(FIXTURE),
                     **DET_KW)
    frames = make_eval_batch(5, 200, seed=3)["images"]
    ref, out = jdet(frames), meshed(frames)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]),
                               atol=JAX_BOX_ATOL)
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=JAX_SCORE_ATOL)
    assert int(out["valid"].sum()) > 0


def test_replicas_hold_their_buffers_on_their_device(fixture_weights):
    """`replicate` moves every parameter and buffer of a fused model,
    its packed weights (non-persistent buffers) included, to each mesh
    device ("meta" stands in for a second card here)."""
    model, sd = fixture_weights
    det = Detector(model, sd, device="cpu", img_size=160,
                   compute_dtype="float32")
    packed = [n for n, _ in det.model.named_buffers()
              if n.rsplit(".", 1)[-1] in ("conv3_w", "adown_w1", "adown_w2",
                                          "chain_w", "chain_b")]
    assert packed
    replicas = mesh.replicate(det.model, mesh.Mesh(("cpu", "meta")))
    assert replicas[0] is det.model
    names = dict(replicas[1].named_buffers())
    assert set(packed) <= set(names)
    for t in (*replicas[1].parameters(), *replicas[1].buffers()):
        assert t.device.type == "meta"
    for t in (*replicas[0].parameters(), *replicas[0].buffers()):
        assert t.device.type == "cpu"


@pytest.fixture(scope="module")
def val_batches(tmp_path_factory):
    """Batches of 8 and 5 (padded to 6 on the mesh) of a val set."""
    val = write_dataset(str(tmp_path_factory.mktemp("val")), "val", 13,
                        seed=1)
    data = DataConfig(val_path=val, num_classes=4, img_size=160,
                      batch_size=8, workers=2)
    batches = list(create_dataloader(val, data, "val"))
    assert [len(b["images"]) for b in batches] == [8, 5]
    return batches


@pytest.fixture(scope="module")
def mesh_map(fixture_weights, val_batches):
    model, sd = fixture_weights
    return Evaluator(model, val_batches, mesh=mesh.Mesh(("cpu", "cpu")),
                     device="cuda").evaluate(sd)


def test_mesh_evaluator_equals_single(fixture_weights, val_batches,
                                      mesh_map):
    """Evaluator(mesh=) on batches of 8 and 5 (padded to 6) of the
    fixture's val set: the same map50, map75 and map."""
    model, sd = fixture_weights
    single = Evaluator(model, val_batches, device="cpu").evaluate(sd)
    assert single["map50"] > 0.5
    for k in ("map50", "map75", "map"):
        assert abs(mesh_map[k] - single[k]) <= MAP_ATOL, k


def test_mesh_evaluator_matches_jax(tiny_yaml, val_batches, mesh_map):
    """The mesh Evaluator's map50, map75 and map against the JAX
    Evaluator's on the same batches, at tests/test_torch_eval.py's
    bound."""
    ref = JEvaluator(JYOLO.from_yaml(tiny_yaml), val_batches).evaluate(
        *jload_weights(FIXTURE))
    assert ref["map50"] > 0.5
    for k in ("map50", "map75", "map"):
        assert abs(mesh_map[k] - ref[k]) <= JAX_MAP_ATOL, \
            (k, mesh_map[k], ref[k])


def test_mesh_helpers(tiny_yaml):
    """pad_batch_to pads with zeros (inference only); split_batch gives
    equal parts; gather_rows slices the padding off; make_mesh takes
    devices, and without a card asks for them; no group means rank 0 of
    1."""
    x = torch.arange(10.0).reshape(5, 2)
    padded = mesh.pad_batch_to(x, 8)
    assert padded.shape == (8, 2) and not padded[5:].any()
    assert torch.equal(padded[:5], x)
    assert mesh.pad_batch_to(x, 5) is x
    m = mesh.make_mesh(devices=("cpu", "cpu", "cpu"))
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    assert mesh.make_mesh(2, devices=("cpu", "cpu", "cpu")).size == 2
    parts = mesh.split_batch(x, m)
    assert [len(p) for p in parts] == [2, 2, 2]
    back = mesh.gather_rows([{"x": p} for p in parts], torch.device("cpu"),
                            5)
    assert torch.equal(back["x"], x)
    assert mesh.local_rows(8, 1, 2) == slice(4, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()
    with pytest.raises(ValueError):
        mesh.Mesh(())
    with pytest.raises(TypeError, match="Mesh"):
        Evaluator(YOLO.from_yaml(tiny_yaml), [], mesh=object())
    assert mesh.init_distributed() == (0, 1)
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    with pytest.raises(ValueError, match="coordinator"):
        mesh.init_distributed(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        mesh.init_distributed("127.0.0.1:1", device="cpu")
    assert mesh.batch_group() is None
    with mesh.global_batch("g"):
        assert mesh.batch_group() == "g"
    assert mesh.batch_group() is None


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

BLOCK_JAX = ("import runpy, sys\n"
             "for m in ('jax', 'jaxlib', 'yolo_re_tpu'):\n"
             "    sys.modules[m] = None\n")


def _cli(module: str, *argvs: list[str]) -> list[str]:
    """A command that runs the CLI module with each argv in turn, in one
    process with jax blocked."""
    code = BLOCK_JAX + "".join(
        f"sys.argv = [{module!r}] + {argv!r}\n"
        f"runpy.run_module('yolo_re_tpu_torch.cli.{module}', "
        f"run_name='__main__')\n" for argv in argvs)
    return [sys.executable, "-c", code]


def test_cli_train_two_processes(tmp_path):
    """cli.train --coordinator --num-processes 2 --process-id {0, 1}
    --device cpu: one epoch over gloo; process 0 alone writes its
    outputs."""
    train = write_dataset(str(tmp_path / "data"), "train", 8, seed=4)
    port = _free_port()
    outs = _run_ranks([_cli("train", [
        "--data", train, "--config", _tiny_path(tmp_path), "--num-classes",
        "4", "--epochs", "1", "--batch", "4", "--img-size", str(SIZE),
        "--workers", "1", "--augment", "minimal", "--output",
        str(tmp_path / f"run{r}"), "--device", "cpu", "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r)])
        for r in range(2)])
    for r, out in enumerate(outs):
        assert f"data parallel: process {r}/2" in out
        assert "final:" in out
    assert {p.name for p in (tmp_path / "run0").iterdir()} == \
        {"last.npz", "metrics.jsonl"}
    assert not (tmp_path / "run1").exists()


def test_cli_val_data_parallel_equals_single(tmp_path):
    """cli.val --data-parallel --device cpu prints the mAP it prints
    without the flag."""
    val = write_dataset(str(tmp_path), "val", 6, seed=1)
    argv = ["--weights", str(FIXTURE), "--config", _tiny_path(tmp_path),
            "--data", val, "--num-classes", "4", "--img-size", "160",
            "--batch", "4", "--workers", "1", "--device", "cpu", "--fuse"]
    lines = _run_ranks([_cli("val", argv, argv + ["--data-parallel"])]
                       )[0].strip().splitlines()[-2:]
    values = [dict(kv.split("=") for kv in line.split()) for line in lines]
    for k in ("map50", "map75", "map"):
        assert values[0][k] == values[1][k], (k, lines)
    assert float(values[0]["map50"]) > 0.5


def test_profile_launches_ddp_mode_needs_a_card(monkeypatch, capsys):
    """`profile_launches ddp [f32]` profiles a DDP step on the card only:
    without one it exits with 2 and prints no timing."""
    from yolo_re_tpu_torch.cli import profile_launches

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["ddp"], ["ddp", "f32"]):
        assert profile_launches.main(argv) == 2
    assert profile_launches.parse(["ddp", "f32"]) == ("ddp", "f32", False, "")
    assert profile_launches.parse(["ddp"]) == ("ddp", "", False, "")
    for bad in (["ddp", "bf16"], ["ddp", "gelan-c"], ["ddp", "f32", "x"]):
        assert profile_launches.parse(bad) is None
    assert "ms" not in capsys.readouterr().out
