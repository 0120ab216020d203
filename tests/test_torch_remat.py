"""Per-block remat in the port (`YOLO.forward(remat=True | "early")`,
torch.utils.checkpoint) held against no remat and against the JAX
package's `model.apply(..., remat=)` (jax.checkpoint) on the CPU.

TINY_YAML / TINY_DUAL_YAML at 64 px, weights drawn by the port's init
(the JAX package's scheme) and handed to both packages. The checkpointed
blocks' forward runs again inside the backward: the gradients must not
move, and the BN running statistics must be updated once, not twice. On
the CPU the train Functions run their kernels' plain versions; the
launch counts on the card are held in tests/test_torch_cuda.py and
chip_smoke.py phase 16.
"""

import contextlib
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from yolo_re_tpu_torch.data.synth import TINY_DUAL_YAML, TINY_YAML
from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.builder import build_plan
from yolo_re_tpu_torch.models.config import parse_yaml
from yolo_re_tpu_torch.models.yolo import (
    YOLO,
    _recompute,
    check_remat,
    remat_step,
)
from yolo_re_tpu_torch.ops.kernels import adown as adown_kernel
from yolo_re_tpu_torch.ops.kernels import stem as stem_kernel
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
MODES = (True, "early")
# remat against no remat in the port: tests/test_model.py:165's bound
GRAD_RTOL = GRAD_ATOL = 1e-5
# the port against the JAX package, over all gradients as one vector:
# the cosine and the norm ratio (per-leaf comparisons meet BN's
# cancellation: a leaf whose gradient cancels is rounding noise)
JAX_COS_MIN = 1 - 1e-6
JAX_NORM_RTOL = 1e-4
# running statistics against the JAX package's new_stats (f32 moments
# summed in another order)
JAX_STATS_RTOL = JAX_STATS_ATOL = 1e-5


@pytest.fixture(scope="module")
def yamls(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    out = {}
    for name, text in (("tiny", TINY_YAML), ("tiny-dual", TINY_DUAL_YAML)):
        (d / f"{name}.yaml").write_text(text)
        out[name] = str(d / f"{name}.yaml")
    return out


def _model(path: str) -> YOLO:
    model = YOLO.from_yaml(path)
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.train()


def _image(seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).random((2, 64, 64, 3), np.float32)


def _objective(preds) -> torch.Tensor:
    """tests/test_model.py:172: the sum of every head output."""
    leaves = []

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)
        else:
            leaves.append(v.float().sum())

    walk(preds)
    return sum(leaves)


def _port_grads(model: YOLO, x: np.ndarray, remat):
    """(gradients by parameter name, the state dict after the step) of
    one train forward + backward of a copy of `model`."""
    m = copy.deepcopy(model)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    loss = _objective(m(xt, remat=remat))
    names = [k for k, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
    return dict(zip(names, grads)), {k: v.clone()
                                     for k, v in m.state_dict().items()}


@pytest.mark.parametrize("name", ["tiny", "tiny-dual"])
@pytest.mark.parametrize("mode", MODES)
def test_remat_grads_and_running_stats_equal_no_remat(yamls, name, mode):
    """The gradients under remat equal those without (rtol/atol 1e-5),
    and the running statistics after the step are the same bits: the
    recompute updated none of them a second time."""
    model = _model(yamls[name])
    x = _image()
    g0, sd0 = _port_grads(model, x, False)
    g1, sd1 = _port_grads(model, x, mode)
    for k, v in g0.items():
        torch.testing.assert_close(g1[k], v, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   msg=k)
    for k, v in sd0.items():
        assert torch.equal(sd1[k], v), k
    # the step moved the statistics (once)
    assert not torch.equal(sd0["layers.stem1.bn.running_mean"],
                           model.state_dict()["layers.stem1.bn.running_mean"])


def _jax_grads(path: str, model: YOLO, x: np.ndarray, remat):
    jmodel = JYOLO.from_yaml(path)
    params, stats = jax_from_state_dict(model.plan, model.state_dict())

    def loss(p):
        preds, new = jmodel.apply(p, stats, jnp.asarray(x), train=True,
                                  remat=remat)
        return sum(v.astype(jnp.float32).sum()
                   for v in jax.tree_util.tree_leaves(preds)), new

    grads, new = jax.jit(jax.grad(loss, has_aux=True))(params)
    grads, new = jax.device_get((grads, new))
    # the gradients as a params tree in the port's names (the same linear
    # layout change as the weights)
    return state_dict_from_jax(model.plan, grads, new), \
        state_dict_from_jax(model.plan, params, new)


@pytest.mark.parametrize("mode", MODES)
def test_remat_matches_jax(yamls, mode):
    """The port's remat gradients against the JAX package's
    `apply(..., remat=mode)` ones (cosine and norm ratio over all
    parameters), and the port's running statistics after the step against
    JAX's new_stats."""
    model = _model(yamls["tiny"])
    x = _image(6)
    got, sd = _port_grads(model, x, mode)
    jg, jsd = _jax_grads(yamls["tiny"], model, x, mode)
    a = torch.cat([got[k].reshape(-1) for k in got]).double()
    b = torch.cat([jg[k].reshape(-1) for k in got]).double()
    cos = float(a @ b / (a.norm() * b.norm()))
    ratio = float(a.norm() / b.norm())
    assert cos >= JAX_COS_MIN, cos
    assert abs(ratio - 1) <= JAX_NORM_RTOL, ratio
    stats = [k for k in sd if k.endswith((".running_mean", ".running_var"))]
    assert len(stats) > 20
    for k in stats:
        torch.testing.assert_close(sd[k], jsd[k], rtol=JAX_STATS_RTOL,
                                   atol=JAX_STATS_ATOL, msg=k)


def test_remat_argument_validation(yamls):
    """yolo_re_tpu/models/yolo.py:104-108: ints are truthy, any string
    but "early" raises (in forward and in the Trainer); eval ignores
    remat."""
    assert check_remat(1) is True and check_remat(0) is False
    assert check_remat("early") == "early"
    model = _model(yamls["tiny"])
    x = _image()
    g1, _ = _port_grads(model, x, 1)
    gt, _ = _port_grads(model, x, True)
    for k, v in gt.items():
        assert torch.equal(g1[k], v), k
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="remat"):
        model(xt, remat="full")
    with pytest.raises(ValueError, match="remat"):
        Trainer(YOLO.from_yaml(yamls["tiny"]),
                config=TrainConfig(data_parallel=False, remat="late"),
                train_loader=[None], device="cpu")
    model.eval()
    with torch.no_grad():
        a = model(xt)[0]
        b = model(xt, remat=True)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("config", ["gelan-c", "yolov9-c", "tiny",
                                    "tiny-dual"])
def test_early_selects_a_strict_nonempty_subset(yamls, config):
    """"early" takes the plan steps at a downscale <= 8: a non-empty
    strict subset of True's, the steps the JAX package's plan picks."""
    path = yamls.get(config) or str(ROOT / "configs" / "models"
                                    / f"{config}.yaml")
    plan = build_plan(parse_yaml(path), 3)
    every = [s.name for s in plan.steps if remat_step(s, True)]
    early = [s.name for s in plan.steps if remat_step(s, "early")]
    assert every == [s.name for s in plan.steps]
    assert early and set(early) < set(every)
    jplan = JYOLO.from_yaml(path).plan
    assert early == [s.name for s in jplan.steps if 0 < s.scale <= 8]
    if config == "gelan-c":
        assert early == ["stem1", "stem2", "stage1", "down1", "stage2",
                         "up2", "concat2", "fpn2"]


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_train_functions_under_remat(monkeypatch):
    """tests/test_adown_train.py:162's counterpart: the ADown and stem
    train Functions under torch.utils.checkpoint run their forward again
    in the backward (the raw conv once more: its saved tensors are
    recomputed, not kept), give the same gradients bit for bit (the plain
    versions here), and update the BN running statistics once."""
    torch.manual_seed(0)
    down = B.ADown(32, 32).train()
    stem = B.Conv(3, 16, 3, 2).train()
    assert stem.is_stem
    x = torch.randn(2, 32, 16, 16).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    img = torch.rand(2, 3, 32, 32)
    for block, inp, module, fn in ((down, x, adown_kernel, "adown_raw"),
                                   (stem, img, stem_kernel,
                                    "stem_conv_raw")):
        r = torch.randn_like(copy.deepcopy(block)(inp))
        calls = _counting(monkeypatch, module, fn)
        ref = copy.deepcopy(block)
        ref_out = ref(inp)
        grads_ref = torch.autograd.grad((ref_out.float() * r).sum(),
                                        list(ref.parameters()))
        assert len(calls) == 1
        rem = copy.deepcopy(block)
        out = checkpoint(rem, inp, use_reentrant=False,
                         preserve_rng_state=False,
                         context_fn=lambda: (contextlib.nullcontext(),
                                             _recompute(None)))
        assert len(calls) == 2
        grads = torch.autograd.grad((out.float() * r).sum(),
                                    list(rem.parameters()))
        assert len(calls) == 3          # recomputed inside the backward
        assert torch.equal(out, ref_out)
        for a, b in zip(grads, grads_ref):
            assert torch.equal(a, b)
        for (k, a), b in zip(rem.state_dict().items(),
                             ref.state_dict().values()):
            assert torch.equal(a, b), k
