"""Injected optimizers in the port's Trainer (`optimizer=`: a
torch.optim factory, or an `(init_fn, step_fn)` pair) held against the
JAX Trainer's (an optax transformation, or the same pair over its
pytrees) on the CPU, and their state through a checkpoint.

TINY_YAML at 64 px, f32, the same init (the port's draw, handed to both
packages) and the same batches. The global-norm clip and the EMA run as
for the default SGD; the injected rule owns its learning rate.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.train.config import TrainConfig as JTrainConfig
from yolo_re_tpu.train.trainer import Trainer as JTrainer
from yolo_re_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

STEPS, BATCH, SIZE = 3, 2, 64
LR, MOMENTUM = 1e-3, 0.9
# Adam's loss items, port against JAX, per step. Step 1 runs before any
# update (the default rule's bound). Adam's first update is lr * sign(g)
# for every element, so an element whose gradient is rounding noise moves
# by lr in either package's own direction: three of TINY_YAML's elements
# (|g| < 7e-8 against a largest 0.17) do, and the tiny model carries that
# to 7.8e-5 relative at step 2 and 4.0e-2 at step 3 (measured; one ulp
# of input changes JAX's own step 3 by 4.6e-4, moving no sign)
ADAM_ITEMS_RTOL = (1e-5, 1e-3, 0.1)
# the SGD pair's parameters after three steps (f32 gradients summed in
# another order, times lr: measured 3e-8), and its momentum buffers, the
# sums of the gradients, as one vector (relative L2)
PAIR_RTOL, PAIR_ATOL = 1e-5, 1e-6
BUFS_REL = 1e-4


def adam(params):
    return torch.optim.Adam(params, lr=LR)


def sgd_pair():
    """Momentum SGD as an (init_fn, step_fn) pair over the port's
    {name: tensor} dicts."""
    def init_fn(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def step_fn(params, grads, bufs, step):
        bufs = {k: MOMENTUM * bufs[k] + grads[k] for k in params}
        return {k: p - LR * bufs[k] for k, p in params.items()}, bufs

    return init_fn, step_fn


def jax_sgd_pair():
    """The same rule over the JAX Trainer's pytrees."""
    def init_fn(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def step_fn(params, grads, bufs, step):
        bufs = jax.tree_util.tree_map(lambda b, g: MOMENTUM * b + g, bufs,
                                      grads)
        return jax.tree_util.tree_map(lambda p, b: p - LR * b, params,
                                      bufs), bufs

    return init_fn, step_fn


class _Loader(list):
    batch_size = BATCH
    drop_last = True


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("optim")
    path = d / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = YOLO.from_yaml(path)
    model.init_parameters(torch.Generator().manual_seed(0))
    params, stats = jax_from_state_dict(model.plan, model.state_dict())
    batches = _Loader(make_eval_batch(BATCH, SIZE, 30 + s)
                      for s in range(STEPS))
    return str(path), {"params": params, "stats": stats}, batches, d


def _port(setup, optimizer, **kw) -> Trainer:
    path, init, batches, d = setup
    cfg = TrainConfig(epochs=1, data_parallel=False, output_dir=str(d), **kw)
    return Trainer(YOLO.from_yaml(path), config=cfg, train_loader=batches,
                   optimizer=optimizer, device="cpu", **init)


def _jax_run(setup, optimizer):
    """The JAX Trainer's three jitted steps; (trainer, loss items)."""
    path, init, batches, d = setup
    jt = JTrainer(JYOLO.from_yaml(path),
                  config=JTrainConfig(epochs=1, data_parallel=False,
                                      output_dir=str(d)),
                  train_loader=batches, optimizer=optimizer, **init)
    items = []
    for s, b in enumerate(batches):
        (jt.params, jt.stats, jt.opt_bufs, jt.ema, _, it, _) = \
            jt._train_step(jt.params, jt.stats, jt.opt_bufs, jt.ema,
                           jnp.asarray(b["images"]),
                           jnp.asarray(b["targets"]), np.int32(s))
        jt.global_step += 1
        items.append(np.asarray(it))
    return jt, np.array(items)


def _port_run(trainer: Trainer, batches) -> np.ndarray:
    return np.array([trainer.train_step(b["images"], b["targets"])[1]
                     .numpy() for b in batches])


@pytest.fixture(scope="module")
def adam_pair(setup):
    jt, jitems = _jax_run(setup, optax.adam(LR))
    tt = _port(setup, adam)
    return jt, jitems, tt, _port_run(tt, setup[2])


def test_adam_factory_matches_optax_adam(adam_pair):
    """Three steps from one state: the port Trainer with a
    torch.optim.Adam factory against the JAX Trainer with optax.adam, loss
    items within ADAM_ITEMS_RTOL step by step; Adam's step count is the
    steps taken."""
    jt, jitems, tt, titems = adam_pair
    for step, rtol in enumerate(ADAM_ITEMS_RTOL):
        np.testing.assert_allclose(titems[step], jitems[step], rtol=rtol,
                                   err_msg=f"step {step + 1}")
    assert tt._torch_opt.state and tt.opt_bufs is None
    step = {float(st["step"]) for st in tt._torch_opt.state.values()}
    assert step == {float(STEPS)}


def test_sgd_pair_matches_jax(setup):
    """The same momentum-SGD (init_fn, step_fn) pair in both packages:
    the parameters after three steps within f32 tolerance; the pair's
    state is the port's {name: tensor} buffers."""
    jt, _ = _jax_run(setup, jax_sgd_pair())
    tt = _port(setup, sgd_pair())
    _port_run(tt, setup[2])
    ref = state_dict_from_jax(tt.model.plan,
                              *jax.device_get((jt.params, jt.stats)))
    for k, p in tt.params.items():
        torch.testing.assert_close(p.detach(), ref[k], rtol=PAIR_RTOL,
                                   atol=PAIR_ATOL, msg=k)
    w0 = _port(setup, None).params["layers.stem1.conv.weight"]
    assert not torch.equal(tt.params["layers.stem1.conv.weight"], w0)
    bufs = state_dict_from_jax(tt.model.plan, *jax.device_get(
        (jt.opt_bufs, jt.stats)))
    a = torch.cat([v.reshape(-1) for v in tt.opt_bufs.values()]).double()
    b = torch.cat([bufs[k].reshape(-1) for k in tt.opt_bufs]).double()
    assert float((a - b).norm() / b.norm()) <= BUFS_REL


def test_pair_moves_the_weights_by_what_step_fn_returns(setup):
    """One step of a plain SGD pair: every parameter equals p - lr * g
    for the gradient handed to step_fn, bit for bit; no lr is logged."""
    seen = {}

    def step_fn(params, grads, state, step):
        seen.update({k: (params[k].detach().clone(), grads[k].clone())
                     for k in params})
        return {k: p - LR * grads[k] for k, p in params.items()}, state

    tt = _port(setup, (lambda params: {}, step_fn))
    b = setup[2][0]
    tt.train_step(b["images"], b["targets"])
    for k, p in tt.params.items():
        p0, g = seen[k]
        assert torch.equal(p.detach(), p0 - LR * g), k
    tt._log_metrics(setup[3] / "pair_log", 0, np.zeros(3), {})
    record = json.loads((setup[3] / "pair_log" / "metrics.jsonl")
                        .read_text())
    assert "lr" not in record and "momentum" not in record


def _state(trainer: Trainer) -> dict[str, torch.Tensor]:
    out = {f"p/{k}": v.detach() for k, v in trainer.params.items()}
    out.update({f"s/{k}": v for k, v in trainer.stats.items()})
    out.update({f"ema/{k}": v for k, v in trainer.ema["params"].items()})
    if trainer._torch_opt is not None:
        names = {id(p): k for k, p in trainer.params.items()}
        for p, st in trainer._torch_opt.state.items():
            for s, v in st.items():
                out[f"opt/{s}/{names[id(p)]}"] = v
    elif trainer.opt_bufs:
        out.update({f"opt/{k}": v for k, v in trainer.opt_bufs.items()})
    return out


@pytest.mark.parametrize("rule", ["adam", "pair"])
@pytest.mark.parametrize("fmt", ["npz", "orbax"])
def test_resume_through_a_checkpoint_is_bit_equal(setup, rule, fmt):
    """An injected rule resumed 2 + 2 steps through a checkpoint (.npz,
    or the checkpoint directory of checkpoint_format "orbax") equals 4
    straight steps bit for bit: parameters, BN statistics, EMA and the
    rule's state (Adam's moments and step)."""
    batches = list(setup[2]) + [setup[2][0]]
    make = adam if rule == "adam" else sgd_pair()
    straight = _port(setup, make, checkpoint_format=fmt)
    _port_run(straight, batches)
    first = _port(setup, make, checkpoint_format=fmt)
    _port_run(first, batches[:2])
    first._save(setup[3] / f"{rule}_{fmt}.npz", 0)
    saved = setup[3] / (f"{rule}_{fmt}" + (".npz" if fmt == "npz" else ""))
    assert saved.is_dir() == (fmt == "orbax")
    resumed = _port(setup, make, checkpoint_format=fmt)
    resumed.load_checkpoint(saved)
    assert resumed.global_step == 2
    _port_run(resumed, batches[2:])
    a, b = _state(straight), _state(resumed)
    assert a.keys() == b.keys() and len(a) > 100
    for k, v in a.items():
        assert torch.equal(torch.as_tensor(b[k]), torch.as_tensor(v)), k


def test_optimizer_states_that_do_not_fit_are_refused(adam_pair, setup):
    """A JAX checkpoint of an optax state cannot map onto a torch
    optimizer (ValueError naming optax); an Adam checkpoint does not
    resume the default SGD, nor SGD's buffers an Adam; a bad optimizer
    argument is refused."""
    jt, _, tt, _ = adam_pair
    d = setup[3]
    jt._save(d / "optax.npz", 0)
    for optimizer in (adam, None):
        with pytest.raises(ValueError, match="optax"):
            _port(setup, optimizer).load_checkpoint(d / "optax.npz")
    tt._save(d / "adam.npz", 0)
    with pytest.raises(ValueError, match="SGD"):
        _port(setup, None).load_checkpoint(d / "adam.npz")
    _port(setup, None)._save(d / "sgd.npz", 0)
    with pytest.raises(ValueError, match="SGD"):
        _port(setup, adam).load_checkpoint(d / "sgd.npz")
    for bad in (object(), (sgd_pair()[0],), lambda ps: object()):
        with pytest.raises(TypeError, match="optimizer"):
            _port(setup, bad)
