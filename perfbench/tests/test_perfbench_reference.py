"""The plain reference against the port's CPU path at the tiny sizes: the
same weights (drawn by the benchmark from a seed) and the same inputs on
both sides. The tests import the port; the reference does not."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from lib.weights import make_weights
from reference import train as ref_train
from reference.model import Network, Run
from reference.serve import letterbox, nms

SEED = 2 ** 31 + 12345


def _port_model(cfg, sd):
    from yolo_re_tpu_torch.models.config import ModelConfig
    from yolo_re_tpu_torch.models.yolo import YOLO

    m = YOLO.from_config(ModelConfig(cfg["num_classes"], 1.0, 1.0,
                                     copy.deepcopy(cfg["layers"])))
    m.load_state_dict(sd, strict=True)
    return m


def _setup(cfg):
    net = Network(cfg)
    sd = make_weights(net.spec(), SEED, torch.device("cpu"),
                      cfg["class_bias"], cfg["num_classes"], net.strides)
    return net, sd


def test_the_weights_load_into_the_port_by_name(tiny_serve, tiny_train):
    for cfg, _ in (tiny_serve, tiny_train):
        net, sd = _setup(cfg)
        _port_model(cfg, sd)            # strict=True: the same names
        assert set(sd) == {n for n, _, _ in net.spec()}


def test_same_seed_same_weights(tiny_serve):
    cfg, _ = tiny_serve
    net, a = _setup(cfg)
    _, b = _setup(cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("fuse", [False, True])
def test_decoded_predictions_match_the_port(tiny_serve, tiny_train, fuse):
    for cfg, _ in (tiny_serve, tiny_train):
        net, sd = _setup(cfg)
        m = _port_model(cfg, sd).eval()
        if fuse:
            m.fuse()
        x = torch.rand(2, 3, 64, 64, generator=torch.Generator()
                       .manual_seed(1))
        with torch.no_grad():
            port, _ = m(x, main_only=True)
        ref = net.decoded(Run(sd), x)
        torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-3)


def test_train_maps_match_the_port(tiny_train):
    cfg, _ = tiny_train
    net, sd = _setup(cfg)
    m = _port_model(cfg, sd).train()
    x = torch.rand(4, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        port = m(x)
        ref = net.train_maps(Run(sd, train=True), x)
    for branch in ("aux", "main"):
        for (pb, pc), (rb, rc) in zip(port[branch], ref[branch]):
            torch.testing.assert_close(rb, pb, rtol=1e-3, atol=2e-3)
            torch.testing.assert_close(rc, pc, rtol=1e-3, atol=2e-3)


def test_letterbox_matches_the_port():
    from yolo_re_tpu_torch.data.device_pipeline import batched_letterbox

    g = torch.Generator().manual_seed(3)
    for h, w in ((48, 80), (90, 60), (64, 64)):
        frames = torch.randint(0, 256, (2, h, w, 3), dtype=torch.uint8,
                               generator=g)
        port = batched_letterbox(frames, 64).permute(0, 3, 1, 2)
        torch.testing.assert_close(letterbox(frames, 64), port,
                                   rtol=0, atol=2e-6)


def test_nms_matches_the_port(tiny_serve):
    from yolo_re_tpu_torch.ops.nms import non_max_suppression

    cfg, _ = tiny_serve
    net, sd = _setup(cfg)
    x = torch.rand(3, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    dec = net.decoded(Run(sd), x)
    port = non_max_suppression(dec, 0.25, 0.45, 50, pre_topk=64)
    ref = nms(dec, 0.25, 0.45, 50, topk=64)
    assert torch.equal(port["valid"], ref["valid"])
    assert torch.equal(port["classes"].long(), ref["classes"].long())
    torch.testing.assert_close(ref["boxes"], port["boxes"])
    torch.testing.assert_close(ref["scores"], port["scores"])


def _targets(batch):
    rng = np.random.default_rng(5)
    t = np.zeros((batch, 6, 5), np.float32)
    for i in range(batch):
        for j in range(rng.integers(1, 5)):
            t[i, j] = (rng.integers(0, 8), *rng.uniform(0.3, 0.7, 2),
                       *rng.uniform(0.1, 0.4, 2))
    return torch.from_numpy(t)


def test_tal_loss_matches_the_port(tiny_train):
    from yolo_re_tpu_torch.loss.tal import TALoss

    cfg, _ = tiny_train
    net, sd = _setup(cfg)
    x = torch.rand(4, 3, 64, 64, generator=torch.Generator().manual_seed(6))
    maps = net.train_maps(Run(sd, train=True), x)
    t = _targets(4)
    port, port_items = TALoss(8, 16, net.strides)(maps, t)
    ref, ref_items = ref_train.loss(maps, t, net.strides, 8)
    torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ref_items, port_items, rtol=1e-5, atol=1e-6)


def test_clip_sgd_and_ema_match_the_port(tiny_train):
    from yolo_re_tpu_torch.models.yolo import param_labels
    from yolo_re_tpu_torch.train.ema import ema_update, init_ema
    from yolo_re_tpu_torch.train.optimizer import (
        clip_by_global_norm,
        init_sgd_state,
        sgd_step,
    )
    from yolo_re_tpu_torch.train.schedule import WarmupCosineSchedule

    cfg, _ = tiny_train
    net, sd = _setup(cfg)
    m = _port_model(cfg, sd)
    labels = param_labels(m)
    params = {k: v.detach().clone() for k, v in m.named_parameters()}
    g = torch.Generator().manual_seed(7)
    grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in
             params.items()}
    assert {k: ref_train.group(k) for k in params} == labels
    sched = WarmupCosineSchedule(base_lr=0.01, total_steps=100_000,
                                 warmup_steps=3000)
    port_p = {k: v.clone() for k, v in params.items()}
    bufs = init_sgd_state(port_p)
    stats = {"s": torch.zeros(1)}
    ema = init_ema(port_p, stats)
    ref_p = {k: v.clone() for k, v in params.items()}
    ref_bufs, ref_avg = {}, {k: v.clone() for k, v in params.items()}
    for step in range(3):
        clipped, _ = clip_by_global_norm(grads, 10.0)
        lr, blr, mom = sched(step)
        sgd_step(port_p, clipped, bufs, labels, lr=lr, bias_lr=blr,
                 momentum=mom, weight_decay=0.0005)
        ema_update(ema, port_p, stats)
        assert (lr, blr, mom) == pytest.approx(ref_train.schedule(step,
                                                                  1000))
        ref_train.sgd(ref_p, ref_train.clip(grads), ref_bufs, lr, blr, mom)
        ref_train.ema(ref_avg, ref_p, step + 1)
    for k in params:
        torch.testing.assert_close(ref_p[k], port_p[k], rtol=1e-5,
                                   atol=1e-7)
        torch.testing.assert_close(ref_avg[k], ema["params"][k], rtol=1e-5,
                                   atol=1e-7)


def test_the_float8_control_rounds_to_four_significant_bits():
    from reference.model import fake_fp8

    x = torch.linspace(-3, 3, 1001)
    q = fake_fp8(x)
    assert not torch.equal(q, x)
    rel = ((q - x).abs() / x.abs().clamp(min=0.05)).max()
    assert 1 / 64 < rel < 1 / 8


def test_the_bfloat16_witness_rounds_values_and_gradients():
    from reference.model import round_bf16

    x = torch.linspace(-3, 3, 1001, dtype=torch.float32).requires_grad_()
    y = round_bf16(x)
    assert torch.equal(y, x.detach().to(torch.bfloat16).float())
    g = torch.linspace(1, 2, 1001)
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, g.to(torch.bfloat16).float())
    assert not torch.equal(gx, g)
