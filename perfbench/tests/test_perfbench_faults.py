"""A whole run on the CPU at a tiny size (the look for a card skipped),
sound and then with the timed path broken underneath: each fault the cell
can have makes `correct` come out false."""

from __future__ import annotations

import json

import pytest
import torch

import run

SEED = 2 ** 31 + 4321
CPU = torch.device("cpu")


def _bench() -> dict:
    return json.loads((run.ROOT / "BENCHMARK.json").read_text())


def _serve(tiny_serve) -> dict:
    cfg, mix = tiny_serve
    return run.execute("gelan-c.serve.host", SEED, 1, False, CPU, _bench(),
                       cfg=cfg, mix=mix)


def _train(tiny_train) -> dict:
    cfg, mix = tiny_train
    return run.execute("yolov9-c.train.bf16", SEED, 1, False, CPU,
                       _bench(), cfg=cfg, mix=mix)


def _broken_detector(monkeypatch, alter):
    from yolo_re_tpu_torch.serving import Detector

    call = Detector.__call__

    def broken(self, frames):
        out = {k: v.clone() for k, v in call(self, frames).items()}
        alter(out)
        return out
    monkeypatch.setattr(Detector, "__call__", broken)


def test_a_sound_serving_run_is_correct(tiny_serve):
    r = _serve(tiny_serve)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"serve.images_per_s", "serve.p95_ms",
                                 "setup_s"}


def _drop_half(out):
    b = out["valid"].shape[0]
    out["valid"][b // 2:] = False
    out["scores"][b // 2:] = 0.0
    out["classes"][b // 2:] = -1


def _alter_answer(out):
    out["classes"][0, 0] = (out["classes"][0, 0] + 1) % 4


@pytest.mark.parametrize("fault", [_drop_half, _alter_answer],
                         ids=["half_of_the_batch", "an_answer_altered"])
def test_serving_faults_are_not_correct(tiny_serve, monkeypatch, fault):
    _broken_detector(monkeypatch, fault)
    r = _serve(tiny_serve)
    assert not r["correct"], r["checks"]


def test_a_sound_training_run_is_correct(tiny_train):
    r = _train(tiny_train)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train.images_per_s", "setup_s"}


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        tiny_train, monkeypatch):
    from yolo_re_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_update", lambda self, grads: None)
    r = _train(tiny_train)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(tiny_train, monkeypatch):
    from yolo_re_tpu_torch.train.trainer import Trainer

    step = Trainer._step

    def half(self, x, t, ready=None, augment=True):
        n = x.shape[0] // 2
        return step(self, x[:n], t[:n], ready, augment)
    monkeypatch.setattr(Trainer, "_step", half)
    r = _train(tiny_train)
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > 0.3
