"""The control of the correctness check: the reference computed in float8
in the program's place fails the cell's limits, where the program passes.
On the CPU at a tiny size; on a card (`-m cuda`) at the cell's size."""

from __future__ import annotations

import time

import pytest
import torch

import control
import run

SEED = 2 ** 31 + 777


def _cell(name, cfg, mix, device):
    work = run.load(run.HERE / "workloads" / f"{name}.json")
    return run.Cell(name, cfg, mix, work["limits"], SEED, 0, False, device,
                    time.perf_counter())


def _fails(readings, limits) -> bool:
    return any(readings[k] > limits[k] for k in limits)


def _check(cell, read):
    r = read(cell)
    assert not _fails(r["program"], cell.limits), r["program"]
    assert _fails(r["control"], cell.limits), r["control"]
    for name, fault in r["faults"].items():
        assert _fails(fault, cell.limits), (name, fault)


def test_the_float8_control_fails_serving_at_a_tiny_size(tiny_serve):
    cfg, mix = tiny_serve
    _check(_cell("gelan-c.serve.host", cfg, mix, torch.device("cpu")),
           control.serve_readings)


def test_the_float8_control_fails_training_at_a_tiny_size(tiny_train):
    cfg, mix = tiny_train
    _check(_cell("yolov9-c.train.bf16", cfg, mix, torch.device("cpu")),
           control.train_readings)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gelan-c.serve.host",
                                  "yolov9-c.train.bf16"])
def test_the_float8_control_fails_at_the_cells_size(card, name):
    work = run.load(run.HERE / "workloads" / f"{name}.json")
    cfg = run.load(run.HERE / "configs" / f"{work['config']}.json")
    mix = run.load(run.HERE / "mixes" / f"{work['traffic']}.json")
    read = control.serve_readings if mix["kind"] == "serve" \
        else control.train_readings
    _check(_cell(name, cfg, mix, card), read)
