"""The port's dry run (dryrun_torch.py) and device helpers
(yolo_re_tpu_torch/utils/devices.py) on the CPU: `dryrun_multichip` in two
gloo processes on TINY_YAML with jax blocked in each, its failure path,
`entry()`, and the refusal to fall back to the CPU without a card.
"""

import math
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu_torch.data.synth import TINY_YAML
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.utils import devices

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import dryrun_torch  # noqa: E402

# the issue's bound for two gloo processes on TINY_YAML (measured ~25 s
# alone)
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


def test_dryrun_two_gloo_processes(tiny_yaml, monkeypatch, capsys):
    """Three DDP steps (the third augmented), npz and directory resume,
    mesh serving and eval, and the trained fixture's detections and
    mAP50 through the mesh, within TIMEOUT_S."""
    # one thread a process, as tests/test_torch_parallel.py runs its ranks
    # (on a loaded machine a second thread's waits between the small
    # collectives doubled the run's time)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = dryrun_torch.dryrun_multichip(2, device="cpu",
                                        model_yaml=tiny_yaml,
                                        timeout=TIMEOUT_S)
    assert out["seconds"] < TIMEOUT_S
    assert out["fixture_det"] > 0 and out["fixture_map50"] > 0.2
    assert len(out["losses"]) == 3 and all(map(math.isfinite,
                                               out["losses"]))
    assert out["resumed"].keys() == {"npz", "orbax"}
    assert all(map(math.isfinite, out["resumed"].values()))
    assert math.isfinite(out["map50"]) and out["n_det"] >= 0
    # the CPU runs the kernels' plain versions, which count no launch
    assert len(out["launches"]) == 9 and not any(out["launches"].values())
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2, cpu): OK")


def test_dryrun_failure_raises_with_every_stderr(tmp_path):
    """A config that does not exist: both processes fail after the
    rendezvous, and the error carries each one's stderr."""
    with pytest.raises(RuntimeError) as err:
        dryrun_torch.dryrun_multichip(
            2, device="cpu", model_yaml=str(tmp_path / "missing.yaml"),
            timeout=TIMEOUT_S)
    msg = str(err.value)
    assert "process 0:" in msg and "process 1:" in msg
    assert msg.count("missing.yaml") >= 2


def test_dryrun_refuses_cards_it_does_not_have(monkeypatch):
    """The default and "cuda" want one card per process and never fall
    back to the CPU: no card, or fewer cards than processes, raises
    before any process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for kw in ({}, {"device": "auto"}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="does not fall back"):
            dryrun_torch.dryrun_multichip(1, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 card"):
        dryrun_torch.dryrun_multichip(2)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        dryrun_torch.dryrun_multichip(1, device="tpu")


def test_entry_fused_gelan_c_forward_on_the_cpu():
    """entry() on the CPU when asked: the fused gelan-c forward and a
    (1, 3, 640, 640) float32 example; run here at 64 px."""
    fn, (example,) = dryrun_torch.entry(device="cpu")
    assert example.shape == (1, 3, 640, 640)
    assert example.dtype == torch.float32 and example.device.type == "cpu"
    decoded, raw = fn(torch.rand(1, 3, 64, 64))
    assert decoded.shape == (1, 8 * 8 + 4 * 4 + 2 * 2, 84)
    assert torch.isfinite(decoded).all() and len(raw) == 3
    model = YOLO.from_yaml(dryrun_torch.GELAN_C)
    assert model.num_classes == 80


def test_devices_without_a_card(monkeypatch):
    """"auto" means the first card and raises without one (no CPU
    fallback); the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for prefer in ("auto", "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="does not fall back"):
            devices.get_device(prefer)
    assert devices.get_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        devices.get_device("tpu")
    assert devices.device_summary() == "cpu: 1x cpu"
    with pytest.raises(RuntimeError, match="does not fall back"):
        dryrun_torch.entry()


def test_devices_on_cards(monkeypatch):
    """With cards (faked here): "auto" is cuda:0, an index past the last
    card raises, and the summary counts the cards by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert devices.get_device() == torch.device("cuda", 0)
    assert devices.get_device("cuda:1") == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="2 CUDA device"):
        devices.get_device("cuda:2")
    assert devices.device_summary() == "cuda: 2x NVIDIA H100 80GB HBM3"
