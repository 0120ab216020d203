"""Checkpoint directories in the port (`checkpoint_format="orbax"`:
a torch.distributed.checkpoint directory with config.json beside it,
train/checkpoint.py) on the CPU: the npz contract of the JAX package's
tests/test_train.py:123, detection of a directory, its EMA weights for
serving, resume from a directory against resume from an .npz, and the
refusal of a JAX orbax directory.
"""

import json

import numpy as np
import pytest
import torch

from yolo_re_tpu_torch.convert import load_weights
from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.checkpoint import (
    is_checkpoint_dir,
    load_checkpoint,
    save_checkpoint,
    save_checkpoint_dir,
)
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


def _contract():
    """tests/test_train.py:123's trees."""
    params = {"layer": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    stats = {"layer": {"mean": np.ones(3, np.float32)}}
    ema = {"params": params, "stats": stats, "updates": np.int32(7)}
    bufs = {"layer": {"w": np.zeros((2, 3), np.float32)}}
    return dict(params=params, stats=stats, ema=ema, opt_bufs=bufs, epoch=3,
                global_step=42, best_fitness=0.5, config={"lr": 0.01})


def test_checkpoint_dir_roundtrip(tmp_path):
    """The npz round trip's contract through a directory, which
    load_checkpoint detects by itself; saving again replaces it."""
    path = tmp_path / "ckpt"
    save_checkpoint_dir(path, **_contract())
    assert path.is_dir() and is_checkpoint_dir(path)
    assert (path / "config.json").is_file()
    ckpt = load_checkpoint(path)
    np.testing.assert_array_equal(ckpt["params"]["layer"]["w"],
                                  np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))
    np.testing.assert_array_equal(ckpt["stats"]["layer"]["mean"],
                                  np.ones(3, np.float32))
    np.testing.assert_array_equal(ckpt["opt"]["layer"]["w"],
                                  np.zeros((2, 3), np.float32))
    assert ckpt["epoch"] == 3
    assert ckpt["global_step"] == 42
    assert ckpt["best_fitness"] == 0.5
    assert int(ckpt["ema"]["updates"]) == 7
    assert ckpt["config"]["lr"] == 0.01
    kw = _contract()
    kw["epoch"] = 4
    save_checkpoint_dir(path, **kw)
    assert load_checkpoint(path)["epoch"] == 4
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt"]


def test_directory_and_npz_load_alike(tmp_path):
    """The same state saved as .npz and as a directory loads to the same
    trees, empty sections included."""
    kw = _contract()
    kw["params"] = {**kw["params"], "concat": {}}
    save_checkpoint(tmp_path / "a.npz", **kw)
    save_checkpoint_dir(tmp_path / "a", **kw)
    a, b = load_checkpoint(tmp_path / "a.npz"), load_checkpoint(tmp_path / "a")
    assert a.keys() == b.keys()
    assert b["params"]["concat"] == {}

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}{k}/").items()}
        return {prefix: np.asarray(tree)}

    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("dir")
    (d / "tiny.yaml").write_text(TINY_YAML)
    batches = [make_eval_batch(2, 64, 40 + s) for s in range(3)]
    return str(d / "tiny.yaml"), batches, d


def _trainer(tiny, fmt: str, out: str) -> Trainer:
    path, batches, _ = tiny
    cfg = TrainConfig(epochs=1, data_parallel=False, checkpoint_format=fmt,
                      output_dir=out)
    return Trainer(YOLO.from_yaml(path), config=cfg, train_loader=batches,
                   device="cpu")


def test_trainer_writes_directories_and_resumes_alike(tiny):
    """train() with checkpoint_format "orbax" writes output_dir/last as a
    directory; a fresh Trainer resumed from it equals one resumed from
    the same state as .npz, and the next step's loss items are the same
    bits."""
    path, batches, d = tiny
    t = _trainer(tiny, "orbax", str(d / "run"))
    t.train()
    assert is_checkpoint_dir(d / "run" / "last")
    assert not (d / "run" / "last.npz").exists()
    t.config.checkpoint_format = "npz"
    t._save(d / "run" / "last.npz", 0)
    states = []
    for src in (d / "run" / "last", d / "run" / "last.npz"):
        r = _trainer(tiny, "npz", str(d / "resumed"))
        r.load_checkpoint(src)
        assert (r.global_step, r.start_epoch) == (3, 1)
        items = r.train_step(batches[0]["images"], batches[0]["targets"])[1]
        states.append(({**r.model.state_dict(), **r.opt_bufs,
                        **{f"ema.{k}": v for k, v in r.ema["params"].items()}},
                       items))
    (a, ia), (b, ib) = states
    assert torch.equal(ia, ib)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    cfg = json.loads((d / "run" / "last" / "config.json").read_text())
    assert cfg["checkpoint_format"] == "orbax"


def test_load_weights_of_a_directory_gives_the_ema(tiny):
    """load_weights(dir) gives the checkpoint's EMA weights, as for an
    .npz checkpoint, and Detector.from_checkpoint serves from it what it
    serves from the .npz."""
    path, batches, d = tiny
    t = _trainer(tiny, "orbax", str(d / "ema"))
    for b in batches:
        t.train_step(b["images"], b["targets"])
    t._save(d / "ema" / "ckpt.npz", 0)
    t.config.checkpoint_format = "npz"
    t._save(d / "ema" / "ckpt.npz", 0)
    params, stats = load_weights(d / "ema" / "ckpt")
    ckpt = load_checkpoint(d / "ema" / "ckpt")
    np.testing.assert_array_equal(params["stem1"]["w"],
                                  ckpt["ema"]["params"]["stem1"]["w"])
    ema = t.ema["params"]["layers.stem1.conv.weight"]
    np.testing.assert_array_equal(
        params["stem1"]["w"], np.transpose(ema.numpy(), (2, 3, 1, 0)))
    assert not np.array_equal(params["stem1"]["w"],
                              ckpt["params"]["stem1"]["w"])
    frames = make_eval_batch(2, 64, 9)["images"]
    kw = {"device": "cpu", "img_size": 64, "compute_dtype": "float32",
          "conf_thres": 0.0}
    a = Detector.from_checkpoint(YOLO.from_yaml(path), str(d / "ema" / "ckpt"),
                                 **kw)(frames)
    b = Detector.from_checkpoint(YOLO.from_yaml(path),
                                 str(d / "ema" / "ckpt.npz"), **kw)(frames)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_a_directory_that_is_no_checkpoint_is_refused(tiny, tmp_path):
    (tmp_path / "empty").mkdir()
    for fn in (load_checkpoint, load_weights):
        with pytest.raises(ValueError, match="npz"):
            fn(tmp_path / "empty")
    with pytest.raises(ValueError, match="checkpoint_format"):
        _trainer(tiny, "zarr", str(tmp_path))


def test_a_jax_orbax_directory_is_refused(tmp_path):
    """A JAX package orbax directory: the port cannot read it (orbax
    imports jax) and says that npz is the format both packages read."""
    pytest.importorskip("orbax.checkpoint")
    from yolo_re_tpu.train.checkpoint import save_checkpoint_orbax

    save_checkpoint_orbax(tmp_path / "jax", **_contract())
    assert (tmp_path / "jax" / "config.json").is_file()
    with pytest.raises(ValueError, match="npz is the format both"):
        load_checkpoint(tmp_path / "jax")
    with pytest.raises(ValueError, match="orbax"):
        load_weights(tmp_path / "jax")


def test_save_format_overrides_the_config(tiny):
    """`Trainer.save(path, format=)` writes either form whatever the
    config says, the two load alike, and an unknown format raises."""
    path, batches, d = tiny
    t = _trainer(tiny, "npz", str(d / "fmt"))
    t.train_step(batches[0]["images"], batches[0]["targets"])
    t.save(d / "fmt" / "ckpt.npz", format="orbax")
    assert is_checkpoint_dir(d / "fmt" / "ckpt")
    assert not (d / "fmt" / "ckpt.npz").exists()
    t.save(d / "fmt" / "ckpt.npz")
    assert (d / "fmt" / "ckpt.npz").is_file()
    assert t.config.checkpoint_format == "npz"
    a, b = (load_checkpoint(d / "fmt" / n) for n in ("ckpt", "ckpt.npz"))
    assert a["global_step"] == b["global_step"] == 1
    np.testing.assert_array_equal(a["params"]["stem1"]["w"],
                                  b["params"]["stem1"]["w"])
    with pytest.raises(ValueError, match="'npz' or 'orbax'"):
        t.save(d / "fmt" / "x.npz", format="pt")
