"""The port's detect, train, convert_weights, export_weights and
bench_loader CLIs (yolo_re_tpu_torch/cli/) run in subprocesses with jax
and the JAX package blocked, on TINY_YAML and the CPU (`--device cpu`: the
kernels' plain versions); their outputs held against the JAX package's
own pipeline on the same weights and images. What cannot run without a
card, or is not ported, is refused.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.convert import torch_export as jexport
from yolo_re_tpu.data.augment import letterbox as jletterbox
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.ops.nms import nms_to_list as jnms_to_list
from yolo_re_tpu.ops.nms import non_max_suppression as jnms
from yolo_re_tpu.train import checkpoint as jckpt
from yolo_re_tpu_torch import convert, upstream
from yolo_re_tpu_torch.cli import bench_loader, detect, train
from yolo_re_tpu_torch.cli.detect import scale_boxes
from yolo_re_tpu_torch.data import synth
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.train import checkpoint

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "assets" / "dryrun_tiny.npz"
# the trained fixture's decoded boxes agree to 1e-3 px of the letterboxed
# canvas (tests/test_torch_model.py), its class scores to PARITY.md's
# 3.1e-5
BOX_ATOL, SCORE_ATOL = 1e-3, 3.1e-5
BLOCK_JAX = ("import runpy, sys\n"
             "for m in ('jax', 'jaxlib', 'yolo_re_tpu'):\n"
             "    sys.modules[m] = None\n")
JAX_LOADED = ("print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'yolo_re_tpu') and sys.modules[m] is not "
              "None))\n")


def _run_blocked(runs: list[tuple[str, list[str]]]) -> list[str]:
    """Run the CLI modules `runs` ((module, argv) pairs) one after another
    in one subprocess with jax blocked; returns its stdout lines, the last
    the jax modules it loaded."""
    code = BLOCK_JAX + "".join(
        f"sys.argv = [{mod!r}] + {argv!r}\n"
        f"runpy.run_module('yolo_re_tpu_torch.cli.{mod}', "
        f"run_name='__main__')\n" for mod, argv in runs) + JAX_LOADED
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    return lines


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """TINY_YAML in a file named gelan-c.yaml (its layers are a subset of
    gelan-c's, by name, so gelan-c's upstream layer map places them), a
    train and a val split on disk, and a wide image for the letterbox."""
    root = tmp_path_factory.mktemp("tiny")
    cfg = root / "gelan-c.yaml"
    cfg.write_text(synth.TINY_YAML)
    train_dir = synth.write_dataset(str(root / "data"), "train", 8, seed=0)
    val_dir = synth.write_dataset(str(root / "data"), "val", 3, seed=1)
    img = cv2.imread(str(Path(val_dir) / "im0.jpg"))
    cv2.imwrite(str(Path(val_dir) / "wide.png"),
                cv2.resize(img, (250, 150), interpolation=cv2.INTER_LINEAR))
    return {"root": root, "config": str(cfg), "train": train_dir,
            "val": val_dir}


def _jax_detections(config: str, paths: list[Path], img_size: int,
                    conf: float, iou: float, classes=None) -> dict:
    """scripts/detect.py's pipeline in the JAX package: letterbox, the
    fused model's predict, non_max_suppression, scale_boxes."""
    jmodel = JYOLO.from_yaml(config)
    params, stats = jmodel.fuse(*jckpt.load_weights(FIXTURE))
    out = {}
    for path in paths:
        img0 = cv2.imread(str(path))
        img, _, _ = jletterbox(img0, img_size, auto=False)
        x = jnp.asarray(img[None, :, :, ::-1].astype(np.float32) / 255.0)
        dec = jmodel.predict(params, stats, x)[0]
        det = jnms_to_list(jnms(dec, conf_thres=conf, iou_thres=iou,
                                classes=classes))[0]
        det[:, :4] = scale_boxes(det[:, :4], img.shape[:2], img0.shape[:2])
        out[path.name] = (det, min(img.shape[0] / img0.shape[0],
                                   img.shape[1] / img0.shape[1]))
    return out


def _assert_detections_equal(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    n = 0
    for name, (det, gain) in ref.items():
        mine = np.asarray(got[name], np.float32).reshape(-1, 6)
        assert mine.shape == det.shape, name
        np.testing.assert_array_equal(mine[:, 5], det[:, 5], err_msg=name)
        np.testing.assert_allclose(mine[:, 4], det[:, 4], atol=SCORE_ATOL,
                                   err_msg=name)
        # BOX_ATOL of the canvas is BOX_ATOL / gain of the image's pixels
        np.testing.assert_allclose(mine[:, :4], det[:, :4],
                                   atol=BOX_ATOL / gain, err_msg=name)
        n += len(det)
    assert n > 0


def test_convert_and_detect_cli_match_jax(tiny):
    """In one subprocess with jax blocked: cli.convert_weights turns the
    fixture, written as an upstream-schema `.pt`, into an .npz; cli.detect
    runs the fused model on the val images from the .npz, from the .pt in
    one hop, and with `--classes`. Detections equal JAX's."""
    root, cfg = tiny["root"], tiny["config"]
    model = YOLO.from_yaml(cfg)
    sd = convert.state_dict_from_jax(model.plan,
                                     *convert.load_weights(FIXTURE))
    torch.save(upstream.reference_to_upstream_sd(sd, "gelan-c"),
               root / "up.pt")
    common = ["--config", cfg, "--source", tiny["val"], "--img-size", "160",
              "--num-classes", "4", "--device", "cpu"]
    lines = _run_blocked([
        ("convert_weights", ["--weights", str(root / "up.pt"), "--config",
                             cfg, "--output", str(root / "up.npz")]),
        ("detect", ["--weights", str(root / "up.npz"), "--output",
                    str(root / "npz"), "--json", str(root / "npz.json")]
         + common),
        ("detect", ["--weights", str(root / "up.pt"), "--output",
                    str(root / "pt"), "--json", str(root / "pt.json")]
         + common),
        ("detect", ["--weights", str(root / "up.npz"), "--output",
                    str(root / "cls"), "--json", str(root / "cls.json"),
                    "--classes", "1", "2"] + common)])
    assert any("upstream yolov9 schema detected" in x for x in lines)
    assert any(x.startswith("average:") for x in lines)
    paths = sorted(Path(tiny["val"]).glob("*"))
    paths = [p for p in paths if p.suffix in (".jpg", ".png")]
    assert len(paths) == 4
    ref = _jax_detections(cfg, paths, 160, 0.25, 0.45)
    got = json.loads((root / "npz.json").read_text())
    _assert_detections_equal(got, ref)
    assert json.loads((root / "pt.json").read_text()) == got
    _assert_detections_equal(json.loads((root / "cls.json").read_text()),
                             _jax_detections(cfg, paths, 160, 0.25, 0.45,
                                             classes=(1, 2)))
    for p in paths:
        assert cv2.imread(str(root / "npz" / p.name)).shape == \
            cv2.imread(str(p)).shape


def test_train_cli_writes_checkpoints_both_packages_read(tiny):
    """cli.train, jax blocked: one epoch from the fixture's weights with
    validation; its last.npz and best.npz are read by the JAX package's
    checkpoint loader and by cli.val."""
    root, cfg = tiny["root"], tiny["config"]
    out = root / "train"
    lines = _run_blocked([
        ("train", ["--data", tiny["train"], "--val", tiny["val"],
                   "--num-classes", "4", "--config", cfg, "--weights",
                   str(FIXTURE), "--epochs", "1", "--batch", "4",
                   "--img-size", "96", "--workers", "2", "--augment",
                   "minimal", "--output", str(out), "--device", "cpu",
                   "--no-dp"]),
        ("val", ["--weights", str(out / "last.npz"), "--config", cfg,
                 "--data", tiny["val"], "--num-classes", "4", "--img-size",
                 "96", "--batch", "4", "--workers", "2", "--device",
                 "cpu"])])
    assert any(x.startswith("final:") for x in lines)
    assert lines[-2].startswith("map50=")
    ck = jckpt.load_checkpoint(out / "last.npz")
    assert (ck["epoch"], ck["global_step"]) == (0, 2)
    assert (out / "best.npz").exists()
    params, _ = convert.load_weights(out / "last.npz")
    np.testing.assert_array_equal(params["stem1"]["w"],
                                  ck["ema"]["params"]["stem1"]["w"])


def test_clis_default_to_cuda_and_refuse_what_is_not_ported(
        tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        detect.main(["--weights", str(FIXTURE), "--config", tiny["config"],
                     "--source", tiny["val"], "--num-classes", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--data", tiny["train"], "--config", tiny["config"],
                    "--num-classes", "4", "--workers", "1"])
    # multi-process training: incomplete rendezvous flags are refused, and
    # a cuda run without a card does not fall back to gloo
    for flags, match in (
            (["--coordinator", "localhost:1234"],
             "num_processes and process_id"),
            (["--num-processes", "2"], "coordinator address"),
            (["--process-id", "0"], "coordinator address")):
        with pytest.raises(ValueError, match=match):
            train.main(["--data", tiny["train"], "--device", "cpu"] + flags)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--data", tiny["train"], "--coordinator",
                    "localhost:1234", "--num-processes", "1",
                    "--process-id", "0"])
    with pytest.raises(SystemExit, match="Unsupported weights"):
        detect.main(["--weights", "w.onnx", "--config", tiny["config"],
                     "--source", tiny["val"], "--device", "cpu"])


def test_export_weights_cli_matches_jax_export(tiny):
    """cli.export_weights, jax blocked, from bare weights, from a training
    checkpoint .npz and from a checkpoint directory (both holding the
    fixture as their EMA weights and other raw weights): each .pt equals
    yolo_re_tpu/convert/torch_export.py: export_state_dict of the fixture
    key for key and tensor for tensor, and loads into the port's model
    with strict=True."""
    root, cfg = tiny["root"], tiny["config"]
    params, stats = jckpt.load_weights(FIXTURE)
    raw = jax.tree_util.tree_map(lambda v: np.asarray(v) + 1.0, params)
    state = dict(params=raw, stats=stats, opt_bufs={},
                 ema={"params": params, "stats": stats, "updates": 7},
                 epoch=2, global_step=9, best_fitness=0.5)
    checkpoint.save_checkpoint(root / "ckpt.npz", **state)
    checkpoint.save_checkpoint_dir(root / "ckpt_dir", **state)
    sources = (str(FIXTURE), str(root / "ckpt.npz"), str(root / "ckpt_dir"))
    outs = [str(root / f"export{i}.pt") for i in range(len(sources))]
    lines = _run_blocked([("export_weights", ["--weights", src, "--config",
                                              cfg, "--output", out])
                          for src, out in zip(sources, outs)])
    assert [ln.split(" from ")[0] for ln in lines[:-1]] == \
        [f"wrote {out}" for out in outs]
    assert "EMA weights" in lines[1] and "EMA weights" in lines[2]
    ref = jexport.export_state_dict(JYOLO.from_yaml(cfg).plan, params, stats)
    for out in outs:
        sd = torch.load(out)
        assert sd.keys() == ref.keys()
        for k, v in ref.items():
            assert sd[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
        model = YOLO.from_yaml(cfg)
        model.load_state_dict(upstream.port_state_dict(sd, model),
                              strict=True)


def test_bench_loader_cli_and_rates(tiny, monkeypatch):
    """cli.bench_loader, jax blocked, on its own synthetic set; and
    loader_rates on the train split, which restores YOLO_TPU_NATIVE."""
    lines = _run_blocked([("bench_loader", ["--n", "8", "--img-size", "64",
                                            "--batch", "4", "--workers", "2",
                                            "--epochs", "1"])])
    assert lines[0].startswith("cv2 pipeline:")
    assert lines[1].startswith("native pipeline:") and lines[1].endswith(
        "x)")
    monkeypatch.setenv("YOLO_TPU_NATIVE", "auto")
    rates = bench_loader.loader_rates(tiny["train"], img_size=64, batch=4,
                                      workers=2, epochs=1)
    assert rates.keys() == {"cv2", "native"}
    assert min(rates.values()) > 0
    assert os.environ["YOLO_TPU_NATIVE"] == "auto"
