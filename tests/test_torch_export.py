"""The port's serving export on the CPU: `Detector.export` writes the whole
pixels-to-detections program to a `torch.export` archive, and the program
`Detector.load_exported` returns is held bit for bit against the live
Detector, and (f32) against the JAX Detector with tests/
test_torch_serving.py's bounds. The five serving kernels are custom ops
(`yolo_torch::*`): torch.library.opcheck holds each one's schema, fake
(shape, dtype, strides) and dispatch, and each equals its plain version.
An archive moved to another device (`device=` at export or load, the
CLI's `--target-device`) names no other device anywhere; on the CPU,
"meta" stands for the card. The trained fixture assets/dryrun_tiny.npz
with TINY_YAML at 160 px, so the detections are real.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.serving import Detector as JDetector
from yolo_re_tpu.train.checkpoint import load_weights as jload_weights
from yolo_re_tpu_torch.data.synth import TINY_DUAL_YAML, TINY_YAML, \
    make_eval_batch
from yolo_re_tpu_torch.models import blocks
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.kernels import adown, conv3, csp_chain, nms, stem
from yolo_re_tpu_torch.serving import Detector, ExportedDetector

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "assets" / "dryrun_tiny.npz"
# tests/test_torch_serving.py's bounds against the JAX Detector
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-5
KEYS = ("boxes", "scores", "classes", "valid")
CONF = 1e-3
BATCH, HEIGHT, WIDTH = 2, 120, 200


def _frames(seed: int) -> np.ndarray:
    """(2, 120, 200, 3) uint8: the middle rows of two synthetic frames."""
    return np.ascontiguousarray(
        make_eval_batch(BATCH, WIDTH, seed)["images"][:, 40:40 + HEIGHT])


def _assert_equal(a: dict, b: dict) -> None:
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


def _detector(tiny_yaml, dtype: str) -> Detector:
    return Detector.from_checkpoint(
        YOLO.from_yaml(tiny_yaml), str(FIXTURE), device="cpu", img_size=160,
        conf_thres=CONF, compute_dtype=dtype)


@pytest.fixture(scope="module")
def exported_f32(tiny_yaml, tmp_path_factory):
    """The f32 Detector, its archive's path and the loaded program."""
    det = _detector(tiny_yaml, "float32")
    path = str(tmp_path_factory.mktemp("export") / "tiny_f32.pt2")
    det.export(path, BATCH, height=HEIGHT, width=WIDTH)
    return det, path, Detector.load_exported(path)


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

def test_roundtrip_equals_live_and_matches_jax(exported_f32, tiny_yaml):
    det, _, run = exported_f32
    frames = _frames(1)
    live, loaded = det(frames), run(frames)
    _assert_equal(live, loaded)
    assert int(loaded["valid"].sum()) > 0
    ref = JDetector(JYOLO.from_yaml(tiny_yaml), *jload_weights(FIXTURE),
                    img_size=160, conf_thres=CONF,
                    compute_dtype="float32")(frames)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(loaded[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(loaded["boxes"].numpy(),
                               np.asarray(ref["boxes"]), atol=BOX_ATOL)
    np.testing.assert_allclose(loaded["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=SCORE_ATOL)


def test_roundtrip_bf16_equals_live(tiny_yaml, tmp_path):
    det = _detector(tiny_yaml, "bfloat16")
    path = str(tmp_path / "tiny_bf16.pt2")
    det.export(path, BATCH, height=HEIGHT, width=WIDTH)
    frames = _frames(2)
    loaded = Detector.load_exported(path)(frames)
    _assert_equal(det(frames), loaded)
    assert int(loaded["valid"].sum()) > 0


def test_dual_model_exports_its_main_branch(tmp_path):
    path = tmp_path / "tiny_dual.yaml"
    path.write_text(TINY_DUAL_YAML)
    model = YOLO.from_yaml(path)
    model.init_parameters(torch.Generator().manual_seed(0))
    det = Detector(model, model.state_dict(), device="cpu", img_size=128,
                   compute_dtype="float32", conf_thres=0.0)
    archive = str(tmp_path / "tiny_dual.pt2")
    det.export(archive, 2)
    run = Detector.load_exported(archive)
    assert run.shape == (2, 128, 128, 3)
    frames = make_eval_batch(2, 128, 7)["images"]
    loaded = run(frames)
    _assert_equal(det(frames), loaded)
    assert int(loaded["valid"].sum()) > 0
    # the aux branch is not in the program
    paths = {path for n in run.program.graph.nodes
             for path, _ in n.meta.get("nn_module_stack", {}).values()}
    assert any(".main_" in p for p in paths)
    assert not any(".aux_" in p or ".cb_" in p for p in paths)


# ---------------------------------------------------------------------------
# what the archive holds
# ---------------------------------------------------------------------------

def _sites(model: YOLO) -> dict[str, int]:
    """Launches of each conv kernel in one forward of a fused model."""
    mods = list(model.modules())
    return {
        "stem_conv": sum(isinstance(m, blocks.Conv) and m.is_stem
                         and m.bn is None for m in mods),
        "adown_packed": sum(isinstance(m, blocks.ADown) and m.packed
                            for m in mods),
        "bottleneck_chain_packed": sum(isinstance(m, blocks.RepNCSP)
                                       and m.chain for m in mods),
        "conv3_silu_packed": sum(isinstance(m, blocks.Conv) and m.is_conv3
                                 and m.bn is None for m in mods)}


def test_graph_holds_every_kernel_site(exported_f32):
    det, _, run = exported_f32
    ops = [n.target.name() for n in run.program.graph.nodes
           if n.op == "call_function"
           and str(n.target).startswith("yolo_torch.")]
    counts = {name: ops.count(f"yolo_torch::{name}")
              for name in (*_sites(det.model), "nms_select")}
    want = {**_sites(det.model), "nms_select": 1}
    assert counts == want
    # TINY_YAML has no chain site; each other kernel has at least one
    assert want["bottleneck_chain_packed"] == 0
    assert min(v for k, v in want.items()
               if k != "bottleneck_chain_packed") >= 1


def test_archive_holds_the_packed_buffers(exported_f32):
    """The non-persistent packed weight images (not in the state dict) are
    constants of the program, equal to the live model's."""
    det, _, run = exported_f32
    consts = run.program.constants
    packed = [(name, buf) for name, buf in det.model.named_buffers()
              if name.rsplit(".", 1)[-1] in ("adown_w1", "adown_w2",
                                             "conv3_w")]
    sites = _sites(det.model)
    assert len(packed) == 2 * sites["adown_packed"] + \
        sites["conv3_silu_packed"] > 0
    for name, buf in packed:
        assert torch.equal(consts[f"model.{name}"], buf), name


@pytest.mark.parametrize("frames", [
    np.zeros((BATCH, HEIGHT + 1, WIDTH, 3), np.uint8),
    np.zeros((BATCH + 1, HEIGHT, WIDTH, 3), np.uint8),
    np.zeros((BATCH, HEIGHT, WIDTH, 3), np.float32),
], ids=["height", "batch", "dtype"])
def test_wrong_input_raises(exported_f32, frames):
    _, _, run = exported_f32
    with pytest.raises(ValueError, match="the archive takes"):
        run(frames)


def test_loaded_program_runs_with_tf32_off(exported_f32):
    """The TF32 flags are global, not part of the graph: the loaded callable
    turns them off while it runs and restores the caller's."""
    _, _, run = exported_f32
    assert isinstance(run, ExportedDetector)
    seen = []
    handle = run.module.register_forward_pre_hook(lambda m, a: seen.append(
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32, torch.is_grad_enabled())))
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        run(_frames(3))
        assert seen == [(False, False, False)]
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        handle.remove()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# the archive on another device
# ---------------------------------------------------------------------------

def _devices(program: torch.export.ExportedProgram) -> set[str]:
    """Every device the program names: its weights and buffers, its tensor
    constants, the graph's `device=` arguments and `.to(device)` calls,
    and the tensors' metadata."""
    found = {str(v.device) for v in program.state_dict.values()}
    found |= {str(v.device) for v in program.constants.values()
              if isinstance(v, torch.Tensor)}
    for n in program.graph.nodes:
        if "device" in n.kwargs:
            found.add(str(n.kwargs["device"]))
        if n.target is torch.ops.aten.to.device:
            found.add(str(n.args[1]))
        vals = n.meta.get("val")
        for v in vals if isinstance(vals, (list, tuple)) else [vals]:
            if isinstance(v, torch.Tensor):
                found.add(str(v.device))
    return found


def test_cpu_archive_retargeted_to_meta_keeps_nothing_on_the_cpu(
        exported_f32):
    """`load_exported(device=)` moves every constant, buffer, packed
    weight image and `device=` of the graph; the archive on disk and the
    program loaded before are left as they were."""
    _, path, run = exported_f32
    assert _devices(run.program) == {"cpu"}
    moved = Detector.load_exported(path, device="meta")
    assert moved.device == torch.device("meta")
    assert _devices(moved.program) == {"meta"}
    consts = moved.program.constants
    assert any(k.endswith(".adown_w1") for k in consts)
    assert all(v.device.type == "meta" for v in consts.values()
               if isinstance(v, torch.Tensor))
    assert _devices(run.program) == {"cpu"}
    assert _devices(Detector.load_exported(path).program) == {"cpu"}


def test_cpu_archive_with_device_cpu_equals_live(exported_f32, tmp_path):
    """device="cpu" on a CPU archive, at load and at export, changes
    nothing: the output is torch.equal to the live Detector's."""
    det, path, _ = exported_f32
    frames = _frames(5)
    live = det(frames)
    run = Detector.load_exported(path, device="cpu")
    assert run.device == torch.device("cpu")
    _assert_equal(live, run(frames))
    archive = str(tmp_path / "cpu.pt2")
    det.export(archive, BATCH, height=HEIGHT, width=WIDTH, device="cpu")
    _assert_equal(live, Detector.load_exported(archive)(frames))
    assert int(live["valid"].sum()) > 0


# ---------------------------------------------------------------------------
# the five custom ops
# ---------------------------------------------------------------------------

def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _case(name: str, dtype: torch.dtype):
    """(args, plain result) of the op `yolo_torch::{name}` at small CPU
    shapes."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    if name == "stem_conv":
        x, w, b = _cl(rnd(2, 3, 17, 22)), rnd(16, 3, 3, 3, scale=0.3), rnd(16)
        return (x, w, b), stem.stem_conv_plain(x, w, b)
    if name == "adown_packed":
        x = _cl(rnd(2, 32, 12, 14))
        w1, w2 = rnd(16, 16, 3, 3, scale=0.2), rnd(16, 16, 1, 1, scale=0.2)
        b1, b2 = rnd(16), rnd(16)
        w1p, w2p = adown.pack_weights(w1, w2)
        return (x, w1p, b1, w2p, b2), adown.adown_plain(x, w1, b1, w2, b2)
    if name == "conv3_silu_packed":
        x, w, b = _cl(rnd(2, 64, 9, 11)), rnd(64, 64, 3, 3, scale=0.05), \
            rnd(64)
        return (x, conv3.pack_weights(w), b), conv3.conv3_silu_plain(x, w, b)
    if name == "bottleneck_chain_packed":
        # one 32-channel RepNCSP bottleneck at 32 x 32
        m = _cl(rnd(1, 32, 32, 32))
        w1, w2 = rnd(1, 32, 32, 3, 3, scale=0.06), \
            rnd(1, 32, 32, 3, 3, scale=0.06)
        b1, b2 = rnd(1, 32), rnd(1, 32)
        return (m, *csp_chain.pack_weights(w1, b1, w2, b2)), \
            csp_chain.bottleneck_chain_plain(m, w1, b1, w2, b2)
    boxes = torch.rand(2, 50, 4, generator=g) * 40
    boxes[..., 2:] += boxes[..., :2] + 1
    scores = torch.rand(2, 50, generator=g)
    return (boxes, scores, 0.45, 20), \
        nms.nms_select_plain(boxes, scores, 0.45, 20)


CASES = [(n, d) for n in ("stem_conv", "adown_packed", "conv3_silu_packed",
                          "bottleneck_chain_packed")
         for d in (torch.float32, torch.bfloat16)] + \
    [("nms_select", torch.float32)]


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in CASES])
def test_custom_op_opcheck_and_plain(name, dtype):
    args, plain = _case(name, dtype)
    op = getattr(torch.ops.yolo_torch, name).default
    torch.library.opcheck(op, args)
    out = op(*args)
    assert torch.equal(out, plain)
    assert out.stride() == plain.stride()
    fake = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args))
    assert (fake.shape, fake.dtype, fake.stride()) == \
        (out.shape, out.dtype, out.stride())


# ---------------------------------------------------------------------------
# the CLI, and loading in a fresh process with jax blocked
# ---------------------------------------------------------------------------

BLOCK_JAX = ("import sys\n"
             "for m in ('jax', 'jaxlib', 'yolo_re_tpu'):\n"
             "    sys.modules[m] = None\n")
JAX_LOADED = ("print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib') and sys.modules[m] is not None))\n")


def _run(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_cli_exports_and_a_fresh_process_loads(tiny_yaml, tmp_path):
    """The CLI exports and verifies with jax blocked, and saves the live
    Detector's output; a second process that imports only
    yolo_re_tpu_torch.serving loads the archive and gives the same
    output: the weights and the packed buffers are in the file."""
    archive, live, loaded, frames = (
        str(tmp_path / n) for n in ("tiny.pt2", "live.npz", "loaded.npz",
                                    "frames.npy"))
    np.save(frames, _frames(4))
    lines = _run(
        BLOCK_JAX + "import runpy\nimport numpy as np\n"
        f"sys.argv = ['export_serving', '--weights', {str(FIXTURE)!r}, "
        f"'--config', {tiny_yaml!r}, '--out', {archive!r}, '--batch', "
        f"'{BATCH}', '--img-size', '160', '--height', '{HEIGHT}', "
        f"'--width', '{WIDTH}', '--conf', '{CONF}', '--num-classes', '4', "
        "'--dtype', 'float32', '--device', 'cpu', '--verify']\n"
        "runpy.run_module('yolo_re_tpu_torch.cli.export_serving', "
        "run_name='__main__')\n"
        "from yolo_re_tpu_torch.models.yolo import YOLO\n"
        "from yolo_re_tpu_torch.serving import Detector\n"
        f"det = Detector.from_checkpoint(YOLO.from_yaml({tiny_yaml!r}), "
        f"{str(FIXTURE)!r}, device='cpu', img_size=160, conf_thres={CONF}, "
        "compute_dtype='float32')\n"
        f"out = det(np.load({frames!r}))\n"
        f"np.savez({live!r}, **{{k: v.numpy() for k, v in out.items()}})\n"
        + JAX_LOADED)
    assert lines[-3].startswith(f"wrote {archive}")
    assert lines[-2] == "verify: artifact output matches live pipeline"
    assert lines[-1] == "[]"
    lines = _run(
        BLOCK_JAX + "import numpy as np\n"
        "from yolo_re_tpu_torch.serving import Detector\n"
        f"out = Detector.load_exported({archive!r})(np.load({frames!r}))\n"
        f"np.savez({loaded!r}, **{{k: v.numpy() for k, v in out.items()}})\n"
        + JAX_LOADED)
    assert lines[-1] == "[]"
    a, b = np.load(live), np.load(loaded)
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["valid"].sum() > 0


def test_cli_target_device_writes_the_moved_archive(tiny_yaml, tmp_path):
    """`--target-device meta`, with jax blocked: the archive written holds
    every tensor and every `device=` on that device."""
    archive = str(tmp_path / "tiny_meta.pt2")
    lines = _run(
        BLOCK_JAX + "import runpy\n"
        f"sys.argv = ['export_serving', '--weights', {str(FIXTURE)!r}, "
        f"'--config', {tiny_yaml!r}, '--out', {archive!r}, '--batch', "
        f"'{BATCH}', '--img-size', '160', '--height', '{HEIGHT}', "
        f"'--width', '{WIDTH}', '--num-classes', '4', '--dtype', "
        "'float32', '--device', 'cpu', '--target-device', 'meta']\n"
        "runpy.run_module('yolo_re_tpu_torch.cli.export_serving', "
        "run_name='__main__')\n" + JAX_LOADED)
    assert lines[-2].startswith(f"wrote {archive}") and " on meta " in \
        lines[-2]
    assert lines[-1] == "[]"
    run = Detector.load_exported(archive)
    assert run.device == torch.device("meta")
    assert _devices(run.program) == {"meta"}
