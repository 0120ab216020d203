"""The port's entry points run their work with TF32 off and restore the
caller's flags (yolo_re_tpu_torch/utils/precision.py, `full_f32`).

PyTorch lets cuDNN run f32 convolutions in TF32 by default, and a caller
may let cuBLAS do the same for f32 matmuls; the JAX package runs f32 at
HIGHEST precision. A forward pre-hook on the model records the two TF32
flags and `cudnn.enabled` inside an f32 (and a bf16) `Detector.__call__`,
an `Evaluator` batch and a `Trainer.train_step`, on the CPU with TINY_YAML
at 64 px: TF32 off inside, `cudnn.enabled` as the caller left it, and the
caller's flags back afterwards, also when the call raises.
tests/test_torch_cuda.py holds the same entry points to the CPU on a card
with the flags at PyTorch's defaults.
"""

import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer
from yolo_re_tpu_torch.utils.precision import full_f32

SIZE = 64
CUDNN, MATMUL = torch.backends.cudnn, torch.backends.cuda.matmul


def _flags() -> tuple[bool, bool, bool]:
    return CUDNN.allow_tf32, MATMUL.allow_tf32, CUDNN.enabled


@pytest.fixture
def caller():
    """A caller that allowed TF32 everywhere; its flags are put back after
    the test whatever happens."""
    saved = _flags()
    CUDNN.allow_tf32 = MATMUL.allow_tf32 = True
    yield _flags()
    CUDNN.allow_tf32, MATMUL.allow_tf32, CUDNN.enabled = saved


class _Boom(RuntimeError):
    pass


def _hook(seen: list, fail: bool):
    def hook(module, args):
        seen.append(_flags())
        if fail:
            raise _Boom("raised inside the model")
    return hook


def _run(entry: str, dtype: str, tmp_path, seen: list, fail: bool) -> None:
    """One call of an entry point on the CPU with the recording hook on the
    model it runs (the Detector's and the Evaluator's model copies carry
    the hook with them)."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = YOLO.from_yaml(path)
    model.init_parameters(torch.Generator().manual_seed(0))
    batch = make_eval_batch(2, SIZE, 0)
    if entry == "detector":
        det = Detector(model, model.state_dict(), device="cpu",
                       img_size=SIZE, compute_dtype=dtype)
        det.model.register_forward_pre_hook(_hook(seen, fail))
        det(batch["images"])
    elif entry == "evaluator":
        sd = model.state_dict()
        model.register_forward_pre_hook(_hook(seen, fail))
        Evaluator(model, [batch], compute_dtype=dtype,
                  device="cpu").evaluate(sd)
    else:
        cfg = TrainConfig(data_parallel=False, compute_dtype=dtype,
                          output_dir=str(tmp_path))
        trainer = Trainer(model, config=cfg, train_loader=[batch],
                          device="cpu")
        model.register_forward_pre_hook(_hook(seen, fail))
        trainer.train_step(batch["images"], batch["targets"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["detector", "evaluator", "trainer"])
def test_entry_points_run_without_tf32(entry, dtype, tmp_path, caller):
    seen: list = []
    _run(entry, dtype, tmp_path, seen, fail=False)
    assert seen, "the hook never ran"
    assert set(seen) == {(False, False, caller[2])}
    assert _flags() == caller


@pytest.mark.parametrize("entry", ["detector", "evaluator", "trainer"])
def test_entry_points_restore_the_flags_after_an_exception(entry, tmp_path,
                                                           caller):
    seen: list = []
    with pytest.raises(_Boom):
        _run(entry, "float32", tmp_path, seen, fail=True)
    assert seen == [(False, False, caller[2])]
    assert _flags() == caller


@pytest.mark.parametrize("enabled", [True, False])
def test_full_f32_leaves_cudnn_enabled_alone(enabled, caller):
    """`cudnn.enabled` is never changed, nested blocks restore in order,
    and the caller's mix of flags comes back as it was."""
    CUDNN.enabled = enabled
    MATMUL.allow_tf32 = False
    before = _flags()
    with full_f32():
        assert _flags() == (False, False, enabled)
        with full_f32():
            assert _flags() == (False, False, enabled)
        assert _flags() == (False, False, enabled)
    assert _flags() == before == (True, False, enabled)
