"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip on a machine without a CUDA device. On one with a
card and nvcc, run them without the JAX test setup (this file imports no
jax):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

chip_smoke.py makes the same comparisons at the main path's full shapes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.kernels import adown, nms, stem
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / \
    "dryrun_tiny.npz"
# f32: the kernels sum in another order than cuDNN; bf16: one rounding of
# the f32 result on each side, so at most about one bf16 ulp
ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, *shape, scale=1.0, dtype=torch.float32, cl=False):
    t = (torch.randn(*shape, generator=g) * scale).to(dtype)
    return t.contiguous(memory_format=torch.channels_last) if cl else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,c", [((2, 3, 32, 48), 64),
                                     ((1, 3, 25, 31), 16)])
def test_stem_kernel_matches_plain(cuda, dtype, shape, c):
    g = torch.Generator().manual_seed(0)
    x = _rand(g, *shape, dtype=dtype, cl=True).to(cuda)
    w = _rand(g, c, 3, 3, 3, scale=0.3, dtype=dtype).to(cuda)
    b = _rand(g, c, dtype=dtype).to(cuda)
    before = stem.launches
    y = stem.stem_conv(x, w, b)
    torch.cuda.synchronize()
    assert stem.launches == before + 1
    torch.testing.assert_close(y.float(), stem.stem_conv_plain(x, w, b).float(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [((1, 32, 8, 24), 32),
                                        ((2, 48, 10, 10), 64),
                                        ((1, 64, 9, 7), 64),
                                        ((1, 40, 8, 10), 24)])
def test_adown_kernel_matches_plain(cuda, dtype, shape, cout):
    """The last shape's channel counts are not multiples of 16: bf16 then
    takes the CUDA-core variant instead of the tensor-core one."""
    g = torch.Generator().manual_seed(1)
    cin = shape[1]
    x = _rand(g, *shape, dtype=dtype, cl=True).to(cuda)
    args = [_rand(g, cout // 2, cin // 2, 3, 3, scale=0.05, dtype=dtype),
            _rand(g, cout // 2, dtype=dtype),
            _rand(g, cout // 2, cin // 2, 1, 1, scale=0.1, dtype=dtype),
            _rand(g, cout // 2, dtype=dtype)]
    args = [a.to(cuda) for a in args]
    before = adown.launches
    y = adown.adown(x, *args)
    torch.cuda.synchronize()
    assert adown.launches == before + 1
    torch.testing.assert_close(y.float(), adown.adown_plain(x, *args).float(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("k", [100, 512, 8400])
def test_nms_kernel_matches_plain(cuda, k):
    g = torch.Generator().manual_seed(2)
    xy = torch.rand(3, k, 2, generator=g) * 600
    wh = torch.rand(3, k, 2, generator=g) * 60 + 5
    cls = torch.randint(0, 3, (3, k, 1), generator=g).float()
    boxes = (torch.cat([xy, xy + wh], -1) + cls * 7680).to(cuda)
    scores = torch.rand(3, k, generator=g)
    scores = torch.where(scores > 0.3, scores, 0.0).bfloat16().float()
    scores = scores.to(cuda)                  # bf16-rounded: many ties
    before = nms.launches
    idx = nms.nms_select(boxes, scores, 0.45, 300)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    assert torch.equal(idx, nms.nms_select_plain(boxes, scores, 0.45, 300))


def test_detector_cuda_matches_cpu(cuda, tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = YOLO.from_yaml(path)
    kw = {"img_size": 160, "compute_dtype": "float32"}
    gpu = Detector.from_checkpoint(model, str(FIXTURE), device=cuda, **kw)
    cpu = Detector.from_checkpoint(model, str(FIXTURE), device="cpu", **kw)
    images = make_eval_batch(4, 160, 0)["images"]
    a = {k: v.cpu() for k, v in gpu(images).items()}
    b = cpu(images)
    for k in ("valid", "classes"):
        assert torch.equal(a[k], b[k])
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
    assert a["valid"].sum(1).min() >= 1


# ---------------------------------------------------------------------------
# train kernels (stem raw + weight grad, ADown raw + backward)
# ---------------------------------------------------------------------------

def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


# weight gradients, relative L2 (chip_smoke.py's bounds): f32 sums in
# another order; bf16 rounds the avg and the max to bf16 before the
# tensor-core product, against the plain version's f32 values
WGRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,c", [((2, 3, 32, 48), 64),
                                     ((1, 3, 25, 31), 16)])
def test_stem_train_kernels_match_plain(cuda, dtype, shape, c):
    g0 = torch.Generator().manual_seed(3)
    x = _rand(g0, *shape, dtype=dtype, cl=True).to(cuda)
    w = _rand(g0, c, 3, 3, 3, scale=0.3, dtype=dtype).to(cuda)
    before = (stem.raw_launches, stem.wgrad_launches)
    y = stem.stem_conv_raw(x, w)
    g = _rand(g0, *y.shape, dtype=dtype, cl=True).to(cuda)
    dw = stem.stem_wgrad(x, g)
    torch.cuda.synchronize()
    assert (stem.raw_launches, stem.wgrad_launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y.float(),
                               stem.stem_conv_raw_plain(x, w).float(),
                               atol=ATOL[dtype], rtol=0)
    assert dw.dtype == torch.float32 and dw.shape == (c, 3, 3, 3)
    assert _rel_l2(dw, stem.stem_wgrad_plain(x, g)) <= WGRAD_REL[dtype]
    assert torch.equal(dw, stem.stem_wgrad(x, g))      # fixed-order sums


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [((2, 32, 16, 24), 32),
                                        ((1, 48, 10, 10), 48),
                                        ((2, 256, 16, 16), 256),
                                        ((1, 64, 9, 7), 64),
                                        ((1, 40, 8, 10), 24)])
def test_adown_train_kernels_match_plain(cuda, dtype, shape, cout):
    """Channel counts 32 and 48 are TINY_YAML's (48 takes the CUDA-core
    forward in bf16), 256 gelan-c's; odd H, W hit the avg-domain edges; the
    last shape's branch channels (20 in, 12 out) are not multiples of 8,
    so bf16 takes the CUDA-core backward too. Inputs are quantized to
    halves so that maxpool ties are common."""
    g0 = torch.Generator().manual_seed(4)
    cin = shape[1]
    x = (torch.round(torch.randn(*shape, generator=g0) * 2) / 2).to(dtype) \
        .contiguous(memory_format=torch.channels_last).to(cuda)
    w1 = _rand(g0, cout // 2, cin // 2, 3, 3, scale=0.05, dtype=dtype).to(cuda)
    w2 = _rand(g0, cout // 2, cin // 2, 1, 1, scale=0.1, dtype=dtype).to(cuda)
    before = (adown.raw_launches, adown.bwd_launches)
    y = adown.adown_raw(x, w1, w2)
    g = _rand(g0, *y.shape, dtype=dtype, cl=True).to(cuda)
    dx, dw1, dw2 = adown.adown_bwd(x, g, w1, w2)
    torch.cuda.synchronize()
    assert (adown.raw_launches, adown.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y.float(),
                               adown.adown_raw_plain(x, w1, w2).float(),
                               atol=ATOL[dtype], rtol=0)
    rdx, rdw1, rdw2 = adown.adown_bwd_plain(x, g, w1, w2)
    assert dx.dtype == dtype and dx.is_contiguous(
        memory_format=torch.channels_last)
    torch.testing.assert_close(dx.float(), rdx.float(), atol=ATOL[dtype],
                               rtol=0)
    assert _rel_l2(dw1, rdw1) <= WGRAD_REL[dtype]
    assert _rel_l2(dw2, rdw2) <= WGRAD_REL[dtype]
    again = adown.adown_bwd(x, g, w1, w2)                # fixed-order sums
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dw1, dw2)))


def test_tiny_train_step_cuda_matches_cpu(cuda, tmp_path):
    """One f32 TINY_YAML train step from the same init: cuda (kernels)
    against the CPU (plain versions)."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    batch = make_eval_batch(4, 96, 5)
    out = []
    for dev in (cuda, torch.device("cpu")):
        cfg = TrainConfig(data_parallel=False, output_dir=str(tmp_path))
        tr = Trainer(YOLO.from_yaml(path), config=cfg, train_loader=[batch],
                     device=dev)
        before = (stem.raw_launches, adown.bwd_launches)
        loss, items, _ = tr.train_step(batch["images"], batch["targets"])
        if dev.type == "cuda":
            assert stem.raw_launches == before[0] + 1
            assert adown.bwd_launches == before[1] + 4
        out.append((float(loss), {k: v.detach().cpu()
                                  for k, v in tr.params.items()}))
    (loss_c, p_c), (loss_h, p_h) = out
    assert abs(loss_c - loss_h) <= 1e-4 * abs(loss_h)
    for k in p_h:
        torch.testing.assert_close(p_c[k], p_h[k], atol=1e-5, rtol=1e-4)
