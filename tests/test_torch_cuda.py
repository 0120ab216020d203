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

from yolo_re_tpu_torch.convert import load_weights
from yolo_re_tpu_torch.data.config import DataConfig
from yolo_re_tpu_torch.data.dataset import create_dataloader
from yolo_re_tpu_torch.data.synth import TINY_YAML, make_eval_batch, \
    write_dataset
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.kernels import adown, conv3, csp_chain, nms, stem
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
# stage1 kernels (conv3, the bottleneck chain) and the Evaluator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 5, 7), (1, 16, 64)])
def test_conv3_kernel_matches_plain(cuda, dtype, shape):
    """H, W that are not multiples of the tile, and one that is."""
    g = torch.Generator().manual_seed(7)
    x = _rand(g, shape[0], 64, *shape[1:], dtype=dtype, cl=True).to(cuda)
    w = _rand(g, 64, 64, 3, 3, scale=0.05, dtype=dtype).to(cuda)
    b = _rand(g, 64, dtype=dtype).to(cuda)
    before = conv3.launches
    y = conv3.conv3_silu(x, w, b)
    torch.cuda.synchronize()
    assert conv3.launches == before + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y.float(),
                               conv3.conv3_silu_plain(x, w, b).float(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 5, 7)])
def test_chain_kernel_matches_plain(cuda, dtype, n, shape):
    """Odd H, W put the image border inside tiles, where every
    intermediate outside the image must be zero; biases of 0.5 make
    SiLU(bias) there clearly non-zero."""
    g = torch.Generator().manual_seed(8)
    m = _rand(g, shape[0], 32, *shape[1:], dtype=dtype, cl=True).to(cuda)
    args = [_rand(g, n, 32, 32, 3, 3, scale=0.06, dtype=dtype),
            _rand(g, n, 32, dtype=dtype) * 0.5 + 0.5,
            _rand(g, n, 32, 32, 3, 3, scale=0.06, dtype=dtype),
            _rand(g, n, 32, dtype=dtype) * 0.5 + 0.5]
    args = [a.to(cuda) for a in args]
    before = csp_chain.launches
    y = csp_chain.bottleneck_chain(m, *args)
    torch.cuda.synchronize()
    assert csp_chain.launches == before + 1
    ref = csp_chain.bottleneck_chain_plain(m, *args)
    # bf16: each of the 2n convs may round its output one ulp apart
    atol = ATOL[dtype] * (n if dtype == torch.bfloat16 else 1)
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=0)


def test_stage1_wrappers_refuse_on_cuda(cuda):
    cl = torch.channels_last
    x = torch.zeros(1, 64, 8, 8, device=cuda).contiguous(memory_format=cl)
    w = torch.zeros(64, 64, 3, 3, device=cuda)
    b = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        conv3.conv3_silu(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="cuda"):
        conv3.conv3_silu(x, w.cpu(), b)
    with pytest.raises(ValueError, match="channels_last"):
        conv3.conv3_silu(x.contiguous(), w, b)
    m = torch.zeros(1, 32, 8, 8, device=cuda).contiguous(memory_format=cl)
    ws = torch.zeros(1, 32, 32, 3, 3, device=cuda)
    bs = torch.zeros(1, 32, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        csp_chain.bottleneck_chain(m.bfloat16(), ws, bs, ws, bs)
    with pytest.raises(ValueError, match="1 to 4"):
        csp_chain.bottleneck_chain(m, *(t.expand(5, *t.shape[1:])
                                        .contiguous() for t in
                                        (ws, bs, ws, bs)))


def test_evaluator_cuda_matches_cpu(cuda, tmp_path):
    """The trained tiny fixture, f32, fused, on its 16-image val set: the
    same mAP on cuda (kernels) as on the CPU (plain versions)."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    val = write_dataset(str(tmp_path), "val", 16, seed=1)
    data = DataConfig(val_path=val, num_classes=4, img_size=160,
                      batch_size=8, workers=2)
    weights = load_weights(str(FIXTURE))
    res = []
    for dev in (cuda, "cpu"):
        ev = Evaluator(YOLO.from_yaml(path), create_dataloader(val, data,
                                                               "val"),
                       device=dev)
        before = nms.launches
        res.append(ev.evaluate(weights))
        if dev is cuda:
            assert nms.launches == before + 2
    assert res[0]["map50"] > 0.5
    for k in ("map50", "map"):
        assert abs(res[0][k] - res[1][k]) <= 1e-3, (k, res)


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
