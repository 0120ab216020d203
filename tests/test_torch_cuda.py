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


# (x shape, Cout, weights at 1/sqrt(fan-in)): TINY_YAML's widths (32; 48
# with Ch = 24, not a multiple of 16); Co = 256 per branch (the N = 256
# instance) at odd H, W; Ho = 21, which no tile height divides; more tiles
# than persistent CTAs, the last round ragged; Co = 512 per branch (two
# n-blocks); 2 x 2 and 3 x 5 inputs (one output row, an avg domain of one
# row). The wide cases draw their weights at 1/sqrt(fan-in), as the
# model's init does, the others at 0.05 (3x3) and 0.1 (1x1).
ADOWN_SHAPES = [((1, 32, 8, 24), 32, False), ((2, 48, 10, 10), 64, False),
                ((1, 64, 9, 7), 64, False), ((1, 40, 8, 10), 24, False),
                ((2, 48, 20, 18), 48, False), ((2, 512, 37, 41), 512, True),
                ((1, 256, 42, 36), 256, True), ((3, 256, 66, 70), 256, True),
                ((3, 256, 160, 168), 256, True),
                ((1, 1024, 12, 14), 1024, True), ((2, 32, 2, 2), 32, False),
                ((2, 32, 3, 5), 32, False)]


def _w_scales(ch: int, fan_in: bool) -> tuple[float, float]:
    return (1 / (9 * ch) ** 0.5, 1 / ch ** 0.5) if fan_in else (0.05, 0.1)


def _adown_atol(dtype: torch.dtype, ref: torch.Tensor,
                fan_in: bool) -> float:
    """ATOL, which is about one bf16 ulp for outputs below 4; the wide
    cases' outputs reach 4-8, where one bf16 ulp is 2^-5, and are held to
    4 ulps of their largest output instead (chip_smoke.py's tolerance)."""
    if fan_in and dtype == torch.bfloat16:
        return 2.0 ** -6 * max(1.0, float(ref.abs().max()))
    return ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,fan_in", ADOWN_SHAPES)
def test_adown_kernel_matches_plain(cuda, dtype, shape, cout, fan_in):
    """(1, 40, 8, 10) -> 24: channel counts that are not multiples of 16,
    so bf16 takes the CUDA-core variant instead of the tensor-core one.
    `adown` packs the weights (one pack launch) and launches the kernel;
    `adown_packed` on the plain packing gives the same output, and so does
    a second call."""
    g = torch.Generator().manual_seed(1)
    cin = shape[1]
    s1, s2 = _w_scales(cin // 2, fan_in)
    x = _rand(g, *shape, dtype=dtype, cl=True).to(cuda)
    args = [_rand(g, cout // 2, cin // 2, 3, 3, scale=s1, dtype=dtype),
            _rand(g, cout // 2, dtype=dtype),
            _rand(g, cout // 2, cin // 2, 1, 1, scale=s2, dtype=dtype),
            _rand(g, cout // 2, dtype=dtype)]
    args = [a.to(cuda) for a in args]
    before = (adown.launches, adown.pack_launches)
    y = adown.adown(x, *args)
    torch.cuda.synchronize()
    assert (adown.launches, adown.pack_launches) == \
        (before[0] + 1, before[1] + 1)
    ref = adown.adown_plain(x, *args)
    torch.testing.assert_close(y.float(), ref.float(),
                               atol=_adown_atol(dtype, ref, fan_in), rtol=0)
    w1p, w2p = adown.pack_weights_plain(args[0], args[2])
    assert torch.equal(adown.adown_packed(x, w1p, args[1], w2p, args[3]), y)


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "f32_to_bf16", "bf16_to_f32"])
@pytest.mark.parametrize("ch,co", [(16, 16), (24, 24), (20, 12), (128, 128),
                                   (256, 256), (512, 512)])
def test_adown_pack_kernel_matches_plain(cuda, dtypes, ch, co):
    """The pack kernel (one launch, with the cast) writes the plain
    packing bit for bit, zero padding included."""
    g = torch.Generator().manual_seed(11)
    src, dst = dtypes
    w1 = _rand(g, co, ch, 3, 3, dtype=src).to(cuda)
    w2 = _rand(g, co, ch, 1, 1, dtype=src).to(cuda)
    before = adown.pack_launches
    got = adown.pack_weights(w1, w2, dst)
    torch.cuda.synchronize()
    assert adown.pack_launches == before + 1
    want = adown.pack_weights_plain(w1, w2, dst)
    assert all(a.dtype == dst and torch.equal(a, b)
               for a, b in zip(got, want))


def _cuda_kernels(fn) -> list[str]:
    """Names of the CUDA kernels fn() runs, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def test_fused_adown_makes_one_launch(cuda):
    """A fused ADown runs one CUDA kernel per call (its weights packed at
    fuse time: no per-call permute or pack); the train forward two (the
    pack, which casts the f32 weights, and the kernel)."""
    from yolo_re_tpu_torch.models.blocks import ADown
    from yolo_re_tpu_torch.models.fuse import fuse_model

    g = torch.Generator().manual_seed(12)
    mod = fuse_model(ADown(256, 256).eval()).to(cuda, torch.bfloat16)
    x = _rand(g, 2, 256, 40, 40, dtype=torch.bfloat16, cl=True).to(cuda)
    before = adown.launches
    with torch.no_grad():
        names = _cuda_kernels(lambda: mod(x))
    assert len(names) == 1 and "adown" in names[0], names
    assert adown.launches == before + 2
    w1 = _rand(g, 128, 128, 3, 3, scale=0.05).to(cuda)
    w2 = _rand(g, 128, 128, 1, 1, scale=0.1).to(cuda)
    names = _cuda_kernels(lambda: adown.adown_raw(x, w1, w2))
    assert len(names) == 2, names
    assert torch.equal(adown.adown_raw(x, w1, w2),
                       adown.adown_raw(x, w1.bfloat16(), w2.bfloat16()))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 160, 160), (1, 80, 80), (1, 20, 24)],
                         ids=["many_tiles", "stage2", "fewer_tiles_than_sms"])
def test_conv3_kernel_persistent_walk(cuda, dtype, shape):
    """The persistent grid: 300 tiles over 132 CTAs (a ragged last round),
    gelan-c's 80 x 80 sites, and 4 tiles (fewer CTAs than SMs), through
    the packed call a fused Conv makes."""
    g = torch.Generator().manual_seed(9)
    x = _rand(g, shape[0], 64, *shape[1:], dtype=dtype, cl=True).to(cuda)
    w = _rand(g, 64, 64, 3, 3, scale=0.05, dtype=dtype).to(cuda)
    b = _rand(g, 64, dtype=dtype).to(cuda)
    wp = conv3.pack_weights(w)
    before = conv3.launches
    y = conv3.conv3_silu_packed(x, wp, b)
    torch.cuda.synchronize()
    assert conv3.launches == before + 1
    torch.testing.assert_close(y.float(),
                               conv3.conv3_silu_plain(x, w, b).float(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(3, 37, 53), (4, 160, 168)],
                         ids=["border", "many_tiles"])
def test_chain_kernel_persistent_walk(cuda, dtype, n, shape):
    """n = 1-4: resident weights (n <= 2) and weights streamed conv by
    conv (n = 3, 4); tiles cut by the border, and more tiles than CTAs
    (each CTA walks several, the last round ragged)."""
    g = torch.Generator().manual_seed(10 + n)
    m = _rand(g, shape[0], 32, *shape[1:], dtype=dtype, cl=True).to(cuda)
    args = [_rand(g, n, 32, 32, 3, 3, scale=0.06, dtype=dtype),
            _rand(g, n, 32, dtype=dtype) * 0.5 + 0.5,
            _rand(g, n, 32, 32, 3, 3, scale=0.06, dtype=dtype),
            _rand(g, n, 32, dtype=dtype) * 0.5 + 0.5]
    args = [a.to(cuda) for a in args]
    wp, bias = csp_chain.pack_weights(*args)
    before = csp_chain.launches
    y = csp_chain.bottleneck_chain_packed(m, wp, bias)
    torch.cuda.synchronize()
    assert csp_chain.launches == before + 1
    ref = csp_chain.bottleneck_chain_plain(m, *args)
    # bf16: a rounding of one conv that differs by one ulp carries through
    # the later bottlenecks, whose residual grows to ~16 at n = 4: 4 ulps
    # of the largest output (chip_smoke.py's tolerance)
    atol = (2.0 ** -6 * max(1.0, float(ref.abs().max()))
            if dtype == torch.bfloat16 else ATOL[dtype])
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(1, 37, 53), (2, 61, 45)],
                         ids=["one_image", "two_images"])
def test_chain_f32_kernel_matches_plain(cuda, n, shape):
    """The f32 chain (3xTF32 products, tiles of 20 - 4n pixels a side):
    H and W that no tile side divides, one image and two, one launch per
    call, within the f32 tolerance."""
    g = torch.Generator().manual_seed(20 + n)
    m = _rand(g, shape[0], 32, *shape[1:], cl=True).to(cuda)
    args = [_rand(g, n, 32, 32, 3, 3, scale=0.06),
            _rand(g, n, 32) * 0.5 + 0.5,
            _rand(g, n, 32, 32, 3, 3, scale=0.06),
            _rand(g, n, 32) * 0.5 + 0.5]
    args = [a.to(cuda) for a in args]
    wp, bias = csp_chain.pack_weights(*args)
    before = csp_chain.launches
    y = csp_chain.bottleneck_chain_packed(m, wp, bias)
    torch.cuda.synchronize()
    assert csp_chain.launches == before + 1
    torch.testing.assert_close(
        y, csp_chain.bottleneck_chain_plain(m, *args),
        atol=ATOL[torch.float32], rtol=0)


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
                                     ((1, 3, 25, 31), 16),
                                     ((3, 3, 37, 53), 64),
                                     ((1, 3, 2, 2), 16),
                                     ((4, 3, 160, 160), 80)])
def test_stem_train_kernels_match_plain(cuda, dtype, shape, c):
    """Odd H and W give input rows that are not 16-byte aligned (37 x 53),
    2 x 2 one output row for a grid sized by the SM count, C = 80 gelan-e's
    stem width (a channel slice of 16)."""
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


@pytest.mark.parametrize("c", [64, 80])
@pytest.mark.parametrize("bsz", [1, 32])
def test_stem_wgrad_f32_kernel_matches_plain(cuda, c, bsz):
    """The f32 stem weight gradient (3xTF32 products, the persistent
    grid): odd H and W, one image and a full batch, gelan-c's and
    gelan-e's stem widths; one launch per call, equal across two calls."""
    g0 = torch.Generator().manual_seed(c + bsz)
    x = torch.rand(bsz, 3, 161, 97, generator=g0).contiguous(
        memory_format=torch.channels_last).to(cuda)
    g = _rand(g0, bsz, c, 81, 49, scale=1e-3, cl=True).to(cuda)
    before = stem.wgrad_launches
    dw = stem.stem_wgrad(x, g)
    torch.cuda.synchronize()
    assert stem.wgrad_launches == before + 1
    assert dw.dtype == torch.float32 and dw.shape == (c, 3, 3, 3)
    assert _rel_l2(dw, stem.stem_wgrad_plain(x, g)) <= \
        WGRAD_REL[torch.float32]
    assert torch.equal(dw, stem.stem_wgrad(x, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,fan_in", [((2, 32, 16, 24), 32, False),
                                               ((1, 48, 10, 10), 48, False),
                                               ((2, 256, 16, 16), 256, False),
                                               ((1, 64, 9, 7), 64, False),
                                               ((1, 40, 8, 10), 24, False),
                                               ((2, 64, 70, 66), 64, False),
                                               ((2, 256, 37, 41), 256, False),
                                               ((2, 512, 37, 41), 512, True),
                                               ((1, 256, 42, 36), 256, True),
                                               ((3, 256, 66, 70), 256, True),
                                               ((4, 256, 96, 96), 256, False),
                                               ((2, 512, 40, 40), 512, True),
                                               ((1, 12, 9, 11), 10, False)])
def test_adown_train_kernels_match_plain(cuda, dtype, shape, cout, fan_in):
    """Channel counts 32 and 48 are TINY_YAML's (48: 24 input channels a
    branch, half a k-step of zero padding in the tensor-core forward), 256
    gelan-c's; odd H, W hit the avg-domain edges; the
    fifth shape's branch channels (20 in, 12 out) are not multiples of 8,
    so bf16 takes the CUDA-core backward too, and the backward's
    memory-bound passes take 1-channel lanes. (2, 64, 70, 66): the dx and
    pool passes walk each column down several strips of rows, and a row's
    66 columns of 8-channel lanes are not a whole number of a CTA's runs of
    lanes; (2, 256, 37, 41): gelan-c's width at odd H and W; then the
    forward's edges: Co = 256 per branch, Ho = 21 (no tile height divides
    it) and more tiles than one round of its persistent grid, with weights
    at 1/sqrt(fan-in) (`_w_scales`); then the f32 backward's tensor-core
    products over several blocks: (4, 256, 96, 96) 9216 output pixels in 3
    slabs, (2, 512, 40, 40) 256 channels a branch (two channel tiles of
    each product); last, branch channels (6 in, 5 out) that are not
    multiples of 4, so those products stage by 4-byte copies. Inputs are
    quantized to halves so that maxpool ties are common."""
    g0 = torch.Generator().manual_seed(4)
    cin = shape[1]
    s1, s2 = _w_scales(cin // 2, fan_in)
    x = (torch.round(torch.randn(*shape, generator=g0) * 2) / 2).to(dtype) \
        .contiguous(memory_format=torch.channels_last).to(cuda)
    w1 = _rand(g0, cout // 2, cin // 2, 3, 3, scale=s1, dtype=dtype).to(cuda)
    w2 = _rand(g0, cout // 2, cin // 2, 1, 1, scale=s2, dtype=dtype).to(cuda)
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


def test_adown_bwd_f32_runs_the_tensor_core_products(cuda):
    """One f32 backward call: the two passes, the three 3xTF32 products
    and the slab sum, six launches, none of the CUDA-core product
    kernels (gemm_dm, gemm_da1, gemm_dw)."""
    g0 = torch.Generator().manual_seed(13)
    x = _rand(g0, 2, 64, 20, 24, cl=True).to(cuda)
    g = _rand(g0, 2, 64, 10, 12, cl=True).to(cuda)
    w1 = _rand(g0, 32, 32, 3, 3, scale=0.05).to(cuda)
    w2 = _rand(g0, 32, 32, 1, 1, scale=0.1).to(cuda)
    names = [n for n in _cuda_kernels(lambda: adown.adown_bwd(x, g, w1, w2))
             if "yolo" in n]
    assert len(names) == 6, names
    for kernel, n in (("pool_avg", 1), ("dgrad_tf32", 2), ("dx_strips", 1),
                      ("dw_tf32", 1), ("dw_reduce", 1)):
        assert sum(kernel in name for name in names) == n, names
    assert not any("gemm_" in name for name in names), names


@pytest.mark.parametrize("shape,cout", [((2, 64, 20, 24), 64),
                                        ((1, 12, 9, 11), 10)])
def test_adown_f32_runs_the_tensor_core_kernel(cuda, shape, cout):
    """An f32 fused call (`adown_packed`) launches the 3xTF32 kernel once,
    an f32 `adown_raw` the pack and that kernel, neither the CUDA-core
    `adown_kernel`; a second call gives the same output, bit for bit.
    (1, 12, 9, 11) -> 10: branch channels 6 in, 5 out, so the kernel takes
    4-byte copies and stores."""
    g0 = torch.Generator().manual_seed(14)
    cin, co = shape[1], cout // 2
    x = _rand(g0, *shape, cl=True).to(cuda)
    w1 = _rand(g0, co, cin // 2, 3, 3, scale=0.05).to(cuda)
    b1 = _rand(g0, co).to(cuda)
    w2 = _rand(g0, co, cin // 2, 1, 1, scale=0.1).to(cuda)
    b2 = _rand(g0, co).to(cuda)
    w1p, w2p = adown.pack_weights(w1, w2)
    for fn, launches in (
            (lambda: adown.adown_packed(x, w1p, b1, w2p, b2), 1),
            (lambda: adown.adown_raw(x, w1, w2), 2)):
        names = [n for n in _cuda_kernels(fn) if "yolo" in n]
        assert len(names) == launches, names
        assert sum("adown_tf32_kernel" in n for n in names) == 1, names
        assert not any("adown_kernel" in n for n in names), names
        assert torch.equal(fn(), fn())


def test_kernels_launch_on_a_second_device(cuda):
    """Launch setup (the shared-memory opt-in, the SM count of a persistent
    grid) is kept per device: the kernels that opt in run on cuda:1 after
    cuda:0 in one process and match their plain versions on both."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    g0 = torch.Generator().manual_seed(7)
    bf = torch.bfloat16
    x3 = _rand(g0, 1, 64, 20, 24, dtype=bf, cl=True)
    w3, b3 = _rand(g0, 64, 64, 3, 3, scale=0.05, dtype=bf), \
        _rand(g0, 64, dtype=bf)
    m = _rand(g0, 1, 32, 20, 24, cl=True)
    chain = (_rand(g0, 1, 32, 32, 3, 3, scale=0.06), _rand(g0, 1, 32),
             _rand(g0, 1, 32, 32, 3, 3, scale=0.06), _rand(g0, 1, 32))
    xa = _rand(g0, 1, 40, 8, 10, cl=True)
    down = (_rand(g0, 12, 20, 3, 3, scale=0.05), _rand(g0, 12),
            _rand(g0, 12, 20, 1, 1, scale=0.1), _rand(g0, 12))
    xs = _rand(g0, 2, 3, 37, 53, dtype=bf, cl=True)
    gs = _rand(g0, 2, 64, 19, 27, dtype=bf, cl=True)
    for dev in ("cuda:0", "cuda:1"):
        def on(*ts):
            return [t.to(dev) for t in ts]
        y = conv3.conv3_silu(*on(x3, w3, b3))
        ref = conv3.conv3_silu_plain(*on(x3, w3, b3))
        torch.testing.assert_close(y.float(), ref.float(), rtol=0,
                                   atol=2.0 ** -6 * float(ref.abs().max()))
        for dtype in (torch.float32, bf):
            args = on(m.to(dtype), *(t.to(dtype) for t in chain))
            y = csp_chain.bottleneck_chain(*args)
            ref = csp_chain.bottleneck_chain_plain(*args)
            atol = (2.0 ** -6 * float(ref.abs().max()) if dtype == bf
                    else ATOL[dtype])
            torch.testing.assert_close(y.float(), ref.float(), rtol=0,
                                       atol=atol)
        torch.testing.assert_close(adown.adown(*on(xa, *down)),
                                   adown.adown_plain(*on(xa, *down)),
                                   atol=ATOL[torch.float32], rtol=0)
        dw = stem.stem_wgrad(*on(xs, gs))
        assert dw.device == torch.device(dev)
        assert _rel_l2(dw, stem.stem_wgrad_plain(*on(xs, gs))) <= \
            WGRAD_REL[bf]
    torch.cuda.synchronize()


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
