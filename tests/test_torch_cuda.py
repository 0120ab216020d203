"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip on a machine without a CUDA device. On one with a
card and nvcc, run them without the JAX test setup (this file imports no
jax):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

chip_smoke.py makes the same comparisons at the main path's full shapes.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_re_tpu_torch.convert import load_weights
from yolo_re_tpu_torch.data import device_pipeline
from yolo_re_tpu_torch.data.config import AugmentConfig, DataConfig
from yolo_re_tpu_torch.data.dataset import create_dataloader
from yolo_re_tpu_torch.data.synth import TINY_DUAL_YAML, TINY_YAML, \
    make_eval_batch, write_dataset
from yolo_re_tpu_torch.eval.evaluator import Evaluator
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops.kernels import adown, conv3, csp_chain, nms, stem
from yolo_re_tpu_torch.parallel import mesh
from yolo_re_tpu_torch.serving import Detector
from yolo_re_tpu_torch.train.config import TrainConfig
from yolo_re_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / \
    "dryrun_tiny.npz"
# f32: the kernels sum in another order than cuDNN. bf16: each side
# rounds its f32 sum once, so the two may sit one bf16 ulp apart. 2^-7 of
# |ref| bounds one ulp of any output; 3e-2 alone did not above 4, where
# one ulp is 2^-5 (the kernels' measured errors are at most one ulp of
# |ref|: test_bf16_kernels_within_one_ulp)
ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


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


# (x shape, C): odd H and W (input rows that are not 16-byte aligned, the
# conv's zero column on the right, a ragged last tile), 2 x 2 (one output
# pixel), C = 80 (gelan-e's stem: two warp ranges of 40 channels) and the
# main path's batch 32 at 640 px, at gelan-c's C = 64 and gelan-e's 80
STEM_SHAPES = [((2, 3, 32, 48), 64), ((1, 3, 25, 31), 16),
               ((3, 3, 37, 53), 64), ((1, 3, 2, 2), 16),
               ((4, 3, 160, 160), 80), ((32, 3, 640, 640), 64),
               ((3, 3, 37, 53), 80), ((32, 3, 640, 640), 80)]


def _stem_case(dev, shape, c, dtype, raw):
    """(kernel call, plain call, launch counter name) on one case's
    inputs: x ~ N(0, 1), w ~ 0.3 N(0, 1), b ~ N(0, 1) (outputs reach 4-8)."""
    g = torch.Generator().manual_seed(0)
    x = _rand(g, *shape, dtype=dtype, cl=True).to(dev)
    w = _rand(g, c, 3, 3, 3, scale=0.3, dtype=dtype).to(dev)
    b = _rand(g, c, dtype=dtype).to(dev)
    if raw:
        return (lambda: stem.stem_conv_raw(x, w),
                lambda: stem.stem_conv_raw_plain(x, w), "raw_launches")
    return (lambda: stem.stem_conv(x, w, b),
            lambda: stem.stem_conv_plain(x, w, b), "launches")


@pytest.mark.parametrize("raw", [False, True], ids=["folded", "raw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,c", STEM_SHAPES)
def test_stem_kernel_matches_plain(cuda, dtype, shape, c, raw):
    """Both modes, one launch a call, within the tolerance, and a second
    call equal bit for bit."""
    fn, plain, counter = _stem_case(cuda, shape, c, dtype, raw)
    before = getattr(stem, counter)
    y = fn()
    torch.cuda.synchronize()
    assert getattr(stem, counter) == before + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y.float(), plain().float(),
                               atol=ATOL[dtype], rtol=RTOL[dtype])
    assert torch.equal(fn(), y)


# (x shape, Cout, weights at 1/sqrt(fan-in)): TINY_YAML's widths (32; 48
# with Ch = 24, not a multiple of 16); Co = 256 per branch (the N = 256
# instance) at odd H, W; Ho = 21, which no tile height divides; more tiles
# than persistent CTAs, the last round ragged; Co = 512 per branch (two
# n-blocks); 2 x 2 and 3 x 5 inputs (one output row, an avg domain of one
# row); gelan-e's widths, Co = 160 and 320 per branch, which pack to N =
# 256 and 512 with a zero tail in the last n-block (small, at odd H and
# W, and at gelan-e's down3 site, 20 x 20 outputs). The wide cases draw
# their weights at 1/sqrt(fan-in), as the model's init does, the others
# at 0.05 (3x3) and 0.1 (1x1).
ADOWN_SHAPES = [((1, 32, 8, 24), 32, False), ((2, 48, 10, 10), 64, False),
                ((1, 64, 9, 7), 64, False), ((1, 40, 8, 10), 24, False),
                ((2, 48, 20, 18), 48, False), ((2, 512, 37, 41), 512, True),
                ((1, 256, 42, 36), 256, True), ((3, 256, 66, 70), 256, True),
                ((3, 256, 160, 168), 256, True),
                ((1, 1024, 12, 14), 1024, True), ((2, 32, 2, 2), 32, False),
                ((2, 32, 3, 5), 32, False), ((2, 320, 12, 14), 320, True),
                ((1, 640, 10, 8), 640, True), ((2, 320, 37, 41), 320, True),
                ((1, 640, 23, 19), 640, True), ((4, 640, 40, 40), 640, True)]


def _w_scales(ch: int, fan_in: bool) -> tuple[float, float]:
    return (1 / (9 * ch) ** 0.5, 1 / ch ** 0.5) if fan_in else (0.05, 0.1)


def _adown_tol(dtype: torch.dtype, ref: torch.Tensor,
               fan_in: bool) -> tuple[float, float]:
    """(atol, rtol): ATOL and RTOL, one bf16 ulp of |ref|; the wide cases
    are held to 4 ulps of their largest output (chip_smoke.py's
    tolerance)."""
    if fan_in and dtype == torch.bfloat16:
        return 2.0 ** -6 * max(1.0, float(ref.abs().max())), 0.0
    return ATOL[dtype], RTOL[dtype]


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
    atol, rtol = _adown_tol(dtype, ref, fan_in)
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=rtol)
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


def _cuda_kernels(fn, expect: str = "yolo") -> list[str]:
    """Names of the CUDA kernels fn() runs, by torch.profiler. The traced
    call runs 50 ms inside the trace, and a trace that holds no device
    activity at all is taken again, up to three times: the profiler drops
    the device activity it dates outside its capture window, and late in
    a long test process it dropped a traced call's first launch or all of
    its launches (F4). If no CUDA kernel's name holds `expect`, it fails
    there and prints the evidence: the number of traces taken and the
    last trace's events unfiltered, (device type, name) each."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for traces in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = prof.events()
        names = [e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert any(expect in n for n in names), (
        f"no CUDA kernel named *{expect}* after {traces} trace(s); the "
        f"last trace's events: "
        f"{[(str(e.device_type), e.name) for e in events]}")
    return names


def test_fused_adown_makes_one_launch(cuda):
    """A fused ADown runs one CUDA kernel per call (its weights packed at
    fuse time: no per-call permute or pack); the train forward two (the
    pack, which casts the f32 weights, and the kernel)."""
    from yolo_re_tpu_torch.models.blocks import ADown
    from yolo_re_tpu_torch.models.fuse import fuse_model

    g = torch.Generator().manual_seed(12)
    mod = fuse_model(ADown(256, 256).eval()).to(cuda, torch.bfloat16)
    x = _rand(g, 2, 256, 40, 40, dtype=torch.bfloat16, cl=True).to(cuda)
    with torch.no_grad():
        names = _cuda_kernels(lambda: mod(x), "adown")
        before = adown.launches
        mod(x)
    assert len(names) == 1 and "adown" in names[0], \
        f"fused ADown: one adown kernel per call, got {names}"
    assert adown.launches == before + 1, \
        f"fused ADown: adown.launches {before} -> {adown.launches} " \
        f"over one call"
    w1 = _rand(g, 128, 128, 3, 3, scale=0.05).to(cuda)
    w2 = _rand(g, 128, 128, 1, 1, scale=0.1).to(cuda)
    names = _cuda_kernels(lambda: adown.adown_raw(x, w1, w2), "adown")
    assert len(names) == 2, \
        f"adown_raw: two kernels per call (pack, adown), got {names}"
    y32, y16 = (adown.adown_raw(x, w1, w2),
                adown.adown_raw(x, w1.bfloat16(), w2.bfloat16()))
    assert torch.equal(y32, y16), \
        f"adown_raw: f32 weights (cast by the pack) and bf16 weights " \
        f"differ: max |diff| {float((y32.float() - y16.float()).abs().max())}" \
        f" at {int((y32 != y16).sum())} of {y32.numel()} outputs"


def _nms_inputs(g, b, k, degenerate=False):
    """(B, K) random class-offset boxes (3 classes) and bf16-rounded
    scores (many ties, 30% zero), in random order. degenerate: also
    zero-width, zero-height and point boxes, coincident copies (two
    zero-area copies give a 0 / 0 NaN IoU) and infinite boxes (area
    inf - inf = NaN)."""
    xy = torch.rand(b, k, 2, generator=g) * 600
    wh = torch.rand(b, k, 2, generator=g) * 60 + 5
    cls = torch.randint(0, 3, (b, k, 1), generator=g).float()
    boxes = torch.cat([xy, xy + wh], -1) + cls * 7680
    scores = torch.rand(b, k, generator=g)
    scores = torch.where(scores > 0.3, scores, 0.0).bfloat16().float()
    if degenerate:
        kind = torch.randint(0, 5, (b, k), generator=g)
        boxes[kind == 1, 2] = boxes[kind == 1, 0]
        boxes[kind == 2, 3] = boxes[kind == 2, 1]
        boxes[kind == 3, 2:] = boxes[kind == 3, :2]
        boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]
        boxes[:, 3::61, 0::2] = float("inf")
    return boxes, scores


def _nms_check(dev, boxes, scores, iou_thres, max_det=300):
    """The kernel's indices equal the plain version's, two calls are bit
    for bit equal, and a call is one launch (counter and trace)."""
    boxes, scores = boxes.to(dev).contiguous(), scores.to(dev).contiguous()

    def call():
        return nms.nms_select(boxes, scores, iou_thres, max_det)

    before = nms.launches
    idx = call()
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    want = nms.nms_select_plain(boxes, scores, iou_thres, max_det)
    assert torch.equal(idx, want), \
        f"{int((idx != want).sum())} of {idx.numel()} indices differ"
    assert torch.equal(call(), idx)
    names = _cuda_kernels(call, "nms_cluster_kernel")
    assert len(names) == 1 and "nms_cluster_kernel" in names[0], names
    return idx


@pytest.mark.parametrize("k", [1, 100, 512, 8400, nms.MAX_K])
@pytest.mark.parametrize("b", [1, 3, 32, 64, 67])
def test_nms_kernel_matches_plain(cuda, b, k):
    """Random order, bf16 ties, iou 0.45, at batch sizes that take each
    cluster size the rule picks on an H100 (K = 8400: 8, 8, 8, 4, 2; K =
    512: 2; K <= 100: 1) and K from one candidate to MAX_K (slices that
    need c >= 2; at batch 67 in two waves)."""
    g = torch.Generator().manual_seed(2)
    _nms_check(cuda, *_nms_inputs(g, b, k), 0.45)


@pytest.mark.parametrize("b", [3, 32])
def test_nms_kernel_evaluator_order(cuda, b):
    """The Evaluator's call: K = 8400 candidates sorted by score,
    descending, the tail zero (under the threshold), at iou 0.6."""
    g = torch.Generator().manual_seed(3)
    boxes, scores = _nms_inputs(g, b, 8400)
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    idx = _nms_check(cuda, boxes, scores, 0.6)
    assert (idx >= 0).sum(1).min() >= 100


@pytest.mark.parametrize("iou_thres", [0.45, 0.0, -0.25])
@pytest.mark.parametrize("b,k", [(3, 517), (32, 8400)])
def test_nms_kernel_degenerate_boxes(cuda, b, k, iou_thres):
    """Zero-area, coincident and infinite boxes (NaN IoUs, which never
    suppress), and a zero and a negative threshold, where a zero
    intersection suppresses unless its union is 0 or NaN."""
    g = torch.Generator().manual_seed(4)
    _nms_check(cuda, *_nms_inputs(g, b, k, degenerate=True), iou_thres)


def test_nms_kernel_runs_in_waves(cuda):
    """More clusters than fit on the card at once: K = MAX_K needs c = 2
    to fit a CTA's shared memory, at a batch above the SM count."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator().manual_seed(5)
    b = sms + 8
    assert nms.cluster_size(b, nms.MAX_K, sms) == 2
    _nms_check(cuda, *_nms_inputs(g, b, nms.MAX_K), 0.45, 100)


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


def _device_us_by_span(prof, prefix: str) -> dict[str, float]:
    """Device us of a trace by the innermost range named `prefix...`
    open on the host when the op that launched the work started (its
    linked correlation id); work launched outside every such range goes
    to None."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                   if e.name().startswith(prefix))
    starts: dict[int, list[int]] = {}
    for e in cpu:
        if not e.linked_correlation_id():
            starts.setdefault(e.correlation_id(), []).append(e.start_ns())
    by: dict = {}
    for e in events:
        flag = getattr(e, "is_user_annotation", None)
        if e.device_type() != DeviceType.CUDA or (flag and flag()):
            continue
        owners = [s for t in starts.get(e.linked_correlation_id(), ())
                  for s in spans if s[0] <= t <= s[1]]
        key = max(owners)[2] if owners else None
        by[key] = by.get(key, 0.0) + (e.end_ns() - e.start_ns()) / 1e3
    return by


def test_spans_on_the_card(cuda, tmp_path):
    """Under a profiler on the card, a Detector call's and a train
    epoch's spans (utils/profiling.span) own the device work their ops
    launch: each layer span of the request and of the step has device
    time in the trace, and no serving work falls outside the request."""
    from torch.profiler import ProfilerActivity, profile

    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    det = Detector.from_checkpoint(YOLO.from_yaml(path), str(FIXTURE),
                                   device=cuda, img_size=160,
                                   compute_dtype="float32")
    images = make_eval_batch(4, 160, 0)["images"]
    batch = make_eval_batch(4, 96, 5)
    tr = Trainer(YOLO.from_yaml(path), config=TrainConfig(
        data_parallel=False, output_dir=str(tmp_path)),
        train_loader=[batch, batch], device=cuda)
    det(images)
    tr.train_one_epoch(0)
    torch.cuda.synchronize()
    for work, prefix, owners in (
            (lambda: det(images), "serve.",
             ["serve.copy", "serve.letterbox", "serve.forward",
              "serve.nms"]),
            (lambda: tr.train_one_epoch(1), "train.",
             ["train.next_batch", "train.input", "train.forward",
              "train.loss", "train.backward", "train.clip", "train.update",
              "train.ema"])):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        by = _device_us_by_span(prof, prefix)
        assert all(by.get(k, 0.0) > 0 for k in owners), by
        if prefix == "serve.":
            assert set(by) == set(owners), by


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
                               atol=ATOL[dtype], rtol=RTOL[dtype])


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
    torch.testing.assert_close(y.float(), ref.float(), atol=atol,
                               rtol=RTOL[dtype])


# (name, shape): the walk at H and W that no tile side divides, a single
# pixel and gelan-c's 80 x 80 sites at batch 32, in both dtypes
CONV3_WALKS = [
    (name, shape, dtype)
    for name, shape in (
        ("many_tiles", (3, 160, 160)), ("stage2", (1, 80, 80)),
        ("fewer_tiles_than_sms", (1, 20, 24)), ("ragged", (5, 97, 131)),
        ("one_pixel", (1, 1, 1)), ("stage2_batch", (32, 80, 80)))
    for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize(
    "shape,dtype", [(s, d) for _, s, d in CONV3_WALKS],
    ids=[f"{n}-dtype{int(d == torch.bfloat16)}" for n, _, d in CONV3_WALKS])
def test_conv3_kernel_persistent_walk(cuda, dtype, shape):
    """The persistent grid: more tiles than CTAs (a ragged last round),
    gelan-c's 80 x 80 sites, fewer tiles than SMs, H and W that no tile
    side divides (each CTA's range of tiles crossing column strips and
    images), a single pixel and batch 32 at 80 x 80, through the packed
    call a fused Conv makes; a second call gives the same output, bit for
    bit."""
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
                               atol=ATOL[dtype], rtol=RTOL[dtype])
    assert torch.equal(conv3.conv3_silu_packed(x, wp, b), y)


def test_conv3_f32_runs_the_tensor_core_kernel(cuda):
    """An f32 packed call (a fused Conv's) launches one kernel, the 3xTF32
    `conv3_tf32_kernel`, and not the CUDA-core `conv3_f32_kernel` it
    replaced."""
    g = torch.Generator().manual_seed(16)
    x = _rand(g, 2, 64, 20, 24, cl=True).to(cuda)
    wp = conv3.pack_weights(_rand(g, 64, 64, 3, 3, scale=0.05).to(cuda))
    b = _rand(g, 64).to(cuda)
    names = [n for n in _cuda_kernels(lambda: conv3.conv3_silu_packed(
        x, wp, b), "conv3_tf32_kernel") if "yolo" in n]
    assert len(names) == 1 and "conv3_tf32_kernel" in names[0], names
    assert not any("conv3_f32_kernel" in n for n in names), names


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
                               atol=ATOL[dtype], rtol=RTOL[dtype])
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
                                               ((1, 12, 9, 11), 10, False),
                                               ((2, 16, 12, 14), 16, False),
                                               ((1, 32, 10, 12), 48, False),
                                               ((2, 64, 130, 98), 64, True),
                                               ((2, 128, 24, 20), 512, True),
                                               ((2, 320, 12, 14), 320, True),
                                               ((1, 640, 10, 8), 640, True),
                                               ((2, 320, 37, 41), 320, True),
                                               ((4, 640, 40, 40), 640, True),
                                               ((2, 320, 80, 80), 320, False)])
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
    each product); then branch channels (6 in, 5 out) that are not
    multiples of 4, so those products stage by 4-byte copies; last, the
    edges of the bf16 products (multiples of 8): Ch = Co = 8 (one k16 step
    of the dM product, a partial n8 block of every tile), Ch = 16 with Co
    = 24, 6370 output pixels (f32: 2 slabs of 3185; bf16 on an H100: 26
    of 245; neither a whole number of 64-pixel chunks), and Co = 256 a
    branch with Ch = 64 (two output-channel tiles of dW, a partial
    input-channel tile); last, gelan-e's widths, Co = 160 and 320 a
    branch (N = 256 and 512 in the forward with a zero tail in the last
    n-block; dW's 128-channel tiles partial), small, at odd H and W, at
    gelan-e's down3 width and size, and at pan_down1's 80 x 80. Inputs are
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
                               atol=ATOL[dtype], rtol=RTOL[dtype])
    rdx, rdw1, rdw2 = adown.adown_bwd_plain(x, g, w1, w2)
    assert dx.dtype == dtype and dx.is_contiguous(
        memory_format=torch.channels_last)
    torch.testing.assert_close(dx.float(), rdx.float(), atol=ATOL[dtype],
                               rtol=RTOL[dtype])
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


def test_adown_bwd_bf16_runs_the_tensor_core_products(cuda):
    """One bf16 backward call with branch channels multiples of 8: the two
    passes, the three bf16 mma.sync products and the slab sum, six
    launches, none of the CUDA-core product kernels (gemm_dm, gemm_da1,
    gemm_dw) and no wmma kernel."""
    g0 = torch.Generator().manual_seed(15)
    bf = torch.bfloat16
    x = _rand(g0, 2, 64, 20, 24, dtype=bf, cl=True).to(cuda)
    g = _rand(g0, 2, 64, 10, 12, dtype=bf, cl=True).to(cuda)
    w1 = _rand(g0, 32, 32, 3, 3, scale=0.05, dtype=bf).to(cuda)
    w2 = _rand(g0, 32, 32, 1, 1, scale=0.1, dtype=bf).to(cuda)
    names = [n for n in _cuda_kernels(lambda: adown.adown_bwd(x, g, w1, w2))
             if "yolo" in n]
    assert len(names) == 6, names
    for kernel, n in (("pool_avg", 1), ("dgrad_bf16", 2), ("dx_strips", 1),
                      ("dw_bf16", 1), ("dw_reduce", 1)):
        assert sum(kernel in name for name in names) == n, names
    assert not any("gemm_" in name or "wmma" in name for name in names), \
        names


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
        names = [n for n in _cuda_kernels(fn, "adown_tf32_kernel")
                 if "yolo" in n]
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


# ---------------------------------------------------------------------------
# yolov9-c: the dual model through the same kernels
# ---------------------------------------------------------------------------

def _counts() -> dict:
    return {"stem": stem.launches, "adown": adown.launches,
            "csp_chain": csp_chain.launches, "conv3": conv3.launches}


def test_tiny_dual_cuda_matches_cpu(cuda, tmp_path):
    """TINY_DUAL_YAML, fused, f32, random weights from seed 0: decoded aux
    and main on cuda (kernels) against the CPU (plain versions), to
    test_detector_cuda_matches_cpu's tolerances; the main-only forward
    equals the full forward's main on the card too."""
    path = tmp_path / "tiny_dual.yaml"
    path.write_text(TINY_DUAL_YAML)
    model = YOLO.from_yaml(path)
    model.init_parameters(torch.Generator().manual_seed(0))
    model.fuse()
    x = torch.rand(2, 3, 160, 160, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref, _ = model(x)
        model.to(cuda)
        before = _counts()
        out, _ = model(x.to(cuda))
        mid = _counts()
        main, _ = model(x.to(cuda), main_only=True)
    # stem1 and aux_stem1, eight ADowns; the main branch's stem and five
    assert (mid["stem"] - before["stem"], mid["adown"] - before["adown"]) \
        == (2, 8)
    assert (stem.launches - mid["stem"], adown.launches - mid["adown"]) \
        == (1, 5)
    for k in ("aux", "main"):
        torch.testing.assert_close(out[k][..., :4].cpu(), ref[k][..., :4],
                                   atol=1e-2, rtol=0)
        torch.testing.assert_close(out[k][..., 4:].cpu(), ref[k][..., 4:],
                                   atol=1e-4, rtol=0)
    assert torch.equal(main, out["main"])


def test_yolov9c_launch_counts(cuda):
    """yolov9-c at full width, fused, (1, 3, 256, 256): the full forward
    launches the stem 2 times (stem1, aux_stem1), ADown 8, the chain 4
    (stage1's and aux_stage1's), conv3 10; the main-only forward (serving,
    eval) 1, 5, 2 and 6, as gelan-c."""
    model = YOLO.from_yaml(Path(__file__).resolve().parent.parent /
                           "configs" / "models" / "yolov9-c.yaml")
    model.init_parameters(torch.Generator().manual_seed(0))
    model = model.fuse().to(cuda)
    x = torch.rand(1, 3, 256, 256, device=cuda)
    for main_only, want in ((False, (2, 8, 4, 10)), (True, (1, 5, 2, 6))):
        before = _counts()
        with torch.no_grad():
            model(x, main_only=main_only)
        got = tuple(v - before[k] for k, v in _counts().items())
        assert got == want, (main_only, got)


def test_tiny_dual_train_step_cuda_matches_cpu(cuda, tmp_path):
    """One f32 TINY_DUAL_YAML train step from the same init: two stem
    pairs (stem1, aux_stem1) and eight ADown pairs on cuda, the loss and
    the parameters to test_tiny_train_step_cuda_matches_cpu's
    tolerances."""
    path = tmp_path / "tiny_dual.yaml"
    path.write_text(TINY_DUAL_YAML)
    batch = make_eval_batch(4, 96, 5)
    out = []
    for dev in (cuda, torch.device("cpu")):
        cfg = TrainConfig(data_parallel=False, output_dir=str(tmp_path))
        tr = Trainer(YOLO.from_yaml(path), config=cfg, train_loader=[batch],
                     device=dev)
        before = (stem.raw_launches, stem.wgrad_launches, adown.raw_launches,
                  adown.bwd_launches)
        loss, _, _ = tr.train_step(batch["images"], batch["targets"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            after = (stem.raw_launches, stem.wgrad_launches,
                     adown.raw_launches, adown.bwd_launches)
            assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 8, 8)
        out.append((float(loss), {k: v.detach().cpu()
                                  for k, v in tr.params.items()}))
    (loss_c, p_c), (loss_h, p_h) = out
    assert abs(loss_c - loss_h) <= 1e-4 * abs(loss_h)
    for k in p_h:
        torch.testing.assert_close(p_c[k], p_h[k], atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# F5: the entry points' f32 work in full f32 under PyTorch's TF32 defaults
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_tf32_defaults():
    """A card with PyTorch's default TF32 flags (cuDNN may run f32 convs in
    TF32, cuBLAS f32 matmuls not), restored to what they were after the
    test: the entry points must turn TF32 off themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    yield torch.device("cuda")
    cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_f32_entry_points_match_cpu_under_default_tf32(cuda_tf32_defaults,
                                                       tmp_path):
    """An f32 Evaluator batch (`_dispatch`: the copy, the fused forward,
    all-anchor NMS) of the trained tiny fixture and one f32 TINY_YAML train
    step, cuda against the CPU, to the f32 tolerances of
    test_detector_cuda_matches_cpu and test_tiny_train_step_cuda_matches_cpu;
    the flags are the caller's again afterwards."""
    from yolo_re_tpu_torch.serving import inference_model

    cuda = cuda_tf32_defaults
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = YOLO.from_yaml(path)
    weights = load_weights(str(FIXTURE))
    batch = make_eval_batch(4, 160, 0)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        ev = Evaluator(model, None, device=dev)
        fused = inference_model(model, weights, ev.device, ev.dtype)
        out, event = ev._dispatch(fused, batch)
        if event is not None:
            event.synchronize()
        outs.append(out)
    (a, b) = outs
    for k in ("valid", "classes"):
        assert torch.equal(a[k], b[k])
    torch.testing.assert_close(a["boxes"], b["boxes"], atol=1e-2, rtol=0)
    torch.testing.assert_close(a["scores"], b["scores"], atol=1e-4, rtol=0)
    assert int(a["valid"].sum()) > 0

    train = make_eval_batch(4, 96, 5)
    res = []
    for dev in (cuda, torch.device("cpu")):
        cfg = TrainConfig(data_parallel=False, output_dir=str(tmp_path))
        tr = Trainer(YOLO.from_yaml(path), config=cfg, train_loader=[train],
                     device=dev)
        loss, _, _ = tr.train_step(train["images"], train["targets"])
        res.append((float(loss), {k: v.detach().cpu()
                                  for k, v in tr.params.items()}))
    (loss_c, p_c), (loss_h, p_h) = res
    assert abs(loss_c - loss_h) <= 1e-4 * abs(loss_h)
    for k in p_h:
        torch.testing.assert_close(p_c[k], p_h[k], atol=1e-5, rtol=1e-4)
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (True, False)


# ---------------------------------------------------------------------------
# F6: the bf16 kernels' errors in bf16 ulps of the reference
# ---------------------------------------------------------------------------

def _bf16_ulps(y: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |y - ref| in bf16 ulps of |ref| over the outputs with
    |ref| >= 1, where one ulp (at least 2^-7) lies far above the f32 sums'
    order (~1e-6); below 1, ATOL holds. 0 if there are none."""
    r = ref.float()
    big = r.abs() >= 1
    if not big.any():
        return 0.0
    _, e = torch.frexp(r[big])              # |r| = f 2^e, f in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(r[big]), e - 8)
    return float(((y.float()[big] - r[big]).abs() / ulp).max())


def _conv3_case(dev, shape):
    g = torch.Generator().manual_seed(9)
    x = _rand(g, shape[0], 64, *shape[1:], dtype=torch.bfloat16,
              cl=True).to(dev)
    w = _rand(g, 64, 64, 3, 3, scale=0.05, dtype=torch.bfloat16).to(dev)
    b = _rand(g, 64, dtype=torch.bfloat16).to(dev)
    return (lambda: conv3.conv3_silu(x, w, b),
            lambda: conv3.conv3_silu_plain(x, w, b))


BF16_ULP_CASES = (
    [(f"conv3-{n}", "conv3", s, None, False) for n, s in (
        ("stage2_batch", (32, 80, 80)), ("ragged", (5, 97, 131)))] +
    [(f"stem-{'x'.join(map(str, s))}-{c}-{m}", "stem", s, c, m == "raw")
     for s, c in STEM_SHAPES for m in ("folded", "raw")])


@pytest.mark.parametrize("kernel,shape,c,raw",
                         [case[1:] for case in BF16_ULP_CASES],
                         ids=[case[0] for case in BF16_ULP_CASES])
def test_bf16_kernels_within_one_ulp(cuda, kernel, shape, c, raw, capsys):
    """conv3 at gelan-c's 80 x 80 sites at batch 32 (whose outputs reach
    4-8) and at a ragged shape, and the stem at its card cases in both
    modes: at most one bf16 ulp of |ref| where |ref| >= 1, and within
    ATOL + RTOL everywhere. Prints each case's error."""
    if kernel == "conv3":
        fn, plain = _conv3_case(cuda, shape)
    else:
        fn, plain, _ = _stem_case(cuda, shape, c, torch.bfloat16, raw)
    y, ref = fn(), plain()
    ulps = _bf16_ulps(y, ref)
    err = float((y.float() - ref.float()).abs().max())
    with capsys.disabled():
        print(f"\n  bf16 {kernel} {shape} C={c} raw={raw}: max |err| "
              f"{err:.4e}, max |ref| {float(ref.float().abs().max()):.3f}, "
              f"{ulps:.3f} ulps of |ref| (|ref| >= 1)")
    assert ulps <= 1.0
    torch.testing.assert_close(y.float(), ref.float(),
                               atol=ATOL[torch.bfloat16],
                               rtol=RTOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# the train input path: device augmentation and the one-batch-ahead copy
# ---------------------------------------------------------------------------

# (function, hyperparameters beyond the "full" preset's): the fast
# (separable) mosaic, the general (gather) warp, HSV + flips; mixup and
# vertical flips at 0.5 so that both branches of their masks run
AUG_CASES = {
    "full_fast": ("full", {}),
    "full_general": ("full", {"degrees": 10.0, "shear": 2.0,
                              "perspective": 1e-4}),
    "batch": ("batch", {})}
# tests/test_torch_augment.py's tolerances (bf16 also RTOL: one ulp)
AUG_ATOL = {"full_fast": 1e-6, "full_general": 1e-4, "batch": 1e-6}


def _augment(case: str, images, targets, draws):
    fn, extra = AUG_CASES[case]
    kw = {"mixup_p": 0.5, "flip_ud": 0.5, **extra}
    if fn == "full":
        return device_pipeline.augment_batch_full(images, targets, draws,
                                                  **kw)
    return device_pipeline.augment_batch(images, targets, draws,
                                         flip_ud=kw["flip_ud"])


def _aug_close(got, ref, atol: float, dtype) -> None:
    img, t = (v.cpu() for v in got)
    assert img.dtype == dtype
    torch.testing.assert_close(img.float(), ref[0].float(), atol=atol,
                               rtol=RTOL[dtype])
    assert torch.equal(t[..., 3] > 0, ref[1][..., 3] > 0)
    assert int((t[..., 3] > 0).sum()) > 8
    torch.testing.assert_close(t, ref[1], atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_augment_cuda_matches_cpu(cuda, case, dtype):
    """The same draws (draw_augment, numpy seed) applied on the card and on
    the CPU to uint8 images normalized in `dtype`, stage by stage on
    identical inputs (chip_smoke.py's `augment_stages`): augment_batch
    whole; augment_batch_full's mosaic, then its rest on the card's
    mosaic (HSV does not keep a one-ulp difference left by the general
    warp within one ulp). Images within the CPU tests' tolerances, the
    same boxes kept, targets close."""
    batch = make_eval_batch(8, 96, 3, max_boxes=12)
    kw = {"mixup_p": 0.5, "flip_ud": 0.5, **AUG_CASES[case][1]}
    draws = device_pipeline.draw_augment(np.random.default_rng([1, 5]), 8,
                                         96, **kw)
    card, host = (
        (torch.from_numpy(batch["images"]).to(dev).to(dtype) / 255.0,
         torch.from_numpy(batch["targets"]).to(dev),
         device_pipeline.draws_to(draws, dev))
        for dev in (cuda, torch.device("cpu")))
    out = _augment(case, *card)
    assert out[1].shape == (8, 12, 5)
    if AUG_CASES[case][0] == "batch":
        _aug_close(out, _augment(case, *host), AUG_ATOL[case], dtype)
        return
    mos = {k: kw.get(k, 0.0) for k in ("degrees", "shear", "perspective")}
    card_mos = device_pipeline.mosaic_affine(*card, **mos)
    _aug_close(card_mos, device_pipeline.mosaic_affine(*host, **mos),
               AUG_ATOL[case], dtype)
    rest = device_pipeline.augment_batch_full(
        card_mos[0].cpu(), card_mos[1].cpu(), host[2],
        **{**kw, "mosaic_p": 0.0}, max_out=12)
    _aug_close(out, rest, AUG_ATOL[case], dtype)


def _aug_trainer(path, dev, batches, out) -> Trainer:
    """A TINY_YAML f32 Trainer from seed 0 with device_augment="full" (the
    "full" preset's hyperparameters)."""
    return Trainer(YOLO.from_yaml(path), train_loader=batches,
                   data=DataConfig(num_classes=4, augment=AugmentConfig()),
                   config=TrainConfig(data_parallel=False,
                                      output_dir=str(out)),
                   device_augment="full", device=dev)


def test_prefetched_epoch_cuda_matches_train_steps(cuda, tmp_path):
    """An augmented TINY_YAML epoch through `_prefetched` (pinned staging,
    the copy stream, the event) against the same batches through
    `train_step`, both on the card: mean loss items within 1e-5
    relative, and the train kernels launched every step."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    batches = [make_eval_batch(4, 96, seed) for seed in range(3)]
    a = _aug_trainer(path, cuda, batches, tmp_path)
    b = _aug_trainer(path, cuda, batches, tmp_path)
    before = stem.raw_launches
    mean = a.train_one_epoch(0)
    assert stem.raw_launches == before + 3
    steps = [b.train_step(x["images"], x["targets"])[1].cpu()
             for x in batches]
    np.testing.assert_allclose(mean, (sum(steps) / 3).numpy(), rtol=1e-5)
    assert np.isfinite(mean).all()


def _pinned_copies(events: list[dict]) -> list[dict]:
    return [e for e in events if e.get("cat") == "gpu_memcpy"
            and "HtoD" in e.get("name", "") and "Pinned" in e["name"]]


def test_batch_copy_runs_off_the_compute_stream(cuda, tmp_path):
    """A traced augmented epoch: the batches' images are copied from pinned
    memory ("Pinned -> Device"), and every copy from pinned memory runs on
    a stream on which none of the package's kernels runs. The epoch runs
    50 ms inside the trace, and the trace is taken again (up to three
    times) while it holds no copy of a batch's images or no kernel: the
    profiler drops some device activity late in a long process (F4; in
    one run of this file it kept 4 of an epoch's 6 copies)."""
    from torch.profiler import ProfilerActivity, profile

    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    batches = [make_eval_batch(4, 96, seed) for seed in range(3)]
    tr = _aug_trainer(path, cuda, batches, tmp_path)
    image_bytes = batches[0]["images"].nbytes

    def stream(e: dict):
        return e.get("args", {}).get("stream", e.get("tid"))

    tr.train_one_epoch(0)
    torch.cuda.synchronize()
    for traces in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            tr.train_one_epoch(0)
            torch.cuda.synchronize()
            time.sleep(0.05)
        trace = tmp_path / f"trace{traces}.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        copies = _pinned_copies(events)
        kernels = {stream(e) for e in events if e.get("cat") == "kernel"
                   and "yolo" in e.get("name", "")}
        if kernels and any(e["args"].get("bytes") == image_bytes
                           for e in copies):
            break
    seen = sorted({(e.get("cat"), e.get("name", "")[:40]) for e in events
                   if e.get("cat") in ("gpu_memcpy", "gpu_memset")})
    assert any(e["args"].get("bytes") == image_bytes for e in copies), (
        traces, seen)
    assert kernels, f"no yolo kernel in {traces} trace(s)"
    assert not {stream(e) for e in copies} & kernels, (
        {stream(e) for e in copies}, kernels)


# ---------------------------------------------------------------------------
# the serving export: the five custom ops and the loaded archive
# ---------------------------------------------------------------------------

def _op_case(name: str, dtype: torch.dtype, dev):
    """(the module of the op `yolo_torch::{name}` and its launch counter,
    args, plain result) on the card."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, cl=False):
        return _rand(g, *shape, scale=scale, dtype=dtype, cl=cl).to(dev)

    if name == "stem_conv":
        args = (rnd(2, 3, 17, 22, cl=True), rnd(16, 3, 3, 3, scale=0.3),
                rnd(16))
        return stem, args, stem.stem_conv_plain(*args)
    if name == "adown_packed":
        x = rnd(2, 32, 12, 14, cl=True)
        w1, w2 = rnd(16, 16, 3, 3, scale=0.05), rnd(16, 16, 1, 1, scale=0.1)
        b1, b2 = rnd(16), rnd(16)
        w1p, w2p = adown.pack_weights(w1, w2)
        return adown, (x, w1p, b1, w2p, b2), \
            adown.adown_plain(x, w1, b1, w2, b2)
    if name == "conv3_silu_packed":
        x, w, b = rnd(2, 64, 9, 11, cl=True), \
            rnd(64, 64, 3, 3, scale=0.05), rnd(64)
        return conv3, (x, conv3.pack_weights(w), b), \
            conv3.conv3_silu_plain(x, w, b)
    if name == "bottleneck_chain_packed":
        m = rnd(1, 32, 32, 32, cl=True)
        w1, w2 = rnd(1, 32, 32, 3, 3, scale=0.06), \
            rnd(1, 32, 32, 3, 3, scale=0.06)
        b1, b2 = rnd(1, 32), rnd(1, 32)
        return csp_chain, (m, *csp_chain.pack_weights(w1, b1, w2, b2)), \
            csp_chain.bottleneck_chain_plain(m, w1, b1, w2, b2)
    boxes = torch.rand(2, 50, 4, generator=g) * 40
    boxes[..., 2:] += boxes[..., :2] + 1
    scores = torch.rand(2, 50, generator=g)
    args = (boxes.to(dev), scores.to(dev), 0.45, 20)
    return nms, args, nms.nms_select_plain(*args)


OP_CASES = [(n, d) for n in ("stem_conv", "adown_packed",
                             "conv3_silu_packed", "bottleneck_chain_packed")
            for d in (torch.float32, torch.bfloat16)] + \
    [("nms_select", torch.float32)]


@pytest.mark.parametrize("name,dtype", OP_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in OP_CASES])
def test_custom_op_opcheck_on_cuda(cuda, name, dtype):
    """torch.library.opcheck on CUDA inputs (schema, fake against the
    kernel's real output: shape, dtype, strides; dispatch), and the op's
    one launch within the tolerance of the plain version."""
    module, args, plain = _op_case(name, dtype, cuda)
    op = getattr(torch.ops.yolo_torch, name).default
    torch.library.opcheck(op, args)
    before = module.launches
    y = op(*args)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    assert y.stride() == plain.stride()
    if name == "nms_select":
        assert torch.equal(y, plain)
    else:
        torch.testing.assert_close(y.float(), plain.float(),
                                   atol=ATOL[dtype], rtol=RTOL[dtype])


def _serving_sites(model) -> dict:
    """Launches of each serving kernel in one request of a fused model."""
    from yolo_re_tpu_torch.models import blocks

    mods = list(model.modules())
    return {
        "stem": sum(isinstance(m, blocks.Conv) and m.is_stem
                    and m.bn is None for m in mods),
        "adown": sum(isinstance(m, blocks.ADown) and m.packed for m in mods),
        "csp_chain": sum(isinstance(m, blocks.RepNCSP) and m.chain
                         for m in mods),
        "conv3": sum(isinstance(m, blocks.Conv) and m.is_conv3
                     and m.bn is None for m in mods),
        "nms": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_detector_cuda_equals_live(cuda, tmp_path, dtype):
    """The trained tiny fixture exported on the card: the loaded program's
    output equals the live cuda Detector's bit for bit, and each call of it
    launches every kernel of the model's sites and one NMS."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    det = Detector.from_checkpoint(YOLO.from_yaml(path), str(FIXTURE),
                                   device=cuda, img_size=160,
                                   conf_thres=1e-3, compute_dtype=dtype)
    archive = str(tmp_path / "tiny.pt2")
    det.export(archive, 2, height=120, width=200)
    run = Detector.load_exported(archive)
    assert run.device.type == "cuda"
    modules = {"stem": stem, "adown": adown, "csp_chain": csp_chain,
               "conv3": conv3, "nms": nms}
    sites = _serving_sites(det.model)
    assert min(v for k, v in sites.items() if k != "csp_chain") >= 1
    for seed in (1, 2):
        frames = np.ascontiguousarray(
            make_eval_batch(2, 200, seed)["images"][:, 40:160])
        live = det(frames)
        before = {k: m.launches for k, m in modules.items()}
        loaded = run(frames)
        torch.cuda.synchronize()
        assert {k: m.launches - before[k] for k, m in modules.items()} == \
            sites
        for k in ("boxes", "scores", "classes", "valid"):
            assert loaded[k].device.type == "cuda"
            assert torch.equal(live[k], loaded[k]), k
        assert int(loaded["valid"].sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_detector_moves_between_cpu_and_card(cuda, tmp_path, dtype):
    """The trained tiny fixture exported on the CPU for the card launches
    the model's sites and one NMS a call and equals the live cuda
    Detector; exported on the card for the CPU it launches nothing and
    equals the live CPU Detector; an archive moved at load likewise."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = YOLO.from_yaml(path)
    kw = {"img_size": 160, "conf_thres": 1e-3, "compute_dtype": dtype}
    live = {d: Detector.from_checkpoint(model, str(FIXTURE), device=d, **kw)
            for d in ("cpu", "cuda")}
    modules = {"stem": stem, "adown": adown, "csp_chain": csp_chain,
               "conv3": conv3, "nms": nms}
    sites = _serving_sites(live["cuda"].model)
    frames = np.ascontiguousarray(
        make_eval_batch(2, 200, 3)["images"][:, 40:160])
    archives = {}
    for src, dst in (("cpu", "cuda"), ("cuda", "cpu")):
        archives[dst] = str(tmp_path / f"for_{dst}.pt2")
        live[src].export(archives[dst], 2, height=120, width=200, device=dst)
    runs = [(d, Detector.load_exported(archives[d])) for d in archives] + \
        [(d, Detector.load_exported(archives[o], device=d))
         for d, o in (("cuda", "cpu"), ("cpu", "cuda"))]
    for dst, run in runs:
        assert run.device.type == dst
        before = {k: m.launches for k, m in modules.items()}
        got = run(frames)
        torch.cuda.synchronize()
        launched = {k: m.launches - before[k] for k, m in modules.items()}
        assert launched == (sites if dst == "cuda"
                            else dict.fromkeys(sites, 0))
        want = live[dst](frames)
        for k in ("boxes", "scores", "classes", "valid"):
            assert got[k].device.type == dst
            assert torch.equal(want[k], got[k]), (dst, k)
        assert int(got["valid"].sum()) > 0


# ---------------------------------------------------------------------------
# data parallelism on the card: the mesh Detector, global moments over NCCL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 5])
def test_mesh_detector_on_one_card_twice(cuda, tmp_path, n):
    """Detector(mesh=Mesh((cuda:0, cuda:0))) on n frames (5: padded to 6)
    against the single Detector, the trained fixture in f32: equal
    detections, every replica tensor (the packed weights included) on the
    card, and each replica's kernels launched."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = YOLO.from_yaml(path)
    card = torch.device("cuda", 0)
    kw = {"img_size": 160, "compute_dtype": "float32"}
    single = Detector.from_checkpoint(model, str(FIXTURE), device=card, **kw)
    meshed = Detector.from_checkpoint(model, str(FIXTURE),
                                      mesh=mesh.Mesh((card, card)), **kw)
    for program in meshed.programs:
        for t in (*program.model.parameters(), *program.model.buffers()):
            assert t.device == card
    images = make_eval_batch(n, 160, 0)["images"]
    a = {k: v.cpu() for k, v in single(images).items()}
    nms.launches = 0
    b = {k: v.cpu() for k, v in meshed(images).items()}
    assert nms.launches == 2
    for k in ("valid", "classes"):
        assert torch.equal(a[k], b[k])
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-4)
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
    assert a["valid"].sum(1).min() >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_moments_over_a_one_process_nccl_group(cuda, dtype):
    """batch_moments inside global_batch over a one-process NCCL group
    (init_distributed, a free localhost port) equals batch_moments without
    a group, and so does dx; the group is gone afterwards."""
    import datetime
    import socket

    import torch.distributed as dist

    from yolo_re_tpu_torch.ops.conv import batch_moments

    g = torch.Generator().manual_seed(3)
    y0 = (torch.randn(4, 64, 20, 20, generator=g) * 2 + 0.5).to(cuda, dtype)
    gm, gv = torch.randn(2, 64, generator=g).to(cuda)

    def moments(group):
        y = y0.clone().requires_grad_()
        with mesh.global_batch(group):
            mean, var = batch_moments(y)
        (mean * gm + var * gv).sum().backward()
        return mean.detach(), var.detach(), y.grad.float()

    ref = moments(None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert mesh.init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda",
                                 timeout=datetime.timedelta(seconds=60)) \
        == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        got = moments(dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    rtol = 1e-6 if dtype == torch.float32 else 1e-5
    for x, r in zip(got, ref):
        torch.testing.assert_close(x, r, rtol=rtol,
                                   atol=rtol * float(r.abs().max()))


# ---------------------------------------------------------------------------
# train tooling and lazy-decode NMS
# ---------------------------------------------------------------------------

def _train_counts() -> tuple[int, int, int, int]:
    return (stem.raw_launches, stem.wgrad_launches, adown.raw_launches,
            adown.bwd_launches)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_launch_counts_and_running_stats(cuda, tmp_path, dtype):
    """One TINY_YAML train step per remat mode from the same init on the
    card: the recomputed blocks launch their forward kernels again (the
    stem at scale 2 under both modes, the four ADowns under True, down1
    and pan_down1 under "early": stem raw 1/2/2, ADown raw 4/8/6), the
    backward kernels once (1/1/1, 4/4/4); the loss items and the BN
    running statistics after the step equal remat off's (the forward
    kernels are bit-stable; the recompute updates no statistic)."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    batch = make_eval_batch(4, 96, 5)
    want = {False: (1, 1, 4, 4), True: (2, 1, 8, 4), "early": (2, 1, 6, 4)}
    out = {}
    for mode in want:
        cfg = TrainConfig(data_parallel=False, output_dir=str(tmp_path),
                          remat=mode, compute_dtype=dtype)
        tr = Trainer(YOLO.from_yaml(path), config=cfg, train_loader=[batch],
                     device=cuda)
        before = _train_counts()
        _, items, _ = tr.train_step(batch["images"], batch["targets"])
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(_train_counts(), before))
        assert got == want[mode], (mode, got)
        out[mode] = (items.cpu(), {k: v.cpu() for k, v in tr.stats.items()})
    for mode in (True, "early"):
        assert torch.equal(out[mode][0], out[False][0]), mode
        for k, v in out[False][1].items():
            assert torch.equal(out[mode][1][k], v), (mode, k)


@pytest.mark.parametrize("conf", [0.25, 1e-3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_raw_cuda_matches_cpu(cuda, tmp_path, conf, dtype):
    """non_max_suppression_raw on the trained fixture's split streams
    (160 px, 2100 anchors; K = 512 and every anchor) on the card (one NMS
    launch) against the CPU (the plain version), f32 and bf16 logits."""
    from yolo_re_tpu_torch.convert import state_dict_from_jax
    from yolo_re_tpu_torch.ops.boxes import make_anchors_np
    from yolo_re_tpu_torch.ops.nms import non_max_suppression_raw

    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = YOLO.from_yaml(path)
    model.load_state_dict(state_dict_from_jax(
        model.plan, *load_weights(str(FIXTURE))), strict=True)
    model.eval()
    x = make_eval_batch(2, 160, 3)["images"].astype(np.float32) / 255
    pts, col = make_anchors_np([(160 // int(s),) * 2 for s in model.strides],
                               model.strides)
    out = []
    for dev in (cuda, torch.device("cpu")):
        model.to(dev)
        with torch.no_grad():
            box, cls = model.predict_split(torch.from_numpy(x).to(dev)
                                           .permute(0, 3, 1, 2))
        before = nms.launches
        r = non_max_suppression_raw(
            box.to(dtype), cls.to(dtype), torch.from_numpy(pts).to(dev),
            torch.from_numpy(col).to(dev), conf_thres=conf)
        assert nms.launches == before + (dev.type == "cuda")
        out.append((box.cpu(), cls.cpu(), {k: v.cpu() for k, v in r.items()}))
    (bc, cc, a), (bh, ch, b) = out
    torch.testing.assert_close(bc, bh, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(cc, ch, atol=1e-4, rtol=1e-5)
    for k in ("valid", "classes"):
        assert torch.equal(a[k], b[k]), k
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3)
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
    assert a["valid"].sum() > 0


def test_checkpoint_dir_saved_on_cuda_loads_on_cpu(cuda, tmp_path):
    """A TINY_YAML Trainer on the card, a step with an injected Adam, saved
    as a checkpoint directory (checkpoint_format "orbax"), resumed by a CPU
    Trainer: every parameter, statistic, EMA tensor and Adam state equal;
    load_weights(dir) gives the EMA."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    batch = make_eval_batch(4, 96, 5)

    def adam(ps):
        return torch.optim.Adam(ps, lr=1e-3)

    trainers = []
    for dev in (cuda, torch.device("cpu")):
        cfg = TrainConfig(data_parallel=False, output_dir=str(tmp_path),
                          checkpoint_format="orbax")
        trainers.append(Trainer(YOLO.from_yaml(path), config=cfg,
                                train_loader=[batch], device=dev,
                                optimizer=adam))
    card, host = trainers
    card.train_step(batch["images"], batch["targets"])
    card._save(tmp_path / "ckpt.npz", 0)
    assert (tmp_path / "ckpt" / ".metadata").is_file()
    host.load_checkpoint(tmp_path / "ckpt")
    for a, b in ((card.params, host.params), (card.stats, host.stats),
                 (card.ema["params"], host.ema["params"])):
        for k, v in a.items():
            assert torch.equal(v.detach().cpu(), b[k].detach()), k
    for k, p in host.params.items():
        mine = host._torch_opt.state[p]
        theirs = card._torch_opt.state[card.params[k]]
        assert mine.keys() == theirs.keys() and mine, k
        for s, v in mine.items():
            assert torch.equal(torch.as_tensor(v).cpu(),
                               torch.as_tensor(theirs[s]).cpu()), (k, s)
    params, _ = load_weights(tmp_path / "ckpt")
    np.testing.assert_array_equal(
        params["stem1"]["w"], np.transpose(
            card.ema["params"]["layers.stem1.conv.weight"].cpu().numpy(),
            (2, 3, 1, 0)))


def test_profile_layers_puts_the_stem_kernel_in_stem1(cuda, tmp_path):
    """cli/profile_layers on the card, fused TINY_YAML bf16 at 160 px: the
    layer rows are the main steps in order and sum to the kernel time, the
    stem kernel (launched once a forward) runs inside stem1's range alone,
    and stem1's row holds its device time."""
    from yolo_re_tpu_torch.cli import profile_layers as pl
    from yolo_re_tpu_torch.utils import profiling

    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    model = pl.build_model(str(path), torch.bfloat16, cuda)
    x = pl.random_batch(2, 160, torch.bfloat16, cuda)
    before = stem.launches
    res = pl.profile_forward(model, x, iters=3)
    assert stem.launches - before == res["forwards"]
    names = [s.name for s in model.main_steps]
    assert [r[0] for r in res["rows"][:len(names)]] == names
    rows = {r[0]: r[2] for r in res["rows"]}
    assert abs(sum(rows.values()) - res["kernel_ms"]) <= \
        1e-3 * res["kernel_ms"]
    assert 0 < res["kernel_ms"] <= res["wall_ms"]
    # F4: late in a long process a trace can still lose a launch; trace
    # again (three times at most) until it holds the stem kernel's
    for _ in range(3):
        with torch.no_grad(), profiling.layer_ranges(model, names):
            prof = profiling.traced(lambda: model(x, main_only=True), cuda)
        by, total = profiling.time_by_layer(prof, cuda,
                                            kernel="stem_kernel")
        if total > 0:
            break
    assert total > 0 and set(by) == {"stem1"}
    assert abs(by["stem1"] - total) <= 1e-6 * total
    assert rows["stem1"] * 1e3 >= 0.5 * total


# ---------------------------------------------------------------------------
# train BN + activation (ops/kernels/bn_silu.py, ops/conv.py: BatchNormAct)
# ---------------------------------------------------------------------------

# (y shape, modules): yolov9-c's train sites at 640 px, batch 32 (the stem's
# 64 x 320 x 320, the widest 32- and 128-channel maps, 512 at 20 x 20, an
# ADown's two modules at 256 x 80 x 80); C = 40 (a tile of 8 threads holding
# 5 vectors), 80 and 12 (no multiple of the 16-byte vector: the one-element
# walk) at odd H and W
BN_SHAPES = [((32, 64, 320, 320), 1), ((32, 128, 160, 160), 1),
             ((32, 32, 160, 160), 1), ((32, 512, 20, 20), 1),
             ((32, 256, 80, 80), 2), ((2, 40, 17, 19), 1),
             ((3, 80, 11, 13), 2), ((3, 12, 9, 7), 1)]


def _bn_case(dev, shape, modules, dtype, seed=0):
    """y ~ 1.5 N(0, 1) + 0.3, g ~ N(0, 1) in dtype, channels_last; BN
    weight ~ U(0.5, 1.5), bias ~ 0.3 N(0, 1); the running statistics of
    `modules` modules."""
    from yolo_re_tpu_torch.ops.kernels import bn_silu  # noqa: F401
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    y = _rand(gen, *shape, scale=1.5, cl=True).add_(0.3).to(dtype).to(dev)
    g = _rand(gen, *shape, dtype=dtype, cl=True).to(dev)
    w = (torch.rand(c, generator=gen) + 0.5).to(dev)
    b = _rand(gen, c, scale=0.3).to(dev)
    k = c // modules
    running = [(torch.zeros(k, device=dev), torch.ones(k, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
               for _ in range(modules)]
    return y, g, w, b, running


def _per_channel_sum_tol(t: torch.Tensor) -> torch.Tensor:
    """1e-5 of each channel's sum of |terms| (f32 sums of up to 3.3M
    terms in two orders)."""
    return 1e-5 * t.abs().sum(dim=(0, 2, 3))


@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,modules", BN_SHAPES)
def test_bn_act_kernels_match_plain(cuda, shape, modules, dtype, act):
    """Each kernel's two jobs against their plain versions on the card:
    - the forward's reduction: mean, rstd, inv, shift within 1e-5
      relative (f32 sums in another order), keep equal; the running
      statistics likewise, and num_batches_tracked counted once a module;
    - the forward's pointwise pass: z equal to the plain pass on the
      kernel's statistics (the same ops at the same rounding points, SiLU
      by the same expf);
    - the backward, on the plain statistics: dweight and dbias each
      channel within 1e-5 of its sum of |terms| (sum order); dx in f32
      within 1e-5 relative, in bf16 within one bf16 ulp of |ref| (each side
      rounds once an f32 value it computes in another op order), and
      within 2^-10 of the largest |dx| near 0 (f32 cancellation)."""
    from yolo_re_tpu_torch.ops.kernels import bn_silu
    y, g, w, b, running = _bn_case(cuda, shape, modules, dtype)
    plain_running = [tuple(t.clone() for t in r) for r in running]
    before = (bn_silu.launches, bn_silu.bwd_launches)
    z, stats = bn_silu.forward(y, w, b, act, running, True, 1e-3, 0.03)
    ref = bn_silu.moments_plain(y, w, b, plain_running, True, 1e-3, 0.03)
    torch.testing.assert_close(stats[:4], ref[:4], rtol=1e-5, atol=1e-5)
    assert torch.equal(stats[4], ref[4])
    for r, p in zip(running, plain_running):
        torch.testing.assert_close(r[0], p[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(r[1], p[1], rtol=1e-5, atol=1e-6)
        assert int(r[2]) == int(p[2]) == 1
    assert z.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(z, bn_silu.affine_act_plain(y, stats, act))
    dx, dw, db = bn_silu.backward(g, y, ref, act)
    sums = bn_silu.grad_sums_plain(g, y, ref, act)
    ga, xhat = bn_silu._grad_terms(g, y, ref, act)
    assert bool(((db - sums[bn_silu.DBIAS]).abs()
                 <= _per_channel_sum_tol(ga)).all())
    assert bool(((dw - sums[bn_silu.DWEIGHT]).abs()
                 <= _per_channel_sum_tol(ga * xhat)).all())
    ref_dx = bn_silu.grad_input_plain(g, y, ref, sums, act)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(
        dx.float(), ref_dx.float(), rtol=rtol,
        atol=2.0 ** -10 * float(ref_dx.abs().max()))
    torch.cuda.synchronize()
    launched = 1 if dtype == torch.bfloat16 else 2
    assert (bn_silu.launches - before[0], bn_silu.bwd_launches - before[1]) \
        == (launched + 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,modules", BN_SHAPES[:1] + BN_SHAPES[-3:])
def test_bn_act_kernels_bit_equal_across_calls(cuda, shape, modules, dtype):
    """No float atomics: two identical calls give equal statistics,
    outputs and gradients."""
    from yolo_re_tpu_torch.ops.kernels import bn_silu
    y, g, w, b, running = _bn_case(cuda, shape, modules, dtype, seed=1)
    outs = []
    for _ in range(2):
        z, stats = bn_silu.forward(y, w, b, "silu", running, False, 1e-3,
                                   0.03)
        outs.append((z, stats, *bn_silu.backward(g, y, stats, "silu")))
    for a, b2 in zip(*outs):
        assert torch.equal(a, b2)
    # update=False left the running statistics as they were
    assert all(int(r[2]) == 0 for r in running)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,wide", [((32, 128, 40, 40), 128, 512),
                                               ((2, 40, 17, 19), 8, 96),
                                               ((3, 12, 9, 7), 4, 20)])
def test_bn_act_backward_reads_a_channel_slice(cuda, shape, offset, wide,
                                               dtype):
    """The gradient a concat hands back is a channel slice of a wider
    channels_last tensor: the backward reads its rows at their pitch (16
    bytes aligned, or not: offset 4 of 20 channels) and gives what it gives
    on a dense copy, bit for bit."""
    from yolo_re_tpu_torch.ops.kernels import bn_silu
    y, _, w, b, running = _bn_case(cuda, shape, 1, dtype, seed=2)
    gen = torch.Generator().manual_seed(3)
    whole = _rand(gen, shape[0], wide, *shape[2:], dtype=dtype,
                  cl=True).to(cuda)
    g = whole[:, offset:offset + shape[1]]
    assert bn_silu.row_pitch(g) == wide
    _, stats = bn_silu.forward(y, w, b, "silu", running, False, 1e-3, 0.03)
    dense = g.contiguous(memory_format=torch.channels_last)
    for a, b2 in zip(bn_silu.backward(g, y, stats, "silu"),
                     bn_silu.backward(dense, y, stats, "silu")):
        assert torch.equal(a, b2)


def test_bn_act_wrappers_raise_on_cuda(cuda):
    """A CUDA tensor that reaches a wrapper launches the kernels or raises:
    an NCHW-contiguous tensor, a float16 one, an activation the kernels
    lack, an NCHW-contiguous gradient."""
    from yolo_re_tpu_torch.ops.kernels import bn_silu
    y, g, w, b, running = _bn_case(cuda, (2, 16, 5, 6), 1, torch.bfloat16)
    _, stats = bn_silu.forward(y, w, b, "silu", running, False, 1e-3, 0.03)
    for call in (lambda: bn_silu.forward(y.contiguous(), w, b, "silu",
                                         running, False, 1e-3, 0.03),
                 lambda: bn_silu.forward(y.half(), w, b, "silu", running,
                                         False, 1e-3, 0.03),
                 lambda: bn_silu.forward(y, w, b, "relu", running, False,
                                         1e-3, 0.03),
                 lambda: bn_silu.backward(g.contiguous(), y, stats, "silu")):
        with pytest.raises((TypeError, ValueError)):
            call()


def _yolov9c_step_grads(cuda, tr, batch, dtype, eager: bool, monkeypatch):
    """One yolov9-c step's loss and parameter gradients on the card, as
    Trainer._step computes them (without the update), the activations in
    dtype; eager: every train BN site through the eager chain."""
    from yolo_re_tpu_torch.ops import conv
    from yolo_re_tpu_torch.utils.precision import full_f32
    with monkeypatch.context() as m:
        if eager:
            m.setattr(conv, "takes_kernels", lambda *args: False)
        x, t, ready = tr._put_batch(batch["images"], batch["targets"])
        if ready is not None:
            torch.cuda.current_stream(cuda).wait_event(ready)
        x = tr._normalized(x).to(dtype).contiguous().permute(0, 3, 1, 2)
        names = list(tr.params)
        before = (conv.fused_sites, conv.eager_sites)
        with full_f32():
            total, _ = tr.loss_fn(tr.model(x), t)
            grads = torch.autograd.grad(total, [tr.params[k] for k in names])
        torch.cuda.synchronize()
        sites = (conv.fused_sites - before[0], conv.eager_sites - before[1])
    return float(total.detach()), dict(zip(names, grads)), sites


def test_yolov9c_bf16_step_runs_every_bn_site_through_the_kernels(
        cuda, tmp_path, monkeypatch):
    """yolov9-c at full width, one bf16 step at batch 8, 320 px, BN scales
    U(0.02, 0.06) (as the benchmark's train cell: at the default scales a
    bf16 step departs from an f32 one by O(1)): every train BN site (the
    model's BN modules, ADown's two counted as one site) takes
    BatchNormAct, none the eager chain. The same step in f32 through the
    eager chain is the reference; d(a, b) is the relative L2 of all
    gradients together. The kernels' step sits no farther from the
    reference than the bf16 eager chain's, plus 10% of it (the rest of the
    step's bf16 rounding, which both share), in the loss (and 1e-5 of it)
    and in d; and the two bf16 steps lie within twice that distance of
    each other (each carries its own bf16 rounding). Measured on an H100
    80GB HBM3: d(kernels, f32) 2.7e-4, d(eager, f32) 6.0e-4, d(kernels,
    eager) 6.6e-4, the two bf16 losses equal."""
    from torch import nn

    from yolo_re_tpu_torch.models.blocks import ADown
    cfg = TrainConfig(data_parallel=False, output_dir=str(tmp_path),
                      compute_dtype="bfloat16")
    model = YOLO.from_yaml(Path(__file__).resolve().parent.parent /
                           "configs" / "models" / "yolov9-c.yaml")
    batch = make_eval_batch(8, 320, 5)
    tr = Trainer(model, config=cfg, train_loader=[batch], device=cuda)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(0.02 + 0.04 * torch.rand(
                    m.num_features, generator=gen))
    want = sum(isinstance(m, nn.BatchNorm2d) for m in model.modules()) - \
        sum(isinstance(m, ADown) for m in model.modules())
    steps = {}
    for name, dtype, eager in (("kernels", torch.bfloat16, False),
                               ("eager", torch.bfloat16, True),
                               ("f32", torch.float32, True)):
        steps[name] = _yolov9c_step_grads(cuda, tr, batch, dtype, eager,
                                          monkeypatch)
    assert steps["kernels"][2] == (want, 0)
    assert steps["eager"][2] == (0, want)

    def flat(name):
        gs = steps[name][1]
        return torch.cat([gs[k].float().flatten() for k in sorted(gs)])

    def d(a, b):
        return float((flat(a) - flat(b)).norm() / flat(b).norm())

    loss = {k: v[0] for k, v in steps.items()}
    print(f"loss {loss}; d(kernels, f32) {d('kernels', 'f32')}, "
          f"d(eager, f32) {d('eager', 'f32')}, d(kernels, eager) "
          f"{d('kernels', 'eager')}")
    # the two bf16 forwards round at the same points; their moments sum in
    # other orders, which moves the loss by a few f32 ulps at most
    assert abs(loss["kernels"] - loss["eager"]) <= 1e-5 * abs(loss["eager"])
    assert abs(loss["kernels"] - loss["f32"]) <= \
        1.1 * abs(loss["eager"] - loss["f32"]) + 1e-5 * abs(loss["f32"])
    assert d("kernels", "f32") <= 1.1 * d("eager", "f32")
    assert d("kernels", "eager") <= 2.2 * d("eager", "f32")
