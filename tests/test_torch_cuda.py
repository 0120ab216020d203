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
