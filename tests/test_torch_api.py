"""The port's remaining public functions held against the JAX package on
the CPU: the activations of ops/conv.py, `xyxy2xywh` and `box_iou`,
`one_cycle_lr`, and `register_block`. Inputs come from numpy seeds and go
to both packages; whole-model weights are the port's init carried to JAX
by yolo_re_tpu_torch.convert (the JAX init compiles op by op, ~20 s
cold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401

from yolo_re_tpu.models import blocks as JB
from yolo_re_tpu.models.yolo import YOLO as JYOLO
from yolo_re_tpu.ops import boxes as jboxes
from yolo_re_tpu.ops.conv import get_activation as jget_activation
from yolo_re_tpu.train.schedule import one_cycle_lr as jone_cycle_lr
from yolo_re_tpu_torch import convert
from yolo_re_tpu_torch.data import synth
from yolo_re_tpu_torch.models import blocks as B
from yolo_re_tpu_torch.models.yolo import YOLO
from yolo_re_tpu_torch.ops import boxes
from yolo_re_tpu_torch.ops.conv import get_activation
from yolo_re_tpu_torch.train.schedule import one_cycle_lr

# f32 decoded output, PARITY.md "Parity" (gelan-c: 3.1e-5)
DECODED_ATOL = 3.1e-5
BOX_ATOL = 1e-6
LR_ATOL = 1e-12
SIZE = 64


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["relu", "leaky_relu", "hardswish", "none"])
def test_activation_matches_jax_within_one_ulp(name):
    """The activations besides SiLU (F.silu and JAX's x * sigmoid(x) part
    by 2 ulp; the whole-model tests hold SiLU)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-8, 8, 4096),
        [-6.0, -3.0, -1e-3, 0.0, 1e-3, 3.0, 6.0, -20.0, 20.0]]
    ).astype(np.float32)
    ref = np.asarray(jget_activation(name)(jnp.asarray(x)))
    y = get_activation(name)(torch.from_numpy(x)).numpy()
    assert y.dtype == ref.dtype == np.float32
    np.testing.assert_array_max_ulp(y, ref, maxulp=1)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unknown activation"):
        get_activation("gelu")


# ---------------------------------------------------------------------------
# a tiny model whose Convs use another activation, fused and unfused
# ---------------------------------------------------------------------------

def _yaml(tmp_path, text: str) -> str:
    p = tmp_path / "model.yaml"
    p.write_text(text)
    return str(p)


def _weights(model: YOLO, seed: int) -> dict:
    """The port's init with non-trivial BN running statistics, so that BN
    and its folding are exercised."""
    model.init_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape,
                                                generator=g) * 0.2 - 0.1)
                m.running_var.add_(torch.rand(m.running_var.shape,
                                              generator=g) * 0.3)
    return model.state_dict()


def _decoded_pair(path: str, fused: bool) -> tuple[np.ndarray, np.ndarray]:
    """The port's decoded output and the JAX package's on the same weights
    and images (TINY-sized, SIZE px)."""
    model, jmodel = YOLO.from_yaml(path), JYOLO.from_yaml(path)
    params, stats = convert.jax_from_state_dict(model.plan,
                                                _weights(model, 0))
    if fused:
        model.fuse()
        params, stats = jmodel.fuse(params, stats)
    x = synth.make_eval_batch(2, SIZE, 1)["images"].astype(np.float32) / 255
    ref, _ = jmodel.predict(params, stats, jnp.asarray(x))
    with torch.no_grad():
        dec, _ = model(_nchw(x))
    return dec.numpy(), np.asarray(ref)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("act", ["relu", "hardswish"])
def test_tiny_model_with_another_activation_matches_jax(tmp_path, act,
                                                        fused):
    text = synth.TINY_YAML.replace(
        "kernel_size: 3, stride: 2}", f"kernel_size: 3, stride: 2, "
        f"activation: {act}}}")
    assert text.count(f"activation: {act}") == 2     # stem1, stem2
    path = _yaml(tmp_path, text)
    model = YOLO.from_yaml(path)
    for name in ("stem1", "stem2"):
        conv = model.layers[name]
        # the kernels' gates admit only SiLU: the library conv runs
        assert conv.activation == act and not conv.is_stem
    dec, ref = _decoded_pair(path, fused)
    assert dec.shape == ref.shape == (2, 336, 8)
    np.testing.assert_allclose(dec, ref, atol=DECODED_ATOL)


def test_train_forward_honours_the_activation(tmp_path):
    """The train path (conv_bn_act with batch statistics) applies the
    layer's activation: relu leaves no negative output."""
    text = synth.TINY_YAML.replace(
        "out_channels: 16, kernel_size: 3, stride: 2}",
        "out_channels: 16, kernel_size: 3, stride: 2, activation: relu}")
    model = YOLO.from_yaml(_yaml(tmp_path, text)).train()
    model.init_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator()
                   .manual_seed(1))
    y = model.layers["stem1"](x)
    assert float(y.min()) == 0.0 and float(y.max()) > 0.0


# ---------------------------------------------------------------------------
# boxes, schedule
# ---------------------------------------------------------------------------

def _xyxy(rng, n: int) -> np.ndarray:
    xy = rng.uniform(0, 600, (n, 2))
    wh = rng.uniform(1, 200, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_xyxy2xywh_matches_jax():
    b = _xyxy(np.random.default_rng(4), 64).reshape(4, 16, 4)
    ref = np.asarray(jboxes.xyxy2xywh(jnp.asarray(b)))
    y = boxes.xyxy2xywh(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(y, ref, atol=BOX_ATOL, rtol=0)
    back = boxes.xywh2xyxy(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(back, b, atol=1e-4, rtol=0)


def test_box_iou_matches_jax():
    rng = np.random.default_rng(5)
    a, b = _xyxy(rng, 37), _xyxy(rng, 23)
    b[:5] = a[:5]                   # identical pairs: IoU 1
    b[5] = [1000, 1000, 1010, 1010]  # disjoint from every box: IoU 0
    ref = np.asarray(jboxes.box_iou(jnp.asarray(a), jnp.asarray(b)))
    y = boxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert y.shape == (37, 23)
    np.testing.assert_allclose(y, ref, atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(np.diag(y[:5, :5]), 1.0, atol=BOX_ATOL)
    assert not y[:, 5].any()


@pytest.mark.parametrize("lrf", [0.01, 0.2])
def test_one_cycle_lr_matches_jax(lrf):
    for total in (1, 7, 300):
        for epoch in np.linspace(0, total, 41):
            assert abs(one_cycle_lr(epoch, total, lrf)
                       - jone_cycle_lr(epoch, total, lrf)) <= LR_ATOL
    assert one_cycle_lr(0, 10, lrf) == 1.0
    assert abs(one_cycle_lr(10, 10, lrf) - lrf) <= LR_ATOL


# ---------------------------------------------------------------------------
# register_block: one YAML, a custom block in both packages
# ---------------------------------------------------------------------------

class JHalfConv:
    """JAX: a Conv whose output is halved."""

    Config = JB.ConvConfig

    @staticmethod
    def init(key, cfg):
        return JB.Conv.init(key, cfg)

    @staticmethod
    def apply(cfg, params, stats, x, *, train=False):
        y, new_stats = JB.Conv.apply(cfg, params, stats, x, train=train)
        return y * 0.5, new_stats


class HalfConv(B.Conv):
    """The port: the same block, built from the same YAML parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x) * 0.5


def test_registered_block_matches_jax(tmp_path, monkeypatch):
    name = "HalfConv"
    text = synth.TINY_YAML.replace(
        "{name: stem2, type: Conv,", f"{{name: stem2, type: {name},")
    assert f"type: {name}" in text
    path = _yaml(tmp_path, text)
    with pytest.raises(ValueError, match="Unknown block type"):
        YOLO.from_yaml(path)
    # the weight bridge maps a registered block's weights by its caller
    monkeypatch.setitem(convert._INVERSES, name, convert._conv_inv)
    JB.register_block(name, JHalfConv)
    B.register_block(name, HalfConv)
    try:
        assert B.get_block_class(name) is HalfConv
        model = YOLO.from_yaml(path)
        layer = model.layers["stem2"]
        assert type(layer) is HalfConv
        assert (layer.conv.in_channels, layer.conv.out_channels,
                layer.conv.stride) == (16, 32, (2, 2))
        dec, ref = _decoded_pair(path, fused=False)
        np.testing.assert_allclose(dec, ref, atol=DECODED_ATOL)
    finally:
        del JB.BLOCKS[name]
        del B.BLOCKS[name]
