"""Train-mode BatchNorm + activation kernels, forward and backward.

    forward   mean, var over (B, H, W) of y, per channel, in f32
              inv = rsqrt(var + eps) * weight, shift = bias - mean * inv
              z = act(y * inv + shift), act "silu" or "none"
              running statistics updated in place (unbiased variance)
    backward  gA = g * act'(a), xhat = (y - mean) * rstd
              dbias = sum gA, dweight = sum gA * xhat
              dx = inv * (gA - mean(gA) - xhat * mean(gA * xhat))

CUDA source `yolo_re_tpu_torch/csrc/bn_silu.cu`. It replaces no TPU kernel:
the JAX package leaves train BN to XLA's fusions (yolo_re_tpu/ops/conv.py:
conv_bn_act). It replaces ops/conv.py's eager chain (`batch_moments`,
`update_running_stats`, `bn_affine`, the activation) and autograd's
backward of each of its ops. Bound: bytes, 10 an element in bf16 (y read
and z written forward; g and y read, dx written backward).

Two kernels, each run for two jobs, each job with its plain PyTorch
version here (`*_plain`, which a CPU tensor takes):

- the reduction: `moments_plain`'s job, one pass of sum y, sum y^2 in
  bf16 (variance E[y^2] - mean^2 clamped at 0), two passes (mean, then
  sum (y - mean)^2) in f32, as the JAX package computes them; its last
  block writes the statistics `[STAT_ROWS, C]` (mean, rstd, inv, shift,
  keep: 0 where the variance was clamped) and updates the running
  statistics of one BN module, or of two that share the tensor's channels
  in order (ADown), unless `update` is False; and `grad_sums_plain`'s
  job, `[GRAD_ROWS, C]` = dbias, dweight, mean(gA), mean(gA * xhat) (0
  where the variance was clamped);
- the pointwise pass: `affine_act_plain`'s job, z = act(y * inv + shift)
  with inv and shift rounded to y's dtype, the product rounded, then the
  sum, then the activation's output (`bn_affine`'s rounding points); and
  `grad_input_plain`'s, dx in f32, rounded once.

`forward` runs the first job of each (one call of the library: 2 launches
in bf16, 3 in f32), `backward` the second of each (2 launches); ops/conv.py's
`BatchNormAct` calls them. The reductions sum in a fixed order (per-block
partials, summed in block order by the last block of each channel tile,
found by an atomic ticket): no float atomics, so two identical calls are
bit-equal. They take NCHW tensors in `torch.channels_last` memory, float32
or bfloat16 (the upstream gradient g may also be a channel slice of a
wider channels_last tensor, as a concat's backward hands it over: its rows
are read at their pitch, `row_pitch`); weight, bias and the statistics are
float32. Launches are counted per kernel launch.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F

from yolo_re_tpu_torch.ops.kernels import build, common

launches = 0        # forward: the reduction (1 bf16, 2 f32) and pointwise (1)
bwd_launches = 0    # backward: the reduction (1) and pointwise (1)

ACTIVATIONS = {"none": 0, "silu": 1}
MEAN, RSTD, INV, SHIFT, KEEP = range(5)
STAT_ROWS = 5
DBIAS, DWEIGHT, GMEAN, GXMEAN = range(4)
GRAD_ROWS = 4
# partials of the reductions: csrc/bn_silu.cu's kReduceBlocksPerSm blocks an
# SM at most, two sums a channel each
REDUCE_BLOCKS_PER_SM = 2

# A BN module's running statistics: (running_mean, running_var,
# num_batches_tracked).
Running = tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# (device index, stream) -> the reductions' partials (float32) and tickets
# (int32 zeros that the last block of each channel tile sets back to 0)
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _check(y: torch.Tensor, act: str) -> None:
    common.check_dtype(y, "y")
    common.check_channels_last(y, "y")
    if y.numel() == 0:
        raise ValueError("y: empty tensor")
    if act not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {act!r}")


def _check_forward(y, weight, bias, act, running) -> None:
    _check(y, act)
    c = y.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if (tuple(t.shape) != (c,) or t.dtype != torch.float32
                or t.device != y.device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous float32 ({c},) "
                             f"on {y.device}")
    if len(running) not in (1, 2) or \
            sum(r[0].numel() for r in running) != c:
        raise ValueError("running: one or two modules' statistics whose "
                         f"channels add up to {c}")
    for rm, rv, nbt in running:
        for name, t in (("running_mean", rm), ("running_var", rv)):
            if (t.dtype != torch.float32 or t.device != y.device
                    or not t.is_contiguous() or t.shape != rm.shape):
                raise ValueError(f"{name}: expected a contiguous float32 "
                                 f"{tuple(rm.shape)} on {y.device}")
        if nbt.dtype != torch.int64 or nbt.numel() != 1 or \
                nbt.device != y.device:
            raise ValueError("num_batches_tracked: expected one int64 on "
                             f"{y.device}")


def row_pitch(t: torch.Tensor) -> int | None:
    """Elements between consecutive (b, h, w) rows of a 4-d NCHW tensor
    whose channels are contiguous and whose rows are evenly spaced: C for
    channels_last memory, more for a channel slice of a wider
    channels_last tensor (the gradient a concat hands back); None for any
    other layout."""
    if t.dim() != 4:
        return None
    b, c, h, w = t.shape
    sb, sc, sh, sw = t.stride()
    ld = sw if w > 1 else sh if h > 1 else sb if b > 1 else c
    if (c > 1 and sc != 1) or ld < c or (w > 1 and sw != ld) or \
            (h > 1 and sh != w * ld) or (b > 1 and sb != h * w * ld):
        return None
    return ld


def _check_backward(g: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
                    act: str) -> int:
    """-> g's row pitch."""
    _check(y, act)
    if g.shape != y.shape or g.dtype != y.dtype or g.device != y.device:
        raise ValueError(f"g: expected {tuple(y.shape)} {y.dtype} on "
                         f"{y.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    ld = row_pitch(g)
    if ld is None:
        raise ValueError("g: expected channels_last memory or a channel "
                         "slice of a channels_last tensor")
    if (tuple(stats.shape) != (STAT_ROWS, y.shape[1])
            or stats.dtype != torch.float32 or stats.device != y.device
            or not stats.is_contiguous()):
        raise ValueError(f"stats: expected a contiguous float32 "
                         f"({STAT_ROWS}, {y.shape[1]}) on {y.device}")
    return ld


def _rows(y: torch.Tensor) -> int:
    return y.numel() // y.shape[1]


def _workspace(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(partials, tickets) of a reduction over y on the current stream:
    one pair a (device, stream), grown to the largest C seen. The
    reductions on one stream run one after another, and each leaves the
    tickets at 0."""
    c = y.shape[1]
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    need = 2 * REDUCE_BLOCKS_PER_SM * sms * c
    key = (y.device.index, common.stream(y))
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < need:
        # a channel tile holds at least one channel: C tickets suffice
        ws = (torch.empty(need, dtype=torch.float32, device=y.device),
              torch.zeros(c, dtype=torch.int32, device=y.device))
        _WORKSPACE[key] = ws
    return ws


def _call(name: str, *args) -> None:
    build.check(getattr(build.library(), name)(*args), name)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_running_plain(running: Sequence[Running], mean: torch.Tensor,
                         var: torch.Tensor, n: int, momentum: float) -> None:
    """running = (1 - momentum) * running + momentum * batch, with the
    unbiased batch variance (n samples per channel), in place; the modules'
    channels follow each other in mean and var."""
    unbiased = var * (n / max(n - 1, 1))
    start = 0
    for rm, rv, nbt in running:
        stop = start + rm.numel()
        rm.copy_((1.0 - momentum) * rm + momentum * mean[start:stop])
        rv.copy_((1.0 - momentum) * rv + momentum * unbiased[start:stop])
        nbt.add_(1)
        start = stop


def moments_plain(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running: Sequence[Running], update: bool, eps: float,
                  momentum: float) -> torch.Tensor:
    """The forward's reduction: the statistics [STAT_ROWS, C]; the
    running statistics updated in place if `update`."""
    yf = y.float()
    mean = yf.mean(dim=(0, 2, 3))
    if y.dtype == torch.bfloat16:
        raw = yf.square().mean(dim=(0, 2, 3)) - mean.square()
        keep = (raw >= 0).float()
        var = raw.clamp(min=0)
    else:
        var = (yf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        keep = torch.ones_like(var)
    rstd = torch.rsqrt(var + eps)
    inv = rstd * weight
    if update:
        update_running_plain(running, mean, var, _rows(y), momentum)
    return torch.stack([mean, rstd, inv, bias - mean * inv, keep])


def _affine(y: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """y * inv + shift in y's dtype, as ops/conv.py: bn_affine applies it."""
    return y * stats[INV].to(y.dtype)[:, None, None] + \
        stats[SHIFT].to(y.dtype)[:, None, None]


def affine_act_plain(y: torch.Tensor, stats: torch.Tensor,
                     act: str) -> torch.Tensor:
    """The forward's pointwise pass: z in y's dtype, channels_last."""
    a = _affine(y, stats)
    z = F.silu(a) if act == "silu" else a
    return z.contiguous(memory_format=torch.channels_last)


def _grad_terms(g: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
                act: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(gA, xhat) in f32: g times act' at the forward's a, and the
    normalized y."""
    gf = g.float()
    if act == "silu":
        a = _affine(y, stats).float()
        s = 1.0 / (1.0 + torch.exp(-a))
        gf = gf * s * (1.0 + a * (1.0 - s))
    xhat = (y.float() - stats[MEAN][:, None, None]) * \
        stats[RSTD][:, None, None]
    return gf, xhat


def grad_sums_plain(g: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
                    act: str) -> torch.Tensor:
    """The backward's reduction: [GRAD_ROWS, C] float32."""
    ga, xhat = _grad_terms(g, y, stats, act)
    s0 = ga.sum(dim=(0, 2, 3))
    s1 = (ga * xhat).sum(dim=(0, 2, 3))
    n = _rows(y)
    return torch.stack([s0, s1, s0 / n,
                        torch.where(stats[KEEP] != 0, s1 / n, 0.0)])


def grad_input_plain(g: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
                     grads: torch.Tensor, act: str) -> torch.Tensor:
    """The backward's pointwise pass: dx in y's dtype, channels_last."""
    ga, xhat = _grad_terms(g, y, stats, act)
    dx = stats[INV][:, None, None] * (
        ga - grads[GMEAN][:, None, None]
        - xhat * grads[GXMEAN][:, None, None])
    return dx.to(y.dtype).contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def forward(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            act: str, running: Sequence[Running], update: bool, eps: float,
            momentum: float) -> tuple[torch.Tensor, torch.Tensor]:
    """y (B, C, H, W) pre-BN, channels_last; weight, bias (C,) float32;
    running: the statistics of the module(s) whose channels y holds, in
    order -> (z in y's dtype, channels_last; the statistics [STAT_ROWS, C]
    float32), the running statistics updated in place if `update`."""
    global launches
    _check_forward(y, weight, bias, act, running)
    if y.device.type == "cpu":
        stats = moments_plain(y, weight, bias, running, update, eps,
                              momentum)
        return affine_act_plain(y, stats, act), stats
    common.check_cuda(y)
    c, rows = y.shape[1], _rows(y)
    stats = torch.empty(STAT_ROWS, c, dtype=torch.float32, device=y.device)
    z = torch.empty_like(y, memory_format=torch.channels_last)
    part, tickets = _workspace(y)
    (rm0, rv0, nbt0), *second = running
    rm1, rv1, nbt1 = (t.data_ptr() for t in second[0]) if second \
        else (None, None, None)
    _call("yolo_bn_forward", y.data_ptr(), weight.data_ptr(),
          bias.data_ptr(), stats.data_ptr(), part.data_ptr(), part.numel(),
          tickets.data_ptr(), tickets.numel(), rm0.data_ptr(),
          rv0.data_ptr(), nbt0.data_ptr(), rm1, rv1, nbt1, rm0.numel(), rows,
          c, eps, momentum, 1.0 - momentum, rows / max(rows - 1, 1),
          int(update), z.data_ptr(), ACTIVATIONS[act], common.dtype_code(y),
          common.stream(y))
    launches += (1 if y.dtype == torch.bfloat16 else 2) + 1
    return z, stats


def backward(g: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
             act: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The upstream gradient g (y's shape and dtype; channels_last, or a
    channel slice of a wider channels_last tensor), y and its statistics
    -> (dx in y's dtype, channels_last; dweight, dbias float32)."""
    global bwd_launches
    ldg = _check_backward(g, y, stats, act)
    if y.device.type == "cpu":
        grads = grad_sums_plain(g, y, stats, act)
        dx = grad_input_plain(g, y, stats, grads, act)
        return dx, grads[DWEIGHT], grads[DBIAS]
    common.check_cuda(y)
    grads = torch.empty(GRAD_ROWS, y.shape[1], dtype=torch.float32,
                        device=y.device)
    dx = torch.empty_like(y, memory_format=torch.channels_last)
    part, tickets = _workspace(y)
    _call("yolo_bn_backward", g.data_ptr(), y.data_ptr(), stats.data_ptr(),
          grads.data_ptr(), part.data_ptr(), part.numel(), tickets.data_ptr(),
          tickets.numel(), dx.data_ptr(), _rows(y), y.shape[1], ldg,
          ACTIVATIONS[act], common.dtype_code(y), common.stream(y))
    bwd_launches += 2
    return dx, grads[DWEIGHT], grads[DBIAS]
