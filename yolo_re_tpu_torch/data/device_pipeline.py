"""On-device batched preprocessing and train-time augmentation
(counterpart of yolo_re_tpu/data/device_pipeline.py).

The bilinear resize is two products against static interpolation-weight
matrices (cv2 INTER_LINEAR half-pixel semantics, border replicate), as in
the JAX package, and the letterbox keeps its gain and rounding, so boxes
map back to the original frame identically.

The augmentations (HSV jitter, flips, the 4-image mosaic with its
random_perspective warp, mixup, GT compaction) keep the JAX functions'
names and arithmetic, but not their random streams: `jax.random` cannot be
matched, so each is split in two. `draw_augment` draws every random
quantity of one batch from an explicit numpy generator (the Trainer seeds
it with (seed + 1, step), so the draws depend on the step alone, as the
JAX Trainer's `fold_in(key(seed + 1), step)` does), and the functions
below apply those draws, handed over as tensors on the images' device.
The products, gathers and 3x3 inverses are PyTorch ops, as they are XLA
ops in the JAX package (no Pallas kernel computes them). Layout NHWC, as
there: the Trainer augments before its permute to NCHW.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_PAD = 114.0 / 255.0


@lru_cache(maxsize=128)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) interpolation weights, cv2 INTER_LINEAR semantics:
    half-pixel centers `src = (dst + 0.5) * in/out - 0.5`, border replicate."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(src).astype(np.int64)
    frac = (src - x0).astype(np.float32)
    lo = np.clip(x0, 0, in_size - 1)
    hi = np.clip(x0 + 1, 0, in_size - 1)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - frac)
    np.add.at(m, (rows, hi), frac)
    return m


def resize_bilinear(img: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Batched bilinear resize (B, H, W, C) float -> (B, out_h, out_w, C):
    one product over rows, one over columns."""
    _, h, w, _ = img.shape
    x = img
    if h != out_h:
        rh = torch.from_numpy(_resize_matrix(h, out_h)).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", rh, x)
    if w != out_w:
        rw = torch.from_numpy(_resize_matrix(w, out_w)).to(x.device, x.dtype)
        x = torch.einsum("pw,bhwc->bhpc", rw, x)
    return x


def batched_letterbox(images: torch.Tensor, new_shape: int | tuple[int, int],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Letterbox a uniform-size batch on its device.

    images: (B, H, W, 3) uint8 (or float already in [0, 1]).
    Returns (B, S_h, S_w, 3) in [0, 1], aspect-preserving resize with
    114-grey padding — the gain and rounding of the host `letterbox`
    (yolo_re_tpu/data/augment.py:41-82). Order: f32 -> /255 -> resize ->
    pad -> clip -> cast.
    """
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    _, h, w, _ = images.shape
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0

    r = min(new_shape[0] / h, new_shape[1] / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (new_shape[1] - new_w) / 2, (new_shape[0] - new_h) / 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))

    x = resize_bilinear(x, new_h, new_w)
    x = torch.nn.functional.pad(x, (0, 0, left, right, top, bottom),
                                value=_PAD)
    return x.clamp(0.0, 1.0).to(dtype)


# ---------------------------------------------------------------------------
# the random draws
# ---------------------------------------------------------------------------

# device augmentation's hyperparameters -> the AugmentConfig fields they
# come from: augment_batch's, and augment_batch_full's (the JAX Trainer's
# mapping, yolo_re_tpu/train/trainer.py:119-139)
BATCH_FIELDS = {k: k for k in ("hsv_h", "hsv_s", "hsv_v", "flip_lr",
                               "flip_ud")}
FULL_FIELDS = {**BATCH_FIELDS, "scale": "scale", "translate": "translate",
               "degrees": "degrees", "shear": "shear",
               "perspective": "perspective", "mosaic_p": "mosaic",
               "mixup_p": "mixup"}
# the ones that only set the draws' ranges: `draw_augment` takes them, the
# functions that apply the draws do not
DRAW_ONLY = ("scale", "translate")

def draw_augment(rng: np.random.Generator, batch: int, size: int, *,
                 scale: float = 0.9, translate: float = 0.1,
                 degrees: float = 0.0, shear: float = 0.0,
                 perspective: float = 0.0, mosaic_p: float = 1.0,
                 mixup_p: float = 0.15, hsv_h: float = 0.015,
                 hsv_s: float = 0.7, hsv_v: float = 0.4,
                 flip_lr: float = 0.5, flip_ud: float = 0.0
                 ) -> dict[str, np.ndarray]:
    """Every random quantity of one batch's augmentation (`augment_batch`
    reads "hsv", "flip_lr" and "flip_ud"; `augment_batch_full` all), drawn
    from `rng` in this fixed order and with the JAX package's
    distributions (yolo_re_tpu/data/device_pipeline.py):

    partner (B, 3) int64   mosaic partners in [0, B)
    zoom (B,)              U(max(1 - scale, 0.1), 1 + scale)
    shift (B, 2)           [y, x] U(0.5 - translate, 0.5 + translate) * size
    angle (B,)             degrees, U(-degrees, degrees)
    shear (B, 2)           [x, y] degrees, U(-shear, shear)
    persp (B, 2)           [x, y] U(-perspective, perspective)
    mosaic (B,) bool       U(0, 1) < mosaic_p
    mixup_r (B,)           Beta(32, 32)
    mixup (B,) bool        U(0, 1) < mixup_p
    hsv (B, 3)             [h, s, v] gains U(-1, 1) * (hsv_h, hsv_s, hsv_v) + 1
    flip_lr, flip_ud (B,)  bool, U(0, 1) < flip_lr / flip_ud

    Floats are f32. Every key is drawn whatever the hyperparameters, so
    the stream's layout does not depend on them.
    """
    f32 = np.float32
    b = batch

    def uniform(lo: float, hi: float, shape) -> np.ndarray:
        return rng.uniform(lo, hi, shape).astype(f32)

    return {
        "partner": rng.integers(0, b, (b, 3)),
        "zoom": uniform(max(1.0 - scale, 0.1), 1.0 + scale, (b,)),
        "shift": uniform(0.5 - translate, 0.5 + translate, (b, 2)) * f32(size),
        "angle": uniform(-degrees, degrees, (b,)),
        "shear": uniform(-shear, shear, (b, 2)),
        "persp": uniform(-perspective, perspective, (b, 2)),
        "mosaic": rng.random(b) < mosaic_p,
        "mixup_r": rng.beta(32.0, 32.0, b).astype(f32),
        "mixup": rng.random(b) < mixup_p,
        "hsv": uniform(-1.0, 1.0, (b, 3))
        * np.array([hsv_h, hsv_s, hsv_v], f32) + f32(1.0),
        "flip_lr": rng.random(b) < flip_lr,
        "flip_ud": rng.random(b) < flip_ud,
    }


def draws_to(draws: dict[str, np.ndarray],
             device: torch.device) -> dict[str, torch.Tensor]:
    """`draw_augment`'s arrays as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in draws.items()}


# ---------------------------------------------------------------------------
# color / flip augmentation
# ---------------------------------------------------------------------------

def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(-1)
    minc = img.amin(-1)
    delta = maxc - minc
    safe = torch.where(delta == 0, 1.0, delta)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    # floor-mod, as jnp's % on floats (C's fmod is not)
    h = torch.where(delta == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    s = torch.where(maxc == 0, 0.0, delta / torch.where(maxc == 0, 1.0, maxc))
    return torch.stack([h, s, maxc], -1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    i = torch.remainder(i.to(torch.int32), 6)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def select(*by_sector: torch.Tensor) -> torch.Tensor:
        """jnp.select over sectors 0-4, the last value for sector 5."""
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, by_sector[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], -1)


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Per-sample multiplicative HSV jitter on float RGB in [0, 1]
    (B, H, W, 3): hue scaled then wrapped, saturation and value scaled then
    clipped, computed in f32 and cast back. gains (B, 3): `draw_augment`'s
    "hsv"."""
    r = gains.to(torch.float32)[:, None, None, :]
    hsv = _rgb_to_hsv(img.to(torch.float32))
    h = torch.remainder(hsv[..., 0] * r[..., 0], 1.0)
    s = (hsv[..., 1] * r[..., 1]).clamp(0.0, 1.0)
    v = (hsv[..., 2] * r[..., 2]).clamp(0.0, 1.0)
    out = _hsv_to_rgb(torch.stack([h, s, v], -1))
    return out.clamp(0.0, 1.0).to(img.dtype)


def random_flip(img: torch.Tensor, targets: torch.Tensor,
                do_lr: torch.Tensor, do_ud: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample horizontal / vertical flips (bool masks (B,)) with label
    updates. img (B, H, W, 3); targets (B, M, 5) [cls, x, y, w, h]
    normalized, zero-padded rows (w == h == 0) left untouched."""
    img = torch.where(do_lr[:, None, None, None], img.flip(2), img)
    img = torch.where(do_ud[:, None, None, None], img.flip(1), img)
    valid = (targets[..., 3] > 0) & (targets[..., 4] > 0)
    x = torch.where(valid & do_lr[:, None], 1.0 - targets[..., 1],
                    targets[..., 1])
    y = torch.where(valid & do_ud[:, None], 1.0 - targets[..., 2],
                    targets[..., 2])
    targets = torch.cat([targets[..., :1], x[..., None], y[..., None],
                         targets[..., 3:]], -1)
    return img, targets


# ---------------------------------------------------------------------------
# mosaic + random_perspective warp
# ---------------------------------------------------------------------------

def _affine_weights(srcf: torch.Tensor, src_size: int) -> torch.Tensor:
    """(B, out) fractional source coords -> (B, out, src) bilinear weights
    (a hat function: rows sampling outside [0, src - 1] sum to < 1, the
    rest is fill, applied by the caller)."""
    j = torch.arange(src_size, dtype=torch.float32, device=srcf.device)
    return (1.0 - (srcf[..., None] - j).abs()).clamp(0.0, 1.0)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 products as elementwise products summed in one fixed
    order (no library GEMM, whose order differs between devices)."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, 3, 3) matrices by their adjugate, in f64 elementwise
    operations rounded once to f32."""
    m = m.to(torch.float64)
    a, b, c = m[:, 0].unbind(-1)
    d, e, f = m[:, 1].unbind(-1)
    g, h, i = m[:, 2].unbind(-1)
    cof = [e * i - f * h, f * g - d * i, d * h - e * g,
           c * h - b * i, a * i - c * g, b * g - a * h,
           b * f - c * e, c * d - a * f, a * e - b * d]
    det = a * cof[0] + b * cof[1] + c * cof[2]
    adj = torch.stack([torch.stack(cof[k::3], -1) for k in range(3)], -2)
    return (adj / det[:, None, None]).to(torch.float32)


def _compose_warp_matrices(zoom: torch.Tensor, shift: torch.Tensor,
                           canvas_size: int, angle: torch.Tensor,
                           shear: torch.Tensor,
                           persp: torch.Tensor) -> torch.Tensor:
    """Per-sample forward 3x3 warp matrices M = T @ S @ R @ P @ C, the host
    `random_perspective` composition (data/augment.py): center at
    canvas/2, perspective, rotation + scale (cv2.getRotationMatrix2D's
    convention), shear, translate. zoom (B,), shift (B, 2) [y, x] output
    pixels, angle (B,) degrees, shear (B, 2) [x, y] degrees, persp (B, 2)
    [x, y]. Returns (B, 3, 3) f32, canvas pixels -> output pixels.

    The general warp's sample coordinates reach 2S, where one f32 ulp of a
    matrix entry moves a sample by ~1e-4 px, so M and its inverse are
    computed the same way on every device: the trigonometry in f64 (the
    libraries round differently in f32), rounded once to f32, and the
    products by `_mm3`."""
    zero = torch.zeros_like(zoom)
    one = torch.ones_like(zoom)

    def f64(fn, deg: torch.Tensor) -> torch.Tensor:
        return fn(torch.deg2rad(deg.to(torch.float64))).to(torch.float32)

    shx, shy = f64(torch.tan, shear[:, 0]), f64(torch.tan, shear[:, 1])

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    half = canvas_size / 2.0
    C = mat([[one, zero, -half * one], [zero, one, -half * one],
             [zero, zero, one]])
    P = mat([[one, zero, zero], [zero, one, zero],
             [persp[:, 0], persp[:, 1], one]])
    ca, sa = f64(torch.cos, angle) * zoom, f64(torch.sin, angle) * zoom
    R = mat([[ca, sa, zero], [-sa, ca, zero], [zero, zero, one]])
    S = mat([[one, shx, zero], [shy, one, zero], [zero, zero, one]])
    T = mat([[one, zero, shift[:, 1]], [zero, one, shift[:, 0]],
             [zero, zero, one]])
    return _mm3(T, _mm3(S, _mm3(R, _mm3(P, C))))


def warp_perspective(canvas: torch.Tensor, M: torch.Tensor, out_size: int,
                     *, pad: float = _PAD,
                     use_perspective: bool = False) -> torch.Tensor:
    """Batched inverse-mapped bilinear warp with constant border fill:
    canvas (B, Hc, Wc, C), M (B, 3, 3) forward matrices (canvas pixels ->
    output pixels; cv2.warpAffine / warpPerspective with borderValue 114).
    Four gathers of the f32 canvas; indices clipped, out-of-bounds taps
    read `pad`; the perspective divisor is held at least 1e-8. The
    inverse is `_inv3`'s, the same bits on every device."""
    b, hc, wc, c = canvas.shape
    minv = _inv3(M)
    o = torch.arange(out_size, dtype=torch.float32, device=canvas.device)
    gx, gy = o[None, :], o[:, None]

    def comp(row: int) -> torch.Tensor:
        return (minv[:, row, 0, None, None] * gx
                + minv[:, row, 1, None, None] * gy
                + minv[:, row, 2, None, None])

    sx, sy = comp(0), comp(1)
    if use_perspective:
        w = comp(2)
        w = torch.where(w.abs() < 1e-8, 1e-8, w)
        sx, sy = sx / w, sy / w
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = canvas.to(torch.float32).reshape(b, hc * wc, c)

    def tap(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        inb = (yi >= 0) & (yi < hc) & (xi >= 0) & (xi < wc)
        idx = yi.clamp(0, hc - 1) * wc + xi.clamp(0, wc - 1)
        v = flat.gather(1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        v = v.reshape(b, out_size, out_size, c)
        return torch.where(inb[..., None], v, pad)

    out = (tap(y0i, x0i) * ((1 - fy) * (1 - fx))[..., None]
           + tap(y0i, x0i + 1) * ((1 - fy) * fx)[..., None]
           + tap(y0i + 1, x0i) * (fy * (1 - fx))[..., None]
           + tap(y0i + 1, x0i + 1) * (fy * fx)[..., None])
    return out.to(canvas.dtype)


def warp_boxes(M: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
               bw: torch.Tensor, bh: torch.Tensor, out_size: int, *,
               use_perspective: bool
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The axis-aligned box around each box's four warped corners, clipped
    to the output (the host label path, data/augment.py). M (B, 3, 3);
    cx, cy, bw, bh (B, ...) canvas-pixel boxes. Returns x1, y1, x2, y2."""
    hw, hh = bw / 2, bh / 2
    xs = torch.stack([cx - hw, cx + hw, cx - hw, cx + hw], -1)
    ys = torch.stack([cy - hh, cy - hh, cy + hh, cy + hh], -1)
    m = M.reshape(M.shape[0], *(1,) * (xs.ndim - 2), 3, 3)
    xp = m[..., 0:1, 0] * xs + m[..., 0:1, 1] * ys + m[..., 0:1, 2]
    yp = m[..., 1:2, 0] * xs + m[..., 1:2, 1] * ys + m[..., 1:2, 2]
    if use_perspective:
        w = m[..., 2:3, 0] * xs + m[..., 2:3, 1] * ys + m[..., 2:3, 2]
        w = torch.where(w.abs() < 1e-8, 1e-8, w)
        xp, yp = xp / w, yp / w
    return (xp.amin(-1).clamp(0.0, out_size), yp.amin(-1).clamp(0.0, out_size),
            xp.amax(-1).clamp(0.0, out_size), yp.amax(-1).clamp(0.0, out_size))


def _valid_first(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """rows (B, N, 5) with the valid ones first, in their order: a stable
    sort on an integer key (ties keep the lower index)."""
    order = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)
    return rows.gather(1, order[..., None].expand(-1, -1, rows.shape[-1]))


def mosaic_affine(images: torch.Tensor, targets: torch.Tensor,
                  draws: dict[str, torch.Tensor], *, degrees: float = 0.0,
                  shear: float = 0.0, perspective: float = 0.0,
                  mosaic_p: float = 1.0, max_out: int | None = None,
                  pad: float = _PAD, rows: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-internal 4-image mosaic + random zoom / translate (and, when
    degrees, shear or perspective is nonzero, rotation / shear /
    perspective) on the device.

        canvas = 2x2 grid of [self, 3 batch partners]          (2S x 2S)
        out(y, x) = canvas((y - u_y) / z + S, (x - u_x) / z + S)

    With degrees = shear = perspective = 0 (every preset) the warp is
    axis-aligned and runs as two batched products against per-sample
    interpolation matrices, in the images' dtype (the fill term cast
    before its add); otherwise `warp_perspective` gathers. images
    (B, S, S, C) float in [0, 1]; targets (B, M, 5) [cls, xywh] normalized,
    f32. draws: `draw_augment`'s partner, zoom, shift, angle, shear,
    persp and (mosaic_p < 1) mosaic. Returns (images (B, S, S, C),
    targets (B, max_out, 5)), max_out defaulting to 4M, kept boxes first.
    rows (n,) int64: compute only these rows of the output (n rows come
    back; a data-parallel process's own rows), their partners still taken
    from the whole batch.
    """
    own, own_t = images, targets
    if rows is not None:
        draws = {k: v[rows] for k, v in draws.items()}
        own, own_t = images[rows], targets[rows]
    b, s, _, c = own.shape
    m = targets.shape[1]
    partner, zoom, shift = draws["partner"], draws["zoom"], draws["shift"]
    canvas = images.new_empty(b, 2 * s, 2 * s, c)
    canvas[:, :s, :s] = own
    canvas[:, :s, s:] = images[partner[:, 0]]
    canvas[:, s:, :s] = images[partner[:, 1]]
    canvas[:, s:, s:] = images[partner[:, 2]]

    general = bool(degrees or shear or perspective)
    if general:
        M = _compose_warp_matrices(zoom, shift, 2 * s, draws["angle"],
                                   draws["shear"], draws["persp"])
        out = warp_perspective(canvas, M, s, pad=pad,
                               use_perspective=perspective > 0)
    else:
        dst = torch.arange(s, dtype=torch.float32, device=images.device)
        z = zoom[:, None]
        wy = _affine_weights((dst[None] - shift[:, :1]) / z + s, 2 * s)
        wx = _affine_weights((dst[None] - shift[:, 1:]) / z + s, 2 * s)
        wy, wx = wy.to(images.dtype), wx.to(images.dtype)
        out = torch.einsum("boh,bhwc->bowc", wy, canvas)
        out = out + ((1.0 - wy.sum(-1))[..., None, None]
                     * pad).to(out.dtype)
        out = torch.einsum("bpw,bhwc->bhpc", wx, out)
        out = out + ((1.0 - wx.sum(-1))[:, None, :, None]
                     * pad).to(out.dtype)
        out = out.to(images.dtype)

    # labels: tile offset -> canvas pixels -> warp -> normalized
    tile_t = torch.stack([own_t, targets[partner[:, 0]],
                          targets[partner[:, 1]], targets[partner[:, 2]]],
                         1)                                    # (B, 4, M, 5)
    off = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]],
                       device=targets.device) * s
    cx = tile_t[..., 1] * s + off[None, :, None, 1]
    cy = tile_t[..., 2] * s + off[None, :, None, 0]
    bw = tile_t[..., 3] * s
    bh = tile_t[..., 4] * s
    valid = (tile_t[..., 3] > 0) & (tile_t[..., 4] > 0)
    zq = zoom[:, None, None]
    if general:
        x1, y1, x2, y2 = warp_boxes(M, cx, cy, bw, bh, s,
                                    use_perspective=perspective > 0)
        bw, bh = bw * zq, bh * zq      # box1 * s of the area-ratio filter
    else:
        cx = zq * (cx - s) + shift[:, None, None, 1]
        cy = zq * (cy - s) + shift[:, None, None, 0]
        bw, bh = bw * zq, bh * zq
        x1 = (cx - bw / 2).clamp(0.0, s)
        y1 = (cy - bh / 2).clamp(0.0, s)
        x2 = (cx + bw / 2).clamp(0.0, s)
        y2 = (cy + bh / 2).clamp(0.0, s)
    w2, h2 = x2 - x1, y2 - y1
    # the host's candidate filter; its area threshold relaxes under
    # perspective
    area_thr = 0.01 if perspective else 0.1
    ar = torch.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    keep = valid & (w2 > 2) & (h2 > 2) & (ar < 100) \
        & (w2 * h2 / (bw * bh + 1e-16) > area_thr)

    keep = keep.reshape(b, 4 * m)
    flat = torch.stack([tile_t[..., 0], (x1 + x2) / 2 / s,
                        (y1 + y2) / 2 / s, w2 / s, h2 / s],
                       -1).reshape(b, 4 * m, 5)
    flat = flat * keep[..., None]
    max_out = max_out or 4 * m
    flat = _valid_first(flat, keep)[:, :max_out]

    if mosaic_p < 1.0:
        do = draws["mosaic"]
        plain_t = targets.new_zeros(b, max_out, 5)
        plain_t[:, :min(m, max_out)] = own_t[:, :max_out]
        out = torch.where(do[:, None, None, None], out, own)
        flat = torch.where(do[:, None, None], flat, plain_t)
    return out, flat


def cap_targets(targets: torch.Tensor, cap: int) -> torch.Tensor:
    """Valid GT rows first (stable), capacity capped at `cap`: keeps the
    loss's (B, M, A) assigner tensors bounded after mosaic (x4) and mixup
    (x2) grew M."""
    valid = (targets[..., 3] > 0) & (targets[..., 4] > 0)
    return _valid_first(targets, valid)[:, :cap]


def mixup(images: torch.Tensor, targets: torch.Tensor, r: torch.Tensor,
          do: torch.Tensor,
          partners: tuple[torch.Tensor, torch.Tensor] | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """MixUp with the batch rolled by one, where `do` (B,) holds: an f32
    blend at ratio r (B,) (`draw_augment`'s Beta(32, 32) "mixup_r"), cast
    back. Target capacity doubles; the partner's rows are zero where no
    mix happened. `partners`: each row's partner (images, targets), when
    the rows are a slice of the batch (default: the batch rolled by
    one)."""
    if partners is None:
        partners = (images.roll(1, 0), targets.roll(1, 0))
    partner, partner_t = partners
    r4 = r.to(torch.float32)[:, None, None, None]
    blend = (images.to(torch.float32) * r4
             + partner.to(torch.float32) * (1 - r4))
    images = torch.where(do[:, None, None, None], blend.to(images.dtype),
                         images)
    partner_t = partner_t * do[:, None, None]
    return images, torch.cat([targets, partner_t], 1)


def augment_batch_full(images: torch.Tensor, targets: torch.Tensor,
                       draws: dict[str, torch.Tensor], *,
                       degrees: float = 0.0, shear: float = 0.0,
                       perspective: float = 0.0, mosaic_p: float = 1.0,
                       mixup_p: float = 0.15, hsv_h: float = 0.015,
                       hsv_s: float = 0.7, hsv_v: float = 0.4,
                       flip_lr: float = 0.5, flip_ud: float = 0.0,
                       max_out: int | None = None, rows: slice | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole train-time augmentation on the device (the Trainer's
    device_augment="full"): mosaic + random_perspective warp, mixup, one
    compaction back to the batch's GT capacity (or max_out), then HSV and
    flips. The hyperparameters here only switch stages and paths; the
    draws carry the rest (`draw_augment` takes scale and translate).

    rows: a data-parallel process's slice of the global batch. images,
    targets and draws are then the global batch's (mosaic and mixup
    partners index it), and only these rows of the output are computed
    and returned, equal to the same rows of the whole batch's output
    (mixup blends a row with the mosaic of the row before it, so that
    row's mosaic is computed too)."""
    cap = max_out or targets.shape[1]
    idx = partners = None
    extra = False
    if rows is not None:
        n = images.shape[0]
        idx = torch.arange(rows.start, rows.stop, device=images.device)
        extra = mixup_p > 0 and len(idx) < n
        if extra:
            idx = torch.cat([(idx[:1] - 1) % n, idx])
    if mosaic_p > 0:
        images, targets = mosaic_affine(
            images, targets, draws, degrees=degrees, shear=shear,
            perspective=perspective, mosaic_p=mosaic_p, rows=idx)
    elif idx is not None:
        images, targets = images[idx], targets[idx]
    if idx is not None:
        draws = {k: v[idx] for k, v in draws.items()}
    if extra:
        partners = (images[:-1], targets[:-1])
        images, targets = images[1:], targets[1:]
        draws = {k: v[1:] for k, v in draws.items()}
    if mixup_p > 0:
        images, targets = mixup(images, targets, draws["mixup_r"],
                                draws["mixup"], partners)
    targets = cap_targets(targets, cap)
    return augment_batch(images, targets, draws, hsv_h=hsv_h, hsv_s=hsv_s,
                         hsv_v=hsv_v, flip_lr=flip_lr, flip_ud=flip_ud)


def augment_batch(images: torch.Tensor, targets: torch.Tensor,
                  draws: dict[str, torch.Tensor], *, hsv_h: float = 0.015,
                  hsv_s: float = 0.7, hsv_v: float = 0.4,
                  flip_lr: float = 0.5, flip_ud: float = 0.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """HSV jitter, then flips (the Trainer's device_augment=True; the host
    keeps mosaic and the warp). A stage runs where its hyperparameters are
    nonzero."""
    if hsv_h or hsv_s or hsv_v:
        images = hsv_jitter(images, draws["hsv"])
    if flip_lr or flip_ud:
        images, targets = random_flip(images, targets, draws["flip_lr"],
                                      draws["flip_ud"])
    return images, targets
