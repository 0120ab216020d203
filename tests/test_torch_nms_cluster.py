"""The NMS kernel's cluster design (csrc/nms.cu), emulated on the CPU.

The CUDA kernel runs only on the card. Here numpy replays its design step
by step: each image's K candidates cut into c contiguous slices (one CTA
each, K not divisible by c), each slice's candidates dealt to the CTA's
threads in turn, the areas computed once, the live candidates reduced
as the kernel reduces its keys (score bits, index): each thread's fold,
each warp's two redux.sync, then in every warp a fold and the redux over
the cluster's warp winners in slot order, the zero-intersection test
without the division, and the whole cluster
stopping at the first winner with a score <= 0. Its indices must equal
`nms_select_plain`'s exactly, and on one case the Pallas kernel's
(interpret mode). The cluster-size rule of the wrapper (`cluster_size`)
is checked on its own. Small shapes only (K <= 700, B <= 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_re_tpu.ops.pallas.nms_kernel import pallas_nms_select
from yolo_re_tpu_torch.ops.kernels import nms
from yolo_re_tpu_torch.ops.nms import MAX_WH

F32 = np.float32
NONE = np.uint32(0xFFFFFFFF)   # no candidate


def _better(s, i, s2, i2):
    """(score desc, index asc), elementwise: the kernel's order of keys."""
    take = (s2 > s) | ((s2 == s) & (i2 < i))
    return np.where(take, s2, s), np.where(take, i2, i)


def _redux(s, i):
    """A warp's two redux.sync over its lanes (the last axis, 32): the
    highest score, then the lowest index among the lanes holding it."""
    m = s.max(-1, keepdims=True)
    return m[..., 0], np.where(s == m, i, NONE).min(-1)


def _warp_winners(live, gidx, threads):
    """Step 1 in each of the c CTAs (the first axis): thread t folds its
    live candidates t, t + threads, ... in that order into a key (score
    bits, index; ties keep the first, the lower index), then each warp's
    redux. -> (c, warps) score bits and indices; score bits 0 = none."""
    c, per = live.shape
    rows = -(-per // threads)
    bits = np.zeros((c, rows * threads), np.uint32)
    idx = np.full((c, rows * threads), NONE, np.uint32)
    alive = live > 0
    bits[:, :per] = np.where(alive, live.view(np.uint32), 0)
    idx[:, :per] = np.where(alive, gidx, NONE)
    s = np.zeros((c, threads), np.uint32)
    i = np.full((c, threads), NONE, np.uint32)
    for row in range(rows):                       # a thread's own order
        cut = slice(row * threads, (row + 1) * threads)
        take = bits[:, cut] > s
        s = np.where(take, bits[:, cut], s)
        i = np.where(take, idx[:, cut], i)
    return _redux(s.reshape(c, -1, 32), i.reshape(c, -1, 32))


def _cluster_winner(ws, wi):
    """Step 3 in one warp: the c * warps winners in slot order (rank,
    warp); lane l folds slots l, l + 32, ..., then the warp's redux. The
    order is total, so the result must be the highest score's lowest
    index, whatever the slots' order."""
    ws, wi = ws.reshape(-1), wi.reshape(-1)
    pad = -len(ws) % 32
    ws = np.concatenate([ws, np.zeros(pad, np.uint32)]).reshape(-1, 32)
    wi = np.concatenate([wi, np.full(pad, NONE, np.uint32)]).reshape(-1, 32)
    s, i = ws[0], wi[0]
    for row in range(1, len(ws)):
        s, i = _better(s, i, ws[row], wi[row])
    win = _redux(s, i)
    assert win[0] == ws.max() and win[1] == wi[ws == ws.max()].min()
    return int(win[0]), int(win[1])


def _suppress(box, area, live, gidx, chosen, cbox, carea, thres):
    """Step 4 for every slice: the plain version's IoU where the
    intersection is not 0, else the shortcut (suppress iff 0 > thres and
    the union is neither 0 nor NaN), and the chosen one; candidates that
    are not live stay as they are."""
    iw = np.fmin(cbox[2], box[..., 2]) - np.fmax(cbox[0], box[..., 0])
    ih = np.fmin(cbox[3], box[..., 3]) - np.fmax(cbox[1], box[..., 1])
    iw = np.where(iw < 0, F32(0), iw)             # NaN stays NaN
    ih = np.where(ih < 0, F32(0), ih)
    inter = iw * ih
    union = (carea + area) - inter
    nonzero = inter != 0
    sup = np.zeros(live.shape, bool)
    sup[nonzero] = inter[nonzero] / union[nonzero] > thres
    if F32(0) > thres:
        u = union[~nonzero]
        sup[~nonzero] = (u == u) & (u != 0)
    sup |= gidx == chosen
    return np.where((live > 0) & sup, F32(0), live)


@np.errstate(divide="ignore", invalid="ignore")   # inf - inf, 0 / 0
def emulate_cluster_nms(boxes, scores, iou_thres, max_det, c,
                        threads=nms.THREADS):
    """(B, K, 4), (B, K) float32 -> (B, max_det) int32, csrc/nms.cu's
    design with c CTAs an image: CTA r's slice is [r * per, (r + 1) * per)
    (per = ceil(K / c); the last slices may be short or empty)."""
    bsz, k = scores.shape
    per = -(-k // c)
    thres = F32(iou_thres)
    gidx = np.arange(c * per).reshape(c, per)
    have = gidx < k
    gidx = np.where(have, gidx, -1)               # no candidate there
    out = np.full((bsz, max_det), -1, np.int32)
    for b in range(bsz):
        box = np.zeros((c * per, 4), F32)
        box[:k] = boxes[b]
        box = box.reshape(c, per, 4)
        area = (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])
        live = np.zeros(c * per, F32)
        live[:k] = scores[b]
        live = live.reshape(c, per)
        for step in range(max_det):
            ws, wi = _cluster_winner(*_warp_winners(live, gidx, threads))
            if ws == 0:
                break                             # the whole cluster stops
            out[b, step] = wi
            # the winner's slot carries its box and its precomputed area
            r, j = divmod(wi, per)
            live = _suppress(box, area, live, gidx, wi, box[r, j],
                             area[r, j], thres)
            assert (live[~have] == 0).all()
    return out


def _clustered(rng, k, nc=3, spread=8.0):
    """k class-offset xyxy boxes around 30 centres (so that suppression
    happens), classes in [0, nc)."""
    centres = rng.uniform(60, 580, (30, 2))
    xy = centres[rng.integers(0, 30, k)] + rng.normal(0, spread, (k, 2))
    wh = rng.uniform(20, 70, (k, 2))
    cls = rng.integers(0, nc, k)
    return (np.concatenate([xy - wh / 2, xy + wh / 2], 1) +
            (cls * MAX_WH)[:, None]).astype(F32)


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _case(name, seed):
    """(boxes (B, K, 4), scores (B, K), iou_thres, max_det)."""
    rng = np.random.default_rng(seed)
    if name == "k1":
        return (_clustered(rng, 1)[None], np.array([[0.7]], F32), 0.45, 300)
    b, k = 3, 700 if name == "bf16_ties" else 517
    boxes = np.stack([_clustered(rng, k) for _ in range(b)])
    scores = rng.uniform(0, 1, (b, k)).astype(F32)
    if name == "bf16_ties":
        # bf16-rounded scores: equal scores are common
        scores = _bf16(np.where(scores > 0.3, scores, 0).astype(F32))
        return boxes, scores, 0.45, 300
    if name == "evaluator_order":
        # the Evaluator's call: candidates sorted by score, descending,
        # those under the threshold zeroed at the tail, at iou 0.6
        scores = np.where(scores > 0.35, scores, 0).astype(F32)
        order = np.argsort(-scores, axis=1, kind="stable")
        return (np.take_along_axis(boxes, order[..., None], 1),
                np.take_along_axis(scores, order, 1), 0.6, 300)
    # degenerate boxes: zero-width and zero-height ones, points, and
    # coincident copies (two zero-area copies give a 0 / 0 NaN IoU)
    kind = rng.integers(0, 5, (b, k))
    boxes[kind == 1, 2] = boxes[kind == 1, 0]
    boxes[kind == 2, 3] = boxes[kind == 2, 1]
    boxes[kind == 3, 2:] = boxes[kind == 3, :2]
    boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]
    # and a few infinite ones, whose area inf - inf is NaN: every union
    # with them is NaN, so their IoU is NaN (never suppresses)
    boxes[:, 3::61, 0::2] = np.inf
    scores = _bf16(scores)
    thres = {"degenerate": 0.45, "negative_thres": -0.25,
             "zero_thres": 0.0}[name]
    return boxes, scores, thres, 120


CASES = ["bf16_ties", "evaluator_order", "degenerate", "negative_thres",
         "zero_thres", "k1"]


@pytest.mark.parametrize("c", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", CASES)
def test_cluster_emulation_matches_plain(name, c):
    boxes, scores, thres, max_det = _case(name, 30 + CASES.index(name))
    want = nms.nms_select_plain(torch.from_numpy(boxes),
                                torch.from_numpy(scores), thres,
                                max_det).numpy()
    got = emulate_cluster_nms(boxes, scores, thres, max_det, c)
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum(1).min() >= 1


@pytest.mark.parametrize("threads", [32, 64, 128])
def test_cluster_emulation_thread_deal(threads):
    """Fewer threads than candidates: each thread folds several in turn,
    and the cluster has 3, 6 or 12 warp winners a step."""
    boxes, scores, thres, max_det = _case("bf16_ties", 30)
    want = nms.nms_select_plain(torch.from_numpy(boxes),
                                torch.from_numpy(scores), thres,
                                max_det).numpy()
    np.testing.assert_array_equal(
        emulate_cluster_nms(boxes, scores, thres, max_det, 3, threads), want)


def test_cluster_emulation_matches_pallas_select():
    """The emulation against the TPU kernel itself (interpret mode on the
    CPU), as test_nms_select_plain_matches_pallas_select runs it."""
    boxes, scores, thres, max_det = _case("bf16_ties", 40)
    ref = pallas_nms_select(jnp.asarray(boxes), jnp.asarray(scores),
                            iou_thres=thres, max_det=max_det)
    got = emulate_cluster_nms(boxes, scores, thres, max_det, 3)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (got >= 0).sum() > 100


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_cluster_size_rule(sms):
    """c is one of 1, 2, 4, 8 (the grid b * c is whole clusters); the
    SMs hold b * c CTAs at once (two an SM where two slices fit its
    shared memory, else one) unless the slice needs c to fit; each slice
    fits its CTA's shared memory; gelan-c's calls on an H100 take c = 8 at
    K = 8400, batch 32, and c = 2 at K = 512."""
    one_cta = nms.SLICE_BYTES // nms.CANDIDATE_BYTES   # the most at c = 1
    two_ctas = (nms.SM_BYTES // 2 - nms.CTA_EXTRA_BYTES) \
        // nms.CANDIDATE_BYTES                         # two an SM
    for b in (1, 2, 3, 16, 32, 33, 64, 66, 67, 131, 132, 133, 264, 265,
              500):
        for k in (1, 2, 100, 255, 256, 511, 512, 1024, 4096, 8400, two_ctas,
                  two_ctas + 1, one_cta, one_cta + 1, nms.MAX_K):
            c = nms.cluster_size(b, k, sms)
            assert c in nms.CLUSTER_SIZES and (b * c) % c == 0
            per = -(-k // c)
            assert per * nms.CANDIDATE_BYTES <= nms.SLICE_BYTES, (b, k, c)
            fits = min(x for x in nms.CLUSTER_SIZES
                       if -(-k // x) * nms.CANDIDATE_BYTES
                       <= nms.SLICE_BYTES)
            held = sms * (2 if 2 * (per * nms.CANDIDATE_BYTES +
                                    nms.CTA_EXTRA_BYTES) <= nms.SM_BYTES
                          else 1)
            assert b * c <= held or c == fits, (b, k, sms, c)
            assert c == fits or per >= nms.THREADS, (b, k, sms, c)
            # no larger c would also be held at once and feed every thread
            assert not any(
                x > c and b * x <= sms * nms.ctas_per_sm(k, x)
                and k // x >= nms.THREADS
                for x in nms.CLUSTER_SIZES), (b, k, sms, c)
    assert nms.ctas_per_sm(two_ctas, 1) == 2
    assert nms.ctas_per_sm(two_ctas + 1, 1) == 1
    assert nms.cluster_size(1, 1, sms) == 1
    assert nms.cluster_size(500, one_cta, sms) == 1
    assert nms.cluster_size(500, one_cta + 1, sms) == 2
    assert nms.cluster_size(500, nms.MAX_K, sms) == 2
    assert nms.cluster_size(32, 8400, 132) == 8
    assert nms.cluster_size(64, 8400, 132) == 4
    assert nms.cluster_size(67, 8400, 132) == 2
    assert nms.cluster_size(32, 512, 132) == 2
    assert nms.cluster_size(32, 100, 132) == 1
    assert nms.cluster_size(1, nms.MAX_K, 132) == 8
