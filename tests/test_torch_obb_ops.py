"""The port's rotated-box ops against the JAX package on the same inputs,
made from a seed with numpy, float32 on the CPU: dist2rbox / rbox2dist, the
corner forms (xywhr2xyxyxyxy, clip_obb_corners, sort_obb_corners,
cxcywhr2xyxyxyxy), probiou (with its CIoU branch, and its gradient) and
batch_probiou, and the rotated NMS: fast triangular suppression over
probiou where a suppressed box still suppresses (a case where greedy NMS
keeps more), its row-tiled blocks against one block, and nms_rotated."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.ops import anchors as JA
from yolosharp_tpu.ops import boxes as JB
from yolosharp_tpu.ops import iou as JI
from yolosharp_tpu.ops import nms as JN
from yolosharp_tpu_torch.ops import (batch_probiou, clip_obb_corners,
                                     cxcywhr2xyxyxyxy, dist2rbox,
                                     nms_rotated, non_max_suppression,
                                     probiou, rbox2dist, sort_obb_corners,
                                     xywhr2xyxyxyxy)
from yolosharp_tpu_torch.ops import nms as nms_mod


def _rboxes(rng, n, lo=2.0, hi=60.0, span=200.0):
    """n xywhr boxes: centres in [0, span), sides in [lo, hi), angles in
    [-pi/4, 3pi/4) (the head's range), float32."""
    return np.concatenate([rng.uniform(0, span, (n, 2)),
                           rng.uniform(lo, hi, (n, 2)),
                           rng.uniform(-math.pi / 4, 3 * math.pi / 4,
                                       (n, 1))], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_dist2rbox_and_rbox2dist_match_jax():
    """dist2rbox of ltrb distances and angles around anchors, and its
    inverse with and without the reg_max clamp: to 1e-5 of the JAX
    package's; rbox2dist inverts dist2rbox."""
    rng = np.random.default_rng(0)
    dist = rng.uniform(0, 15, (2, 50, 4)).astype(np.float32)
    ang = rng.uniform(-math.pi / 4, 3 * math.pi / 4, (2, 50, 1)).astype(
        np.float32)
    anc = rng.uniform(0, 8, (50, 2)).astype(np.float32)
    want = np.asarray(JA.dist2rbox(jnp.asarray(dist), jnp.asarray(ang),
                                   jnp.asarray(anc)))
    got = dist2rbox(_t(dist), _t(ang), _t(anc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for reg_max in (None, 15):
        want = np.asarray(JA.rbox2dist(jnp.asarray(got), jnp.asarray(anc),
                                       jnp.asarray(ang), reg_max=reg_max))
        back = rbox2dist(_t(got), _t(anc), _t(ang), reg_max=reg_max).numpy()
        np.testing.assert_allclose(back, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back, np.minimum(dist, 15 - 0.01), atol=1e-4)


def test_corner_forms_match_jax():
    """xywhr2xyxyxyxy (the reference's corner order), clip_obb_corners to a
    (h, w), sort_obb_corners by angle around the centre and the demo's
    cxcywhr2xyxyxyxy: equal to the JAX package's (to 1e-5)."""
    rng = np.random.default_rng(1)
    rb = _rboxes(rng, 40)
    want = np.asarray(JB.xywhr2xyxyxyxy(jnp.asarray(rb)))
    got = xywhr2xyxyxyxy(_t(rb)).numpy()
    assert got.shape == (40, 4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        clip_obb_corners(_t(got), (120, 90)).numpy(),
        np.asarray(JB.clip_obb_corners(jnp.asarray(got), (120, 90))))
    shuffled = got[:, rng.permutation(4)]
    np.testing.assert_array_equal(
        sort_obb_corners(_t(shuffled)).numpy(),
        np.asarray(JB.sort_obb_corners(jnp.asarray(shuffled))))
    for row in rb[:5]:
        np.testing.assert_allclose(cxcywhr2xyxyxyxy(row),
                                   JB.cxcywhr2xyxyxyxy(row), rtol=1e-6)


@pytest.mark.parametrize("ciou", [False, True])
def test_probiou_and_its_gradient_match_jax(ciou):
    """Elementwise probiou of broadcast (A, 1, 5) x (1, B, 5) boxes (equal
    boxes, squares, thin and far apart ones among them), plain and with the
    CIoU term: values to 1e-5 relative, the gradient of their sum with
    respect to both sets to 1e-6 + 1e-4|ref|."""
    rng = np.random.default_rng(2 + ciou)
    a = _rboxes(rng, 12)[:, None]
    b = _rboxes(rng, 9)[None]
    a[0, 0] = b[0, 0]                                   # the same box
    a[1, 0, 2:4] = a[1, 0, 3]                           # a square
    b[0, 1, 2:4] = [80.0, 2.0]                          # a thin box

    def jfn(x, y):
        v = JI.probiou(x, y, CIoU=ciou)
        return v.sum(), v

    (_, want), (gx, gy) = jax.value_and_grad(jfn, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = probiou(ta, tb, CIoU=ciou)
    got.sum().backward()
    assert got.shape == (12, 9, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert got[0, 0, 0] > 0.99
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gx), atol=1e-6,
                               rtol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gy), atol=1e-6,
                               rtol=1e-4)


def test_batch_probiou_matches_jax():
    """Pairwise (N, 5) x (M, 5) -> (N, M) equal to the JAX package's (to
    1e-5), and the port's batched (B, N, 5) x (B, M, 5) form equal to it
    image by image."""
    rng = np.random.default_rng(4)
    x, y = _rboxes(rng, 3 * 17).reshape(3, 17, 5), _rboxes(rng, 3 * 11)
    y = y.reshape(3, 11, 5)
    batched = batch_probiou(_t(x), _t(y)).numpy()
    assert batched.shape == (3, 17, 11)
    for i in range(3):
        want = np.asarray(JI.batch_probiou(jnp.asarray(x[i]),
                                           jnp.asarray(y[i])))
        np.testing.assert_allclose(
            batch_probiou(_t(x[i]), _t(y[i])).numpy(), want, rtol=1e-5,
            atol=1e-6)
        np.testing.assert_allclose(batched[i], want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ NMS
def _chain_prediction():
    """One image, one class, three boxes in a row (scores 0.9, 0.8, 0.7):
    box 0 overlaps box 1, box 1 overlaps box 2, box 0 and box 2 do not.
    Greedy NMS keeps 0 and 2 (1 is suppressed and cannot suppress 2); the
    fast NMS keeps only 0."""
    boxes = np.array([[50, 50, 40, 20, 0.1], [64, 50, 40, 20, 0.1],
                      [78, 50, 40, 20, 0.1]], np.float32)
    nc = 2
    pred = np.zeros((1, 4 + nc + 1, 3), np.float32)
    pred[0, :4] = boxes[:, :4].T
    pred[0, 4] = [0.9, 0.8, 0.7]
    pred[0, 4 + nc] = boxes[:, 4]
    return pred, boxes, nc


def test_rotated_nms_is_fast_nms_as_jax():
    """On a suppression chain the rotated NMS keeps what the JAX package's
    keeps (the fast NMS: box 0 only), not what greedy NMS would (0 and
    2); boxes come back xywhr with the angle, also as the last extra."""
    pred, boxes, nc = _chain_prediction()
    iou = np.asarray(JI.batch_probiou(jnp.asarray(boxes),
                                      jnp.asarray(boxes)))
    assert iou[0, 1] > 0.45 and iou[1, 2] > 0.45 and iou[0, 2] < 0.45
    want = JN.non_max_suppression(jnp.asarray(pred), 0.25, 0.45, nc=nc,
                                  rotated=True)
    got = non_max_suppression(_t(pred), 0.25, 0.45, nc=nc, rotated=True)
    assert got.boxes.shape == (1, 300, 5)
    assert int(got.valid.sum()) == int(np.asarray(want.valid).sum()) == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    # the axis-aligned path over the same boxes is greedy: 0 and 2 stay
    pred_aa = pred[:, :4 + nc]
    assert int(non_max_suppression(_t(pred_aa), 0.25, 0.3,
                                   nc=nc).valid.sum()) == 2


def _crowd_prediction(rng, b, a, nc):
    """(B, 4 + nc + 1, A) rotated predictions: clusters of overlapping
    boxes of several classes, half the anchors under conf 0.25."""
    centres = rng.uniform(20, 300, (b, a // 8, 2)).repeat(8, 1)
    xy = centres + rng.normal(0, 6, (b, a, 2))
    wh = rng.uniform(8, 40, (b, a, 2))
    ang = rng.uniform(-math.pi / 4, 3 * math.pi / 4, (b, a, 1))
    scores = rng.uniform(0, 0.5, (b, a, nc)) ** 2 * 4
    return np.concatenate([xy, wh, np.clip(scores, 0, 1), ang],
                          -1).transpose(0, 2, 1).astype(np.float32)


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("pre_topk", [None, 64])
def test_rotated_nms_matches_jax(pre_topk, agnostic):
    """Crowded images of 3 classes (the class offset on the centre only,
    or none when agnostic), every candidate or a truncated pool: boxes,
    scores, classes, extras, validity and truncation equal to the JAX
    package's rotated non_max_suppression (to 1e-6)."""
    rng = np.random.default_rng(5 + agnostic)
    pred = _crowd_prediction(rng, 3, 160, 3)
    want = JN.non_max_suppression(jnp.asarray(pred), 0.25, 0.45, nc=3,
                                  pre_topk=pre_topk, agnostic=agnostic,
                                  rotated=True, max_det=50)
    got = non_max_suppression(_t(pred), 0.25, 0.45, nc=3, pre_topk=pre_topk,
                              agnostic=agnostic, rotated=True, max_det=50)
    assert 3 < int(got.valid.sum(-1).min())
    assert bool(got.truncated.any()) == (pre_topk is not None)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_rotated_nms_row_tiles_match_one_block(monkeypatch):
    """The probiou blocks tiled over images and rows (a block cap of 500
    elements: rows of 2-3 candidates) keep exactly what one block keeps."""
    rng = np.random.default_rng(6)
    pred = _t(_crowd_prediction(rng, 4, 240, 2))
    whole = non_max_suppression(pred, 0.2, 0.45, nc=2, rotated=True)
    monkeypatch.setattr(nms_mod, "_IOU_ELEMS", 500)
    tiled = non_max_suppression(pred, 0.2, 0.45, nc=2, rotated=True)
    assert int(whole.valid.sum()) > 20
    for g, w in zip(tiled, whole):
        assert torch.equal(g, w)


def test_nms_rotated_matches_jax():
    """The standalone keep mask over unsorted boxes, in their own order."""
    rng = np.random.default_rng(7)
    boxes = _rboxes(rng, 60, 10, 50, 120)
    scores = rng.uniform(0, 1, 60).astype(np.float32)
    want = np.asarray(JN.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores),
                                     0.3))
    got = nms_rotated(_t(boxes), _t(scores), 0.3).numpy()
    assert 0 < got.sum() < 60
    np.testing.assert_array_equal(got, want)
