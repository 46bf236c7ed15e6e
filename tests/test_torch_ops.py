"""The port's ops and decode (yolosharp_tpu_torch/ops, predict) against the
JAX package's on the same numpy-seeded inputs: box formats, IoU, anchors,
DFL, greedy NMS (keep-set, valid, truncated), the head decodes and the
End2End top-k."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolosharp_tpu.ops import anchors as jax_anchors
from yolosharp_tpu.ops import boxes as jax_boxes
from yolosharp_tpu.ops.iou import box_iou as jax_box_iou
from yolosharp_tpu.ops.nms import non_max_suppression as jax_nms
from yolosharp_tpu import predict as jax_predict
from yolosharp_tpu_torch import predict as port_predict
from yolosharp_tpu_torch.ops import (bbox2dist, box_iou, dfl_decode,
                                     dist2bbox, make_anchors,
                                     non_max_suppression, xywh2xyxy,
                                     xyxy2xywh)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_box_formats_and_iou():
    rng = np.random.default_rng(0)
    xywh = np.concatenate([rng.uniform(0, 100, (2, 7, 2)),
                           rng.uniform(1, 30, (2, 7, 2))], -1).astype(np.float32)
    np.testing.assert_allclose(xywh2xyxy(_t(xywh)).numpy(),
                               np.asarray(jax_boxes.xywh2xyxy(xywh)), **TOL)
    xyxy = np.asarray(jax_boxes.xywh2xyxy(xywh))
    np.testing.assert_allclose(xyxy2xywh(_t(xyxy)).numpy(),
                               np.asarray(jax_boxes.xyxy2xywh(xyxy)), **TOL)
    a, b = xyxy[0], xyxy[1, :5]
    np.testing.assert_allclose(box_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jax_box_iou(a, b)), **TOL)
    # the batched form the NMS uses
    batched = box_iou(_t(xyxy), _t(xyxy)).numpy()
    for i in range(2):
        np.testing.assert_allclose(batched[i],
                                   np.asarray(jax_box_iou(xyxy[i], xyxy[i])),
                                   **TOL)


def test_anchors_dist_and_dfl():
    shapes = [(12, 10), (6, 5), (3, 3)]
    anc, strd = make_anchors(shapes, (8, 16, 32))
    janc, jstrd = jax_anchors.make_anchors(shapes, (8, 16, 32))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(janc))
    np.testing.assert_array_equal(strd.numpy(), np.asarray(jstrd))
    rng = np.random.default_rng(1)
    a = anc.shape[0]
    dist = rng.uniform(0, 8, (2, a, 4)).astype(np.float32)
    for xywh in (True, False):
        np.testing.assert_allclose(
            dist2bbox(_t(dist), anc, xywh=xywh).numpy(),
            np.asarray(jax_anchors.dist2bbox(dist, janc, xywh=xywh)), **TOL)
    box = np.asarray(jax_anchors.dist2bbox(dist, janc, xywh=False))
    np.testing.assert_allclose(
        bbox2dist(anc, _t(box), reg_max=16).numpy(),
        np.asarray(jax_anchors.bbox2dist(janc, box, reg_max=16)), **TOL)
    logits = rng.standard_normal((2, a, 64)).astype(np.float32) * 3
    np.testing.assert_allclose(dfl_decode(_t(logits)).numpy(),
                               np.asarray(jax_anchors.dfl_decode(logits)),
                               **TOL)


def _prediction(b, a, nc, seed, n_clusters=12):
    """(B, 4+nc, A) xywh + scores with boxes clustered so that greedy
    suppression chains form."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 300, (b, n_clusters, 2))
    which = rng.integers(0, n_clusters, (b, a))
    cxy = np.take_along_axis(centers, which[..., None], 1) \
        + rng.normal(0, 6, (b, a, 2))
    wh = rng.uniform(10, 60, (b, a, 2))
    scores = rng.uniform(0, 1, (b, a, nc)) ** 3
    pred = np.concatenate([cxy, wh, scores], -1).astype(np.float32)
    return pred.transpose(0, 2, 1).copy()


def _assert_same_nms(got, want):
    np.testing.assert_array_equal(got.truncated.numpy(),
                                  np.asarray(want.truncated))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for i in range(got.valid.shape[0]):
        v = np.asarray(want.valid[i])
        # equal-score rows may come in another order: compare sorted rows
        rows_g = np.concatenate([got.boxes[i].numpy()[v],
                                 got.scores[i].numpy()[v, None],
                                 got.classes[i].numpy()[v, None]], 1)
        rows_w = np.concatenate([np.asarray(want.boxes[i])[v],
                                 np.asarray(want.scores[i])[v, None],
                                 np.asarray(want.classes[i])[v, None]], 1)
        order = np.lexsort(rows_g.T[::-1])
        order_w = np.lexsort(rows_w.T[::-1])
        # box corners are pixels (float32 ulp ~1.5e-5 at 200 px)
        np.testing.assert_allclose(rows_g[order], rows_w[order_w], atol=1e-4,
                                   rtol=1e-5)
        # padding rows are zero
        assert not got.boxes[i].numpy()[~v].any()
        assert not got.scores[i].numpy()[~v].any()


@pytest.mark.parametrize("b,a,nc,conf,kw", [
    (3, 300, 5, 0.25, {}),
    (2, 300, 5, 0.05, dict(pre_topk=32)),          # truncated pool
    (2, 300, 5, 0.25, dict(agnostic=True)),
    (2, 400, 3, 0.02, dict(max_det=10)),           # more kept than max_det
    (1, 2600, 4, 0.0, {}),                          # JAX's tiled greedy path
])
def test_nms_matches_jax(b, a, nc, conf, kw):
    pred = _prediction(b, a, nc, seed=a + nc)
    want = jax_nms(jnp.asarray(pred), conf, 0.45, nc=nc, **kw)
    got = non_max_suppression(_t(pred), conf, 0.45, nc=nc, **kw)
    if "pre_topk" in kw:
        assert got.truncated.all()
    assert got.valid.any()
    _assert_same_nms(got, want)


def _branch(b, shapes, nc, seed):
    """Random raw head maps: JAX NHWC and port NCHW views of one array."""
    rng = np.random.default_rng(seed)

    def maps(ch, scale):
        return [(rng.standard_normal((b, h, w, ch)) * scale).astype(np.float32)
                for h, w in shapes]

    jb = {"box": maps(64, 1.5), "cls": maps(nc, 1.2)}
    tb = {k: tuple(_t(m).permute(0, 3, 1, 2) for m in v)
          for k, v in jb.items()}
    return jb, tb


@pytest.mark.parametrize("end2end", [False, True])
def test_decode_inference_matches_jax(end2end):
    jb, tb = _branch(2, [(8, 12), (4, 6), (2, 3)], 7, seed=4)
    want = np.asarray(jax_predict.decode_inference(jb, nc=7, end2end=end2end))
    got = port_predict.decode_inference(tb, end2end=end2end)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    if end2end:
        want_e2e = np.asarray(jax_predict.e2e_postprocess(
            jnp.asarray(want).swapaxes(-1, -2), nc=7, max_det=50))
        got_e2e = port_predict.e2e_postprocess(got.transpose(-1, -2), nc=7,
                                               max_det=50)
        np.testing.assert_allclose(got_e2e.numpy(), want_e2e, atol=1e-4,
                                   rtol=1e-5)


def test_decode_inference_topk_matches_jax():
    jb, tb = _branch(3, [(12, 12), (6, 6), (3, 3)], 7, seed=5)
    want, wtrunc = jax_predict.decode_inference_topk(jb, nc=7, conf_thres=0.25,
                                                     k=64)
    got, gtrunc = port_predict.decode_inference_topk(tb, conf_thres=0.25,
                                                     k=64)
    np.testing.assert_array_equal(gtrunc.numpy(), np.asarray(wtrunc))
    assert gtrunc.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    # and through the NMS, as the predict path composes them
    g = non_max_suppression(got, 0.25, 0.45, nc=7)
    w = jax_nms(want, 0.25, 0.45, nc=7)
    _assert_same_nms(g, w)
