"""The port's loss modules against the JAX package on the same inputs, made
from a seed with numpy: ``ops.iou.bbox_iou`` (CIoU / GIoU / DIoU, values and
gradients), ``loss.tal.assign`` (with and without topk2, and with exact
ties), ``detection_loss`` and the End2End pair (loss items and the
gradients with respect to the head maps), and the attention backward
against ``_pallas_attn_bwd``. All float32 on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.kernels.attention import _pallas_attn_bwd
from yolosharp_tpu.loss.losses import detection_loss as jax_detection_loss
from yolosharp_tpu.loss.losses import e2e_wrap as jax_e2e_wrap
from yolosharp_tpu.loss.tal import assign as jax_assign
from yolosharp_tpu.ops.anchors import make_anchors as jax_make_anchors
from yolosharp_tpu.ops.iou import bbox_iou as jax_bbox_iou
from yolosharp_tpu_torch.kernels import attention_bihd, attention_grads_plain
from yolosharp_tpu_torch.loss import (assign, detection_loss,
                                      e2e_gain_schedule, e2e_wrap)
from yolosharp_tpu_torch.loss.tal import topk_mask
from yolosharp_tpu_torch.ops import bbox_iou

NC = 5


def _boxes(rng, n, xywh):
    """n random boxes, xywh or xyxy, in a 64-pixel frame."""
    c = rng.uniform(8, 56, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    if xywh:
        return np.concatenate([c, wh], -1).astype(np.float32)
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["IoU", "GIoU", "DIoU", "CIoU"])
@pytest.mark.parametrize("xywh", [True, False])
def test_bbox_iou_matches_jax(kind, xywh):
    """Values to 1e-6 and the gradients of their sum to 1e-6 + 1e-5|ref|
    (float32 rounding in another order)."""
    rng = np.random.default_rng(3)
    b1, b2 = _boxes(rng, 64, xywh), _boxes(rng, 64, xywh)
    b2[:8] = b1[:8]           # identical boxes: IoU 1, CIoU's v = 0
    b2[8:16, :2] += 200       # disjoint boxes: no intersection
    kw = {kind: True} if kind != "IoU" else {}

    def jax_sum(a, b):
        return jax_bbox_iou(a, b, xywh=xywh, **kw).sum()

    want = np.asarray(jax_bbox_iou(jnp.asarray(b1), jnp.asarray(b2),
                                   xywh=xywh, **kw))
    want_g1, want_g2 = jax.grad(jax_sum, (0, 1))(jnp.asarray(b1),
                                                 jnp.asarray(b2))
    t1, t2 = (torch.from_numpy(b).requires_grad_() for b in (b1, b2))
    got = bbox_iou(t1, t2, xywh=xywh, **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6,
                               rtol=1e-6)
    for g, w in ((t1.grad, want_g1), (t2.grad, want_g2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)


def test_topk_mask_breaks_ties_by_smallest_index():
    m = torch.tensor([[0.0, 0.5, 0.5, 0.5, 0.1, 0.5, 0.0]])
    assert topk_mask(m, 3).tolist() == [[0, 1, 1, 1, 0, 0, 0]]
    assert topk_mask(m, 6).tolist() == [[1, 1, 1, 1, 1, 1, 0]]


FEATS = ((8, 8), (4, 4), (2, 2))      # a 64x64 image


def _assign_inputs(seed, ties):
    """A padded batch of 3 images, 6 gt slots (4, 2 and 0 valid)."""
    rng = np.random.default_rng(seed)
    anc, strides = (np.asarray(t) for t in jax_make_anchors(FEATS,
                                                            (8, 16, 32)))
    anc_px = (anc * strides).astype(np.float32)
    b, a, m = 3, anc.shape[0], 6
    if ties:
        # one score and one box for every anchor: the align metrics inside
        # a gt tie exactly and the top-k must take the smallest indices
        scores = np.full((b, a, NC), 0.5, np.float32)
        pd = np.tile(np.array([16, 16, 48, 48], np.float32), (b, a, 1))
    else:
        scores = rng.uniform(0.01, 0.99, (b, a, NC)).astype(np.float32)
        pd = np.concatenate([anc_px - rng.uniform(2, 20, (b, a, 2)),
                             anc_px + rng.uniform(2, 20, (b, a, 2))],
                            -1).astype(np.float32)
    gt = np.stack([_boxes(rng, m, False) for _ in range(b)])
    gt[0, 0] = [30, 30, 34, 33]         # smaller than the min stride
    labels = rng.integers(0, NC, (b, m)).astype(np.int32)
    mask = np.zeros((b, m), bool)
    mask[0, :4] = True
    mask[1, :2] = True
    gt[~mask] = 0
    return scores, pd, anc_px, labels, gt, mask


@pytest.mark.parametrize("topk2", [None, 3])
@pytest.mark.parametrize("ties", [False, True])
def test_assign_matches_jax(topk2, ties):
    """fg_mask, target_labels and target_gt_idx on the foreground exact,
    target_bboxes and target_scores to 1e-6."""
    inputs = _assign_inputs(7, ties)
    want = jax_assign(*map(jnp.asarray, inputs), topk=10, topk2=topk2,
                      num_classes=NC)
    got = assign(*map(torch.from_numpy, inputs), topk=10, topk2=topk2,
                 num_classes=NC)
    fg = np.asarray(want.fg_mask)
    assert fg.sum() > 5
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.target_labels.numpy(),
                                  np.asarray(want.target_labels))
    np.testing.assert_array_equal(got.target_gt_idx.numpy()[fg],
                                  np.asarray(want.target_gt_idx)[fg])
    for g, w in ((got.target_bboxes, want.target_bboxes),
                 (got.target_scores, want.target_scores)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def _head_maps(rng, b, nc, scale=1.0):
    """NHWC (box, cls) maps of the three levels of a 64x64 image."""
    box = [(rng.standard_normal((b, h, w, 64)) * scale).astype(np.float32)
           for h, w in FEATS]
    cls = [(rng.standard_normal((b, h, w, nc)) - 2).astype(np.float32)
           for h, w in FEATS]
    return box, cls


def _batch(rng, b=2, m=8):
    xywh = np.stack([_boxes(rng, m, True) / 64 for _ in range(b)])
    mask = np.zeros((b, m), bool)
    mask[0, :5] = True
    mask[1, :3] = True
    xywh[~mask] = 0
    return {"cls": rng.integers(0, NC, (b, m)).astype(np.int32),
            "bboxes": xywh.astype(np.float32), "mask_gt": mask}


def _torch_maps(maps):
    """NHWC leaves (for the gradients) and their NCHW views."""
    leaves = [torch.from_numpy(m).requires_grad_() for m in maps]
    return leaves, tuple(t.permute(0, 3, 1, 2) for t in leaves)


@pytest.mark.parametrize("end2end", [False, True])
def test_detection_loss_matches_jax(end2end):
    """Loss items to 1e-5 relative, gradients with respect to every head
    map to 1e-6 + 1e-4|ref|; End2End sums one2many (top-k 10) and one2one
    (top-k 1) at gains 1.0 (the detect task's _loss_kwargs)."""
    rng = np.random.default_rng(11)
    branches = ["one2many", "one2one"] if end2end else ["one2many"]
    maps = {br: _head_maps(rng, 2, NC) for br in branches}
    batch = _batch(rng)
    flat = [m for br in branches for m in maps[br][0] + maps[br][1]]

    def jax_preds(arrs):
        out, i = {}, 0
        for br in branches:
            out[br] = {"box": tuple(arrs[i:i + 3]),
                       "cls": tuple(arrs[i + 3:i + 6])}
            i += 6
        return out

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if end2end:
        jfn = jax_e2e_wrap(
            functools.partial(jax_detection_loss, nc=NC, tal_topk=10),
            functools.partial(jax_detection_loss, nc=NC, tal_topk=1))
        fn = e2e_wrap(functools.partial(detection_loss, nc=NC, tal_topk=10),
                      functools.partial(detection_loss, nc=NC, tal_topk=1))
    else:
        def jfn(p, b):
            return jax_detection_loss(p["one2many"], b, nc=NC)

        def fn(p, b):
            return detection_loss(p["one2many"], b, nc=NC)

    (want_loss, want_items), want_grads = jax.value_and_grad(
        lambda arrs: jfn(jax_preds(arrs), jb), has_aux=True)(
            [jnp.asarray(m) for m in flat])

    leaves, views = _torch_maps(flat)
    preds, i = {}, 0
    for br in branches:
        preds[br] = {"box": views[i:i + 3], "cls": views[i + 3:i + 6]}
        i += 6
    loss, items = fn(preds, {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    loss.backward()
    assert float(want_items[0]) > 0
    np.testing.assert_allclose(items.detach().numpy(),
                               np.asarray(want_items), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-4)


def test_e2e_gain_schedule_matches_jax():
    from yolosharp_tpu.loss.losses import e2e_gain_schedule as jax_sched

    for epochs in (1, 2, 10):
        for epoch in range(epochs + 1):
            assert e2e_gain_schedule(epoch, epochs) == jax_sched(epoch,
                                                                 epochs)


@pytest.mark.parametrize("b,n,h,d", [(2, 35, 2, 32), (3, 64, 4, 16)])
def test_attention_backward_matches_jax(b, n, h, d):
    """attention_grads_plain (the backward the card runs under the kernel's
    forward) and CPU autograd through the plain version, both against
    _pallas_attn_bwd called directly, float32, to 1e-5."""
    rng = np.random.default_rng(n + d)
    qkv = rng.standard_normal((b, n, h, 3 * d)).astype(np.float32)
    g = rng.standard_normal((b, n, h, d)).astype(np.float32)
    scale = d ** -0.5
    q, k, v = np.split(qkv, 3, axis=-1)
    want = _pallas_attn_bwd(scale, tuple(map(jnp.asarray, (q, k, v))),
                            jnp.asarray(g))
    tq, tk, tv = torch.from_numpy(qkv).split(d, dim=-1)
    got = attention_grads_plain(tq, tk, tv, torch.from_numpy(g), scale)
    t = torch.from_numpy(qkv).requires_grad_()
    attention_bihd(*t.split(d, dim=-1), scale).backward(torch.from_numpy(g))
    auto = t.grad.split(d, dim=-1)
    for gg, aa, w in zip(got, auto, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(aa.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
