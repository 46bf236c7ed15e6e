"""The port's OBB loss modules against the JAX package on the same inputs,
made from a seed with numpy, float32 on the CPU: the rotated task-aligned
assigner (point-in-rotated-rectangle candidates, probiou metrics, with and
without topk2) and obb_loss (loss items and the gradients with respect to
every head map, the angle maps included), with ground truths under 2 px
(dropped) and squares among them, an image without labels, and the
End2End pair (one2one at top-k 7, then 1) at the OBB schedule's gains."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_loss import FEATS, _head_maps
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.loss import losses as JL
from yolosharp_tpu.loss.tal import assign as jax_assign
from yolosharp_tpu.ops.anchors import make_anchors as jax_make_anchors
from yolosharp_tpu_torch.loss import assign, e2e_wrap, obb_loss

NC = 5


def _rgt(rng, m, tiny=False):
    """m xywhr ground truths in a 64-pixel frame (angles in [-pi/2, 0), as
    minAreaRect gives them); the second a square; with `tiny` the third is
    under 2 px on a side."""
    g = np.concatenate([rng.uniform(10, 54, (m, 2)), rng.uniform(4, 30,
                                                                 (m, 2)),
                        rng.uniform(-math.pi / 2, 0, (m, 1))], -1)
    g[1, 3] = g[1, 2]
    if tiny:
        g[2, 2] = 1.5
    return g.astype(np.float32)


def _rotated_assign_inputs(seed):
    """A padded batch of 3 images, 6 gt slots (4, 2 and 0 valid), xywhr
    predictions around the anchors, in pixels."""
    rng = np.random.default_rng(seed)
    anc, strides = (np.asarray(t) for t in jax_make_anchors(FEATS,
                                                            (8, 16, 32)))
    anc_px = (anc * strides).astype(np.float32)
    b, a, m = 3, anc.shape[0], 6
    scores = rng.uniform(0.01, 0.99, (b, a, NC)).astype(np.float32)
    pd = np.concatenate([anc_px + rng.normal(0, 2, (b, a, 2)),
                         rng.uniform(4, 30, (b, a, 2)),
                         rng.uniform(-math.pi / 4, 3 * math.pi / 4,
                                     (b, a, 1))], -1).astype(np.float32)
    gt = np.stack([_rgt(rng, m) for _ in range(b)])
    gt[0, 0, 2:4] = [5, 6]              # smaller than the min stride
    labels = rng.integers(0, NC, (b, m)).astype(np.int32)
    mask = np.zeros((b, m), bool)
    mask[0, :4] = True
    mask[1, :2] = True
    gt[~mask] = 0
    return scores, pd, anc_px, labels, gt, mask


@pytest.mark.parametrize("topk2", [None, 1])
def test_rotated_assign_matches_jax(topk2):
    """fg_mask, target_labels and target_gt_idx on the foreground exact,
    target_bboxes (xywhr) and target_scores to 1e-6."""
    inputs = _rotated_assign_inputs(7)
    kw = dict(topk=10 if topk2 is None else 7, topk2=topk2, num_classes=NC,
              rotated=True)
    want = jax_assign(*map(jnp.asarray, inputs), **kw)
    got = assign(*map(torch.from_numpy, inputs), **kw)
    fg = np.asarray(want.fg_mask)
    assert fg.sum() > 5
    assert got.target_bboxes.shape[-1] == 5
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.target_labels.numpy(),
                                  np.asarray(want.target_labels))
    np.testing.assert_array_equal(got.target_gt_idx.numpy()[fg],
                                  np.asarray(want.target_gt_idx)[fg])
    for g, w in ((got.target_bboxes, want.target_bboxes),
                 (got.target_scores, want.target_scores)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def _obb_batch(rng, empty=False):
    """A padded batch (5 and 3 valid boxes of 8 slots), normalised xywh and
    the angle: a square and a box under 2 px among them; with `empty` the
    second image has no labels."""
    gt = np.stack([_rgt(rng, 8, tiny=True) for _ in range(2)])
    gt[..., :4] /= 64.0
    mask = np.zeros((2, 8), bool)
    mask[0, :5] = True
    mask[1, :3] = True
    if empty:
        mask[1] = False
    gt[~mask] = 0
    return {"cls": rng.integers(0, NC, (2, 8)).astype(np.int32),
            "bboxes": gt.astype(np.float32), "mask_gt": mask}


def _obb_maps(rng, b):
    box, cls = _head_maps(rng, b, NC)
    angle = [rng.uniform(-math.pi / 4, 3 * math.pi / 4, (b, h, w, 1))
             .astype(np.float32) for h, w in FEATS]
    return box + cls + angle


def _as_preds(arrs, nchw):
    def lvl(t):
        return t.permute(0, 3, 1, 2) if nchw else t

    return {"box": tuple(lvl(t) for t in arrs[0:3]),
            "cls": tuple(lvl(t) for t in arrs[3:6]),
            "angle": tuple(lvl(t) for t in arrs[6:9])}


@pytest.mark.parametrize("case", ["one2many", "no_labels", "end2end"])
def test_obb_loss_matches_jax(case):
    """Loss items (box, cls, dfl, angle) to 1e-5 relative and the gradients
    with respect to every head map to 1e-6 + 1e-4|ref|: the rotated
    assigner, the ground truths under 2 px dropped, a square among them,
    an image without labels beside one with, and the End2End pair at the
    OBB schedule's gains (one2many at top-k 10, one2one at top-k 7 then
    1). The image without labels gives its anchors all-zero targets, and
    probiou's sqrt of the zero target's covariance term has an infinite
    derivative: the box and angle maps' gradients are NaN at the same
    places in both (the train step's non-finite skip is the guard)."""
    rng = np.random.default_rng(len(case))
    batch = _obb_batch(rng, empty=case == "no_labels")
    branches = ["one2many", "one2one"] if case == "end2end" else ["one2many"]
    flat = [a for _ in branches for a in _obb_maps(rng, 2)]
    gains = dict(o2m_gain=0.6, o2o_gain=0.4) if case == "end2end" else {}

    if case == "end2end":
        jfn = JL.e2e_wrap(
            functools.partial(JL.obb_loss, nc=NC, tal_topk=10),
            functools.partial(JL.obb_loss, nc=NC, tal_topk=7, tal_topk2=1))
        fn = e2e_wrap(functools.partial(obb_loss, nc=NC, tal_topk=10),
                      functools.partial(obb_loss, nc=NC, tal_topk=7,
                                        tal_topk2=1))
    else:
        def jfn(p, b):
            return JL.obb_loss(p["one2many"], b, nc=NC)

        def fn(p, b, **_):
            return obb_loss(p["one2many"], b, nc=NC)

    def split(arrs, nchw):
        return {br: _as_preds(arrs[9 * i:9 * i + 9], nchw)
                for i, br in enumerate(branches)}

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, want_items), want_grads = jax.value_and_grad(
        lambda arrs: jfn(split(arrs, False), jb, **gains), has_aux=True)(
            [jnp.asarray(a) for a in flat])
    leaves = [torch.from_numpy(a).requires_grad_() for a in flat]
    loss, items = fn(split(leaves, True),
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     **gains)
    loss.backward()
    want_items = np.asarray(want_items)
    assert items.shape == (4,) and (want_items > 0).all()
    np.testing.assert_allclose(items.detach().numpy(), want_items, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-4)
    finite = [bool(torch.isfinite(t.grad).all()) for t in leaves]
    if case == "no_labels":
        assert finite == [False] * 3 + [True] * 3 + [False] * 3
    else:
        assert all(finite)
        assert any(t.grad.abs().max() > 0 for t in leaves[6:9])


def test_obb_loss_drops_ground_truths_under_2px():
    """A batch whose only label is under 2 px on a side assigns nothing:
    the box, DFL and angle items are 0, as the JAX package's."""
    rng = np.random.default_rng(3)
    batch = _obb_batch(rng)
    batch["mask_gt"][:] = False
    batch["mask_gt"][0, 2] = True                # the 1.5 px wide one
    arrs = _obb_maps(rng, 2)
    want = np.asarray(JL.obb_loss(_as_preds([jnp.asarray(a) for a in arrs],
                                            False),
                                  {k: jnp.asarray(v)
                                   for k, v in batch.items()}, nc=NC)[1])
    got = obb_loss(_as_preds([torch.from_numpy(a) for a in arrs], True),
                   {k: torch.from_numpy(v) for k, v in batch.items()},
                   nc=NC)[1].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] == got[2] == got[3] == 0 and got[1] > 0
