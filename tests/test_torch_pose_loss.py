"""The port's pose ops and loss against the JAX package on the same inputs,
made from a seed with numpy, float32 on the CPU: kpt_iou (the OKS) and
clip_keypoints, and pose_loss (loss items and the gradients with respect
to every head map) at 17 x 3 and 5 x 2 keypoints, with visibilities 0, 1
and 2, an image without labels, and the End2End pair (one2one at top-k 7,
then 1)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_loss import FEATS, _batch, _head_maps
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.loss import losses as JL
from yolosharp_tpu.ops.boxes import clip_keypoints as jax_clip_keypoints
from yolosharp_tpu.ops.iou import kpt_iou as jax_kpt_iou
from yolosharp_tpu_torch.loss import OKS_SIGMA, e2e_wrap, pose_loss
from yolosharp_tpu_torch.ops import clip_keypoints, kpt_iou

NC = 5


def test_oks_sigmas_equal_jax():
    np.testing.assert_array_equal(OKS_SIGMA.numpy(), np.asarray(JL.OKS_SIGMA))


@pytest.mark.parametrize("pred_dim", [2, 3])
@pytest.mark.parametrize("k", [17, 5])
def test_kpt_iou_matches_jax(k, pred_dim):
    """OKS of 6 ground truths (visibilities 0, 1, 2; one with none
    visible) against 9 predictions of kd = 2 or 3, with the COCO sigmas at
    K = 17 and 1 / K else: to 1e-6."""
    rng = np.random.default_rng(k + pred_dim)
    gt = np.concatenate([rng.uniform(0, 64, (6, k, 2)),
                         rng.integers(0, 3, (6, k, 1))], -1).astype(
                             np.float32)
    gt[0, :, 2] = 0.0
    pred = rng.uniform(0, 64, (9, k, pred_dim)).astype(np.float32)
    pred[:3, :, :2] = gt[:3, :, :2] + rng.normal(0, 2, (3, k, 2))
    area = rng.uniform(50, 900, 6).astype(np.float32)
    sigma = (np.array(JL.OKS_SIGMA) if k == 17
             else np.ones(k, np.float32) / k)
    want = np.asarray(jax_kpt_iou(jnp.asarray(gt), jnp.asarray(pred),
                                  jnp.asarray(area), jnp.asarray(sigma)))
    got = kpt_iou(torch.from_numpy(gt), torch.from_numpy(pred),
                  torch.from_numpy(area), torch.from_numpy(sigma)).numpy()
    assert got.shape == (6, 9)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert got[1:3].max() > 0.3 and not got[0].any()


@pytest.mark.parametrize("kd", [2, 3])
def test_clip_keypoints_matches_jax(kd):
    """Keypoints inside, on the edge and outside a 40 x 60 image: clipped
    to it, the visibility of the outside ones zeroed (kd = 3): equal."""
    rng = np.random.default_rng(kd)
    kpts = np.concatenate([rng.uniform(-20, 80, (4, 17, 2)),
                           rng.integers(0, 3, (4, 17, 1))], -1)[..., :kd]
    kpts[0, 0, :2] = [60.0, 40.0]
    kpts = kpts.astype(np.float32)
    want = np.asarray(jax_clip_keypoints(jnp.asarray(kpts), (40, 60)))
    got = clip_keypoints(torch.from_numpy(kpts), (40, 60)).numpy()
    np.testing.assert_array_equal(got, want)


def _pose_batch(rng, kpt_shape, empty=False):
    """The loss tests' padded batch (5 and 3 valid boxes of 8 slots) with
    K keypoints of kd values inside each box (visibility 0, 1 or 2 when
    kd = 3); with `empty` the second image has no labels."""
    batch = _batch(rng)
    k, kd = kpt_shape
    cxy, wh = batch["bboxes"][..., None, :2], batch["bboxes"][..., None, 2:]
    xy = cxy + (rng.uniform(0, 1, (2, 8, k, 2)) - 0.5) * wh
    vis = rng.integers(0, 3, (2, 8, k, 1)).astype(np.float32)
    kpts = np.concatenate([xy, vis], -1)[..., :kd].astype(np.float32)
    kpts[~batch["mask_gt"]] = 0.0
    batch["keypoints"] = kpts
    if empty:
        batch["mask_gt"][1] = False
        batch["bboxes"][1] = 0.0
        batch["keypoints"][1] = 0.0
    return batch


def _pose_maps(rng, b, nk):
    box, cls = _head_maps(rng, b, NC)
    kpt = [(rng.standard_normal((b, h, w, nk)) * 0.5).astype(np.float32)
           for h, w in FEATS]
    return box + cls + kpt


def _as_preds(arrs, nchw):
    def lvl(t):
        return t.permute(0, 3, 1, 2) if nchw else t

    return {"box": tuple(lvl(t) for t in arrs[0:3]),
            "cls": tuple(lvl(t) for t in arrs[3:6]),
            "kpt": tuple(lvl(t) for t in arrs[6:9])}


@pytest.mark.parametrize("case", ["k17_kd3", "k5_kd2", "no_labels",
                                  "end2end"])
def test_pose_loss_matches_jax(case):
    """Loss items (box, pose, kobj, cls, dfl) to 1e-5 relative and the
    gradients with respect to every head map to 1e-6 + 1e-4|ref|: 17 x 3
    keypoints (the COCO sigmas, kobj on the visibility logit), 5 x 2 (the
    sigmas 1 / K, kobj 0), an image without labels beside one with, and
    the End2End pair at the pose schedule's gains (one2many at top-k 10,
    one2one at top-k 7 then 1)."""
    rng = np.random.default_rng(len(case))
    kpt_shape = (5, 2) if case == "k5_kd2" else (17, 3)
    kw = dict(nc=NC, kpt_num=kpt_shape[0], kpt_dim=kpt_shape[1])
    batch = _pose_batch(rng, kpt_shape, empty=case == "no_labels")
    branches = ["one2many", "one2one"] if case == "end2end" else ["one2many"]
    nk = kpt_shape[0] * kpt_shape[1]
    flat = [a for _ in branches for a in _pose_maps(rng, 2, nk)]
    gains = dict(o2m_gain=0.6, o2o_gain=0.4) if case == "end2end" else {}

    if case == "end2end":
        jfn = JL.e2e_wrap(
            functools.partial(JL.pose_loss, tal_topk=10, **kw),
            functools.partial(JL.pose_loss, tal_topk=7, tal_topk2=1, **kw))
        fn = e2e_wrap(functools.partial(pose_loss, tal_topk=10, **kw),
                      functools.partial(pose_loss, tal_topk=7, tal_topk2=1,
                                        **kw))
    else:
        def jfn(p, b):
            return JL.pose_loss(p["one2many"], b, **kw)

        def fn(p, b, **_):
            return pose_loss(p["one2many"], b, **kw)

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
    assert want_items[1] > 0
    assert (want_items[2] > 0) == (kpt_shape[1] == 3)
    np.testing.assert_allclose(items.detach().numpy(), want_items, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-4)
    kpt_grads = [t.grad for t in leaves[6:9]]
    assert any(g.abs().max() > 0 for g in kpt_grads)
