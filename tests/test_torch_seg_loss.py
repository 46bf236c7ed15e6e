"""The port's segment ops and losses against the JAX package on the same
inputs, made from a seed with numpy, float32 on the CPU: crop_mask,
process_mask (at proto scale and upsampled to 640x640, 480x640 and 4x
canvases), mask_iou, the three nearest rules of the segment path,
segmentation_loss (loss items and the gradients with respect to every
head map and the proto; NMS and the End2End pair; the masks' resize to the
proto grid; several checkpointed chunks), and the semseg branch with
bce_dice_loss and multi_channel_dice_loss."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_loss import FEATS, _batch, _head_maps
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.loss import losses as JL
from yolosharp_tpu.ops.iou import mask_iou as jax_mask_iou
from yolosharp_tpu.ops.masks import crop_mask as jax_crop_mask
from yolosharp_tpu.ops.masks import process_mask as jax_process_mask
from yolosharp_tpu_torch.loss import (bce_dice_loss, e2e_wrap,
                                      multi_channel_dice_loss,
                                      segmentation_loss)
from yolosharp_tpu_torch.loss.losses import resize_nearest_centres
from yolosharp_tpu_torch.ops import crop_mask, mask_iou, process_mask

NC = 5
NM = 32


def _proto_case(rng, n, mh, mw, ih, iw):
    protos = rng.standard_normal((NM, mh, mw)).astype(np.float32)
    coeffs = (rng.standard_normal((n, NM)) * 0.5).astype(np.float32)
    c = rng.uniform(0.1, 0.9, (n, 2)) * [iw, ih]
    wh = rng.uniform(0.05, 0.6, (n, 2)) * [iw, ih]
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return protos, coeffs, boxes


def test_crop_mask_matches_jax():
    """Boxes with fractional, outside and inverted edges: equal."""
    rng = np.random.default_rng(0)
    masks = rng.standard_normal((12, 17, 23)).astype(np.float32)
    boxes = rng.uniform(-4, 26, (12, 4)).astype(np.float32)
    want = np.asarray(jax_crop_mask(jnp.asarray(masks), jnp.asarray(boxes)))
    got = crop_mask(torch.from_numpy(masks), torch.from_numpy(boxes))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("canvas,proto", [((640, 640), (160, 160)),
                                          ((480, 640), (120, 160)),
                                          ((64, 96), (16, 24))],
                         ids=["640x640", "480x640", "4x"])
@pytest.mark.parametrize("upsample", [False, True])
def test_process_mask_matches_jax(canvas, proto, upsample):
    """process_mask's bool masks against the JAX package's: equal on at
    least 99.99% of the pixels (a sum within float32 rounding of 0 may land
    on the other side of the > 0 threshold; F.interpolate's clamped
    bilinear weights equal jax.image.resize's renormalised ones when
    upsampling, so the rest is rounding). Measured: every pixel equal."""
    rng = np.random.default_rng(canvas[0] + upsample)
    protos, coeffs, boxes = _proto_case(rng, 20, *proto, *canvas)
    want = np.asarray(jax_process_mask(
        jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes),
        canvas, upsample=upsample))
    got = process_mask(torch.from_numpy(protos), torch.from_numpy(coeffs),
                       torch.from_numpy(boxes), canvas,
                       upsample=upsample).numpy()
    assert got.dtype == want.dtype == np.bool_
    assert got.shape == want.shape == ((20,) + (canvas if upsample
                                                 else proto))
    agree = (got == want).mean()
    print(f"{canvas} upsample={upsample}: {agree:.6f} of the pixels agree")
    assert agree >= 0.9999
    assert 0.01 < got.mean() < 0.99


def test_mask_iou_matches_jax():
    rng = np.random.default_rng(1)
    a = (rng.uniform(0, 1, (7, 300)) > 0.6).astype(np.float32)
    b = (rng.uniform(0, 1, (11, 300)) > 0.3).astype(np.float32)
    b[0] = 0.0                                    # an empty mask
    want = np.asarray(jax_mask_iou(jnp.asarray(a), jnp.asarray(b)))
    got = mask_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_the_three_nearest_rules():
    """The loss resizes masks as jax.image.resize(nearest) does, half-pixel
    centres (F.interpolate "nearest-exact", not "nearest"); val resizes
    ground-truth masks as cv2 INTER_NEAREST, floor(dst * src / dst)
    (tests/test_torch_seg_data.py::test_resize_nearest_matches_cv2); the
    nearest warps round the mapped coordinate
    (test_nearest_warps_match_cv2). At 7x9 -> 5x4 and 10x10 -> 4x6 the
    rules pick different pixels, and each port rule equals its source."""
    from test_torch_seg_data import resize_nearest

    x = np.arange(2 * 7 * 9, dtype=np.float32).reshape(2, 7, 9)
    y = np.arange(2 * 10 * 10, dtype=np.float32).reshape(2, 10, 10)
    for src, (h, w) in ((x, (5, 4)), (y, (4, 6))):
        want = np.asarray(jax.image.resize(jnp.asarray(src),
                                           (2, h, w), "nearest"))
        got = resize_nearest_centres(torch.from_numpy(src), h, w).numpy()
        np.testing.assert_array_equal(got, want)
        exact = F.interpolate(torch.from_numpy(src)[:, None], size=(h, w),
                              mode="nearest-exact")[:, 0].numpy()
        np.testing.assert_array_equal(exact, want)
        floor = F.interpolate(torch.from_numpy(src)[:, None], size=(h, w),
                              mode="nearest")[:, 0].numpy()
        cv2_rule = np.stack([resize_nearest(s, h, w) for s in src])
        np.testing.assert_array_equal(floor, cv2_rule)
        assert not np.array_equal(floor, want)


# ------------------------------------------------------ segmentation loss
def _seg_batch(rng, m, mask_hw):
    """A padded batch of 2 images (5 and 3 valid instances of m slots)
    with overlap-id masks: each instance's box region at mask scale, later
    instances over earlier ones."""
    batch = _batch(rng, m=m)
    b = batch["cls"].shape[0]
    mh, mw = mask_hw
    masks = np.zeros((b, mh, mw), np.float32)
    for i in range(b):
        for j in np.flatnonzero(batch["mask_gt"][i]):
            cx, cy, w, h = batch["bboxes"][i, j]
            x1 = max(int((cx - w / 2) * mw), 0)
            x2 = min(int(np.ceil((cx + w / 2) * mw)), mw)
            y1 = max(int((cy - h / 2) * mh), 0)
            y2 = min(int(np.ceil((cy + h / 2) * mh)), mh)
            keep = rng.uniform(0, 1, (y2 - y1, x2 - x1)) < 0.8
            masks[i, y1:y2, x1:x2][keep] = j + 1
    batch["masks"] = masks
    return batch


def _seg_maps(rng, b):
    box, cls = _head_maps(rng, b, NC)
    mask = [rng.standard_normal((b, h, w, NM)).astype(np.float32)
            for h, w in FEATS]
    proto = rng.standard_normal((b, 16, 16, NM)).astype(np.float32)
    return box + cls + mask + [proto]


def _as_preds(arrs, nchw):
    def lvl(t):
        return t.permute(0, 3, 1, 2) if nchw else t

    return {"box": tuple(lvl(t) for t in arrs[0:3]),
            "cls": tuple(lvl(t) for t in arrs[3:6]),
            "mask": tuple(lvl(t) for t in arrs[6:9]),
            "proto": lvl(arrs[9])}


@pytest.mark.parametrize("case", ["nms", "end2end", "resized_masks",
                                  "chunks"])
def test_segmentation_loss_matches_jax(case):
    """Loss items (box, seg, cls, dfl, semseg) to 1e-5 relative and the
    gradients with respect to every head map and the proto to 1e-6 +
    1e-4|ref|: the NMS loss (TAL top-k 10); the End2End pair at the
    segment schedule's gains (one2one at top-k 7 then 1); masks at 24x20
    resized to the 16x16 proto grid; and 40 label slots, so that the 400
    foreground slots run as two checkpointed chunks of 256. The slots come
    from a top-k over the 0/1 foreground, whose tied order is free: only
    loss items and gradients are compared."""
    rng = np.random.default_rng(len(case))
    m = 40 if case == "chunks" else 8
    batch = _seg_batch(rng, m, (24, 20) if case == "resized_masks"
                       else (16, 16))
    branches = ["one2many", "one2one"] if case == "end2end" else ["one2many"]
    flat = [a for _ in branches for a in _seg_maps(rng, 2)]
    kw = dict(o2m_gain=0.6, o2o_gain=0.4) if case == "end2end" else {}

    if case == "end2end":
        jfn = JL.e2e_wrap(
            functools.partial(JL.segmentation_loss, nc=NC, tal_topk=10),
            functools.partial(JL.segmentation_loss, nc=NC, tal_topk=7,
                              tal_topk2=1))
        fn = e2e_wrap(functools.partial(segmentation_loss, nc=NC,
                                        tal_topk=10),
                      functools.partial(segmentation_loss, nc=NC,
                                        tal_topk=7, tal_topk2=1))
    else:
        def jfn(p, b):
            return JL.segmentation_loss(p["one2many"], b, nc=NC)

        def fn(p, b, **_):
            return segmentation_loss(p["one2many"], b, nc=NC)

    def split(arrs, nchw):
        return {br: _as_preds(arrs[10 * i:10 * i + 10], nchw)
                for i, br in enumerate(branches)}

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, want_items), want_grads = jax.value_and_grad(
        lambda arrs: jfn(split(arrs, False), jb, **kw), has_aux=True)(
            [jnp.asarray(a) for a in flat])
    leaves = [torch.from_numpy(a).requires_grad_() for a in flat]
    loss, items = fn(split(leaves, True),
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     **kw)
    loss.backward()
    want_items = np.asarray(want_items)
    assert want_items[1] > 0 and want_items[4] == 0
    np.testing.assert_allclose(items.detach().numpy(), want_items, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-4)


def test_semseg_branch_matches_jax():
    """With "semseg" logits (2, NC, 12, 12) and "sem_masks" class ids at the
    16x16 mask grid (resized to the logits' 12x12 by torch's nearest
    rule), the semseg item (BCE + Dice, the box gain) and the loss's
    gradient with respect to the logits equal the JAX package's (NHWC
    there) to 1e-5 / 1e-6 + 1e-4|ref|; the other four items are the NMS
    loss's."""
    rng = np.random.default_rng(5)
    batch = _seg_batch(rng, 8, (16, 16))
    batch["sem_masks"] = rng.integers(0, NC, (2, 16, 16)).astype(np.int32)
    flat = _seg_maps(rng, 2)
    sem = rng.standard_normal((2, 12, 12, NC)).astype(np.float32)

    def jfn(s):
        preds = dict(_as_preds([jnp.asarray(a) for a in flat], False),
                     semseg=s)
        return JL.segmentation_loss(preds, {k: jnp.asarray(v) for k, v in
                                            batch.items()}, nc=NC)

    (_, want_items), want_g = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(sem))
    t = torch.from_numpy(sem).requires_grad_()
    preds = dict(_as_preds([torch.from_numpy(a) for a in flat], True),
                 semseg=t.permute(0, 3, 1, 2))
    loss, items = segmentation_loss(
        preds, {k: torch.from_numpy(v) for k, v in batch.items()}, nc=NC)
    loss.backward()
    assert float(want_items[4]) > 0
    np.testing.assert_allclose(items.detach().numpy(),
                               np.asarray(want_items), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("resize", [False, True])
def test_bce_dice_losses_match_jax(resize):
    """bce_dice_loss (and multi_channel_dice_loss at its default smooth) on
    (B, C, H, W) maps against the JAX package's NHWC functions, values to
    1e-6 relative; the target at 10x14 for logits of 6x5 takes torch's
    nearest rule."""
    rng = np.random.default_rng(resize)
    logits = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    th, tw = (10, 14) if resize else (6, 5)
    target = (rng.uniform(0, 1, (2, th, tw, 3)) > 0.5).astype(np.float32)
    tl = torch.from_numpy(logits).permute(0, 3, 1, 2)
    tt = torch.from_numpy(target).permute(0, 3, 1, 2)
    want = float(JL.bce_dice_loss(jnp.asarray(logits), jnp.asarray(target)))
    np.testing.assert_allclose(float(bce_dice_loss(tl, tt)), want, rtol=1e-6)
    if not resize:
        want = float(JL.multi_channel_dice_loss(jnp.asarray(logits),
                                                jnp.asarray(target)))
        np.testing.assert_allclose(float(multi_channel_dice_loss(tl, tt)),
                                   want, rtol=1e-6)
