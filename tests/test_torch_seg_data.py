"""The segment task's data path in the port against cv2 5.0 and the JAX
package, on the CPU: the cv2-free mask functions of image_ops (fill_poly,
the nearest warps, the uint8 linear and the nearest resizes), the segment
branch of load_labels on a PNG polygon dataset, the mask branches of the
host augmentations (mosaic4, random_perspective, letterbox, rectangle, the
flips) from the same rng, the collate's masks, device_batch's mask pool
and LUT, and the device render of the masks against jax.jit of the JAX
render."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mosaic import FULL_WARP, _records
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data import augment as jax_augment
from yolosharp_tpu.data import device_augment as JDA
from yolosharp_tpu.data.dataset import YoloDataset as JaxDataset
from yolosharp_tpu.data.labels import load_labels as jax_load_labels
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu_torch import Config, ScalarType, TaskType
from yolosharp_tpu_torch.data import YoloDataset, augment
from yolosharp_tpu_torch.data import device_augment as DA
from yolosharp_tpu_torch.data.image_ops import (encode_png, fill_poly,
                                                nearest_indices, resize_linear,
                                                warp_affine, warp_perspective)
from yolosharp_tpu_torch.data.labels import load_labels

NC = 3
S = 64


def make_seg_dataset(root, n_train, n_val, sizes, nc, seed=0):
    """PNG images (a noisy background, 1-8 polygons of 3-12 vertices in
    solid colours, overlapping) with YOLO segment labels (class, then the
    polygon's normalised x y pairs, clipped to [0, 1]) under
    root/images/{train,val} and root/labels/{train,val}."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(root, "labels", split), exist_ok=True)
        for i in range(n):
            h, w = sizes[rng.integers(len(sizes))]
            img = np.clip(rng.normal(rng.uniform(40, 215), 8, (h, w, 3)),
                          0, 255).astype(np.uint8)
            rows = []
            for _ in range(rng.integers(1, 9)):
                k = int(rng.integers(3, 13))
                c = rng.uniform(0.15, 0.85, 2)
                ang = np.sort(rng.uniform(0, 2 * np.pi, k))
                rad = rng.uniform(0.05, 0.3) * rng.uniform(0.5, 1.0, k)
                pts = np.clip(c + rad[:, None] * np.stack(
                    [np.cos(ang), np.sin(ang)], -1), 0, 1)
                shape = np.zeros((h, w), np.uint8)
                fill_poly(shape, (pts * [w, h]).astype(np.int32), 1)
                img[shape > 0] = rng.integers(0, 256, 3)
                rows.append(f"{rng.integers(nc)} "
                            + " ".join(f"{v:.6f}" for v in pts.reshape(-1)))
            name = f"{split}{i:03d}"
            with open(os.path.join(root, "images", split, name + ".png"),
                      "wb") as f:
                f.write(encode_png(img))
            with open(os.path.join(root, "labels", split, name + ".txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")


# ------------------------------------------------------------- image_ops
def _polygon(kind, rng, h, w):
    """An int32 polygon of one kind on an h x w mask."""
    if kind == "convex":
        ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 13))))
        c = rng.uniform(0.3, 0.7, 2) * [w, h]
        r = rng.uniform(1, max(2, min(h, w) / 3))
        pts = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
    elif kind == "concave":
        ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(5, 15))))
        rad = rng.uniform(0.1, 0.45, len(ang)) * min(h, w)
        pts = [w / 2, h / 2] + rad[:, None] * np.stack(
            [np.cos(ang), np.sin(ang)], -1)
    elif kind == "self_intersecting":
        pts = rng.uniform(0, 1, (int(rng.integers(4, 12)), 2)) * [w, h]
    elif kind == "degenerate":
        n = int(rng.integers(1, 4))
        a = rng.uniform(0, 1, 2) * [w - 1, h - 1]
        b = a + rng.uniform(-2, 2, 2)              # 1-2 px, collinear runs
        pts = a + np.linspace(0, 1, n)[:, None] * (b - a)
    else:       # vertices on and past the border
        pts = rng.uniform(-0.3, 1.3, (int(rng.integers(3, 10)), 2)) * [w, h]
        return pts.astype(np.int32)
    return np.clip(pts, 0, [w - 1, h - 1]).astype(np.int32)


@pytest.mark.parametrize("kind", ["convex", "concave", "self_intersecting",
                                  "degenerate", "out_of_range"])
def test_fill_poly_matches_cv2(kind):
    """300 polygons of a kind on random masks of 3-60 px a side, each over
    the previous (later ids over earlier ones): equal to cv2.fillPoly
    (cv2 5.0) bit for bit, vertices inside the mask and (out_of_range) up
    to 30% of a side past its border, where the edges start from their
    clipped lines."""
    rng = np.random.default_rng(len(kind))
    for t in range(300):
        h, w = (int(v) for v in rng.integers(3, 61, 2))
        got = np.zeros((h, w), np.uint8)
        want = np.zeros((h, w), np.uint8)
        inside = True
        for color in range(1, 4):
            poly = _polygon(kind, rng, h, w)
            fill_poly(got, poly, color)
            cv2.fillPoly(want, [poly], color=color)
            inside &= bool(((poly >= 0) & (poly < [w, h])).all())
        assert inside or kind == "out_of_range"
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{t} {(h, w)} {poly.tolist()}")


@pytest.mark.parametrize("case", ["shrink_by_one", "random", "upscale",
                                  "exact_halves"])
def test_resize_mask_linear_matches_cv2(case):
    """The uint8 (H, W) linear resize against cv2.resize(INTER_LINEAR),
    bit for bit, on id masks (0-8) and full-range values: the val
    rectangle's shrink (a ceil(rw/4) mask to rw//4), random sizes,
    upscales and exact halvings."""
    rng = np.random.default_rng(len(case))
    for t in range(200):
        H, W = (int(v) for v in rng.integers(2, 161, 2))
        if case == "shrink_by_one":
            h, w = max(1, H - int(rng.integers(0, 2))), max(
                1, W - int(rng.integers(0, 2)))
        elif case == "random":
            h, w = (int(v) for v in rng.integers(1, 161, 2))
        elif case == "upscale":
            h, w = H * int(rng.integers(1, 4)), W * int(rng.integers(1, 4))
        else:
            H, W = 2 * H, 2 * W
            h, w = H // 2, W // 2
        hi = 9 if t % 2 else 256
        img = rng.integers(0, hi, (H, W), dtype=np.uint8)
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(resize_linear(img, h, w), want,
                                      err_msg=f"{(H, W)} -> {(h, w)}")


def resize_nearest(img, h, w):
    """img resized to (h, w) by nearest_indices on both axes."""
    H, W = img.shape[:2]
    return img[nearest_indices(H, h)[:, None], nearest_indices(W, w)[None]]


def test_resize_nearest_matches_cv2():
    """nearest_indices on both axes against cv2.resize(INTER_NEAREST), bit
    for bit, 2-D and 3-D, down and up; the rule differs from the loss's
    half-pixel centres (tests/test_torch_seg_loss.py) at these shapes."""
    rng = np.random.default_rng(0)
    for t in range(300):
        H, W = (int(v) for v in rng.integers(1, 200, 2))
        h, w = (int(v) for v in rng.integers(1, 200, 2))
        img = rng.integers(0, 256, (H, W) + ((3,) if t % 2 else ()),
                           dtype=np.uint8)
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest(img, h, w), want)


def test_nearest_warps_match_cv2():
    """warp_affine / warp_perspective with nearest=True, border 0, against
    cv2.warpAffine / warpPerspective(INTER_NEAREST, borderValue=0) on id
    masks, with the augment's rotations, scales, shears and perspective:
    both warps bit for bit."""
    rng = np.random.default_rng(0)
    for t in range(200):
        h, w = (int(v) for v in rng.integers(20, 121, 2))
        img = rng.integers(0, 9, (h, w), dtype=np.uint8)
        a = np.radians(rng.uniform(-10, 10))
        s = rng.uniform(0.5, 1.5)
        M = np.eye(3, dtype=np.float32)
        M[:2, :2] = [[np.cos(a) * s, np.sin(a) * s],
                     [-np.sin(a) * s, np.cos(a) * s]]
        M[0, 1] += rng.uniform(-0.03, 0.03)
        M[1, 0] += rng.uniform(-0.03, 0.03)
        M[:2, 2] = rng.uniform(-20, 20, 2)
        P = M.copy()
        P[2, :2] = rng.uniform(-5e-4, 5e-4, 2)
        ow, oh = (int(v) for v in rng.integers(20, 121, 2))
        np.testing.assert_array_equal(
            warp_affine(img, M[:2], ow, oh, border=0, nearest=True),
            cv2.warpAffine(img, M[:2], (ow, oh), flags=cv2.INTER_NEAREST,
                           borderValue=0))
        np.testing.assert_array_equal(
            warp_perspective(img, P, ow, oh, border=0, nearest=True),
            cv2.warpPerspective(img, P, (ow, oh), flags=cv2.INTER_NEAREST,
                                borderValue=0))


# ---------------------------------------------------------------- labels
@pytest.fixture(scope="module")
def seg_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seg_pngs"))
    # sides up to the image size (no image resize: equal pools) and one
    # larger (a resize), widths and heights with and without rw % 4 == 0
    make_seg_dataset(root, 9, 4, [(64, 48), (48, 64), (64, 64), (30, 62),
                                  (96, 80)], NC, seed=3)
    return root


def _configs(root, **kw):
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=S, batch_size=3,
                  number_class=NC, workers=1, **kw)
    return (Config(task_type=TaskType.segment,
                   scalar_type=ScalarType.float32, **common),
            JaxConfig(task_type=JaxTaskType.segment, scalar_type="float32",
                      **common))


@pytest.mark.parametrize("is_val", [False, True])
def test_load_labels_matches_jax(seg_root, is_val):
    """The segment branch of load_labels on the PNG polygon dataset:
    classes and boxes (from the polygons' extremes) equal, masks of
    ceil(size / 4) equal to the JAX package's cv2.fillPoly ids (polygons
    with a vertex at x or y = 1.0, one pixel past the mask, included)."""
    cfg, jcfg = _configs(seg_root)
    got = load_labels(cfg, is_val=is_val)
    want = jax_load_labels(jcfg, is_val=is_val)
    assert [r.im_file for r in got] == [r.im_file for r in want]
    for g, w in zip(got, want):
        assert g.resized_shape == w.resized_shape
        assert g.rectangle_shape == w.rectangle_shape
        np.testing.assert_array_equal(g.cls, w.cls)
        np.testing.assert_array_equal(g.bboxes, w.bboxes)
        assert g.mask.shape == w.mask.shape == tuple(
            -(-v // 4) for v in g.resized_shape)
        assert g.mask.max() == len(g.cls)
        np.testing.assert_array_equal(g.mask, w.mask, err_msg=g.im_file)


# --------------------------------------------------------- augmentations
def _masked(recs, jrecs, seed):
    """Random overlap-id masks (0..n) of ceil(size / 4) on the record
    pairs, the same on both."""
    rng = np.random.default_rng(seed)
    for r, jr in zip(recs, jrecs):
        h, w = r.resized_shape
        r.mask = rng.integers(0, len(r.cls) + 1, (-(-h // 4), -(-w // 4)),
                              dtype=np.uint8)
        jr.mask = r.mask.copy()
    return recs, jrecs


@pytest.mark.parametrize("seed", range(3))
def test_mosaic4_masks_match_jax(seed):
    """The same draws: the 2s/4 mosaic mask with its instance ids offset
    per tile and renumbered 1..n over the surviving boxes equals the JAX
    package's; the survivors' classes and boxes equal."""
    recs, jrecs = _masked(*_records(10 + seed, 4), seed)
    got = augment.mosaic4(recs[0], recs[1:], S, np.random.default_rng(seed))
    want = jax_augment.mosaic4(jrecs[0], jrecs[1:], S,
                               np.random.default_rng(seed))
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.cls, want.cls)
    np.testing.assert_array_equal(got.bboxes, want.bboxes)
    assert got.mask.max() <= len(got.cls)


@pytest.mark.parametrize("hyps", [{}, FULL_WARP], ids=["affine", "full"])
def test_random_perspective_masks_match_jax(hyps):
    """A masked mosaic through random_perspective with the same rng: the
    warped mask (cv2 INTER_NEAREST in the JAX package, the mask-scale
    matrix) and its renumbering equal the JAX package's, through the
    affine and the perspective warp; boxes to 1e-4."""
    recs, jrecs = _masked(*_records(20, 4), 1)
    cfg, _ = _configs("", **hyps)
    args = (cfg.degrees, cfg.translate, cfg.scale, cfg.shear,
            cfg.perspective)
    got = augment.random_perspective(
        augment.mosaic4(recs[0], recs[1:], S, np.random.default_rng(2)),
        *args, np.random.default_rng(3))
    want = jax_augment.random_perspective(
        jax_augment.mosaic4(jrecs[0], jrecs[1:], S, np.random.default_rng(2)),
        *args, np.random.default_rng(3))
    np.testing.assert_array_equal(got.cls, want.cls)
    np.testing.assert_allclose(got.bboxes, want.bboxes, atol=1e-4)
    assert got.mask.shape == want.mask.shape == (S // 4, S // 4)
    assert got.mask.max() > 0
    np.testing.assert_array_equal(got.mask, want.mask)


@pytest.mark.parametrize("name", ["letterbox", "rectangle", "flip_lr",
                                  "flip_ud"])
def test_resize_pad_and_flip_masks_match_jax(name):
    """letterbox and rectangle resize the mask through cv2 INTER_LINEAR in
    the JAX package (ids blend; resize_linear is bit-exact) and pad
    it with 0; the flips mirror it: masks equal, boxes to 1e-4, for
    records of 20-64 px (the rectangle at the next 32-multiple + 16)."""
    recs, jrecs = _masked(*_records(30, 6), 2)
    for r, jr in zip(recs, jrecs):
        h, w = r.resized_shape
        r.rectangle_shape = jr.rectangle_shape = (
            (h // 32 + 1) * 32 + 16, (w // 32 + 1) * 32 + 16)
        if name == "letterbox":
            got, want = (augment.letterbox(r, S, S, 4),
                         jax_augment.letterbox(jr, S, S, 4))
        elif name == "rectangle":
            got, want = augment.rectangle(r, 4), jax_augment.rectangle(jr, 4)
        else:
            got = getattr(augment, name)(r)
            want = getattr(jax_augment, name)(jr)
        np.testing.assert_array_equal(got.mask, want.mask)
        np.testing.assert_allclose(got.bboxes, want.bboxes, atol=1e-4)


# -------------------------------------------------------- dataset, render
def _same_records(ds, jds):
    """Give the port's dataset the JAX dataset's images and masks, so that
    what follows is held without the load's resize differences (images
    within one level of cv2; test_load_labels_matches_jax)."""
    for r, jr in zip(ds.records, jds.records):
        assert r.im_file == jr.im_file
        r.img, r.mask = jr.img.copy(), jr.mask.copy()


def test_collate_masks_match_jax(seg_root):
    """The val collate (rectangle) and the letterbox train collate: the
    masks (B, h/4, w/4) float32, zero-padded to the batch's canvas, equal
    to the JAX package's, beside equal labels."""
    cfg, jcfg = _configs(seg_root, image_process_type="letterbox",
                         hsv_h=0.0, hsv_s=0.0, hsv_v=0.0)
    for is_val in (True, False):
        ds, jds = YoloDataset(cfg, is_val=is_val), JaxDataset(jcfg,
                                                               is_val=is_val)
        _same_records(ds, jds)
        ml = jds.max_label_count
        for start in range(0, len(ds), 3):
            idx = range(start, min(start + 3, len(ds)))
            got = ds.collate([ds.get(i) for i in idx], ml)
            want = jds.collate([jds.get(i) for i in idx], ml)
            assert got["masks"].dtype == want["masks"].dtype == np.float32
            assert got["masks"].shape[1:] == tuple(
                v // 4 for v in got["images"].shape[1:3])
            for k in ("masks", "cls", "bboxes", "mask_gt"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("extras", [0, 2])
def test_device_batch_masks_match_jax(seg_root, extras):
    """A planned segment batch (the mosaic's defaults, the full warp):
    aug_mask_pool (each record's mask top-left on a zero s/4 page) and
    aug_mask_lut equal to the JAX package's, with the other plan arrays,
    with batch-local partners and with 2 dataset-wide extras."""
    cfg, jcfg = _configs(seg_root, mosaic_partner_pool=extras,
                         **FULL_WARP)
    ds, jds = YoloDataset(cfg), JaxDataset(jcfg)
    _same_records(ds, jds)
    ds.rng, jds.rng = np.random.default_rng(1), np.random.default_rng(1)
    ml = jds.max_label_count
    got = ds.device_batch(np.arange(3), ml)
    want = jds.device_batch(np.arange(3), ml)
    assert set(got) == set(want)
    assert got["aug_mask_pool"].shape == (3 + extras, S // 4, S // 4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("hyps", [{}, FULL_WARP,
                                  dict(flip_lr=1.0, flip_ud=1.0)],
                         ids=["axis_aligned", "full_warp", "flips"])
def test_render_masks_match_jax(seg_root, hyps):
    """The torch render of a planned batch's masks against jax.jit of the
    JAX mosaic_perspective_masks on the same pool, plan and LUT: ids equal
    on at least 99.9% of the mask pixels (a sampling point on a tile or
    pixel edge can round the other way; the fraction is printed), and
    train.resolve_batch_images puts them in the batch as "masks"."""
    from yolosharp_tpu_torch.train import resolve_batch_images

    cfg, jcfg = _configs(seg_root, **hyps)
    ds = YoloDataset(cfg)
    batch = ds.device_batch(np.arange(6), ds.max_label_count)
    keys = DA.PLAN_KEYS[:-1] + ("aug_mask_lut",)
    want = np.asarray(jax.jit(JDA.mosaic_perspective_masks,
                              static_argnums=(2, 3))(
        jnp.asarray(batch["aug_mask_pool"]),
        tuple(jnp.asarray(batch[k]) for k in keys), S, 4))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = DA.render_masks(tb).numpy()
    assert got.shape == want.shape == (6, S // 4, S // 4)
    assert got.dtype == np.float32
    frac = (got != want).mean()
    print(f"{hyps}: {frac:.3e} of the mask ids differ")
    assert frac <= 1e-3
    assert got.max() > 0
    images, out = resolve_batch_images(tb, torch.float32)
    assert images.shape == (6, 3, S, S)
    np.testing.assert_array_equal(out["masks"].numpy(), got)
