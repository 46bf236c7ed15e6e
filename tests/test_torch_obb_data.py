"""The OBB task's data path in the port against the JAX package, on the
CPU: the cv2-free minimum-area rectangle against cv2 5.0's minAreaRect and
the whole xyxyxyxy2xywhr against the JAX one, the OBB branch of load_labels
on a PNG set of rotated rectangles, the corner branches of the host
augmentations (letterbox, rectangle, the flips, mosaic4,
random_perspective) from the same rng, and _label_arrays through the
collate (host batches) and device_batch (planned batches)."""

import math
import os

import cv2
import numpy as np
import pytest

from test_torch_mosaic import FULL_WARP
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data import augment as jax_augment
from yolosharp_tpu.data.dataset import YoloDataset as JaxDataset
from yolosharp_tpu.data.labels import LabelRecord as JaxRecord
from yolosharp_tpu.data.labels import load_labels as jax_load_labels
from yolosharp_tpu.ops.boxes import xyxyxyxy2xywhr as jax_xyxyxyxy2xywhr
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu_torch import Config, ScalarType, TaskType
from yolosharp_tpu_torch.data import YoloDataset, augment
from yolosharp_tpu_torch.data.image_ops import encode_png, fill_poly
from yolosharp_tpu_torch.data.labels import LabelRecord, load_labels
from yolosharp_tpu_torch.ops.boxes import xyxyxyxy2xywhr
from yolosharp_tpu_torch.ops.rect import convex_hull_indices, min_area_rect

NC = 3
S = 64


def rotated_corners(cx, cy, w, h, angle):
    """The 4 corners (..., 4, 2) float64 of rectangles (centre, sides,
    angle in radians), in the order xywhr2xyxyxyxy gives."""
    c, s = np.cos(angle), np.sin(angle)
    v1 = np.stack([w / 2 * c, w / 2 * s], -1)
    v2 = np.stack([-h / 2 * s, h / 2 * c], -1)
    ct = np.stack([cx, cy], -1)
    return np.stack([ct + v1 + v2, ct + v1 - v2, ct - v1 - v2, ct - v1 + v2],
                    -2)


def make_obb_dataset(root, n_train, n_val, sizes, nc, seed=0):
    """PNG images (a noisy background, 1-8 solid rotated rectangles drawn
    with fill_poly) with YOLO OBB labels under root/images/{train,val} and
    root/labels/{train,val}: a class and the rectangle's 4 corners,
    normalised, some of them outside the image."""
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
                bw, bh = rng.uniform(0.1, 0.5, 2) * min(h, w)
                cor = rotated_corners(rng.uniform(0.1, 0.9) * w,
                                      rng.uniform(0.1, 0.9) * h, bw, bh,
                                      rng.uniform(-math.pi, math.pi))
                plane = np.zeros((h, w), np.uint8)
                fill_poly(plane, cor.astype(np.int32), 1)
                img[plane > 0] = rng.integers(0, 256, 3)
                rows.append(f"{rng.integers(nc)} " + " ".join(
                    f"{v:.6f}" for v in (cor / [w, h]).reshape(-1)))
            name = f"{split}{i:03d}"
            with open(os.path.join(root, "images", split, name + ".png"),
                      "wb") as f:
                f.write(encode_png(img))
            with open(os.path.join(root, "labels", split, name + ".txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")


def obb_records(seed, n):
    """n (port, JAX) record pairs with the same pixels and labels: sides
    20..S, 0-4 rotated rectangles, their corners and the boxes spanning
    them."""
    rng = np.random.default_rng(seed)
    ours, theirs = [], []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(20, S + 1, 2))
        m = int(rng.integers(0, 5))
        cor = rotated_corners(rng.uniform(0.2, 0.8, m) * w,
                              rng.uniform(0.2, 0.8, m) * h,
                              rng.uniform(0.1, 0.5, m) * w,
                              rng.uniform(0.1, 0.5, m) * h,
                              rng.uniform(-math.pi, math.pi, m))
        cor = cor.reshape(m, 4, 2).astype(np.float32)
        fields = dict(
            im_file=f"{i}.png", org_shape=(h, w), resized_shape=(h, w),
            img=rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            cls=rng.integers(0, NC, m).astype(np.float32),
            bboxes=np.concatenate([cor.min(1), cor.max(1)], -1),
            obb_corners=cor)
        ours.append(LabelRecord(**fields))
        theirs.append(JaxRecord(**{k: (v.copy() if isinstance(v, np.ndarray)
                                       else v) for k, v in fields.items()}))
    return ours, theirs


def _assert_obb_equal(got, want, atol=0.0):
    np.testing.assert_array_equal(got.cls, want.cls)
    np.testing.assert_allclose(got.bboxes, want.bboxes, atol=atol)
    assert got.obb_corners.shape == want.obb_corners.shape
    np.testing.assert_allclose(got.obb_corners, want.obb_corners, atol=atol)


# ----------------------------------------------------- minimum-area rect
def _cv2_rects(pts):
    return np.array([[*r[0], *r[1], r[2]] for r in
                     (cv2.minAreaRect(p) for p in pts)], np.float32)


def _box_corners(rects):
    """Corners (N, 4, 2) float64 of (cx, cy, w, h, angle in degrees)."""
    r = np.asarray(rects, np.float64)
    return rotated_corners(r[:, 0], r[:, 1], r[:, 2], r[:, 3],
                           np.deg2rad(r[:, 4]))


def _assert_rects_match(got, want, rounded=False):
    """(w, h) order and the [-90, 0) angle as cv2's (the sides' order where
    they differ by more than 1e-3), every value to 1e-5 relative (the
    angle in degrees). `rounded`: the sets are rectangles or parallelograms
    with float32-rounded corners, whose edges tie to within rounding, and
    OpenCV's rounding and the port's may take different tied edges; then
    the rectangles' corners agree to 1e-4 of the longer side."""
    assert ((got[:, 4] >= -90 - 1e-4) & (got[:, 4] < 0)).all()
    longer = np.abs(want[:, 2] - want[:, 3]) > 1e-3 * want[:, 2:4].max(1)
    np.testing.assert_array_equal((got[:, 2] > got[:, 3])[longer],
                                  (want[:, 2] > want[:, 3])[longer])
    if rounded:
        err = np.abs(_box_corners(got) - _box_corners(want)).max((1, 2))
        side = np.maximum(want[:, 2:4].max(1), 1.0)
        assert (err <= 1e-4 * side).all(), (err / side).max()
    else:
        err = np.abs(got - want)
        assert (err <= 1e-5 * np.maximum(np.abs(want), 1.0)).all(), err.max()


def _point_sets(kind, rng):
    if kind == "convex_quads":
        # random quads in general position: convex or not, the hull is what
        # minAreaRect sees (exact area ties between edges included)
        return rng.uniform(0, 640, (4000, 4, 2))
    if kind == "integer_grid":
        # duplicate, collinear and axis-aligned points on a small grid
        return rng.integers(0, 5, (4000, 4, 2))
    if kind == "axis_aligned":
        x, y = rng.integers(0, 600, (2, 500))
        w, h = rng.integers(1, 100, (2, 500))
        return np.stack([np.stack([x, y], -1), np.stack([x + w, y], -1),
                         np.stack([x + w, y + h], -1),
                         np.stack([x, y + h], -1)], 1)
    if kind == "squares":
        x, y = rng.integers(0, 600, (2, 500))
        s = rng.integers(1, 100, 500)
        sq = np.stack([np.stack([x, y], -1), np.stack([x + s, y], -1),
                       np.stack([x + s, y + s], -1),
                       np.stack([x, y + s], -1)], 1)
        # and the diamonds (squares at 45 degrees) through their centres
        dm = np.stack([np.stack([x, y + s], -1), np.stack([x + s, y], -1),
                       np.stack([x + 2 * s, y + s], -1),
                       np.stack([x + s, y + 2 * s], -1)], 1)
        return np.concatenate([sq, dm])
    if kind == "degenerate":
        # points repeated, three or four exactly collinear, all equal
        a = rng.integers(0, 50, (500, 2))
        d = rng.integers(-5, 6, (500, 2))
        line = np.stack([a, a + d, a + 2 * d, a + 3 * d], 1)
        line = line[:, rng.permutation(4)]
        twice = np.stack([a, a + d, a, a + d], 1)
        same = np.stack([a] * 4, 1)
        corner = np.stack([a, a + d, a + 2 * d, a + [7, 0]], 1)
        return np.concatenate([line, twice, same, corner])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["convex_quads", "integer_grid",
                                  "axis_aligned", "squares", "degenerate"])
def test_min_area_rect_matches_cv2(kind):
    """min_area_rect against cv2 5.0's minAreaRect: the hull (Sklansky, the
    cyclic shift) equal point for point, the centre, sides and angle to
    1e-5 relative, the sides in cv2's (w, h) order, the angle in [-90, 0)
    (an axis-aligned 10 x 5 box is (5, 10) at -90 degrees)."""
    pts = _point_sets(kind, np.random.default_rng(0)).astype(np.float32)
    hull, count = convex_hull_indices(pts)
    for p, h, c in zip(pts, hull, count):
        want = cv2.convexHull(p, clockwise=False).reshape(-1, 2)
        np.testing.assert_array_equal(p[h[:c]], want)
    _assert_rects_match(min_area_rect(pts), _cv2_rects(pts))


def test_min_area_rect_axis_aligned_convention():
    """OpenCV 5.0's own examples: a 10 x 5 box lying flat is (5, 10) at -90
    degrees, standing it is (10, 5) at -90, a point is 0 x 0 at -90."""
    got = min_area_rect(np.float32([[[0, 0], [10, 0], [10, 5], [0, 5]],
                                    [[0, 0], [5, 0], [5, 10], [0, 10]],
                                    [[3, 3]] * 4]))
    np.testing.assert_array_equal(got, [[5, 2.5, 5, 10, -90],
                                        [2.5, 5, 10, 5, -90],
                                        [3, 3, 0, 0, -90]])


def test_min_area_rect_rotated_rectangles_every_15_degrees():
    """Rectangles (sides 10 x 5 to 100 x 3, squares among them) rotated by
    every multiple of 15 degrees, corners rounded to float32, in two corner
    orders: cv2's (w, h) order and angle, the rectangles' corners to 1e-4
    of the longer side (the rounded corners make the four edges tie to
    within rounding)."""
    sides = [(10, 5), (5, 10), (7, 7), (100, 3), (33.3, 17.1), (64, 64)]
    rects = np.array([rotated_corners(cx, cy, w, h, np.deg2rad(a))
                      for a in range(0, 360, 15) for w, h in sides
                      for cx, cy in ((50, 50), (320.5, 100.25))])
    for pts in (rects, rects[:, ::-1]):
        pts = pts.astype(np.float32)
        _assert_rects_match(min_area_rect(pts), _cv2_rects(pts),
                            rounded=True)


def test_xyxyxyxy2xywhr_matches_jax():
    """The whole conversion against the JAX package's (cv2.minAreaRect, the
    angle in radians): quads in general position and rotated rectangles,
    with leading dimensions (B, n, 4, 2) and an empty set."""
    rng = np.random.default_rng(5)
    quads = rng.uniform(0, 640, (3, 40, 4, 2)).astype(np.float32)
    want = jax_xyxyxyxy2xywhr(quads)
    got = xyxyxyxy2xywhr(quads)
    assert got.shape == want.shape == (3, 40, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rects = rotated_corners(rng.uniform(50, 590, 200),
                            rng.uniform(50, 590, 200),
                            rng.uniform(2, 100, 200), rng.uniform(2, 100, 200),
                            np.deg2rad(rng.integers(0, 24, 200) * 15.0))
    rects = rects.astype(np.float32)
    got, want = xyxyxyxy2xywhr(rects), jax_xyxyxyxy2xywhr(rects)
    deg = np.float32([1, 1, 1, 1, 180 / math.pi])
    _assert_rects_match(got * deg, want * deg, rounded=True)
    assert xyxyxyxy2xywhr(np.zeros((0, 4, 2))).shape == (0, 5)


# ---------------------------------------------------------------- labels
@pytest.fixture(scope="module")
def obb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obb_pngs"))
    # sides up to the image size (no resize: equal pools) and one larger
    make_obb_dataset(root, 9, 4, [(64, 48), (48, 64), (64, 64), (30, 62),
                                  (96, 80)], NC, seed=3)
    return root


def _configs(root, **kw):
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=S, batch_size=3,
                  number_class=NC, workers=1, **kw)
    return (Config(task_type=TaskType.obb, scalar_type=ScalarType.float32,
                   **common),
            JaxConfig(task_type=JaxTaskType.obb, scalar_type="float32",
                      **common))


@pytest.mark.parametrize("is_val", [False, True])
def test_load_labels_matches_jax(obb_root, is_val):
    """The OBB branch of load_labels: classes equal, the boxes spanning
    the corners' extremes and the 4 corners scaled to resized pixels equal
    to the JAX package's; the 96x80 images resize."""
    got = load_labels(_configs(obb_root)[0], is_val=is_val)
    want = jax_load_labels(_configs(obb_root)[1], is_val=is_val)
    assert [r.im_file for r in got] == [r.im_file for r in want]
    for g, w in zip(got, want):
        assert g.resized_shape == w.resized_shape
        assert g.rectangle_shape == w.rectangle_shape
        assert g.obb_corners.shape == (len(g.cls), 4, 2)
        assert g.mask is None and g.keypoints is None
        _assert_obb_equal(g, w)


# --------------------------------------------------------- augmentations
@pytest.mark.parametrize("name", ["letterbox", "rectangle", "flip_lr",
                                  "flip_ud"])
def test_resize_pad_and_flip_corners_match_jax(name):
    """letterbox and rectangle shift the corners by their pads, the flips
    mirror them (the corner order kept): equal to the JAX package's, for
    records of 20-64 px (the rectangle at the next 32-multiple + 16)."""
    recs, jrecs = obb_records(30, 8)
    moved = 0
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
        _assert_obb_equal(got, want)
        moved += int((got.obb_corners != r.obb_corners).any())
        # the transform worked on a copy
        np.testing.assert_array_equal(r.obb_corners, jr.obb_corners)
    assert moved >= 3


@pytest.mark.parametrize("seed", range(2))
def test_mosaic4_corners_match_jax(seed):
    """The same draws: the survivors' classes, boxes and corners (offset
    by their tile's pad) equal the JAX package's."""
    recs, jrecs = obb_records(10 + seed, 4)
    got = augment.mosaic4(recs[0], recs[1:], S, np.random.default_rng(seed))
    want = jax_augment.mosaic4(jrecs[0], jrecs[1:], S,
                               np.random.default_rng(seed))
    _assert_obb_equal(got, want)
    assert len(got.cls) > 0


@pytest.mark.parametrize("hyps", [{}, FULL_WARP], ids=["affine", "full"])
def test_random_perspective_corners_match_jax(hyps):
    """A mosaic through random_perspective with the same rng: the warped
    corners (clipped to the canvas) and boxes to 1e-4 of the JAX
    package's."""
    recs, jrecs = obb_records(20, 4)
    cfg, _ = _configs("", **hyps)
    args = (cfg.degrees, cfg.translate, cfg.scale, cfg.shear,
            cfg.perspective)
    got = augment.random_perspective(
        augment.mosaic4(recs[0], recs[1:], S, np.random.default_rng(2)),
        *args, np.random.default_rng(3))
    want = jax_augment.random_perspective(
        jax_augment.mosaic4(jrecs[0], jrecs[1:], S, np.random.default_rng(2)),
        *args, np.random.default_rng(3))
    assert len(got.cls) > 0
    _assert_obb_equal(got, want, atol=1e-4)


# ------------------------------------------------------- collate, planner
def _same_images(ds, jds):
    """Give the port's dataset the JAX dataset's images, so that what
    follows is held without the load's resize differences (images within
    one level of cv2; tests/test_torch_data.py)."""
    for r, jr in zip(ds.records, jds.records):
        assert r.im_file == jr.im_file
        r.img = jr.img.copy()


def _assert_label_arrays(got, want):
    """_label_arrays of an OBB batch: bboxes (B, M, 5) float32, normalised
    xywh and the angle in radians in [-pi/2, 0), zero in the padding
    slots; classes and validity equal, the boxes as the JAX package's (its
    cv2.minAreaRect) to _assert_rects_match's rule for rounded
    rectangles, in canvas pixels."""
    assert got["bboxes"].dtype == np.float32
    assert got["bboxes"].shape == want["bboxes"].shape
    assert got["bboxes"].shape[-1] == 5
    assert not got["bboxes"][~got["mask_gt"]].any()
    for k in ("cls", "mask_gt"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    h, w = want["images"].shape[1:3] if "images" in want else \
        want["aug_pool"].shape[1:3]
    to_px = np.float64([w, h, w, h, 180 / math.pi])
    valid = got["mask_gt"]
    _assert_rects_match(got["bboxes"][valid] * to_px,
                        want["bboxes"][valid] * to_px, rounded=True)


def test_collate_label_arrays_match_jax(obb_root):
    """The val collate (rectangle) and the letterbox train collate with
    both flips: the OBB _label_arrays equal the JAX package's."""
    cfg, jcfg = _configs(obb_root, image_process_type="letterbox",
                         flip_ud=0.5, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0)
    for is_val in (True, False):
        ds = YoloDataset(cfg, is_val=is_val)
        jds = JaxDataset(jcfg, is_val=is_val)
        _same_images(ds, jds)
        ml = jds.max_label_count
        for start in range(0, len(ds), 3):
            idx = range(start, min(start + 3, len(ds)))
            got = ds.collate([ds.get(i) for i in idx], ml)
            want = jds.collate([jds.get(i) for i in idx], ml)
            assert set(got) == set(want)
            _assert_label_arrays(got, want)


@pytest.mark.parametrize("hyps", [{}, FULL_WARP], ids=["affine", "full"])
def test_host_mosaic_label_arrays_match_jax(obb_root, hyps):
    """The host mosaic (mosaic4 + random_perspective, then the flips) from
    the same rng, through the collate: the OBB _label_arrays of the warped,
    clipped corners equal the JAX package's."""
    cfg, jcfg = _configs(obb_root, flip_ud=0.5, hsv_h=0.0, hsv_s=0.0,
                         hsv_v=0.0, **hyps)
    ds, jds = YoloDataset(cfg), JaxDataset(jcfg)
    _same_images(ds, jds)
    ds.rng, jds.rng = np.random.default_rng(4), np.random.default_rng(4)
    ml = jds.max_label_count
    for start in (0, 3, 6):
        idx = range(start, start + 3)
        got = ds.collate([ds.get(i) for i in idx], ml)
        want = jds.collate([jds.get(i) for i in idx], ml)
        assert got["mask_gt"].any()
        _assert_label_arrays(got, want)


@pytest.mark.parametrize("extras", [0, 2])
def test_device_batch_label_arrays_match_jax(obb_root, extras):
    """A planned OBB batch (the mosaic's defaults with the full warp and
    both flips possible): the planner's corners through _label_arrays equal
    the JAX package's, with the plan arrays and the pool, with batch-local
    partners and with 2 dataset-wide extras."""
    cfg, jcfg = _configs(obb_root, mosaic_partner_pool=extras, flip_ud=0.5,
                         **FULL_WARP)
    ds, jds = YoloDataset(cfg), JaxDataset(jcfg)
    assert ds.use_device_augment()
    _same_images(ds, jds)
    ds.rng, jds.rng = np.random.default_rng(1), np.random.default_rng(1)
    ml = jds.max_label_count
    got = ds.device_batch(np.arange(3), ml)
    want = jds.device_batch(np.arange(3), ml)
    assert set(got) == set(want)
    assert got["mask_gt"].any()
    for k in want:
        if k != "bboxes":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_label_arrays(got, want)
