"""The pose task's data path in the port against the JAX package, on the
CPU: the pose branch of load_labels on a PNG keypoint dataset (17 x 3 and
5 x 2), the keypoint branches of the host augmentations (letterbox,
rectangle, the flips, mosaic4, random_perspective) from the same rng, the
collate's keypoints and device_batch's planned keypoints."""

import os

import numpy as np
import pytest

from test_torch_mosaic import FULL_WARP
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data import augment as jax_augment
from yolosharp_tpu.data.dataset import YoloDataset as JaxDataset
from yolosharp_tpu.data.labels import LabelRecord as JaxRecord
from yolosharp_tpu.data.labels import load_labels as jax_load_labels
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu_torch import Config, ScalarType, TaskType
from yolosharp_tpu_torch.data import YoloDataset, augment
from yolosharp_tpu_torch.data.image_ops import encode_png
from yolosharp_tpu_torch.data.labels import LabelRecord, load_labels

NC = 3
S = 64


def make_pose_dataset(root, n_train, n_val, sizes, nc, kpt_shape=(17, 3),
                      seed=0):
    """PNG images (a noisy background, 1-8 solid rectangles) with YOLO pose
    labels under root/images/{train,val} and root/labels/{train,val}: a
    class, the rectangle's normalised xywh, then K keypoints inside it of
    kd values (x, y [, visibility from {0, 1, 2}]); half of the invisible
    ones sit at (0, 0), as COCO writes them."""
    rng = np.random.default_rng(seed)
    k, kd = kpt_shape
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(root, "labels", split), exist_ok=True)
        for i in range(n):
            h, w = sizes[rng.integers(len(sizes))]
            img = np.clip(rng.normal(rng.uniform(40, 215), 8, (h, w, 3)),
                          0, 255).astype(np.uint8)
            rows = []
            for _ in range(rng.integers(1, 9)):
                bw, bh = rng.uniform(0.15, 0.5, 2)
                cx = rng.uniform(bw / 2, 1 - bw / 2)
                cy = rng.uniform(bh / 2, 1 - bh / 2)
                x1, x2 = int((cx - bw / 2) * w), int((cx + bw / 2) * w)
                y1, y2 = int((cy - bh / 2) * h), int((cy + bh / 2) * h)
                img[y1:y2, x1:x2] = rng.integers(0, 256, 3)
                xy = np.stack([rng.uniform(cx - bw / 2, cx + bw / 2, k),
                               rng.uniform(cy - bh / 2, cy + bh / 2, k)], -1)
                vis = rng.integers(0, 3, k)
                xy[(vis == 0) & (rng.uniform(0, 1, k) < 0.5)] = 0.0
                pts = np.concatenate([xy, vis[:, None]], -1) if kd == 3 \
                    else xy
                rows.append(f"{rng.integers(nc)} {cx:.6f} {cy:.6f} "
                            f"{bw:.6f} {bh:.6f} "
                            + " ".join(f"{v:.6f}" for v in pts.reshape(-1)))
            name = f"{split}{i:03d}"
            with open(os.path.join(root, "images", split, name + ".png"),
                      "wb") as f:
                f.write(encode_png(img))
            with open(os.path.join(root, "labels", split, name + ".txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")


def pose_records(seed, n, kpt_shape=(17, 3)):
    """n (port, JAX) record pairs with the same pixels and labels: sides
    20..S, 0-4 boxes, each with K keypoints of kd values inside its box
    (visibility 0, 1 or 2 when kd = 3; a few invisible ones at (0, 0))."""
    rng = np.random.default_rng(seed)
    k, kd = kpt_shape
    ours, theirs = [], []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(20, S + 1, 2))
        m = int(rng.integers(0, 5))
        x1, y1 = rng.uniform(0, 0.6, m) * w, rng.uniform(0, 0.6, m) * h
        bw, bh = rng.uniform(0.1, 0.4, m) * w, rng.uniform(0.1, 0.4, m) * h
        xy = np.stack([x1[:, None] + rng.uniform(0, 1, (m, k)) * bw[:, None],
                       y1[:, None] + rng.uniform(0, 1, (m, k)) * bh[:, None]],
                      -1)
        vis = rng.integers(0, 3, (m, k, 1)).astype(float)
        xy[(vis[..., 0] == 0) & (rng.uniform(0, 1, (m, k)) < 0.5)] = 0.0
        fields = dict(
            im_file=f"{i}.png", org_shape=(h, w), resized_shape=(h, w),
            img=rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            cls=rng.integers(0, NC, m).astype(np.float32),
            bboxes=np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(
                np.float32),
            keypoints=(np.concatenate([xy, vis], -1) if kd == 3
                       else xy).astype(np.float32))
        ours.append(LabelRecord(**fields))
        theirs.append(JaxRecord(**{k_: (v.copy() if isinstance(v, np.ndarray)
                                        else v) for k_, v in fields.items()}))
    return ours, theirs


def _assert_pose_equal(got, want, atol=0.0):
    np.testing.assert_array_equal(got.cls, want.cls)
    np.testing.assert_allclose(got.bboxes, want.bboxes, atol=atol)
    assert got.keypoints.shape == want.keypoints.shape
    np.testing.assert_allclose(got.keypoints, want.keypoints, atol=atol)


# ---------------------------------------------------------------- labels
@pytest.fixture(scope="module", params=[(17, 3), (5, 2)], ids=["k17", "k5"])
def pose_root(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pose_pngs"))
    # sides up to the image size (no resize: equal pools) and one larger
    make_pose_dataset(root, 9, 4, [(64, 48), (48, 64), (64, 64), (30, 62),
                                   (96, 80)], NC, request.param, seed=3)
    return root, request.param


def _configs(root, kpt_shape=(17, 3), **kw):
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=S, batch_size=3,
                  number_class=NC, workers=1, keypoint_num=kpt_shape[0],
                  keypoint_dim=kpt_shape[1], **kw)
    return (Config(task_type=TaskType.pose,
                   scalar_type=ScalarType.float32, **common),
            JaxConfig(task_type=JaxTaskType.pose, scalar_type="float32",
                      **common))


@pytest.mark.parametrize("is_val", [False, True])
def test_load_labels_matches_jax(pose_root, is_val):
    """The pose branch of load_labels: classes and boxes (columns 1-4)
    equal, keypoints (n, K, kd) from column 5 on, scaled to resized pixels,
    equal to the JAX package's; the 96x80 images resize."""
    root, kpt_shape = pose_root
    cfg, jcfg = _configs(root, kpt_shape)
    got = load_labels(cfg, is_val=is_val)
    want = jax_load_labels(jcfg, is_val=is_val)
    assert [r.im_file for r in got] == [r.im_file for r in want]
    for g, w in zip(got, want):
        assert g.resized_shape == w.resized_shape
        assert g.rectangle_shape == w.rectangle_shape
        assert g.keypoints.shape == (len(g.cls),) + kpt_shape
        assert g.mask is None
        _assert_pose_equal(g, w)


# --------------------------------------------------------- augmentations
@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["k17", "k5"])
@pytest.mark.parametrize("name", ["letterbox", "rectangle", "flip_lr",
                                  "flip_ud"])
def test_resize_pad_and_flip_keypoints_match_jax(name, kpt_shape):
    """letterbox and rectangle shift the keypoints by their pads (the
    invisible ones at (0, 0) too), the flips mirror them without a swap of
    left and right keypoints: equal to the JAX package's, for records of
    20-64 px (the rectangle at the next 32-multiple + 16)."""
    recs, jrecs = pose_records(30, 6, kpt_shape)
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
        _assert_pose_equal(got, want)
        moved += int((got.keypoints != r.keypoints).any())
        # the transform worked on a copy
        np.testing.assert_array_equal(r.keypoints, jr.keypoints)
    assert moved >= 3


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["k17", "k5"])
@pytest.mark.parametrize("seed", range(2))
def test_mosaic4_keypoints_match_jax(seed, kpt_shape):
    """The same draws: the survivors' classes, boxes and keypoints (offset
    by their tile's pad) equal the JAX package's."""
    recs, jrecs = pose_records(10 + seed, 4, kpt_shape)
    got = augment.mosaic4(recs[0], recs[1:], S, np.random.default_rng(seed))
    want = jax_augment.mosaic4(jrecs[0], jrecs[1:], S,
                               np.random.default_rng(seed))
    _assert_pose_equal(got, want)
    assert len(got.cls) > 0


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["k17", "k5"])
@pytest.mark.parametrize("hyps", [{}, FULL_WARP], ids=["affine", "full"])
def test_random_perspective_keypoints_match_jax(hyps, kpt_shape):
    """A mosaic through random_perspective with the same rng: the warped
    keypoints (visibility 0 outside the canvas, clipped to it) and boxes
    to 1e-4 of the JAX package's."""
    recs, jrecs = pose_records(20, 4, kpt_shape)
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
    _assert_pose_equal(got, want, atol=1e-4)


# ------------------------------------------------------- collate, planner
def _same_images(ds, jds):
    """Give the port's dataset the JAX dataset's images, so that what
    follows is held without the load's resize differences (images within
    one level of cv2; tests/test_torch_data.py)."""
    for r, jr in zip(ds.records, jds.records):
        assert r.im_file == jr.im_file
        r.img = jr.img.copy()


def test_collate_keypoints_match_jax(pose_root):
    """The val collate (rectangle) and the letterbox train collate with
    flips: keypoints (B, M, K, kd) float32 normalised by the batch's
    canvas, zero in the padding slots, equal to the JAX package's, beside
    equal labels."""
    root, kpt_shape = pose_root
    cfg, jcfg = _configs(root, kpt_shape, image_process_type="letterbox",
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
            assert got["keypoints"].dtype == np.float32
            assert got["keypoints"].shape == (len(idx), ml) + kpt_shape
            assert not got["keypoints"][~got["mask_gt"]].any()
            for k in ("keypoints", "cls", "bboxes", "mask_gt"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("extras", [0, 2])
def test_device_batch_keypoints_match_jax(pose_root, extras):
    """A planned pose batch (the mosaic's defaults with the full warp and
    both flips possible): the planner's keypoints, normalised by the
    canvas, equal to the JAX package's, with the plan arrays and the pool,
    with batch-local partners and with 2 dataset-wide extras."""
    root, kpt_shape = pose_root
    cfg, jcfg = _configs(root, kpt_shape, mosaic_partner_pool=extras,
                         flip_ud=0.5, **FULL_WARP)
    ds, jds = YoloDataset(cfg), JaxDataset(jcfg)
    assert ds.use_device_augment()
    _same_images(ds, jds)
    ds.rng, jds.rng = np.random.default_rng(1), np.random.default_rng(1)
    ml = jds.max_label_count
    got = ds.device_batch(np.arange(3), ml)
    want = jds.device_batch(np.arange(3), ml)
    assert set(got) == set(want) and "keypoints" in got
    assert got["keypoints"].shape == (3, ml) + kpt_shape
    assert got["mask_gt"].any()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
