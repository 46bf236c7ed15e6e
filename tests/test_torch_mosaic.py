"""The port's mosaic path against the JAX package and cv2, on the CPU: the
host planner (equal arrays from the same rng), the torch render of a
planned batch (against jax.jit of the JAX render), apply_hsv, the host
mosaic4 and random_perspective (both exact), the cv2-free warps against
cv2 (bit for bit), YoloDataset / DataLoader under the mosaic on a
synthetic PNG dataset, one v8n train step on a planned batch, and train()
through the host mosaic."""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import make_dataset
from test_torch_train import NC, check_step_pair, step_pair
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data import augment as jax_augment
from yolosharp_tpu.data import device_augment as JDA
from yolosharp_tpu.data.dataset import YoloDataset as JaxDataset
from yolosharp_tpu.data.labels import LabelRecord as JaxRecord
from yolosharp_tpu.data.loader import DataLoader as JaxLoader
from yolosharp_tpu_torch import Config, ScalarType, YoloSize, YoloTask
from yolosharp_tpu_torch.data import DataLoader, YoloDataset, augment
from yolosharp_tpu_torch.data import device_augment as DA
from yolosharp_tpu_torch.data.image_ops import warp_affine, warp_perspective
from yolosharp_tpu_torch.data.labels import LabelRecord

S = 64
# the full warp of random_perspective: rotation, shear and perspective
FULL_WARP = dict(degrees=10.0, shear=2.0, perspective=5e-4)


class FakeRng:
    """Replays a scripted draw sequence (uniforms and integers), as
    tests/test_device_augment.py's."""

    def __init__(self, uniforms, integers):
        self.u = list(uniforms)
        self.i = list(integers)

    def uniform(self, lo=0.0, hi=1.0, size=None):
        assert size is None
        t = self.u.pop(0) if self.u else 0.5
        return lo + (hi - lo) * t

    def integers(self, lo, hi, size=None):
        if size is None:
            if not self.i:
                return lo
            v = self.i.pop(0)
            assert lo <= v < hi, (lo, v, hi)
            return v
        return np.asarray([self.integers(lo, hi) for _ in range(size)])


def _records(seed, n, kpts=False):
    """n (port, JAX) record pairs with the same pixels and labels: sides
    20..S, 0-4 boxes, and with kpts keypoints and OBB corners too."""
    rng = np.random.default_rng(seed)
    ours, theirs = [], []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(20, S + 1, 2))
        k = int(rng.integers(0, 5))
        cx, cy = rng.uniform(0.2, 0.8, k) * w, rng.uniform(0.2, 0.8, k) * h
        bw, bh = rng.uniform(0.1, 0.4, k) * w, rng.uniform(0.1, 0.4, k) * h
        fields = dict(
            im_file=f"{i}.png", org_shape=(h, w), resized_shape=(h, w),
            img=rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            cls=rng.integers(0, NC, k).astype(np.float32),
            bboxes=np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2], -1).astype(np.float32))
        if kpts:
            fields["keypoints"] = np.concatenate(
                [rng.uniform(0, 1, (k, 3, 2)) * [w, h],
                 rng.integers(0, 3, (k, 3, 1))], -1).astype(np.float32)
            fields["obb_corners"] = (rng.uniform(0, 1, (k, 4, 2))
                                     * [w, h]).astype(np.float32)
        ours.append(LabelRecord(**fields))
        theirs.append(JaxRecord(**fields))
    return ours, theirs


def _configs(**kw):
    return (Config(image_size=S, scalar_type=ScalarType.float32, **kw),
            JaxConfig(image_size=S, scalar_type="float32", **kw))


def _assert_labels_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.resized_shape == w.resized_shape
        np.testing.assert_array_equal(g.cls, w.cls)
        np.testing.assert_array_equal(g.bboxes, w.bboxes)
        for name in ("keypoints", "obb_corners"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extras", [0, 3])
def test_plan_matches_jax(extras):
    """Equal plan arrays and labels (boxes, keypoints, OBB corners) from
    the same rng, with batch-local partners in groups of 4 and with 3
    dataset-wide extras a group of 4 (mosaic_partner_pool)."""
    cfg, jcfg = _configs(flip_ud=0.5, **FULL_WARP)
    n = 8 + 2 * extras
    recs, jrecs = _records(1, n, kpts=True)
    got, labels = DA.plan_mosaic_batch(recs, cfg, np.random.default_rng(7),
                                       group=4, extras_per_group=extras)
    want, jlabels = JDA.plan_mosaic_batch(jrecs, jcfg,
                                          np.random.default_rng(7), group=4,
                                          extras_per_group=extras)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(labels) == 8
    _assert_labels_equal(labels, jlabels)


def _pool(recs):
    pool = np.full((len(recs), S, S, 3), 114, np.uint8)
    for k, r in enumerate(recs):
        h, w = r.resized_shape
        pool[k, :h, :w] = r.img
    return pool


# the hyps of the render cases: the full warp, the reference's axis-aligned
# defaults, and both flips always taken
RENDERS = {"full_warp": FULL_WARP, "axis_aligned": {},
           "flips": dict(flip_lr=1.0, flip_ud=1.0)}


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_matches_jax(name):
    """The torch render of 6 planned 64x64 images against jax.jit of the
    JAX render on the same pool and plan, float32 in [0, 255]: at most
    0.1% of the values more than 1e-2 apart (measured: none; the largest
    difference 5.5e-3 with the full warp, 2.4e-4 without, from rounding
    the sampling coordinate and HSV in another order)."""
    cfg, _ = _configs(**RENDERS[name])
    recs, _ = _records(2, 6)
    plan, _ = DA.plan_mosaic_batch(recs, cfg, np.random.default_rng(3))
    pool = _pool(recs)
    arrays = tuple(plan[:7])
    want = np.asarray(jax.jit(JDA.mosaic_perspective_images,
                              static_argnums=2)(
        jnp.asarray(pool), tuple(jnp.asarray(a) for a in arrays), S))
    got = DA.mosaic_perspective_images(
        torch.from_numpy(pool), tuple(torch.from_numpy(a) for a in arrays),
        S).numpy()
    assert got.shape == want.shape == (6, S, S, 3)
    assert got.dtype == np.float32
    d = np.abs(got - want)
    print(f"{name}: {(d > 1e-2).mean():.3e} of the values more than 1e-2 "
          f"apart, max {d.max():.3e}")
    assert (d > 1e-2).mean() <= 1e-3


def test_apply_hsv_matches_jax():
    """apply_hsv on float [0, 255] images (grays, saturated and clipped
    colours included) with per-image gains, against the JAX apply_hsv
    image by image: within 1e-3 (float32 rounding of the same formula)."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (4, 24, 24, 3)).astype(np.float32)
    img[:, :4] = img[:, :4, :, :1]                   # grays: diff == 0
    img[:, 4:8, :, 0] = 255.0                        # a saturated channel
    img[:, 8:10] = 0.0                               # black
    gains = np.stack([rng.uniform(0.6, 1.4, 4), rng.uniform(0.3, 1.7, 4),
                      rng.uniform(-0.015, 0.015, 4)], -1).astype(np.float32)
    gains[0] = (1.4, 1.7, 0.015)
    want = np.stack([np.asarray(JDA.apply_hsv(jnp.asarray(i), jnp.asarray(g)))
                     for i, g in zip(img, gains)])
    got = DA.apply_hsv(torch.from_numpy(img), torch.from_numpy(gains))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_mosaic4_matches_jax():
    """The same scripted draws: canvas, boxes, keypoints, OBB corners and
    the mosaic border equal; with segment masks on the records, the
    mosaic's overlap ids equal too (tests/test_torch_seg_data.py holds the
    segment branches in full)."""
    recs, jrecs = _records(5, 4, kpts=True)
    # centre (yc, xc) inside the canvas, so that all four tiles are cut
    got = augment.mosaic4(recs[0], recs[1:], S, FakeRng([], [50, 70]))
    want = jax_augment.mosaic4(jrecs[0], jrecs[1:], S, FakeRng([], [50, 70]))
    np.testing.assert_array_equal(got.img, want.img)
    assert got.mosaic_border == want.mosaic_border == (-S // 2, -S // 2)
    assert got.resized_shape == want.resized_shape == (2 * S, 2 * S)
    _assert_labels_equal([got], [want])
    rng = np.random.default_rng(5)
    for r, jr in zip(recs, jrecs):
        h, w = r.resized_shape
        r.mask = rng.integers(0, len(r.cls) + 1, (-(-h // 4), -(-w // 4)),
                              dtype=np.uint8)
        jr.mask = r.mask.copy()
    got = augment.mosaic4(recs[0], recs[1:], S, FakeRng([], [50, 70]))
    want = jax_augment.mosaic4(jrecs[0], jrecs[1:], S, FakeRng([], [50, 70]))
    assert got.mask.shape == want.mask.shape == (S // 2, S // 2)
    assert got.mask.max() > 0
    np.testing.assert_array_equal(got.mask, want.mask)


@pytest.mark.parametrize("hyps", [FULL_WARP, {}], ids=["full", "affine"])
def test_random_perspective_matches_jax(hyps):
    """A mosaic through random_perspective with the same rng: labels
    (boxes, keypoints, OBB corners) to 1e-4, the warped image equal to the
    JAX package's (cv2's warp there)."""
    cfg, _ = _configs(**hyps)
    recs, jrecs = _records(6, 4, kpts=True)
    src = augment.mosaic4(recs[0], recs[1:], S, np.random.default_rng(0))
    jsrc = jax_augment.mosaic4(jrecs[0], jrecs[1:], S,
                               np.random.default_rng(0))
    args = (cfg.degrees, cfg.translate, cfg.scale, cfg.shear,
            cfg.perspective)
    got = augment.random_perspective(src, *args, np.random.default_rng(1))
    want = jax_augment.random_perspective(jsrc, *args,
                                          np.random.default_rng(1))
    assert got.img.shape == want.img.shape == (S, S, 3)
    assert got.mosaic_border == (0, 0)
    np.testing.assert_array_equal(got.cls, want.cls)
    for name in ("bboxes", "keypoints", "obb_corners"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got.img, want.img)


def _warp_matrix(rng, kind):
    """A (3, 3) float64 matrix of one kind: random_perspective's draw (a
    small rotation and scale, perspective up to 5e-4), near-identity
    (sub-pixel), or strongly sheared and scaled with perspective."""
    if kind == "near_identity":
        M = np.eye(3)
        M[:2] += rng.normal(0, 1e-3, (2, 3))
        M[:2, 2] = rng.uniform(-3, 3, 2)
        M[2, :2] = rng.normal(0, 1e-6, 2)
        return M
    if kind == "sheared":
        M = np.eye(3)
        M[0, 1], M[1, 0] = rng.uniform(-1.5, 1.5, 2)
        M[:2, :2] *= rng.uniform(0.3, 2.5)
        M[:2, 2] = rng.uniform(-50, 50, 2)
        M[2, :2] = rng.uniform(-1e-3, 1e-3, 2)
        return M
    rad = math.radians(rng.uniform(-10, 10))
    sc = 1 + rng.uniform(-0.5, 0.5)
    return np.array([[math.cos(rad) * sc, math.sin(rad) * sc,
                      rng.uniform(-20, 20)],
                     [-math.sin(rad) * sc, math.cos(rad) * sc,
                      rng.uniform(-20, 20)],
                     [rng.uniform(-5e-4, 5e-4), rng.uniform(-5e-4, 5e-4), 1]])


@pytest.mark.parametrize("seed", range(4))
def test_warps_match_cv2(seed):
    """warp_affine / warp_perspective against cv2.warpAffine /
    cv2.warpPerspective (INTER_LINEAR and INTER_NEAREST) bit for bit, on
    random images of 1 and 3 channels at borders 114 and 128, with float32
    (odd seeds) and float64 matrices: random_perspective's draws,
    near-identity and strongly sheared ones. The output widths include
    ones below and off the multiples of 16, cv2's vector step (the last
    out_w % 16 pixels of a row take its scalar code)."""
    rng = np.random.default_rng(seed)
    for kind in ("augment", "near_identity", "sheared"):
        for channels in (1, 3):
            h, w = (int(v) for v in rng.integers(40, 200, 2))
            shape = (h, w, channels) if channels > 1 else (h, w)
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            ow, oh = (int(v) for v in rng.integers(50, 200, 2))
            ow = (ow, 7, 33)[int(rng.integers(3))]
            M = _warp_matrix(rng, kind)
            if seed % 2:
                M = M.astype(np.float32)
            for border in (114, 128):
                fill = (border,) * 3
                for flags, near in ((cv2.INTER_LINEAR, False),
                                    (cv2.INTER_NEAREST, True)):
                    msg = f"{kind} {channels} {border} {near}"
                    np.testing.assert_array_equal(
                        warp_affine(img, M[:2], ow, oh, border, near),
                        cv2.warpAffine(img, M[:2], (ow, oh), flags=flags,
                                       borderValue=fill), err_msg=msg)
                    np.testing.assert_array_equal(
                        warp_perspective(img, M, ow, oh, border, near),
                        cv2.warpPerspective(img, M, (ow, oh), flags=flags,
                                            borderValue=fill),
                        err_msg=msg)


# ------------------------------------------------------- dataset, loader
@pytest.fixture(scope="module")
def mosaic_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mosaic_pngs"))
    # sides at most the image size: no resize, so pools are equal
    make_dataset(root, 9, 2, [(64, 48), (48, 64), (64, 64), (32, 64)], NC,
                 seed=3)
    return root


def _data_configs(root, **kw):
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=S, batch_size=3,
                  number_class=NC, workers=1, **kw)
    return (Config(scalar_type=ScalarType.float32, **common),
            JaxConfig(scalar_type="float32", **common))


@pytest.mark.parametrize("extras", [0, 2])
def test_device_batch_and_loader_match_jax(mosaic_root, extras):
    """Under the mosaic with device_augment (the defaults): both datasets
    take the device render, and two epochs of loader batches (the planned
    batches: labels, the uint8 pool, the plan arrays) are equal to the JAX
    loader's, with batch-local partners and with 2 dataset-wide extras."""
    cfg, jcfg = _data_configs(mosaic_root, mosaic_partner_pool=extras,
                              flip_ud=0.5, **FULL_WARP)
    ds, jds = YoloDataset(cfg), JaxDataset(jcfg)
    assert ds.use_device_augment() and jds.use_device_augment()
    ml = ds.max_label_count
    assert ml == jds.max_label_count
    dl = DataLoader(ds, 3, workers=1, max_labels=ml)
    jdl = JaxLoader(jds, 3, workers=1, max_labels=ml)
    n = 0
    for _ in range(2):
        for got, want in zip(dl, jdl):
            assert set(got) == set(want)
            assert "aug_pool" in got and "images" not in got
            assert len(got["aug_pool"]) == 3 + extras
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            n += 1
    assert n == 6
    ds.close_mosaic(True)
    assert not ds.use_device_augment()


def test_get_under_the_mosaic_matches_jax(mosaic_root):
    """YoloDataset.get while the mosaic is open (mosaic4 ->
    random_perspective -> flips -> HSV on the host) against the JAX
    dataset's, same seeds: labels equal (boxes to 1e-4), images equal
    (cv2's warp and HSV in the JAX package)."""
    cfg, jcfg = _data_configs(mosaic_root, flip_ud=0.5, **FULL_WARP)
    ds, jds = YoloDataset(cfg), JaxDataset(jcfg)
    for i in range(len(ds)):
        got, want = ds.get(i), jds.get(i)
        np.testing.assert_array_equal(got.cls, want.cls)
        np.testing.assert_allclose(got.bboxes, want.bboxes, atol=1e-4)
        assert got.img.shape == want.img.shape == (S, S, 3)
        np.testing.assert_array_equal(got.img, want.img, err_msg=str(i))


def test_train_step_on_a_planned_batch_matches_jax(mosaic_root):
    """One float32 v8n step on a planned batch of the device render (the
    reference's axis-aligned default hyps): the port renders it in torch,
    the JAX step in its resolve_batch_images; held to the rules of
    tests/test_torch_train.py (loss items 1e-4, the parameter changes where
    the gradients fix AdamW's update, within one float32 spacing of the
    parameter more), BN statistics to 5e-5 of each tensor's largest: the
    two renders' images differ by up to 2.4e-4 of 255 (float32 rounding,
    test_render_matches_jax), which the batch-of-3 statistics carry to
    1.2e-5 of the largest running mean (measured)."""
    cfg, _ = _data_configs(mosaic_root)
    ds = YoloDataset(cfg)
    batch = ds.device_batch(np.arange(3), ds.max_label_count)
    check_step_pair(step_pair("v8", batch), ulp=True, stats_rtol=5e-5)


def test_train_takes_the_host_mosaic(tmp_path, monkeypatch):
    """train() on the CPU with device_augment=False and mosaic=0.5: the
    host mosaic (mosaic4 + random_perspective) and letterbox both serve
    epoch 1, nothing is rendered on the device, losses are finite and the
    weights are written."""
    root = str(tmp_path / "data")
    make_dataset(root, 4, 2, [(64, 48), (48, 64), (64, 64)], NC, seed=2)
    calls = {"mosaic4": 0, "letterbox": 0, "render": 0}

    def counted(module, name, key):
        real = getattr(module, name)

        def fn(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(module, name, fn)

    counted(augment, "mosaic4", "mosaic4")
    counted(augment, "letterbox", "letterbox")
    counted(DA, "render_batch", "render")
    cfg = Config(root_path=root, train_data_path="images/train",
                 val_data_path="images/val", output_path=str(tmp_path / "o"),
                 image_size=S, batch_size=2, epochs=1, workers=1,
                 yolo_size=YoloSize.n, number_class=NC,
                 scalar_type=ScalarType.float32, close_mosaic=1,
                 device_augment=False, mosaic=0.5)
    task = YoloTask(cfg, device="cpu")
    task.train()
    assert calls["mosaic4"] > 0 and calls["letterbox"] > 0
    assert calls["render"] == 0
    assert (tmp_path / "o" / "weights" / "best.bin").exists()
    rows = (tmp_path / "o" / "log.csv").read_text().strip().splitlines()
    assert len(rows) == 2 and "nan" not in rows[1].lower()
