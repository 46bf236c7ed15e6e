"""The classify task's data path in the port against cv2 5.0 and the JAX
package, on the CPU: resize_linear and resize_linear_f32 bit for bit
against cv2.resize (INTER_LINEAR) at the classify sizes, the cv2-free
GaussianBlur / equalizeHist / getRotationMatrix2D bit for bit, warp_affine
at border 128 bit for bit, every op of classify_augment and
the AutoAugment / RandAugment / AugMix / RandomErasing policies against the
JAX module on the same image and generator, and ClassificationDataset
(train and val get, collate, classes) against the JAX dataset on a PNG
folder-per-class set."""

import os

import cv2
import numpy as np
import pytest
import torch

from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data import classify_augment as JCA
from yolosharp_tpu.data.dataset import ClassificationDataset as JaxDataset
from yolosharp_tpu.types import AutoAugmentType as JaxAAT
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu_torch import Config, TaskType
from yolosharp_tpu_torch.data import ClassificationDataset, DataLoader
from yolosharp_tpu_torch.data import classify_augment as CA
from yolosharp_tpu_torch.data.image_ops import (encode_png, equalize_hist_u8,
                                                gaussian_blur3_u8,
                                                resize_linear,
                                                resize_linear_f32,
                                                rotation_matrix_2d,
                                                warp_affine)
from yolosharp_tpu_torch.types import AutoAugmentType

S = 64
NC = 5
# (source, destination) sizes of the classify path: the RandomResizedCrop
# squash, the val short side and the predict squash, down- and upscales
RESIZES = [((480, 640), (224, 298)), ((500, 375), (298, 224)),
           ((448, 448), (224, 224)), ((224, 224), (112, 112)),
           ((100, 150), (224, 224)), ((57, 91), (224, 224)),
           ((640, 480), (224, 224)), ((5, 7), (3, 2))]


def smooth_image(h, w, seed):
    """Smooth blobs plus noise, uint8 RGB: structure for every op."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(low, np.ones((8, 8, 1)))[:h, :w]
    img = img + rng.normal(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_cls_dataset(root, n_train, n_val, nc, sizes=(40, 100), seed=0):
    """A folder-per-class PNG set under root/{train,val}/class{c}: each
    class one pattern (stripes of its own period and colour) over noise,
    n_train / n_val images a class of sizes[0]..sizes[1] px a side."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(nc):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d, exist_ok=True)
            colour = np.random.default_rng(100 + c).integers(0, 256, 3)
            for i in range(n):
                h, w = (int(v) for v in rng.integers(*sizes, 2))
                img = rng.normal(128, 30, (h, w, 3))
                img[:, ::c + 2] = colour
                img = np.clip(img, 0, 255).astype(np.uint8)
                with open(os.path.join(d, f"{i:03d}.png"), "wb") as f:
                    f.write(encode_png(img))


def cls_configs(root, aat="autoaugment", **kw):
    """(the port's Config, the JAX Config) of the classify task on a set at
    S px; kw: plain values (no enums) for both."""
    common = dict(root_path=root, train_data_path="train",
                  val_data_path="val", image_size=S, number_class=NC, **kw)
    return (Config(task_type=TaskType.classify,
                   auto_augment=AutoAugmentType(aat), **common),
            JaxConfig(task_type=JaxTaskType.classify,
                      auto_augment=JaxAAT(aat), **common))


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_linear_matches_cv2(src, dst, channels):
    """uint8 (H, W) and (H, W, 3) images: equal to cv2.resize INTER_LINEAR."""
    rng = np.random.default_rng(sum(src) + (channels or 0))
    img = rng.integers(0, 256, src + ((channels,) if channels else ()),
                       dtype=np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear(img, *dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("src,dst", RESIZES + [((40, 30), (640, 480)),
                                               ((160, 160), (483, 640))])
def test_resize_linear_f32_within_one_rounding_of_cv2(src, dst, binary):
    """float32 (H, W) in [0, 1] (uniform, or the 0 / 1 masks the segment
    stream resizes), and one-pixel rows and columns (cv2 takes its own
    resize there, IPP's elsewhere): equal to cv2.resize INTER_LINEAR; a
    (2, H, W) stack resizes each map as alone."""
    rng = np.random.default_rng(sum(src))
    img = rng.uniform(0, 1, src).astype(np.float32)
    if binary:
        img = (img > 0.5).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear_f32(torch.from_numpy(img), *dst).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for line in (img[:1], img[:, :1]):
        np.testing.assert_array_equal(
            resize_linear_f32(torch.from_numpy(line), *dst).numpy(),
            cv2.resize(line, dst[::-1], interpolation=cv2.INTER_LINEAR)
            .reshape(dst))
    # a stack of maps: each resized as alone
    both = resize_linear_f32(torch.from_numpy(np.stack([img, 1 - img])),
                             *dst).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(
        both[1], resize_linear_f32(torch.from_numpy(1 - img), *dst).numpy())


@pytest.mark.parametrize("shape", [(64, 64, 3), (7, 9, 3), (1, 5, 3),
                                   (33, 17), (2, 2, 3)])
def test_gaussian_blur3_matches_cv2(shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    np.testing.assert_array_equal(gaussian_blur3_u8(img),
                                  cv2.GaussianBlur(img, (3, 3), 0))


@pytest.mark.parametrize("levels", [None, 1, 2, 7])
def test_equalize_hist_matches_cv2(levels):
    """Random, one-level (left as it is), two- and seven-level images, and
    a smooth one."""
    rng = np.random.default_rng(levels or 0)
    for img in (rng.integers(0, 256, (48, 64), dtype=np.uint8)
                if levels is None
                else rng.integers(100, 100 + levels, (48, 64),
                                  dtype=np.uint8),
                smooth_image(40, 56, 1)[..., 0]):
        np.testing.assert_array_equal(equalize_hist_u8(img),
                                      cv2.equalizeHist(img))


def test_rotation_matrix_matches_cv2():
    for angle in (0.0, 30.0, -27.3, 90.0, 13.333, -180.0):
        for centre in ((112.0, 80.5), (32, 32), (0.1, 1e3)):
            np.testing.assert_array_equal(
                rotation_matrix_2d(centre, angle, 1.0),
                cv2.getRotationMatrix2D(centre, angle, 1.0))


@pytest.mark.parametrize("seed", range(3))
def test_warp_affine_border_128_matches_cv2(seed):
    """The shear / translate / rotate matrices of classify_augment at border
    128, on 3-channel and 1-channel images: equal to cv2.warpAffine."""
    img = smooth_image(61, 83, seed)
    h, w = img.shape[:2]
    for m in (np.float32([[1, 0.27, 0], [0, 1, 0]]),
              np.float32([[1, 0, 0], [-0.19, 1, 0]]),
              np.float32([[1, 0, 0.4533 * w], [0, 1, 0]]),
              cv2.getRotationMatrix2D((w / 2, h / 2), 23.0 + seed, 1.0)):
        for x in (img, img[..., seed]):
            want = cv2.warpAffine(x, m, (w, h), borderValue=(128, 128, 128))
            np.testing.assert_array_equal(
                warp_affine(x, m, w, h, border=128), want)


@pytest.mark.parametrize("name", list(JCA._OPS))
def test_op_matches_jax(name):
    """Each _OPS entry at four magnitudes of its range (both signs where
    signed) on images of three sizes: equal to the JAX op."""
    assert list(CA._OPS) == list(JCA._OPS)
    fn, (lo, hi), signed = JCA._OPS[name]
    assert CA._OPS[name][1:] == ((lo, hi), signed)
    for seed, (h, w) in enumerate(((64, 64), (57, 91), (224, 160))):
        img = smooth_image(h, w, seed)
        for m in np.linspace(lo, hi, 4):
            for sign in ((1, -1) if signed else (1,)):
                want = fn(img, sign * m)
                got = CA._OPS[name][0](img, sign * m)
                assert got.shape == want.shape and got.dtype == np.uint8
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("policy", ["auto_augment", "rand_augment",
                                    "augmix", "random_erasing"])
def test_policy_matches_jax(policy):
    """40 images, each with a fresh generator of its own seed in both
    packages: the same ops drawn (both generators end in the same state)
    and the same images."""
    for seed in range(40):
        img = smooth_image(S, S, seed)
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        want = getattr(JCA, policy)(img, rj)
        got = getattr(CA, policy)(img, rp)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(seed))
        assert rj.bit_generator.state == rp.bit_generator.state


@pytest.fixture(scope="module")
def cls_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cls"))
    make_cls_dataset(root, 4, 2, NC)
    return root


@pytest.mark.parametrize("aat", ["autoaugment", "randaugment", "augmix",
                                 "none"])
def test_train_get_matches_jax(cls_root, aat):
    """ClassificationDataset.get of the train split, called in sequence (the
    loader's threads share the generator, so its order is not fixed) on a
    fresh dataset of seed 0 in both packages: the same classes and sample
    order, each image (s, s, 3) and equal, the generators in the same
    state after."""
    cfg, jcfg = cls_configs(cls_root, aat)
    ds, jds = ClassificationDataset(cfg), JaxDataset(jcfg)
    assert len(ds) == len(jds) == 4 * NC
    assert ds.classes == jds.classes == [f"class{c}" for c in range(NC)]
    assert [(os.path.basename(p), c) for p, c in ds.samples] == \
        [(os.path.basename(p), c) for p, c in jds.samples]
    assert ds.max_label_count == 1 and not ds.use_device_augment()
    for i in range(len(ds)):
        got, want = ds.get(i), jds.get(i)
        assert got["cls"] == want["cls"]
        assert got["image"].shape == want["image"].shape == (S, S, 3)
        np.testing.assert_array_equal(got["image"], want["image"])
    assert ds.rng.bit_generator.state == jds.rng.bit_generator.state


def test_val_get_and_collate_match_jax(cls_root):
    """The val split (short side to s, centre crop) equal to the JAX
    dataset's, the collate's images and int32 classes equal, and the
    port's DataLoader gives the collated batches of the set in order, the
    last padded with repeats."""
    cfg, jcfg = cls_configs(cls_root)
    ds = ClassificationDataset(cfg, is_val=True)
    jds = JaxDataset(jcfg, is_val=True)
    items = [ds.get(i) for i in range(len(ds))]
    jitems = [jds.get(i) for i in range(len(jds))]
    got, want = ds.collate(items, 1), jds.collate(jitems, 1)
    assert set(got) == set(want) == {"images", "cls"}
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["cls"], want["cls"])
    assert got["cls"].dtype == np.int32
    batches = list(DataLoader(ds, 3, shuffle=False, workers=2))
    assert len(batches) == -(-len(ds) // 3)
    for b, batch in enumerate(batches):
        idx = np.arange(3 * b, min(3 * b + 3, len(ds)))
        idx = np.concatenate([idx, np.resize(idx, 3 - len(idx))])
        np.testing.assert_array_equal(batch["images"], got["images"][idx])
        np.testing.assert_array_equal(batch["cls"], got["cls"][idx])


def test_missing_split_warns_and_falls_back(cls_root, capsys):
    """A split folder that does not exist: the WARNING the JAX dataset
    prints, and the root folder's images (both splits) in its place."""
    cfg, _ = cls_configs(cls_root)
    cfg.val_data_path = "absent"
    ds = ClassificationDataset(cfg, is_val=True)
    assert "WARNING: classification split 'absent' not found" in \
        capsys.readouterr().out
    assert len(ds) == NC * 6
