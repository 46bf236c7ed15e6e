"""The port's cv2-free data path against cv2 and the JAX package: the PNG
reader (equal to cv2.imread), resize_linear (equal to cv2.resize), the
OpenCV 8-bit HSV pair and random_hsv, YoloDataset + DataLoader on a
synthetic PNG dataset (labels, mask_gt and shapes equal, pixels within the
HSV bound), bucket_shapes and utils/metrics."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data import augment as jax_augment
from yolosharp_tpu.data.dataset import YoloDataset as JaxDataset
from yolosharp_tpu.data.labels import LabelRecord as JaxRecord
from yolosharp_tpu.data.labels import bucket_shapes as jax_bucket_shapes
from yolosharp_tpu.data.loader import DataLoader as JaxLoader
from yolosharp_tpu.types import ImageProcessType as JaxIPT
from yolosharp_tpu.utils import metrics as jax_metrics
from yolosharp_tpu_torch import Config, ScalarType
from yolosharp_tpu_torch.data import DataLoader, YoloDataset, augment
from yolosharp_tpu_torch.data.image_ops import (decode_png_rgb, encode_png,
                                                hsv_to_rgb_u8,
                                                read_image_rgb,
                                                resize_linear, rgb_to_hsv_u8)
from yolosharp_tpu_torch.data.labels import LabelRecord, bucket_shapes
from yolosharp_tpu_torch.types import ImageProcessType
from yolosharp_tpu_torch.utils import metrics



def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img):
    """An 8-bit RGB PNG with filter type 0 (None) on every row."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))


def make_dataset(root, n_train, n_val, sizes, nc, seed=0):
    """Solid-colour images with 1-8 solid rectangles and their YOLO txt
    labels, as PNG files under root/images/{train,val} (the port's
    encode_png: adaptive row filters)."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(root, "labels", split), exist_ok=True)
        for i in range(n):
            h, w = sizes[rng.integers(len(sizes))]
            img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
            img = np.clip(img + rng.normal(0, 8, img.shape), 0,
                          255).astype(np.uint8)
            rows = []
            for _ in range(rng.integers(1, 9)):
                bw, bh = rng.uniform(0.1, 0.5, 2)
                cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(
                    bh / 2, 1 - bh / 2)
                x1, x2 = int((cx - bw / 2) * w), int((cx + bw / 2) * w)
                y1, y2 = int((cy - bh / 2) * h), int((cy + bh / 2) * h)
                img[y1:y2, x1:x2] = rng.integers(0, 256, 3)
                rows.append(f"{rng.integers(nc)} {cx:.6f} {cy:.6f} "
                            f"{bw:.6f} {bh:.6f}")
            name = f"{split}{i:03d}"
            with open(os.path.join(root, "images", split, name + ".png"),
                      "wb") as f:
                f.write(encode_png(img))
            with open(os.path.join(root, "labels", split, name + ".txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")


def _filters(path):
    """The set of row filter types in a PNG file."""
    data = open(path, "rb").read()
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + length])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    w, h, _, color = header[:4]
    stride = w * {0: 1, 2: 3, 6: 4}[color] + 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, stride)[:, 0].tolist())


def _photo(rng, h, w, c):
    low = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, c))
    img = np.kron(low, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def test_png_reader_equals_cv2(tmp_path):
    """Gray, RGB and RGBA files that cv2 writes at every compression level
    (libpng's adaptive filters: Sub, Up, Average, Paeth) and one with
    filter None read exactly as cv2.imread(IMREAD_COLOR) reads them."""
    rng = np.random.default_rng(0)
    seen = set()
    paths = []
    for ch in (1, 3, 4):
        for level in range(10):
            img = _photo(rng, 37, 53, ch)
            p = str(tmp_path / f"c{ch}_{level}.png")
            cv2.imwrite(p, img[..., 0] if ch == 1 else img,
                        [cv2.IMWRITE_PNG_COMPRESSION, level])
            paths.append(p)
    p = str(tmp_path / "none.png")
    write_png(p, _photo(rng, 29, 31, 3))
    paths.append(p)
    for p in paths:
        want = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(decode_png_rgb(open(p, "rb").read(), p),
                                      want)
        np.testing.assert_array_equal(read_image_rgb(p), want)
        seen |= _filters(p)
    assert seen == {0, 1, 2, 3, 4}


def test_png_reader_refuses_what_it_cannot_read(tmp_path):
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="a.jpg: not a PNG"):
        decode_png_rgb(open(jpg, "rb").read(), jpg)
    bad = str(tmp_path / "bad.png")
    data = bytearray(encode_png(np.zeros((8, 8, 3), np.uint8)))
    data[data.index(b"IDAT") + 6] ^= 0x55          # inside the zlib stream
    with open(bad, "wb") as f:
        f.write(data)
    assert cv2.imread(bad) is None
    with pytest.raises(ValueError,
                       match="bad.png: PNG chunk IDAT is corrupt") as err:
        decode_png_rgb(open(bad, "rb").read(), bad)
    assert isinstance(err.value, FileNotFoundError)
    with pytest.raises(FileNotFoundError, match="missing.png"):
        read_image_rgb(str(tmp_path / "missing.png"))


def _filter_bytes(img, ftypes):
    """The filtered scanlines of an 8-bit image (H, W, C), row y filtered
    by ftypes[y], byte by byte as the PNG spec (9.2-9.4) writes them."""
    h, w, bpp = img.shape
    x = img.reshape(h, w * bpp).astype(int)
    raw = bytearray()
    for y in range(h):
        raw.append(int(ftypes[y]))
        for i in range(w * bpp):
            a = int(x[y, i - bpp]) if i >= bpp else 0
            b = int(x[y - 1, i]) if y else 0
            c = int(x[y - 1, i - bpp]) if y and i >= bpp else 0
            p = a + b - c
            paeth = (a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c)
                     else b if abs(p - b) <= abs(p - c) else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ftypes[y]]
            raw.append((int(x[y, i]) - pred) % 256)
    return bytes(raw)


def _filtered_png(img, ftypes):
    h, w, bpp = img.shape
    color = {1: 0, 3: 2, 4: 6}[bpp]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(_filter_bytes(img, ftypes), 6))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_takes_any_row_filter_mix(tmp_path, channels):
    """Every filter after every other (runs, alternation, Average and Paeth
    in the first row and column) decodes to the image, as cv2.imread reads
    it; 1-pixel-wide and 1-row images too."""
    rng = np.random.default_rng(channels)
    for h, w in ((25, 31), (7, 1), (1, 9)):
        img = _photo(rng, h, w, channels)
        ftypes = rng.integers(0, 5, h)
        ftypes[:min(h, 5)] = np.arange(5)[:min(h, 5)][::-1]
        p = str(tmp_path / f"c{channels}_{h}x{w}.png")
        with open(p, "wb") as f:
            f.write(_filtered_png(img, ftypes))
        want = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        got = decode_png_rgb(open(p, "rb").read(), p)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.repeat(img, 3, 2) if channels == 1 else img[..., :3])


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_encode_png_round_trips_through_cv2(tmp_path, channels):
    """encode_png's files read back as the image, by cv2.imread and by the
    port, and each row's filter has the least sum of signed bytes."""
    rng = np.random.default_rng(10 + channels)
    img = _photo(rng, 40, 56, channels)
    img[5:20, 10:30] = rng.integers(0, 256, channels)
    data = encode_png(img[..., 0] if channels == 1 else img)
    p = str(tmp_path / "a.png")
    with open(p, "wb") as f:
        f.write(data)
    want = np.repeat(img, 3, 2) if channels == 1 else img[..., :3]
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB), want)
    np.testing.assert_array_equal(decode_png_rgb(data, p), want)
    assert len(_filters(p)) > 1
    chosen = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:]),
                           np.uint8).reshape(40, -1)[:, 0]
    costs = np.stack([np.abs(np.frombuffer(_filter_bytes(img, [f] * 40),
                                           np.int8).reshape(40, -1)[:, 1:]
                             .astype(int)).sum(1) for f in range(5)], 1)
    np.testing.assert_array_equal(costs[np.arange(40), chosen],
                                  costs.min(1))


@pytest.mark.parametrize("src,dst", [((100, 77), (64, 48)),
                                     ((37, 53), (50, 91)),
                                     ((480, 640), (48, 64)),
                                     ((40, 30), (640, 480)),
                                     ((448, 448), (224, 224)),
                                     ((57, 91), (224, 224)),
                                     ((640, 480), (224, 224))])
def test_resize_linear_within_one_level_of_cv2(src, dst):
    """resize_linear equals cv2.resize(INTER_LINEAR) bit for bit on a
    3-channel uint8 image (cv2's 11-bit fixed-point weights; the name dates
    from the float resize it replaced, which was within one level): down-
    and upscales, the exact 2x downscale among them."""
    rng = np.random.default_rng(sum(src))
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear(img, *dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_hsv_pair_matches_opencv():
    """Every 8-bit RGB colour to HSV exactly; HSV to RGB over every valid
    (h, s, v) exactly, in rows of one pixel (cv2's scalar loop, which
    rounds), of 1280 (its vector loop, which truncates) and of 45 (both:
    the last 45 % 32 pixels of a row take the scalar loop)."""
    axes = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                       indexing="ij")
    rgb = np.stack(axes, -1).reshape(-1, 1, 3).astype(np.uint8)
    np.testing.assert_array_equal(rgb_to_hsv_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = rgb.copy()
    hsv = hsv[hsv[..., 0] < 180].reshape(-1, 1, 3)
    for w in (1, 1280, 45):
        rows = hsv[:len(hsv) // w * w].reshape(-1, w, 3)
        np.testing.assert_array_equal(
            hsv_to_rgb_u8(rows), cv2.cvtColor(rows, cv2.COLOR_HSV2RGB),
            err_msg=str(w))


def test_random_hsv_and_flips_match_jax():
    """Same rng draws, same boxes, same pixels."""
    rng_img = np.random.default_rng(5)
    img = _photo(rng_img, 48, 64, 3)
    boxes = np.array([[3, 4, 30, 40], [10, 0, 64, 12]], np.float32)
    cls = np.array([1, 2], np.float32)
    rec = LabelRecord("x", img=img, cls=cls, bboxes=boxes,
                      resized_shape=(48, 64))
    jrec = JaxRecord("x", img=img, cls=cls, bboxes=boxes,
                     resized_shape=(48, 64))
    for seed in range(3):
        got = augment.random_hsv(rec, 0.015, 0.7, 0.4,
                                 np.random.default_rng(seed))
        want = jax_augment.random_hsv(jrec, 0.015, 0.7, 0.4,
                                      np.random.default_rng(seed))
        np.testing.assert_array_equal(got.img, want.img)
    for fn in ("flip_lr", "flip_ud"):
        got, want = getattr(augment, fn)(rec), getattr(jax_augment, fn)(jrec)
        np.testing.assert_array_equal(got.img, want.img)
        np.testing.assert_array_equal(got.bboxes, want.bboxes)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pngs"))
    # sides at most the image size (64): no resize, so the pixels differ
    # from the JAX pipeline only by the HSV round trip
    make_dataset(root, 7, 5, [(64, 48), (48, 64), (64, 64), (32, 64)], 3)
    return root


def _configs(root, **kw):
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=64, batch_size=3,
                  number_class=3, workers=1, **kw)
    return (Config(scalar_type=ScalarType.float32, **common),
            JaxConfig(scalar_type="float32", **common))


@pytest.mark.parametrize("is_val", [False, True])
def test_dataset_and_loader_match_jax(dataset_root, is_val):
    """Two epochs of shuffled train batches (letterbox, flips, HSV) or one
    of val batches (rectangle shapes): labels, mask_gt and shapes equal,
    images equal."""
    cfg, jcfg = _configs(dataset_root, flip_ud=0.5)
    cfg.image_process_type = ImageProcessType.letterbox
    jcfg.image_process_type = JaxIPT.letterbox
    ds, jds = YoloDataset(cfg, is_val=is_val), JaxDataset(jcfg, is_val=is_val)
    assert ds.max_label_count == jds.max_label_count
    dl = DataLoader(ds, 3, shuffle=not is_val, workers=1,
                    max_labels=ds.max_label_count)
    jdl = JaxLoader(jds, 3, shuffle=not is_val, workers=1,
                    max_labels=jds.max_label_count)
    n = 0
    for _ in range(1 if is_val else 2):
        for got, want in zip(dl, jdl):
            assert set(got) == {"images", "cls", "bboxes", "mask_gt"}
            for k in ("cls", "mask_gt"):
                np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_allclose(got["bboxes"], want["bboxes"],
                                       atol=1e-6)
            assert got["images"].shape == want["images"].shape
            np.testing.assert_array_equal(got["images"], want["images"])
            n += 1
    assert n == (2 if is_val else 6)


def test_max_label_count_and_mosaic_close(dataset_root):
    """The mosaic quadruples the label slots until close_mosaic; get(0)
    under the mosaic (mosaic4 -> random_perspective -> flips -> HSV) equals
    the JAX dataset's: labels equal (boxes to 1e-4), pixels equal (the
    warp and the HSV round trip are cv2's to the bit)."""
    cfg, jcfg = _configs(dataset_root)
    ds, jds = YoloDataset(cfg), JaxDataset(jcfg)
    n_open = ds.max_label_count
    assert n_open == jds.max_label_count
    got, want = ds.get(0), jds.get(0)
    np.testing.assert_array_equal(got.cls, want.cls)
    np.testing.assert_allclose(got.bboxes, want.bboxes, atol=1e-4)
    assert got.img.shape == want.img.shape == (64, 64, 3)
    np.testing.assert_array_equal(got.img, want.img)
    ds.close_mosaic(True)
    jds.close_mosaic(True)
    assert ds.max_label_count == jds.max_label_count < n_open
    ds.get(0)


def test_bucket_shapes_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        shapes = [tuple(int(v) for v in rng.choice([320, 352, 384, 416, 448,
                                                    640], 2))
                  for _ in range(rng.integers(1, 12))]
        for k in (0, 1, 2, 4):
            assert bucket_shapes(shapes, k) == jax_bucket_shapes(shapes, k)


def test_metrics_equal_jax():
    """match_predictions, ap_per_class and summarize on random predictions:
    equal to the JAX package's."""
    rng = np.random.default_rng(2)
    for _ in range(5):
        n_pred, n_gt = rng.integers(1, 60), rng.integers(1, 20)
        iou = rng.uniform(0, 1, (n_gt, n_pred)).astype(np.float32)
        iou[iou < 0.4] = 0
        pc = rng.integers(0, 4, n_pred).astype(float)
        tc = rng.integers(0, 4, n_gt).astype(float)
        tp = metrics.match_predictions(pc, tc, iou)
        np.testing.assert_array_equal(
            tp, jax_metrics.match_predictions(pc, tc, iou))
        conf = rng.uniform(0, 1, n_pred)
        got = metrics.ap_per_class(tp, conf, pc, tc)
        want = jax_metrics.ap_per_class(tp, conf, pc, tc)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert metrics.summarize(got) == jax_metrics.summarize(want)
