"""The port's cv2-free PNG and TIFF readers against cv2 5.0 on the CPU, bit
for bit against cv2.imread(IMREAD_COLOR) -> RGB: every PNG colour type and
bit depth, Adam7 or not, every row filter; TIFF strips and tiles, both
planar configurations, both byte orders, none / LZW (current and old-style
codes) / Deflate / PackBits, the predictor, gray (min-is-black and -white,
1 / 8 / 16 bits), palette, RGB (8 / 16 bits), extra samples and
unassociated alpha, Orientation 1-4 (5-8 raise, where cv2.imread returns
None); the files cv2 and PIL write, those that tests/data_torch/images/
writers.py writes where neither does, the committed fixtures against
their manifest, the kinds that still raise (cv2 returns None for them),
the ones that no longer do, and a detect set of mixed formats loaded as
the JAX package's loader loads it (cv2 there)."""

import hashlib
import io
import itertools
import json
import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_data import make_dataset
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data.labels import load_labels as jax_load_labels
from yolosharp_tpu_torch import Config
from yolosharp_tpu_torch.data.image_ops import decode_png_rgb, read_image_rgb
from yolosharp_tpu_torch.data.labels import load_labels
from yolosharp_tpu_torch.data.tiff import decode_tiff_rgb

FIXTURES = os.path.join(os.path.dirname(__file__), "data_torch", "images")
sys.path.insert(0, FIXTURES)
from writers import write_png, write_tiff  # noqa: E402

# (colour type, bit depth, samples a pixel) of every standard PNG kind
PNG_KINDS = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1),
             (2, 8, 3), (2, 16, 3), (3, 1, 1), (3, 2, 1), (3, 4, 1),
             (3, 8, 1), (4, 8, 2), (4, 16, 2), (6, 8, 4), (6, 16, 4)]
SIZES = [(1, 1), (3, 5), (17, 10), (33, 47)]   # (h, w)


def cv2_rgb(path):
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _samples(rng, h, w, c, depth, smooth):
    """Random samples, or a smooth ramp, below 2**depth."""
    top = 1 << depth
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w]
        ramp = (xx * 7 + yy * 5)[..., None] + np.arange(c) * 3
        v = ramp * top // (7 * w + 5 * h + 3 * c)
    else:
        v = rng.integers(0, top, (h, w, c))
    return v.astype(np.uint16 if depth == 16 else np.uint8)


_FILE_NUMBER = itertools.count()


def _read_both(tmp_path, data, name):
    """(path, cv2.imread -> RGB or None) of data written to a new file
    (rewriting a file in place is slow on some file systems)."""
    path = str(tmp_path / f"{next(_FILE_NUMBER)}_{name}")
    with open(path, "wb") as f:
        f.write(data)
    return path, cv2_rgb(path)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("kind", PNG_KINDS,
                         ids=lambda k: f"type{k[0]}_{k[1]}bit")
def test_png_kind_matches_cv2(tmp_path, kind, interlace):
    """Every PNG colour type at every bit depth, Adam7-interlaced or not,
    random and smooth samples at odd sizes, random row filters (a palette
    of fewer entries than the indices reach: libpng's 256 slots, zero
    filled): read_image_rgb equal to cv2.imread -> RGB."""
    color, depth, c = kind
    rng = np.random.default_rng(depth * 10 + color + interlace)
    for (h, w), smooth in itertools.product(SIZES, (False, True)):
        s = _samples(rng, h, w, c, depth, smooth)
        pal = (rng.integers(0, 256, (min(1 << depth, 200), 3))
               if color == 3 else None)
        data = write_png(s, depth, color, interlace, pal, seed=h + w)
        path, want = _read_both(tmp_path, data, f"{h}x{w}{smooth}.png")
        assert want is not None
        np.testing.assert_array_equal(read_image_rgb(path), want,
                                      err_msg=f"{h}x{w} smooth={smooth}")


@pytest.mark.parametrize("kind", ["palette_trns", "palette_4bit",
                                  "palette_1bit", "gray_alpha", "bilevel",
                                  "rgb16_cv2", "gray16_cv2", "rgba16_cv2"])
def test_png_that_cv2_and_pil_write(tmp_path, kind):
    """PNGs that PIL (paletted with tRNS, 4- and 1-bit palettes, gray +
    alpha, 1-bit) and cv2 (16-bit gray, RGB and RGBA) write: equal to
    cv2.imread -> RGB."""
    rng = np.random.default_rng(len(kind))
    img = rng.integers(0, 256, (29, 43, 3), dtype=np.uint8)
    bio = io.BytesIO()
    if kind == "palette_trns":
        Image.fromarray(img).quantize(100).save(
            bio, "PNG", transparency=bytes(range(100)))
    elif kind.startswith("palette"):
        bits = 4 if kind == "palette_4bit" else 1
        Image.fromarray(img).quantize(1 << bits).save(bio, "PNG", bits=bits)
    elif kind == "gray_alpha":
        Image.fromarray(img[..., :2], "LA").save(bio, "PNG")
    elif kind == "bilevel":
        Image.fromarray(img[..., 0] > 100).save(bio, "PNG")
    else:
        c = {"rgb16_cv2": 3, "gray16_cv2": 1, "rgba16_cv2": 4}[kind]
        wide = rng.integers(0, 65536, (29, 43, c), dtype=np.uint16)
        bio.write(cv2.imencode(".png", wide[..., 0] if c == 1 else wide)[1])
    path, want = _read_both(tmp_path, bio.getvalue(), "a.png")
    np.testing.assert_array_equal(read_image_rgb(path), want)
    np.testing.assert_array_equal(decode_png_rgb(bio.getvalue()), want)


# (compression, predictor): the codecs, the predictor where they take one
CODECS = [(1, 1), (5, 1), (5, 2), (8, 1), (8, 2), (32946, 2), (32773, 1)]


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("layout", ["strip", "strips_of_5", "tiles_16",
                                    "tiles_32x16", "planar_strips",
                                    "planar_tiles"])
@pytest.mark.parametrize("codec", CODECS, ids=lambda c: f"c{c[0]}p{c[1]}")
def test_tiff_rgb_layouts_match_cv2(tmp_path, codec, layout, big_endian):
    """8-bit RGB TIFFs in every layout, codec and byte order, at sizes with
    and without partial edge tiles, Orientation 1-4: read_image_rgb equal to
    cv2.imread -> RGB (the predictor differences each row of a strip or
    tile)."""
    compression, predictor = codec
    rng = np.random.default_rng(compression + predictor + len(layout))
    kw = dict(compression=compression, predictor=predictor,
              big_endian=big_endian,
              planar=2 if layout.startswith("planar") else 1)
    if "tiles" in layout:
        kw["tile"] = (32, 16) if layout == "tiles_32x16" else (16, 16)
    elif layout != "strip":
        kw["rows_per_strip"] = 5
    for (h, w), orientation in itertools.product(((13, 17), (40, 33)),
                                                 (1, 2, 3, 4)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = write_tiff(img, orientation=orientation, **kw)
        path, want = _read_both(tmp_path, data, "a.tif")
        assert want is not None
        np.testing.assert_array_equal(read_image_rgb(path), want,
                                      err_msg=f"{h}x{w} o{orientation}")


TIFF_SAMPLE_KINDS = {
    # name: (samples (h, w, s) from rng, write_tiff keywords)
    "gray8": (lambda r: r.integers(0, 256, (11, 19, 1)), dict()),
    "gray8_miniswhite": (lambda r: r.integers(0, 256, (11, 19, 1)),
                         dict(photometric=0)),
    "gray16": (lambda r: r.integers(0, 65536, (11, 19, 1)), dict(bits=16)),
    "gray16_miniswhite_mm": (lambda r: r.integers(0, 65536, (11, 19, 1)),
                             dict(bits=16, photometric=0, big_endian=True,
                                  compression=5, predictor=2)),
    "bilevel": (lambda r: r.integers(0, 2, (11, 19, 1)), dict(bits=1)),
    "bilevel_miniswhite_tiles": (lambda r: r.integers(0, 2, (37, 20, 1)),
                                 dict(bits=1, photometric=0, tile=(16, 16),
                                      compression=32773)),
    "palette1": (lambda r: r.integers(0, 2, (11, 19, 1)),
                 dict(bits=1, photometric=3, colormap="16")),
    "palette4": (lambda r: r.integers(0, 16, (11, 19, 1)),
                 dict(bits=4, photometric=3, colormap="16", compression=5)),
    "palette8": (lambda r: r.integers(0, 256, (11, 19, 1)),
                 dict(bits=8, photometric=3, colormap="16", compression=8)),
    "palette8_8bit_colormap": (lambda r: r.integers(0, 256, (11, 19, 1)),
                               dict(bits=8, photometric=3, colormap="8")),
    "rgb16": (lambda r: r.integers(0, 65536, (9, 14, 3)), dict(bits=16)),
    "rgb16_lzw_pred_mm": (lambda r: r.integers(0, 65536, (9, 14, 3)),
                          dict(bits=16, compression=5, predictor=2,
                               big_endian=True)),
    "rgba_no_extra": (lambda r: r.integers(0, 256, (9, 14, 4)), dict()),
    "rgba_unspecified": (lambda r: r.integers(0, 256, (9, 14, 4)),
                         dict(extra=[0])),
    "rgba_associated": (lambda r: r.integers(0, 256, (9, 14, 4)),
                        dict(extra=[1])),
    "rgba_unassociated": (lambda r: r.integers(0, 256, (9, 14, 4)),
                          dict(extra=[2], compression=5, predictor=2)),
    "rgba_unassociated_planar": (lambda r: r.integers(0, 256, (9, 14, 4)),
                                 dict(extra=[2], planar=2)),
    "rgba16_unassociated": (lambda r: r.integers(0, 65536, (9, 14, 4)),
                            dict(extra=[2], bits=16)),
    "gray_alpha_unassociated": (lambda r: r.integers(0, 256, (9, 14, 2)),
                                dict(extra=[2])),
    "gray16_alpha": (lambda r: r.integers(0, 65536, (9, 14, 2)),
                     dict(extra=[1], bits=16)),
    "old_style_lzw": (lambda r: r.integers(0, 256, (120, 150, 3)),
                      dict(compression=5, compat=True, rows_per_strip=50)),
    "old_style_lzw_pred": (lambda r: r.integers(0, 256, (30, 40, 3)),
                           dict(compression=5, compat=True, predictor=2)),
    "lzw_table_resets": (lambda r: r.integers(0, 256, (200, 300, 3)),
                         dict(compression=5)),
    "packbits_runs": (lambda r: r.integers(0, 2, (30, 200, 3)) * 255,
                      dict(compression=32773)),
    "predictor_ignored_by_packbits": (
        lambda r: r.integers(0, 256, (9, 14, 3)),
        dict(compression=32773, predictor=2)),
}


@pytest.mark.parametrize("kind", sorted(TIFF_SAMPLE_KINDS))
def test_tiff_sample_kinds_match_cv2(tmp_path, kind):
    """Gray (min-is-black / -white at 1, 8, 16 bits), palette (1 / 4 / 8
    bits, a 16-bit ColorMap or one below 256), RGB at 16 bits, extra
    samples (none, unspecified, associated, unassociated: premultiplied),
    old-style LZW, full LZW tables, long PackBits runs, the predictor
    PackBits ignores: read_image_rgb and decode_tiff_rgb equal to
    cv2.imread -> RGB."""
    make, kw = TIFF_SAMPLE_KINDS[kind]
    rng = np.random.default_rng(len(kind))
    kw = dict(kw)
    bits = kw.get("bits", 8)
    img = make(rng).astype(np.uint16 if bits == 16 else np.uint8)
    if kw.get("colormap"):
        top = 65536 if kw["colormap"] == "16" else 256
        kw["colormap"] = rng.integers(0, top, (1 << bits, 3))
    data = write_tiff(img, **kw)
    path, want = _read_both(tmp_path, data, "a.tif")
    assert want is not None
    np.testing.assert_array_equal(read_image_rgb(path), want)
    np.testing.assert_array_equal(decode_tiff_rgb(data), want)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P", "1",
                                  "I;16"])
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate", "packbits"])
def test_tiff_that_pil_writes(tmp_path, mode, compression):
    """TIFFs that PIL writes in each mode and compression (and RGB LZW with
    the predictor): equal to cv2.imread -> RGB."""
    rng = np.random.default_rng(len(mode) + len(compression))
    rgb = cv2.GaussianBlur(rng.integers(0, 256, (45, 61, 3), dtype=np.uint8),
                           (5, 5), 0)
    im = {"RGB": lambda: Image.fromarray(rgb),
          "L": lambda: Image.fromarray(rgb[..., 0]),
          "RGBA": lambda: Image.fromarray(np.dstack([rgb, rgb[..., :1]])),
          "LA": lambda: Image.fromarray(rgb[..., :2], "LA"),
          "P": lambda: Image.fromarray(rgb).quantize(50),
          "1": lambda: Image.fromarray(rgb[..., 0] > 128),
          "I;16": lambda: Image.fromarray(
              rgb[..., 0].astype(np.uint16) * 251)}[mode]()
    bio = io.BytesIO()
    im.save(bio, "TIFF", compression=compression)
    path, want = _read_both(tmp_path, bio.getvalue(), "a.tif")
    np.testing.assert_array_equal(read_image_rgb(path), want)
    if mode == "RGB" and compression == "tiff_lzw":
        bio = io.BytesIO()
        im.save(bio, "TIFF", compression=compression, tiffinfo={317: 2})
        path, want = _read_both(tmp_path, bio.getvalue(), "p.tif")
        np.testing.assert_array_equal(read_image_rgb(path), want)


@pytest.mark.parametrize("kind", ["rgb8", "rgb16", "gray8", "gray16", "bgra"])
def test_tiff_that_cv2_writes(tmp_path, kind):
    """TIFFs that cv2.imwrite writes (LZW with the predictor): equal to
    cv2.imread -> RGB."""
    rng = np.random.default_rng(len(kind))
    shape = {"rgb8": (23, 31, 3), "rgb16": (23, 31, 3), "gray8": (23, 31),
             "gray16": (23, 31), "bgra": (23, 31, 4)}[kind]
    dtype = np.uint16 if "16" in kind else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    path = str(tmp_path / "a.tif")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))


@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
def test_tiff_transposing_orientations_raise(tmp_path, orientation):
    """Orientation 5-8: cv2.imread returns None, and the port raises a
    ValueError naming the file and the tag (as the JAX label loader
    raises on cv2's None)."""
    img = np.random.default_rng(orientation).integers(0, 256, (9, 13, 3),
                                                      dtype=np.uint8)
    path, want = _read_both(tmp_path, write_tiff(img, orientation=orientation),
                            "o.tif")
    assert want is None
    with pytest.raises(ValueError, match="Orientation") as err:
        read_image_rgb(path)
    assert path in str(err.value)
    assert isinstance(err.value, FileNotFoundError)


def _jpeg_in_tiff():
    """A TIFF whose strip is a JPEG (compression 7)."""
    img = np.zeros((8, 8, 1), np.uint8)
    data = bytearray(write_tiff(img))
    at = data.index(bytes([3, 1, 3, 0, 1, 0, 0, 0, 1, 0]))  # tag 259 = 1
    data[at + 8] = 7
    return bytes(data)


@pytest.mark.parametrize("kind,match", [
    ("jpeg_in_tiff", "Compression"), ("float", "SampleFormat"),
    ("gray2", "BitsPerSample"), ("five_samples", "SamplesPerPixel"),
    ("truncated_strip", "truncated"), ("bigtiff", "BigTIFF")])
def test_tiff_that_is_not_read_raises(tmp_path, kind, match):
    """What cv2.imread returns None for, the TIFF reader refuses with a
    ValueError naming the file and the tag or the fault: a strip that
    claims to be JPEG and is not, float samples, 2-bit gray, 5 samples, an
    uncompressed strip cut short, BigTIFF. The error is a FileNotFoundError
    too, as the JAX loader raises where cv2.imread returns None."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    if kind == "jpeg_in_tiff":
        data = _jpeg_in_tiff()
    elif kind == "float":
        data = bytearray(write_tiff(img[..., :1]))
        # one more directory entry would move the data: patch BitsPerSample
        # into SampleFormat (339 = IEEE float) instead
        at = data.index(bytes([2, 1, 3, 0, 1, 0, 0, 0, 8, 0]))
        data[at:at + 10] = bytes([0x53, 1, 3, 0, 1, 0, 0, 0, 3, 0])
        data = bytes(data)
    elif kind == "gray2":
        data = write_tiff(img[..., :1] >> 6, bits=2)
    elif kind == "five_samples":
        data = write_tiff(rng.integers(0, 256, (8, 8, 5), dtype=np.uint8),
                          extra=[2, 0])
    elif kind == "truncated_strip":
        data = bytearray(write_tiff(img))
        at = data.index(bytes([0x11, 1, 4, 0, 1, 0, 0, 0, 8, 0, 0, 0]))
        data[at + 8:at + 12] = (len(data) - 10).to_bytes(4, "little")
        data = bytes(data)
    else:
        data = b"II+\0" + bytes(12)
    path = str(tmp_path / f"{kind}.tif")
    with open(path, "wb") as f:
        f.write(data)
    assert cv2_rgb(path) is None
    with pytest.raises(ValueError, match=match) as err:
        read_image_rgb(path)
    assert path in str(err.value)
    assert isinstance(err.value, FileNotFoundError)


@pytest.mark.parametrize("kind", ["ycbcr", "corrupt_lzw"])
def test_tiff_once_refused_matches_cv2(tmp_path, kind):
    """TIFFs the reader refused until cv2.imread was found to read them (so
    the JAX loader reads them too), now equal to cv2.imread: samples
    tagged YCbCr (Photometric 6, read as libtiff's default 2x2 blocks) and
    LZW data whose first code is EOI (libtiff's "Not enough data": zeros)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    if kind == "ycbcr":
        data = write_tiff(img, photometric=6)
    else:
        data = bytearray(write_tiff(img, compression=5))
        data[9] ^= 0xFF
        data = bytes(data)
    path, want = _read_both(tmp_path, data, f"{kind}.tif")
    assert want is not None
    np.testing.assert_array_equal(read_image_rgb(path), want)
    np.testing.assert_array_equal(decode_tiff_rgb(data), want)


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_image_fixture_matches_manifest(name):
    """Each committed fixture of tests/data_torch/images: its RGB bytes hash
    to the manifest's (cv2's when the fixtures were written) and equal
    cv2.imread here."""
    entry = _manifest()[name]
    path = os.path.join(FIXTURES, name)
    img = read_image_rgb(path)
    assert list(img.shape) == entry["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(img, cv2_rgb(path))


def _mixed_dataset(root):
    """make_dataset's detect set with each PNG rewritten in one of the new
    formats, cycled: progressive and CMYK JPEG, paletted, 16-bit and Adam7
    PNG, LZW / tiled / planar / palette TIFF."""
    make_dataset(root, 9, 4, [(64, 48), (40, 90), (100, 70)], 3, seed=6)

    def pil(img, fmt, **kw):
        bio = io.BytesIO()
        img.save(bio, fmt, **kw)
        return bio.getvalue()

    writers = [
        (".jpg", lambda a: pil(Image.fromarray(a), "JPEG", quality=85,
                               progressive=True)),
        (".jpg", lambda a: pil(Image.fromarray(255 - np.dstack(
            [a, a[..., :1] // 2]), "CMYK"), "JPEG", quality=90)),
        (".png", lambda a: pil(Image.fromarray(a).quantize(64), "PNG")),
        (".png", lambda a: cv2.imencode(".png", a[..., ::-1].astype(
            np.uint16) * 257)[1].tobytes()),
        (".png", lambda a: write_png(a, 8, 2, interlace=1)),
        (".tif", lambda a: write_tiff(a, compression=5, predictor=2)),
        (".tiff", lambda a: write_tiff(a, compression=8, tile=(16, 16))),
        (".tif", lambda a: write_tiff(a, planar=2, compression=32773)),
        (".tif", lambda a: pil(Image.fromarray(a).quantize(32), "TIFF",
                               compression="tiff_lzw")),
    ]
    for split, k in (("train", 0), ("val", 3)):
        d = os.path.join(root, "images", split)
        for name in sorted(os.listdir(d)):
            png = os.path.join(d, name)
            img = read_image_rgb(png)
            os.remove(png)
            ext, write = writers[k % len(writers)]
            k += 1
            with open(png[:-4] + ext, "wb") as f:
                f.write(write(img))


@pytest.mark.parametrize("is_val", [False, True])
def test_mixed_format_detect_set_loads_as_jax(tmp_path, is_val):
    """load_labels of a detect set of mixed formats in the port and in the
    JAX package (cv2.imread there): the same files, boxes and image
    arrays, resized to the image size."""
    root = str(tmp_path)
    _mixed_dataset(root)
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=64,
                  number_class=3)
    got = load_labels(Config(**common), is_val=is_val)
    want = jax_load_labels(JaxConfig(**common), is_val=is_val)
    assert len(got) == len(want) == (4 if is_val else 9)
    exts = set()
    for g, w in zip(got, want):
        assert g.im_file == w.im_file
        exts.add(os.path.splitext(g.im_file)[1])
        assert g.org_shape == w.org_shape
        np.testing.assert_array_equal(g.img, w.img, err_msg=g.im_file)
        np.testing.assert_array_equal(g.bboxes, w.bboxes)
    assert exts == ({".png", ".tif", ".tiff"} if is_val
                    else {".jpg", ".png", ".tif", ".tiff"})
