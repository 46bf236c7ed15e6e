"""The port's cv2-free WebP reader (data/webp.py, csrc/webp_decode.cpp)
against cv2 5.0 on the CPU, bit for bit against cv2.imread(IMREAD_COLOR)
-> RGB: lossless files of every size PIL and cv2 write (the transforms,
colour cache, meta prefix codes and backward references their encoders
choose), lossy files at every quality and method, lossy files with an
ALPH chunk (raw and compressed), the VP8 options only libwebp's advanced
API sets (the simple filter, sharpness, segments, partitions), the EXIF
orientations, animations (the first frame), WebP bytes under a .jpg name,
and files cut short or corrupted, which both refuse."""

import io
import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

import libwebp_encode
from yolosharp_tpu_torch.data.errors import ImageReadError
from yolosharp_tpu_torch.data.image_ops import read_image_rgb
from yolosharp_tpu_torch.data.webp import decode_webp_rgb

FIXTURES = os.path.join(os.path.dirname(__file__), "data_torch", "images")


def _both(tmp_path, name, data):
    """(port's RGB or None, cv2's RGB or None) of `data` as a file."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    try:
        got = read_image_rgb(path)
    except ImageReadError as err:
        assert path in str(err) and isinstance(err, FileNotFoundError)
        got = None
    return got, None if want is None else want[..., ::-1]


def _same(got, want, label):
    assert (got is None) == (want is None), label
    if want is not None:
        np.testing.assert_array_equal(got, want, err_msg=label)


def content(rng, h, w, kind):
    """Noise (kind 0), a smooth ramp (1) or a ramp with noise (2)."""
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     ((xx + yy) * 7) % 256], -1)
    if kind == 2:
        base = base + rng.integers(-20, 20, (h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def pil_webp(img, **kw):
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "WEBP", **kw)
    return bio.getvalue()


SIZES = [(1, 1), (1, 17), (16, 16), (17, 33), (48, 64), (101, 77)]


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossless_matches_cv2(tmp_path, size, kind):
    """VP8L from PIL at methods 0-6 and from cv2 (quality above 100)."""
    rng = np.random.default_rng(size[0] * 1000 + size[1] * 10 + kind)
    img = content(rng, *size, kind)
    for i, method in enumerate((0, 3, 6)):
        got, want = _both(tmp_path, f"l{i}.webp", pil_webp(
            img, lossless=True, method=method, quality=int(rng.integers(0, 101))))
        _same(got, want, f"PIL method {method}")
        assert want is not None
    data = cv2.imencode(".webp", img[..., ::-1],
                        [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes()
    assert data[12:16] == b"VP8L"
    got, want = _both(tmp_path, "cv2.webp", data)
    _same(got, want, "cv2")


@pytest.mark.parametrize("quality", [0, 25, 50, 75, 90, 100])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossy_matches_cv2(tmp_path, size, quality):
    """VP8 key frames from PIL at methods 0, 4 and 6 and from cv2, noise
    and ramps (i16 and i4 modes, skipped and coded blocks)."""
    rng = np.random.default_rng(size[0] * 1000 + size[1] * 10 + quality)
    for kind in (0, 2):
        img = content(rng, *size, kind)
        for method in (0, 4, 6):
            data = pil_webp(img, quality=quality, method=method)
            assert data[12:16] == b"VP8 "
            got, want = _both(tmp_path, f"q{kind}{method}.webp", data)
            _same(got, want, f"kind {kind} method {method}")
            assert want is not None
        data = cv2.imencode(".webp", img[..., ::-1], [
            cv2.IMWRITE_WEBP_QUALITY, max(quality, 1)])[1].tobytes()
        got, want = _both(tmp_path, f"c{kind}.webp", data)
        _same(got, want, "cv2")


OPTIONS = [dict(filter_type=0, filter_strength=60),
           dict(filter_type=0, filter_strength=100, filter_sharpness=3),
           dict(filter_type=1, filter_strength=100, filter_sharpness=7),
           dict(filter_type=1, filter_strength=40, filter_sharpness=5),
           dict(filter_strength=0, autofilter=0),
           dict(segments=1, sns_strength=0),
           dict(segments=2, sns_strength=100),
           dict(segments=4, sns_strength=100, filter_strength=90),
           dict(partitions=3, method=0),
           dict(partitions=2, method=0, quality=95.0),
           dict(quality=5.0, method=0), dict(quality=100.0, method=6)]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "-".join(
    f"{k}{v}" for k, v in o.items()))
def test_lossy_encoder_options_match_cv2(tmp_path, opts):
    """The VP8 options only libwebp's advanced API sets: the simple loop
    filter, strengths and sharpness, 1-4 segments with spatial noise
    shaping, several token partitions (which libwebp's encoder writes at
    method 0)."""
    rng = np.random.default_rng(len(str(opts)))
    for i, size in enumerate([(37, 53), (130, 97)]):
        data = libwebp_encode.encode(content(rng, *size, 2), **opts)
        assert data is not None and data[12:16] == b"VP8 "
        got, want = _both(tmp_path, f"o{i}.webp", data)
        _same(got, want, str(opts))
        assert want is not None


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("size", SIZES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
def test_alpha_matches_cv2(tmp_path, size, lossless):
    """RGBA from PIL: VP8X with a compressed ALPH chunk and a VP8 frame
    (lossy), or VP8L with alpha; cv2 drops the alpha for IMREAD_COLOR."""
    rng = np.random.default_rng(size[0] + size[1])
    rgba = np.concatenate([content(rng, *size, 2), rng.integers(
        0, 256, (*size, 1), dtype=np.uint8)], -1)
    for q in (30, 90):
        got, want = _both(tmp_path, f"a{q}.webp", pil_webp(
            rgba, quality=q, lossless=lossless))
        _same(got, want, f"quality {q}")
        assert want is not None


def _raw_alpha(data, w, h):
    """A lossy VP8X + ALPH file's ALPH chunk replaced by an uncompressed
    one (method 0)."""
    at = data.index(b"ALPH")
    size = int.from_bytes(data[at + 4:at + 8], "little")
    body = bytes([0]) + bytes(range(256)) * (w * h // 256 + 1)
    body = body[:1 + w * h]
    chunk = b"ALPH" + len(body).to_bytes(4, "little") + body + b"\0" * (
        len(body) & 1)
    out = data[:at] + chunk + data[at + 8 + size + (size & 1):]
    return out[:4] + (len(out) - 8).to_bytes(4, "little") + out[8:]


def test_raw_alpha_chunk_matches_cv2(tmp_path):
    rng = np.random.default_rng(3)
    rgba = np.concatenate([content(rng, 20, 30, 2), np.full(
        (20, 30, 1), 128, np.uint8)], -1)
    data = _raw_alpha(pil_webp(rgba, quality=80), 30, 20)
    got, want = _both(tmp_path, "raw_alpha.webp", data)
    _same(got, want, "raw ALPH")
    assert want is not None


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("lossless", [False, True])
def test_exif_orientation_matches_cv2(tmp_path, orientation, lossless):
    """An EXIF chunk's Orientation (as PIL writes it, "Exif\\0\\0" first),
    applied as cv2 5.0 applies it to a WebP."""
    rng = np.random.default_rng(orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    data = pil_webp(content(rng, 24, 40, 2), quality=85, lossless=lossless,
                    exif=exif.tobytes())
    got, want = _both(tmp_path, "o.webp", data)
    _same(got, want, f"orientation {orientation}")
    assert want.shape[:2] == ((40, 24) if orientation > 4 else (24, 40))


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_reads_its_first_frame(tmp_path, lossless):
    """An animated file (ANIM / ANMF): cv2 5.0's imread returns the first
    frame."""
    rng = np.random.default_rng(int(lossless))
    frames = [Image.fromarray(content(rng, 36, 52, k)) for k in (2, 0, 1)]
    bio = io.BytesIO()
    frames[0].save(bio, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, lossless=lossless, quality=70)
    got, want = _both(tmp_path, "anim.webp", bio.getvalue())
    _same(got, want, "animation")
    assert want is not None


def test_webp_under_a_jpg_name_is_read_by_content(tmp_path):
    rng = np.random.default_rng(4)
    data = pil_webp(content(rng, 30, 44, 2), quality=80)
    got, want = _both(tmp_path, "actually_webp.jpg", data)
    _same(got, want, ".jpg name")
    assert want is not None


@pytest.mark.parametrize("kind", ["cut_lossy", "cut_lossless", "riff_size",
                                  "bad_vp8_tag", "bad_vp8l_signature",
                                  "corrupt_lossless", "canvas_mismatch",
                                  "no_image_chunk"])
def test_broken_webp_raises_where_cv2_reads_nothing(tmp_path, kind):
    """Files cut short, a RIFF size past the file's end, an inter frame
    tag, a VP8L without its signature, a lossless stream whose codes break,
    a VP8X canvas that is not the image's size and a VP8X file without an
    image: cv2 reads no image, and the port raises naming the file."""
    rng = np.random.default_rng(5)
    img = content(rng, 40, 56, 0)
    lossy, lossless = pil_webp(img, quality=70), pil_webp(img, lossless=True)
    if kind == "cut_lossy":
        data = lossy[:len(lossy) * 2 // 3]
    elif kind == "cut_lossless":
        data = lossless[:len(lossless) // 2]
    elif kind == "riff_size":
        data = lossy[:4] + (len(lossy) + 100).to_bytes(4, "little") + lossy[8:]
    elif kind == "bad_vp8_tag":
        data = lossy[:20] + bytes([lossy[20] | 1]) + lossy[21:]
    elif kind == "bad_vp8l_signature":
        data = lossless[:20] + b"\x2e" + lossless[21:]
    elif kind == "corrupt_lossless":
        data = lossless[:25] + bytes(40) + lossless[65:]
    elif kind == "canvas_mismatch":
        rgba = np.concatenate([img, img[..., :1]], -1)
        data = bytearray(pil_webp(rgba, quality=70))
        data[24] ^= 1                          # canvas width - 1, low byte
        data = bytes(data)
    else:
        data = (b"RIFF" + (22).to_bytes(4, "little") + b"WEBPVP8X"
                + (10).to_bytes(4, "little") + bytes(10))
    got, want = _both(tmp_path, f"{kind}.webp", data)
    assert want is None and got is None
    with pytest.raises(ValueError):
        decode_webp_rgb(data, "x.webp")


def _bmp_index(img, n):
    """(h, w) indices of img's gray in n levels and an n-colour palette."""
    gray = img.astype(np.int32).sum(-1) * n // (3 * 256)
    pal = np.stack([np.linspace(20, 250, n), np.linspace(240, 10, n),
                    (np.arange(n) * 97) % 256], -1).astype(np.uint8)
    return gray, pal


def _new_kinds_dataset(root):
    """make_dataset's detect set with each PNG rewritten in one of the
    kinds this reader adds or one of the old ones, cycled: 4-bit, 16-bit
    5-6-5 and RLE8 BMP, binary and ASCII PNM under .png, lossy WebP under
    .jpg, lossless WebP under .png, then a baseline JPEG and a PNG."""
    from test_torch_data import make_dataset
    sys.path.insert(0, FIXTURES)
    from writers import BI_BITFIELDS, BI_RLE8, rle_encode, write_bmp, write_pnm

    make_dataset(root, 9, 4, [(64, 48), (40, 90), (100, 70)], 3, seed=8)

    def rgb565(a):
        a = a.astype(int)
        return ((a[..., 0] >> 3) << 11) | ((a[..., 1] >> 2) << 5) | (a[..., 2] >> 3)

    writers = [
        (".bmp", lambda a: write_bmp(_bmp_index(a, 16)[0], 4,
                                     palette=_bmp_index(a, 16)[1])),
        (".bmp", lambda a: write_bmp(rgb565(a), 16, compression=BI_BITFIELDS,
                                     masks=(0xF800, 0x7E0, 0x1F))),
        (".bmp", lambda a: write_bmp(np.zeros(a.shape[:2], int), 8,
                                     compression=BI_RLE8,
                                     palette=_bmp_index(a, 64)[1],
                                     rle=rle_encode(_bmp_index(a, 64)[0], 8))),
        (".png", lambda a: write_pnm(a, 6)),
        (".jpg", lambda a: pil_webp(a, quality=80)),
        (".png", lambda a: pil_webp(a, lossless=True)),
        (".png", lambda a: write_pnm(a.astype(int) * 4, 3, 1020)),
        (".jpg", lambda a: cv2.imencode(".jpg", a[..., ::-1])[1].tobytes()),
        (".png", lambda a: cv2.imencode(".png", a[..., ::-1])[1].tobytes()),
    ]
    for split, k in (("train", 0), ("val", 2)):
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
def test_new_kinds_detect_set_loads_as_jax(tmp_path, is_val):
    """load_labels of a detect set that mixes BMP (4-bit, 16-bit, RLE8),
    PNM and WebP (a lossy one under a .jpg name) with JPEG and PNG, in the
    port and in the JAX package (cv2.imread there): the same files, boxes
    and image arrays, resized to the image size."""
    from yolosharp_tpu.config import Config as JaxConfig
    from yolosharp_tpu.data.labels import load_labels as jax_load_labels
    from yolosharp_tpu_torch import Config
    from yolosharp_tpu_torch.data.labels import load_labels

    root = str(tmp_path)
    _new_kinds_dataset(root)
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=64, number_class=3)
    got = load_labels(Config(**common), is_val=is_val)
    want = jax_load_labels(JaxConfig(**common), is_val=is_val)
    assert len(got) == len(want) == (4 if is_val else 9)
    kinds = set()
    for g, w in zip(got, want):
        assert g.im_file == w.im_file
        with open(g.im_file, "rb") as f:
            kinds.add((f.read(2), os.path.splitext(g.im_file)[1]))
        assert g.org_shape == w.org_shape
        np.testing.assert_array_equal(g.img, w.img, err_msg=g.im_file)
        np.testing.assert_array_equal(g.bboxes, w.bboxes)
    assert {(b"BM", ".bmp"), (b"RI", ".jpg")} <= kinds
    if not is_val:
        assert {(b"P6", ".png"), (b"P3", ".png"), (b"RI", ".png"),
                (b"\xff\xd8", ".jpg"), (b"\x89P", ".png")} <= kinds
