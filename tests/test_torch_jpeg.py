"""The port's cv2-free image input against cv2 5.0, on the CPU: JPEG
(jpeg.py and the host C++ of csrc/jpeg_decode.cpp, built here with c++)
bit for bit against cv2.imread(IMREAD_COLOR) -> RGB over sampling
factors, qualities, restart intervals, optimised tables and sizes, both
baseline and progressive (from cv2 and PIL), Adobe CMYK, the EXIF
orientations 1-8, the committed fixtures against their manifest, the
files it refuses (where cv2 returns None) and those it once refused;
BMP (8-bit paletted, 24- and 32-bit, both row orders)
and PNG with an eXIf orientation; reading JPEG, PNG, BMP and TIFF where
cv2 cannot be imported; a JPEG detect set loaded as the JAX package's
loader loads it (cv2 there), a JPEG classify set's get and a JPEG path
served by image_predict."""

import hashlib
import io
import itertools
import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_data import make_dataset
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data.labels import load_labels as jax_load_labels
from yolosharp_tpu_torch import Config
from yolosharp_tpu_torch.data import jpeg
from yolosharp_tpu_torch.data.image_ops import (decode_bmp_rgb, encode_png,
                                                read_image_rgb)
from yolosharp_tpu_torch.data.labels import load_labels

FIXTURES = os.path.join(os.path.dirname(__file__), "data_torch", "jpeg")
sys.path.insert(0, FIXTURES)
from make_fixtures import SAMPLING, encode, exif_app1, smooth_image  # noqa
sys.path.insert(0, os.path.join(os.path.dirname(FIXTURES), "images"))
from writers import write_tiff  # noqa: E402

SIZES = [(1, 1), (7, 9), (17, 33), (67, 45), (641, 479)]   # (w, h)


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize(
    "sampling,quality,rst,optimize,size",
    list(itertools.product(list(SAMPLING) + ["gray"], [50, 75, 95, 100],
                           [0, 1, 3], [0, 1], SIZES)),
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_decode_matches_cv2(tmp_path, sampling, quality, rst, optimize,
                            size):
    """A JPEG that cv2.imencode writes with these settings (a 2-D image
    for grayscale): read_image_rgb equal to cv2.imread -> RGB, and
    decode_jpeg_rgb of the bytes the same."""
    w, h = size
    img = smooth_image(h, w, quality + rst + w)
    if sampling == "gray":
        img = img[..., 0]
    data = encode(img, sampling, quality, rst, optimize, 0)
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2_rgb(path)
    got = read_image_rgb(path)
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jpeg.decode_jpeg_rgb(data), want)


@pytest.mark.parametrize(
    "sampling,quality,rst,size",
    list(itertools.product(list(SAMPLING) + ["gray"], [50, 95], [0, 2],
                           [(1, 1), (17, 33), (67, 45)])),
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_progressive_matches_cv2(tmp_path, sampling, quality, rst, size):
    """A progressive JPEG that cv2.imencode writes (libjpeg-turbo's scan
    script: DC first and refine, spectral selection and successive
    approximation of the AC bands, EOB runs) at these settings:
    read_image_rgb equal to cv2.imread -> RGB."""
    w, h = size
    img = smooth_image(h, w, quality + rst + w)
    if sampling == "gray":
        img = img[..., 0]
    data = encode(img, sampling, quality, rst, 0, 1)
    assert jpeg.parse_jpeg(data).progressive
    path = str(tmp_path / "p.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))


def _pil_jpeg(img, mode=None, **kw):
    bio = io.BytesIO()
    Image.fromarray(img, mode).save(bio, "JPEG", **kw)
    return bio.getvalue()


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("quality", [60, 92])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_progressive_matches_cv2(tmp_path, subsampling, quality,
                                     optimize):
    """A progressive JPEG that PIL writes (4:4:4, 4:2:2, 4:2:0; optimised
    Huffman tables or not; the tables of each scan defined before it):
    equal to cv2.imread -> RGB."""
    img = smooth_image(75, 121, quality + subsampling)
    data = _pil_jpeg(img, quality=quality, progressive=True,
                     subsampling=subsampling, optimize=optimize)
    path = str(tmp_path / "p.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))


def _without_app14(data):
    """The bytes without their Adobe APP14 segment."""
    for marker, a, b in _segments(data):
        if marker == 0xEE:
            return data[:a] + data[b:]
    return data


@pytest.mark.parametrize("adobe", [True, False])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_cmyk_matches_cv2(tmp_path, subsampling, progressive, adobe):
    """A CMYK JPEG that PIL writes (Adobe APP14 transform 0, the channels
    stored inverted), baseline or progressive, 4:4:4 or 4:2:0, and the
    same bytes without the APP14 marker (libjpeg takes four components
    as CMYK then too): cv2's integer CMYK -> BGR, equal to cv2.imread ->
    RGB."""
    rng = np.random.default_rng(subsampling + 2 * progressive)
    img = np.dstack([255 - smooth_image(37, 45, subsampling),
                     rng.integers(0, 256, (37, 45), dtype=np.uint8)])
    data = _pil_jpeg(img, "CMYK", quality=90, subsampling=subsampling,
                     progressive=progressive)
    if not adobe:
        data = _without_app14(data)
    info = jpeg.parse_jpeg(data)
    assert info.color == jpeg.COLOR_CMYK
    assert (info.adobe_transform is None) != adobe
    path = str(tmp_path / "c.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(tmp_path, orientation):
    """An APP1 EXIF Orientation spliced in after SOI, little- and
    big-endian: the image turned and flipped as cv2.imread turns it; an
    APP1 that is not EXIF (XMP) first leaves the image as it is."""
    img = smooth_image(37, 53, orientation)
    data = encode(img, "420", 90, 0, 0, 0)
    for le in (True, False):
        spliced = data[:2] + exif_app1(orientation, le) + data[2:]
        path = str(tmp_path / f"o{int(le)}.jpg")
        with open(path, "wb") as f:
            f.write(spliced)
        want = cv2_rgb(path)
        assert want.shape == ((53, 37, 3) if orientation > 4
                              else (37, 53, 3))
        np.testing.assert_array_equal(read_image_rgb(path), want)
    xmp = b"http://ns.adobe.com/xap/1.0/\0<x/>"
    spliced = (data[:2] + b"\xff\xe1" + struct.pack(">H", len(xmp) + 2)
               + xmp + exif_app1(orientation) + data[2:])
    path = str(tmp_path / "xmp.jpg")
    with open(path, "wb") as f:
        f.write(spliced)
    np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_fixture_matches_manifest(name):
    """Each committed fixture, the progressive one included: its RGB bytes
    hash to the manifest's (cv2's when the fixtures were written) and
    equal cv2.imread here."""
    entry = _manifest()[name]
    path = os.path.join(FIXTURES, name)
    img = read_image_rgb(path)
    assert list(img.shape) == entry["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(img, cv2_rgb(path))


def _segments(data):
    """(marker, start, end) of each marker segment before the scan."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        length, = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((data[pos + 1], pos, pos + 2 + length))
        pos += 2 + length
    return out


def _without_app0(data):
    """The bytes without their JFIF APP0 segment."""
    for marker, a, b in _segments(data):
        if marker == 0xE0:
            return data[:a] + data[b:]
    return data


@pytest.mark.parametrize("markers", ["adobe_rgb", "adobe_ycc", "rgb_ids",
                                     "no_marker", "jfif_and_adobe_rgb"])
def test_colour_space_markers_match_cv2(tmp_path, markers):
    """libjpeg's choice of the colour space of a 3-component frame: JFIF
    means YCbCr; else an Adobe APP14 transform 0 means RGB (no
    conversion) and 1 YCbCr; else the component ids 'R' 'G' 'B' mean RGB;
    else YCbCr. Each against cv2.imread of the same bytes."""
    img = smooth_image(24, 40, 3)
    data = encode(img, "444", 90, 0, 0, 0)
    adobe = b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                   0 if "rgb" in markers else 1)
    app14 = b"\xff\xee" + struct.pack(">H", len(adobe) + 2) + adobe
    if markers == "jfif_and_adobe_rgb":
        data = data[:2] + app14 + data[2:]
    elif markers.startswith("adobe"):
        data = _without_app0(data)
        data = data[:2] + app14 + data[2:]
    else:
        data = _without_app0(data)
        if markers == "rgb_ids":
            at = data.index(b"\xff\xc0") + 10
            sof = bytearray(data)
            for i, cid in enumerate(b"RGB"):
                sof[at + 3 * i] = cid
            sos = data.index(b"\xff\xda") + 5
            for i, cid in enumerate(b"RGB"):
                sof[sos + 2 * i] = cid
            data = bytes(sof)
    path = str(tmp_path / f"{markers}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))


def test_sixteen_bit_quant_tables_match_cv2(tmp_path):
    """The 8-bit DQT tables rewritten as 16-bit ones (Pq = 1), the chroma
    table's values tripled (past 255): decoded as cv2 decodes them."""
    img = smooth_image(33, 47, 4)
    data = encode(img, "420", 25, 0, 0, 0)
    out, last = b"", 0
    for marker, a, b in _segments(data):
        if marker != 0xDB:
            continue
        body, at, new = data[a + 4:b], 0, b""
        while at < len(body):
            tq = body[at] & 15
            vals = np.frombuffer(body[at + 1:at + 65], np.uint8)
            vals = vals.astype(np.uint16) * (1 if tq == 0 else 3)
            new += bytes([0x10 | tq]) + vals.astype(">u2").tobytes()
            at += 65
        out += data[last:a] + b"\xff\xdb" + struct.pack(">H", len(new) + 2) \
            + new
        last = b
    data = out + data[last:]
    path = str(tmp_path / "q16.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert jpeg.parse_jpeg(data).qtables.max() > 255
    np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))


def _ycck(data):
    """PIL's CMYK JPEG with its Adobe transform set to 2 (YCCK)."""
    at = data.index(b"Adobe") + 11
    return data[:at] + b"\x02" + data[at + 1:]


def _unrefined(data):
    """A progressive JPEG without its last scan (cv2's script ends with
    the luma AC refinement to Al 0), so libjpeg smooths its blocks."""
    last = data.rindex(b"\xff\xda")
    return data[:last] + b"\xff\xd9"


def _jpeg_in_tiff(img):
    """A TIFF whose strip claims to be JPEG (Compression 7)."""
    data = bytearray(write_tiff(img))
    at = data.index(bytes([3, 1, 3, 0, 1, 0, 0, 0, 1, 0]))
    data[at + 8] = 7
    return bytes(data)


def _twelve_bit(data):
    at = data.index(b"\xff\xc0") + 4
    return data[:at] + b"\x0c" + data[at + 1:]


@pytest.mark.parametrize("kind,match", [
    ("cut_in_header", "truncated"),
    ("sof10", "arithmetic-coded progressive"), ("twelve_bit", "12-bit"),
    ("not_an_image", "not a PNG, JPEG, BMP, TIFF, PNM, PAM or WebP"),
    ("jpeg_in_tiff", "Compression"), ("tiff_orientation6", "Orientation")])
def test_unreadable_files_raise(tmp_path, kind, match):
    """What cv2.imread returns None for, the port refuses with a ValueError
    naming the file (no image is substituted): a file cut in its headers,
    a sequential scan under an arithmetic-coded progressive (SOF10) frame,
    12-bit samples, text, a TIFF strip that claims to be JPEG and is not,
    a TIFF Orientation 6. The error is a FileNotFoundError too, as the JAX
    loader raises where cv2.imread returns None."""
    img = smooth_image(48, 64, 0)
    base = encode(img, "420", 75, 0, 0, 0)
    if kind == "cut_in_header":
        data = base[:100]
    elif kind == "sof10":
        at = base.index(b"\xff\xc0")
        data = base[:at] + b"\xff\xca" + base[at + 2:]
    elif kind == "twelve_bit":
        data = _twelve_bit(base)
    elif kind == "not_an_image":
        data = b"class x y w h\n" * 4
    elif kind == "jpeg_in_tiff":
        data = _jpeg_in_tiff(img)
    else:
        data = write_tiff(img, orientation=6)
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match=match) as err:
        read_image_rgb(path)
    assert path in str(err.value)
    assert isinstance(err.value, FileNotFoundError)


@pytest.mark.parametrize("kind", ["ycck", "truncated", "arithmetic",
                                  "progressive_unrefined"])
def test_once_refused_files_match_cv2(tmp_path, kind):
    """Files the port refused until cv2.imread was found to read them (so
    the JAX loader reads them too), now equal to cv2.imread: YCCK (Adobe
    transform 2, jdcolor.c's ycck_cmyk_convert), a scan cut short (fake
    EOIs, the MCUs past the cut gray), Huffman data under an
    arithmetic-coded (SOF9) frame (jdarith.c decodes it as garbage up to
    its first bad code), a progressive file without its last scan (block
    smoothing)."""
    img = smooth_image(48, 64, 0)
    base = encode(img, "420", 75, 0, 0, 0)
    if kind == "ycck":
        data = _ycck(_pil_jpeg(np.dstack([img, img[..., :1]]), "CMYK"))
    elif kind == "truncated":
        data = base[:len(base) * 2 // 3]
    elif kind == "arithmetic":
        at = base.index(b"\xff\xc0")
        data = base[:at] + b"\xff\xc9" + base[at + 2:]
    else:
        data = _unrefined(encode(img, "420", 75, 0, 0, 1))
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2_rgb(path)
    np.testing.assert_array_equal(read_image_rgb(path), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg_rgb(data), want)


def _top_down(data):
    """A bottom-up BMP's bytes rewritten top-down (negative height, rows in
    reading order)."""
    b = bytearray(data)
    off, = struct.unpack("<I", b[10:14])
    w, h = struct.unpack("<ii", b[18:26])
    bpp, = struct.unpack("<H", b[28:30])
    stride = (w * bpp // 8 + 3) & ~3
    rows = [bytes(b[off + i * stride:off + (i + 1) * stride])
            for i in range(h)]
    b[off:off + stride * h] = b"".join(rows[::-1])
    b[22:26] = struct.pack("<i", -h)
    return bytes(b)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_matches_cv2(tmp_path, channels, top_down):
    """BMPs that cv2.imencode writes (8-bit paletted gray, 24-bit, 32-bit
    BI_BITFIELDS with alpha), bottom-up and top-down, at widths with and
    without row padding: equal to cv2.imread -> RGB."""
    rng = np.random.default_rng(channels)
    for h, w in ((5, 9), (1, 1), (13, 16)):
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        data = cv2.imencode(".bmp", img)[1].tobytes()
        if top_down:
            data = _top_down(data)
        path = str(tmp_path / f"{h}x{w}.bmp")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))
        np.testing.assert_array_equal(decode_bmp_rgb(data), cv2_rgb(path))


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_png_exif_orientation_matches_cv2(tmp_path, orientation):
    """A PNG with an eXIf chunk: turned as cv2.imread turns it."""
    img = smooth_image(5, 9, orientation)
    png = encode_png(img)
    tiff = exif_app1(orientation)[10:]
    chunk = (struct.pack(">I", len(tiff)) + b"eXIf" + tiff
             + struct.pack(">I", zlib.crc32(b"eXIf" + tiff) & 0xFFFFFFFF))
    path = str(tmp_path / "e.png")
    with open(path, "wb") as f:
        f.write(png[:33] + chunk + png[33:])
    np.testing.assert_array_equal(read_image_rgb(path), cv2_rgb(path))


def test_reads_without_cv2(tmp_path):
    """In a process where ``import cv2`` fails, read_image_rgb reads a PNG,
    a JPEG, a BMP, a progressive JPEG, a paletted PNG and an LZW TIFF to
    the arrays cv2 gives here."""
    img = smooth_image(30, 41, 7)
    bio = io.BytesIO()
    Image.fromarray(img).quantize(50).save(bio, "PNG")
    files = {"a.png": encode_png(img),
             "a.jpg": encode(img, "420", 80, 2, 0, 0),
             "a.bmp": cv2.imencode(".bmp", img[..., ::-1])[1].tobytes(),
             "p.jpg": encode(img, "422", 80, 0, 0, 1),
             "p.png": bio.getvalue(),
             "a.tif": write_tiff(img, compression=5, predictor=2)}
    for name, data in files.items():
        with open(tmp_path / name, "wb") as f:
            f.write(data)
        np.save(tmp_path / f"{name}.npy", cv2_rgb(str(tmp_path / name)))
    script = (
        "import sys; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from yolosharp_tpu_torch.data.image_ops import read_image_rgb\n"
        "for n in ('a.png', 'a.jpg', 'a.bmp', 'p.jpg', 'p.png', 'a.tif'):\n"
        "    p = sys.argv[1] + '/' + n\n"
        "    assert np.array_equal(read_image_rgb(p), np.load(p + '.npy'))\n"
        "try:\n"
        "    import cv2\n"
        "except ImportError:\n"
        "    print('ok without cv2')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          capture_output=True, text=True, cwd=repo)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok without cv2"


def _jpeg_dataset(root):
    """make_dataset's detect set with each PNG rewritten as a JPEG (4:2:0,
    q 90; the val split at 4:4:4 with restart markers) under the same
    name with .jpg."""
    make_dataset(root, 6, 3, [(64, 48), (40, 90), (100, 70)], 3, seed=4)
    for split in ("train", "val"):
        d = os.path.join(root, "images", split)
        for name in sorted(os.listdir(d)):
            png = os.path.join(d, name)
            img = read_image_rgb(png)
            os.remove(png)
            data = (encode(img, "420", 90, 0, 0, 0) if split == "train"
                    else encode(img, "444", 90, 2, 1, 0))
            with open(png[:-4] + ".jpg", "wb") as f:
                f.write(data)


@pytest.mark.parametrize("is_val", [False, True])
def test_jpeg_detect_set_loads_as_jax(tmp_path, is_val):
    """load_labels of a JPEG detect set in the port and in the JAX package
    (cv2.imread there): the same files, boxes and image arrays, resized
    to the image size."""
    root = str(tmp_path)
    _jpeg_dataset(root)
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=64,
                  number_class=3)
    got = load_labels(Config(**common), is_val=is_val)
    want = jax_load_labels(JaxConfig(**common), is_val=is_val)
    assert len(got) == len(want) == (3 if is_val else 6)
    for g, w in zip(got, want):
        assert g.im_file == w.im_file and g.im_file.endswith(".jpg")
        assert g.org_shape == w.org_shape
        np.testing.assert_array_equal(g.img, w.img, err_msg=g.im_file)
        np.testing.assert_array_equal(g.bboxes, w.bboxes)


def test_jpeg_classify_get_and_predict_path(tmp_path):
    """A folder-per-class JPEG set: the port's ClassificationDataset val get
    equals the JAX dataset's (cv2 there); image_predict of a .jpg path
    equals image_predict of the decoded array."""
    from yolosharp_tpu.data.dataset import ClassificationDataset as JaxDS
    from yolosharp_tpu.types import TaskType as JaxTaskType
    from yolosharp_tpu_torch import (ScalarType, TaskType, YoloSize,
                                     YoloTask, YoloType)
    from yolosharp_tpu_torch.data import ClassificationDataset

    root = str(tmp_path)
    for split, n in (("train", 2), ("val", 2)):
        for c in range(2):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i in range(n):
                img = smooth_image(40 + 7 * i, 52 + 5 * c, 10 * c + i)
                with open(os.path.join(d, f"{i}.jpg"), "wb") as f:
                    f.write(encode(img, ("420", "422")[i], 85, 0, 0, 0))
    common = dict(root_path=root, train_data_path="train",
                  val_data_path="val", number_class=2, image_size=32)
    ds = ClassificationDataset(
        Config(task_type=TaskType.classify, **common), is_val=True)
    jds = JaxDS(JaxConfig(task_type=JaxTaskType.classify, **common),
                is_val=True)
    assert len(ds) == len(jds) == 4
    for i in range(len(ds)):
        got, want = ds.get(i), jds.get(i)
        assert got["cls"] == want["cls"]
        np.testing.assert_array_equal(got["image"], want["image"])
    task = YoloTask(Config(yolo_type=YoloType.v8, yolo_size=YoloSize.n,
                           number_class=2, image_size=64,
                           scalar_type=ScalarType.float32), device="cpu")
    path = os.path.join(root, "val", "class1", "1.jpg")
    by_path = task.image_predict(path, 0.0, 0.5)
    by_array = task.image_predict(read_image_rgb(path), 0.0, 0.5)
    assert len(by_path) == len(by_array) > 0
    for a, b in zip(by_path, by_array):
        assert (a.class_id, a.score, a.center_x, a.center_y) == \
            (b.class_id, b.score, b.center_x, b.center_y)
