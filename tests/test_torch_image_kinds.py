"""The JPEG and TIFF kinds cv2.imread (5.0: libjpeg-turbo 3.1, libtiff 4.7)
reads through its codecs' recovery paths and rarer codecs, against the
port's cv2-free readers on the CPU, bit for bit: JPEG cut short at several
offsets (baseline, progressive, arithmetic) or without EOI, restart markers
misnumbered or missing (libjpeg's resync), progressive files whose scans
leave low coefficients unrefined (block smoothing), sequential files of
several scans, YCCK, arithmetic-coded (sequential and progressive, with
restarts and conditioning); TIFF of JPEG (Photometric 1, 2 and 6), CCITT
(modified Huffman, T.4 1D / 2D / fill bits, T.6, both FillOrders), CMYK
(contiguous and planar), uncompressed YCbCr (every subsampling libtiff
puts) and LZW strips that end short; and a detect set of those kinds
loaded as the JAX package's loader loads it (cv2 there)."""

import io
import os
import struct
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_data import make_dataset
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data.labels import load_labels as jax_load_labels
from yolosharp_tpu_torch import Config
from yolosharp_tpu_torch.data.image_ops import read_image_rgb
from yolosharp_tpu_torch.data.labels import load_labels

HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(HERE, "data_torch", "images"))
sys.path.insert(0, os.path.join(HERE, "data_torch", "jpeg"))
from make_fixtures import encode, smooth_image  # noqa: E402
from writers import (jpeg_coefficients, quant_table, write_jpeg,  # noqa: E402
                     write_jpeg_tiff, write_tiff, ycc_planes)

F420, F422, F444 = [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)], \
    [(1, 1)] * 3
# libjpeg's jpeg_simple_progression for 3 components
PROGRESSION = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
               ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
               ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0),
               ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


def read_both(tmp_path, data, name):
    """(the port's RGB or None, cv2.imread -> RGB or None) of data written
    to a new file."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    want = None if want is None else cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
    try:
        got = read_image_rgb(path)
    except ValueError as err:
        assert path in str(err) and isinstance(err, FileNotFoundError)
        got = None
    return got, want


def assert_reads_as_cv2(tmp_path, data, name="a.jpg"):
    got, want = read_both(tmp_path, data, name)
    assert want is not None, "cv2 returns no image for this case"
    assert got is not None, "the port refuses a file cv2 reads"
    np.testing.assert_array_equal(got, want)


def assert_matches_cv2(tmp_path, data, name="a.jpg"):
    """Equal to cv2.imread where it reads the file; refused (naming it)
    where it returns None. True where cv2 reads it."""
    got, want = read_both(tmp_path, data, name)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    return want is not None


def numpy_jpeg(img, factors, quality=80, scans=None, **kw):
    """writers.write_jpeg of an RGB image's YCbCr planes."""
    qt = [quant_table(False, quality), quant_table(True, quality)]
    coefs = jpeg_coefficients(ycc_planes(img), factors, qt, [0, 1, 1])
    return write_jpeg(coefs, qt, [0, 1, 1], factors, img.shape[1],
                      img.shape[0], scans or [((0, 1, 2), 0, 63, 0, 0)], **kw)


def _jpeg_kind(kind, seed):
    img = smooth_image(48, 64, seed)
    if kind == "baseline":
        return encode(img, "420", 75, 0, 0, 0)
    if kind == "progressive":
        return encode(img, "420", 75, 0, 0, 1)
    if kind == "restarts":
        return encode(img, "444", 80, 2, 0, 1)
    return numpy_jpeg(img, F420, 80, PROGRESSION, arithmetic=True,
                      progressive=True)


@pytest.mark.parametrize("frac", [0.15, 0.4, 0.65, 0.9])
@pytest.mark.parametrize("kind", ["baseline", "progressive", "restarts",
                                  "arithmetic"])
def test_cut_jpeg_matches_cv2(tmp_path, kind, frac):
    """A JPEG cut frac of the way through its scan data (libjpeg inserts
    fake EOIs; the MCUs past the cut keep their coefficients, smoothed
    where progressive): equal to cv2.imread; where the cut falls inside a
    later scan's header, cv2 returns None and the port refuses it. A cut
    inside the one scan of a sequential file always reads."""
    data = _jpeg_kind(kind, int(frac * 100))
    sos = data.index(b"\xff\xda")
    read = assert_matches_cv2(tmp_path,
                              data[:sos + int((len(data) - sos) * frac)])
    assert read or kind != "baseline"


@pytest.mark.parametrize("cut", ["no_eoi", "in_eoi", "sos_header",
                                 "before_sos"])
def test_jpeg_ends_match_cv2(tmp_path, cut):
    """A JPEG without its EOI or cut in it reads as cv2 reads it; cut in
    or before its first scan header, cv2 returns None and the port raises
    naming the file."""
    data = _jpeg_kind("baseline", 3)
    sos = data.index(b"\xff\xda")
    data = {"no_eoi": data[:-2], "in_eoi": data[:-1],
            "sos_header": data[:sos + 7], "before_sos": data[:sos - 30]}[cut]
    got, want = read_both(tmp_path, data, "c.jpg")
    if cut in ("sos_header", "before_sos"):
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got, want)


def _restarts(data):
    """Positions of the RSTn markers after the first SOS."""
    out, pos = [], data.index(b"\xff\xda")
    while True:
        pos = data.find(b"\xff", pos + 1)
        if pos < 0 or pos + 1 >= len(data):
            return out
        if 0xD0 <= data[pos + 1] <= 0xD7:
            out.append(pos)


@pytest.mark.parametrize("fault", ["next", "skip3", "previous", "missing",
                                   "two"])
@pytest.mark.parametrize("progressive", [0, 1])
def test_restart_faults_match_cv2(tmp_path, progressive, fault):
    """RSTn markers renumbered (the next one's number, three on, the one
    before) or removed: libjpeg's jpeg_resync_to_restart (a marker one or
    two ahead stays unread, one behind is skipped, any other is
    swallowed) and process_restart, equal to cv2.imread."""
    data = bytearray(encode(smooth_image(48, 64, 9), "420", 80, 1, 0,
                            progressive))
    pos = _restarts(bytes(data))
    p = pos[len(pos) // 3]
    n = data[p + 1] - 0xD0
    if fault == "missing":
        del data[p:p + 2]
    elif fault == "two":
        data[p + 1] = 0xD0 + (n + 1) % 8
        q = pos[2 * len(pos) // 3]
        data[q + 1] = 0xD0 + (data[q + 1] - 0xD0 + 6) % 8
    else:
        data[p + 1] = 0xD0 + (n + {"next": 1, "skip3": 3,
                                   "previous": 7}[fault]) % 8
    assert_reads_as_cv2(tmp_path, bytes(data))


@pytest.mark.parametrize("kept", range(1, 10))
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_progressive_smoothing_matches_cv2(tmp_path, sampling, kept):
    """A progressive JPEG of cv2's 10-scan script with only its first
    ``kept`` scans (then EOI): libjpeg-turbo smooths the blocks of each
    component whose first 9 AC coefficients are not all exact (its 5x5
    DC kernels, the DC itself where no AC was sent), equal to
    cv2.imread."""
    data = encode(smooth_image(48, 64, kept), sampling, 75, 0, 0, 1)
    at = 0
    for _ in range(kept + 1):
        at = data.index(b"\xff\xda", at + 2)
    assert_reads_as_cv2(tmp_path, data[:at] + b"\xff\xd9")


@pytest.mark.parametrize("scans", ["one_each", "luma_then_chroma",
                                   "chroma_then_luma"])
@pytest.mark.parametrize("factors", [F420, F444])
def test_sequential_scans_match_cv2(tmp_path, factors, scans):
    """A baseline frame coded in several scans, each of a subset of the
    components (interleaved or not): equal to cv2.imread."""
    plan = {"one_each": [((0,), 0, 63, 0, 0), ((1,), 0, 63, 0, 0),
                         ((2,), 0, 63, 0, 0)],
            "luma_then_chroma": [((0,), 0, 63, 0, 0),
                                 ((1, 2), 0, 63, 0, 0)],
            "chroma_then_luma": [((2, 1), 0, 63, 0, 0),
                                 ((0,), 0, 63, 0, 0)]}[scans]
    data = numpy_jpeg(smooth_image(45, 61, len(scans)), factors, 85, plan,
                      restart=3)
    assert_reads_as_cv2(tmp_path, data)


def _ycck_file(factors, quality=90, seed=4):
    rng = np.random.default_rng(seed)
    rgb = smooth_image(48, 64, seed)
    k = rng.integers(0, 256, (48, 64)).astype(np.float64)
    planes = ycc_planes(rgb) + [k]
    qt = [quant_table(False, quality), quant_table(True, quality)]
    tq = [0, 1, 1, 0]
    factors = factors + [factors[0]]
    return write_jpeg(jpeg_coefficients(planes, factors, qt, tq), qt, tq,
                      factors, 64, 48, [((0, 1, 2, 3), 0, 63, 0, 0)],
                      adobe_transform=2)


@pytest.mark.parametrize("layout", ["444", "420", "pil_progressive_420"])
def test_ycck_matches_cv2(tmp_path, layout):
    """YCCK (Adobe transform 2): jdcolor.c's ycck_cmyk_convert, then cv2's
    CMYK -> BGR, equal to cv2.imread."""
    if layout == "pil_progressive_420":
        bio = io.BytesIO()
        img = smooth_image(48, 64, 2)
        Image.fromarray(np.dstack([img, img[..., :1]]), "CMYK").save(
            bio, "JPEG", quality=85, subsampling=2, progressive=True)
        data = bio.getvalue()
        at = data.index(b"Adobe") + 11
        data = data[:at] + b"\x02" + data[at + 1:]
    else:
        data = _ycck_file(F444 if layout == "444" else F420)
    assert_reads_as_cv2(tmp_path, data)


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("mode", ["sequential", "progressive"])
@pytest.mark.parametrize("factors", [F420, F422, F444, "gray"])
def test_arithmetic_matches_cv2(tmp_path, factors, mode, restart):
    """Arithmetic-coded JPEG (SOF9, SOF10 with jpeg_simple_progression's
    scans) that writers.write_jpeg writes after jcarith.c, with and without
    restarts: jdarith.c's QM decoder, equal to cv2.imread."""
    img = smooth_image(40, 56, restart)
    prog = mode == "progressive"
    if factors == "gray":
        qt = [quant_table(False, 80)]
        coefs = jpeg_coefficients([img[..., 1].astype(np.float64)], [(1, 1)],
                                  qt, [0])
        scans = ([((0,), 0, 0, 0, 1), ((0,), 1, 63, 0, 1),
                  ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)] if prog
                 else [((0,), 0, 63, 0, 0)])
        data = write_jpeg(coefs, qt, [0], [(1, 1)], 56, 40, scans,
                          arithmetic=True, progressive=prog, restart=restart)
    else:
        data = numpy_jpeg(img, factors, 80, PROGRESSION if prog else None,
                          arithmetic=True, progressive=prog,
                          restart=restart)
    assert_reads_as_cv2(tmp_path, data)


@pytest.mark.parametrize("kx", [1, 20])
def test_arithmetic_conditioning_matches_cv2(tmp_path, kx):
    """A DAC segment setting the AC conditioning Kx: equal to cv2.imread."""
    data = numpy_jpeg(smooth_image(48, 64, kx), F420, 80, PROGRESSION,
                      arithmetic=True, progressive=True, kx=kx)
    assert_reads_as_cv2(tmp_path, data)


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_arithmetic_matches_cv2(tmp_path, seed):
    """Bytes of an arithmetic-coded scan overwritten (a bad code ends the
    scan up to the next restart, JWRN_ARITH_BAD_CODE): read as cv2 reads
    it, or refused where cv2 returns None."""
    rng = np.random.default_rng(seed)
    data = bytearray(numpy_jpeg(smooth_image(48, 64, seed), F420, 80,
                                PROGRESSION if seed % 2 else None,
                                arithmetic=True, progressive=seed % 2 == 1,
                                restart=2 * (seed % 3)))
    sos = bytes(data).index(b"\xff\xda")
    for _ in range(3):
        data[int(rng.integers(sos + 12, len(data) - 2))] = int(
            rng.integers(256))
    got, want = read_both(tmp_path, bytes(data), "x.jpg")
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ TIFF
def _pil_tiff(im, **kw):
    bio = io.BytesIO()
    im.save(bio, "TIFF", **kw)
    return bio.getvalue()


@pytest.mark.parametrize("kind", ["ycbcr420_strips16", "ycbcr444_whole",
                                  "ycbcr422_strips32", "rgb_strips16",
                                  "pil_rgb", "pil_gray", "cv2_gray",
                                  "cv2_rgb"])
def test_jpeg_in_tiff_matches_cv2(tmp_path, kind):
    """JPEG-in-TIFF (Compression 7), each strip decoded on its own with
    the JPEGTables: YCbCr (Photometric 6, libjpeg's conversion), RGB (2)
    and gray (1) as decoded; equal to cv2.imread."""
    img = smooth_image(45, 61, len(kind))
    if kind.startswith("ycbcr") or kind == "rgb_strips16":
        factors = {"420": F420, "444": F444, "422": F422}.get(kind[5:8], F444)
        rows = {"strips16": 16, "whole": 45, "strips32": 32}[
            kind.split("_")[1]]
        data = write_jpeg_tiff(img, rows, factors, 80,
                               photometric=2 if kind[:3] == "rgb" else 6)
    elif kind.startswith("pil"):
        data = _pil_tiff(Image.fromarray(img if kind == "pil_rgb"
                                         else img[..., 0]),
                         compression="jpeg")
    else:
        src = img[..., 0] if kind == "cv2_gray" else img[..., ::-1]
        ok, buf = cv2.imencode(".tif", src, [
            cv2.IMWRITE_TIFF_COMPRESSION, 7, cv2.IMWRITE_TIFF_ROWSPERSTRIP,
            16])
        assert ok
        data = buf.tobytes()
    assert_reads_as_cv2(tmp_path, data, "j.tif")


@pytest.mark.parametrize("fill_order", [1, 2])
@pytest.mark.parametrize("coding", ["mh", "t4_1d", "t4_2d", "t4_fill_bits",
                                    "t6"])
def test_ccitt_matches_cv2(tmp_path, coding, fill_order):
    """CCITT bilevel TIFF that PIL writes through libtiff: modified Huffman
    (Compression 2), T.4 1D, 2D and with fill bits (3, Group3Options 0 / 1
    / 4), T.6 (4), each in both FillOrders; equal to cv2.imread."""
    rng = np.random.default_rng(len(coding) + fill_order)
    bits = (smooth_image(48, 64, fill_order)[..., 0] > 128) ^ (
        rng.random((48, 64)) > 0.95)
    compression, options = {"mh": ("tiff_ccitt", None),
                            "t4_1d": ("group3", 0), "t4_2d": ("group3", 1),
                            "t4_fill_bits": ("group3", 5),
                            "t6": ("group4", None)}[coding]
    info = {266: fill_order}
    if options is not None:
        info[292] = options
    data = _pil_tiff(Image.fromarray(bits), compression=compression,
                     tiffinfo=info)
    assert_reads_as_cv2(tmp_path, data, "f.tif")


def test_wide_ccitt_matches_cv2(tmp_path):
    """CCITT rows of 2700 pixels (runs past 1728 take the extended make-up
    codes), T.4 2D and T.6: equal to cv2.imread."""
    rng = np.random.default_rng(0)
    bits = np.zeros((12, 2700), bool)
    bits[:, 100:2600] = rng.random((12, 2500)) > 0.999
    for compression, info in (("group3", {292: 1}), ("group4", {})):
        data = _pil_tiff(Image.fromarray(bits), compression=compression,
                         tiffinfo=info)
        assert_reads_as_cv2(tmp_path, data, f"w_{compression}.tif")


@pytest.mark.parametrize("layout", ["pil_raw", "pil_lzw", "pil_packbits",
                                    "contig", "planar", "planar_lzw"])
def test_cmyk_tiff_matches_cv2(tmp_path, layout):
    """CMYK TIFF (Photometric 5, InkSet 1, 8-bit): tif_getimage.c's k =
    255 - K, r = k (255 - C) / 255, equal to cv2.imread."""
    rng = np.random.default_rng(len(layout))
    cmyk = np.dstack([smooth_image(45, 61, 1),
                      rng.integers(0, 256, (45, 61), dtype=np.uint8)])
    if layout.startswith("pil"):
        data = _pil_tiff(Image.fromarray(cmyk, "CMYK"), compression={
            "pil_raw": "raw", "pil_lzw": "tiff_lzw",
            "pil_packbits": "packbits"}[layout])
    else:
        data = write_tiff(cmyk, photometric=5,
                          planar=2 if "planar" in layout else 1,
                          compression=5 if "lzw" in layout else 1,
                          rows_per_strip=16)
    assert_reads_as_cv2(tmp_path, data, "c.tif")


@pytest.mark.parametrize("size", [(48, 64), (45, 61)])
@pytest.mark.parametrize("subsampling", [(1, 1), (1, 2), (2, 1), (2, 2),
                                         (4, 1), (4, 2), (4, 4)])
def test_ycbcr_tiff_matches_cv2(tmp_path, subsampling, size):
    """Uncompressed YCbCr TIFF (Photometric 6) in each subsampling
    tif_getimage.c puts (blocks of hs x vs luma samples, then Cb and Cr),
    strips of 8 rows, whole and partial blocks at the edges: TIFFYCbCrToRGB
    with the default coefficients and reference, equal to cv2.imread."""
    h, w = size
    ycc = np.clip(np.round(np.stack(ycc_planes(smooth_image(h, w, 5)), -1)),
                  0, 255).astype(np.uint8)
    data = write_tiff(ycc, photometric=6, subsampling=subsampling,
                      rows_per_strip=8)
    assert_reads_as_cv2(tmp_path, data, "y.tif")


@pytest.mark.parametrize("fault", ["count_30", "count_80", "byte_flip"])
@pytest.mark.parametrize("predictor", [1, 2])
def test_short_lzw_strip_matches_cv2(tmp_path, predictor, fault):
    """An LZW strip whose byte count is cut, or a byte of it overwritten:
    libtiff leaves zeros after what it decoded and skips that strip's
    predictor ("Not enough data"); cv2 reads the image, equal to the
    port's."""
    data = bytearray(write_tiff(smooth_image(48, 64, 1), compression=5,
                                predictor=predictor, rows_per_strip=16))
    count_at = bytes(data).index(struct.pack("<HHI", 279, 4, 3))
    at = struct.unpack("<I", data[count_at + 8:count_at + 12])[0] + 4
    (count,) = struct.unpack("<I", data[at:at + 4])
    offset_at = bytes(data).index(struct.pack("<HHI", 273, 4, 3))
    first = struct.unpack("<I", data[offset_at + 8:offset_at + 12])[0] + 4
    (offset,) = struct.unpack("<I", data[first:first + 4])
    if fault == "byte_flip":
        data[offset + count // 2] ^= 0x5A
    else:
        data[at:at + 4] = struct.pack("<I", count * int(fault[-2:]) // 100)
    assert_reads_as_cv2(tmp_path, bytes(data), "l.tif")


# ----------------------------------------------------------- detect set
def _new_kinds_dataset(root):
    """make_dataset's detect set with each PNG rewritten, cycled, as a cut
    JPEG, a CCITT T.6 TIFF, a YCbCr JPEG-in-TIFF, a CMYK TIFF and an
    arithmetic-coded JPEG."""
    make_dataset(root, 6, 4, [(64, 48), (40, 90), (100, 70)], 3, seed=8)

    def cut(a):
        data = encode(a, "420", 85, 0, 0, 1)
        sos = data.index(b"\xff\xda")
        return data[:sos + (len(data) - sos) * 2 // 3]

    writers = [
        (".jpg", cut),
        (".tif", lambda a: _pil_tiff(Image.fromarray(a[..., 1] > 100),
                                     compression="group4")),
        (".tif", lambda a: write_jpeg_tiff(a, 16, F420, 85)),
        (".tiff", lambda a: write_tiff(np.dstack([255 - a, a[..., :1] // 3]),
                                       photometric=5, compression=5)),
        (".jpg", lambda a: numpy_jpeg(a, F420, 85, arithmetic=True)),
    ]
    k = 0
    for split in ("train", "val"):
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
    """load_labels of a detect set of cut JPEG, CCITT TIFF, YCbCr
    JPEG-in-TIFF, CMYK TIFF and arithmetic JPEG files in the port and in
    the JAX package (cv2.imread there): the same files, boxes and image
    arrays, resized to the image size."""
    root = str(tmp_path)
    _new_kinds_dataset(root)
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", image_size=64,
                  number_class=3)
    got = load_labels(Config(**common), is_val=is_val)
    want = jax_load_labels(JaxConfig(**common), is_val=is_val)
    assert len(got) == len(want) == (4 if is_val else 6)
    for g, w in zip(got, want):
        assert g.im_file == w.im_file
        assert g.org_shape == w.org_shape
        np.testing.assert_array_equal(g.img, w.img, err_msg=g.im_file)
        np.testing.assert_array_equal(g.bboxes, w.bboxes)
