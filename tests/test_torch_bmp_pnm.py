"""The port's cv2-free BMP, PNM and PAM readers against cv2 5.0 on the CPU,
bit for bit against cv2.imread(IMREAD_COLOR) -> RGB (None where cv2
returns None, and then the port raises an error that is both a
FileNotFoundError and a ValueError, naming the file).

BMP: every header size cv2 reads (OS/2 12, 36, 40, 52, 56, 64, 108, 124),
1-, 4- and 8-bit palettes (short ones too), 16-bit 5-5-5 and 5-6-5 with
the masks where cv2 looks for them, 24-bit, 32-bit with BI_RGB and with
BI_BITFIELDS of any masks (cv2 scales each channel in float32), RLE8 and
RLE4 with every escape, bottom-up and top-down; seeded random files of
each kind and seeded random RLE op streams, which found the behaviours the
reader copies (bmp.py's docstring). PNM: P1-P6, ASCII and binary, every
maxval kind, comments. PAM: every tuple type, bit mode, 8 and 16 bits; the
_ALPHA kinds are held on the pixels cv2 writes (cv2 5.0 leaves the rest of
each row unwritten, see pnm.py)."""

import os
import struct
import sys

import cv2
import numpy as np
import pytest

from yolosharp_tpu_torch.data.bmp import decode_bmp_rgb
from yolosharp_tpu_torch.data.errors import ImageReadError
from yolosharp_tpu_torch.data.image_ops import read_image_rgb
from yolosharp_tpu_torch.data.pnm import decode_pnm_rgb

FIXTURES = os.path.join(os.path.dirname(__file__), "data_torch", "images")
sys.path.insert(0, FIXTURES)
from writers import (BI_BITFIELDS, BI_RGB, BI_RLE4, BI_RLE8,  # noqa: E402
                     rle_encode, write_bmp, write_pam, write_pnm)


def _both(tmp_path, name, data):
    """(port's RGB or None, cv2's RGB or None) of `data` written as a file
    (a new name each time: cv2 reads a path)."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    try:
        got = read_image_rgb(path)
    except ImageReadError as err:
        assert path in str(err)
        assert isinstance(err, FileNotFoundError)
        got = None
    return got, None if want is None else want[..., ::-1]


def _assert_same(got, want, label=""):
    if want is None:
        assert got is None, f"{label}: cv2 reads nothing, the port read"
        return
    assert got is not None, f"{label}: cv2 reads it, the port raised"
    np.testing.assert_array_equal(got, want, err_msg=label)


# ----------------------------------------------------------------- BMP
# (header size, top-down): an OS/2 header's sizes are 16-bit unsigned
HEADERS = [(12, False)] + [(hs, td) for hs in (36, 40, 52, 56, 64, 108, 124)
                           for td in (False, True)]


@pytest.mark.parametrize("header,top_down", HEADERS)
@pytest.mark.parametrize("bpp", [1, 4, 8])
def test_paletted_bmp_matches_cv2(tmp_path, bpp, header, top_down):
    """Palettes of every header (OS/2: 3-byte entries, 2**bpp of them;
    else 4-byte entries, biClrUsed of them: full and short, an index past
    a short palette reads black)."""
    rng = np.random.default_rng(bpp * 1000 + header)
    for i, (h, w) in enumerate([(1, 1), (5, 7), (9, 33)]):
        n = 1 << bpp if header == 12 or i == 0 else int(rng.integers(2, (1 << bpp) + 1))
        pal = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, 1 << bpp, (h, w))
        data = write_bmp(idx, bpp, header=header, palette=pal,
                         top_down=top_down)
        got, want = _both(tmp_path, f"p{i}.bmp", data)
        _assert_same(got, want, f"{bpp}-bit, header {header}, {n} colours")
        assert want is not None


@pytest.mark.parametrize("header", [40, 56, 108, 124])
@pytest.mark.parametrize("masks", [None, (0x7C00, 0x3E0, 0x1F),
                                   (0xF800, 0x7E0, 0x1F),
                                   (0xF00, 0xF0, 0xF)],
                         ids=["rgb555", "bf555", "bf565", "bf444"])
def test_16bit_bmp_matches_cv2(tmp_path, masks, header):
    """16-bit: BI_RGB (5-5-5) and BI_BITFIELDS, the masks as cv2 finds
    them (after the header, whatever its size), with the masks also
    written there for a longer header; other masks raise, as cv2 reads
    nothing."""
    rng = np.random.default_rng(header)
    v = rng.integers(0, 1 << 16, (6, 11))
    data = write_bmp(v, 16, header=header,
                     compression=BI_BITFIELDS if masks else BI_RGB,
                     masks=masks)
    got, want = _both(tmp_path, "a.bmp", data)
    _assert_same(got, want, "masks in the header")
    if masks and header > 40:
        off = 14 + header
        data = data[:off] + struct.pack("<3I", *masks) + data[off:]
        data = data[:10] + struct.pack("<I", off + 12) + data[14:]
        got, want = _both(tmp_path, "b.bmp", data)
        _assert_same(got, want, "masks after the header")
        assert (want is None) == (masks == (0xF00, 0xF0, 0xF))


def _random_mask(rng):
    bits = int(rng.integers(1, 25))
    shift = int(rng.integers(0, 33 - bits))
    return (((1 << bits) - 1) << shift) & 0xFFFFFFFF


@pytest.mark.parametrize("header", [40, 52, 56, 108, 124])
def test_32bit_bmp_masks_match_cv2(tmp_path, header):
    """32-bit BI_RGB and BI_BITFIELDS: 40 seeded mask sets of 1-24-bit
    channels anywhere in the word, one of them zero now and then, each
    channel scaled as cv2 scales it (float32) where the header holds the
    masks (56 bytes on), the bytes as B, G, R where it does not."""
    rng = np.random.default_rng(header)
    v = rng.integers(0, 1 << 32, (7, 9), dtype=np.uint64)
    got, want = _both(tmp_path, "rgb.bmp", write_bmp(v, 32, header=header))
    _assert_same(got, want, "BI_RGB")
    for i in range(40):
        masks = [_random_mask(rng) for _ in range(4)]
        if i % 7 == 3:
            masks[i % 3] = 0
        data = write_bmp(v, 32, header=header, compression=BI_BITFIELDS,
                         masks=masks)
        got, want = _both(tmp_path, f"m{i}.bmp", data)
        _assert_same(got, want, f"masks {[hex(m) for m in masks]}")


@pytest.mark.parametrize("header,top_down",
                         [(12, False), (40, False), (40, True), (124, False),
                          (124, True)])
def test_24bit_bmp_matches_cv2(tmp_path, header, top_down):
    rng = np.random.default_rng(header)
    for i, (h, w) in enumerate([(1, 1), (4, 5), (13, 31)]):
        px = rng.integers(0, 256, (h, w, 3))
        got, want = _both(tmp_path, f"t{i}.bmp",
                          write_bmp(px, 24, header=header, top_down=top_down))
        _assert_same(got, want, f"{h}x{w}")
        assert want is not None


def _rle_ops(rng, h, w, bpp):
    """A seeded stream of RLE ops that reaches every escape: runs (RLE4:
    pairs too), absolute runs, end-of-line, delta, end-of-bitmap, some
    past the row's end or the image's."""
    ops = []
    for _ in range(int(rng.integers(1, 3 * h + 3))):
        k = rng.random()
        if k < 0.35:
            ops.append(("run", int(rng.integers(1, w + 2)),
                        int(rng.integers(0, 256 if bpp == 8 else 16))))
        elif k < 0.45 and bpp == 4:
            ops.append(("pairrun", int(rng.integers(1, w + 2)),
                        int(rng.integers(0, 16)), int(rng.integers(0, 16))))
        elif k < 0.65:
            ops.append(("abs", [int(a) for a in rng.integers(
                0, 1 << bpp, int(rng.integers(3, max(4, w + 2))))]))
        elif k < 0.8:
            ops.append(("eol",))
        elif k < 0.92:
            ops.append(("delta", int(rng.integers(0, w + 1)),
                        int(rng.integers(0, 3))))
        else:
            ops.append(("eob",))
    if rng.random() < 0.85:
        ops.append(("eob",))
    return ops


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("bpp", [4, 8])
def test_rle_bmp_matches_cv2(tmp_path, bpp, seed):
    """RLE8 / RLE4: the encoder's own streams (runs, absolute runs, an
    end-of-line each row, an end-of-bitmap) and 60 seeded random op
    streams a seed (deltas, early ends, runs past the row), bottom-up and
    top-down: the same image, or None from both."""
    rng = np.random.default_rng(seed * 10 + bpp)
    comp = BI_RLE8 if bpp == 8 else BI_RLE4
    decoded = 0
    for i in range(60):
        h, w = int(rng.integers(1, 8)), int(rng.integers(1, 12))
        pal = rng.integers(0, 256, (1 << bpp, 3))
        if i % 4 == 0:
            data = rle_encode(rng.integers(0, 3, (h, w)), bpp)
        else:
            data = rle_encode(None, bpp, _rle_ops(rng, h, w, bpp))
        bmp = write_bmp(np.zeros((h, w), int), bpp, compression=comp,
                        palette=pal, rle=data, top_down=i % 7 == 0)
        got, want = _both(tmp_path, f"r{i}.bmp", bmp)
        _assert_same(got, want, f"stream {i}")
        decoded += want is not None
    assert decoded >= 15


@pytest.mark.parametrize("kind", ["header20", "bpp2", "clrused300",
                                  "alphabitfields", "rle8_4bit",
                                  "truncated_rows", "truncated_palette",
                                  "rle_no_eob"])
def test_bmp_kinds_cv2_refuses_raise(tmp_path, kind):
    """What cv2 5.0 reads no image from raises, naming the file: a 20-byte
    header, 2-bit pixels, a palette of 300 colours, BI_ALPHABITFIELDS,
    RLE8 on 4-bit pixels, rows or a palette cut short, an RLE stream that
    ends before its last row."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 4, (4, 8))
    pal = rng.integers(0, 256, (16, 3))
    if kind == "header20":
        d = write_bmp(rng.integers(0, 256, (4, 8, 3)), 24)
        data = d[:14] + struct.pack("<I", 20) + d[18:34] + d[54:]
        data = data[:10] + struct.pack("<I", 34) + data[14:]
    elif kind == "bpp2":
        data = write_bmp(idx, 2, palette=pal[:4])
    elif kind == "clrused300":
        data = write_bmp(idx, 8, palette=pal, clr_used=300)
    elif kind == "alphabitfields":
        data = write_bmp(idx.astype(np.uint64), 32, header=56, compression=6,
                         masks=(0xFF, 0xFF00, 0xFF0000, 0))
    elif kind == "rle8_4bit":
        data = write_bmp(idx, 4, compression=BI_RLE8, palette=pal,
                         rle=rle_encode(idx, 8))
    elif kind == "truncated_rows":
        data = write_bmp(rng.integers(0, 256, (4, 8, 3)), 24)[:-5]
    elif kind == "truncated_palette":
        data = write_bmp(idx, 8, palette=pal)[:54 + 30]
    else:
        data = write_bmp(idx, 8, compression=BI_RLE8, palette=pal,
                         rle=rle_encode(None, 8, [("run", 8, 1), ("eol",)]))
    got, want = _both(tmp_path, f"{kind}.bmp", data)
    assert want is None and got is None
    with pytest.raises(ValueError) as err:
        decode_bmp_rgb(data, "x.bmp")
    assert "x.bmp" in str(err.value)


# ----------------------------------------------------------------- PNM
@pytest.mark.parametrize("maxval", [1, 7, 100, 254, 255, 256, 1000, 65535])
@pytest.mark.parametrize("kind", [2, 3, 5, 6])
def test_pnm_maxval_matches_cv2(tmp_path, kind, maxval):
    """Graymaps and pixmaps at every maxval kind: ASCII scaled to 8 bits
    (values past maxval clamp to it), binary as stored, 16-bit samples as
    their high byte; comments in the header."""
    rng = np.random.default_rng(kind * 100000 + maxval)
    shape = (5, 13, 3) if kind in (3, 6) else (5, 13)
    top = maxval + (3 if kind in (2, 3) and maxval < 255 else 1)
    s = rng.integers(0, top, shape)
    if kind in (5, 6) and maxval < 256:
        s = np.minimum(s, 255)
    for i, comment in enumerate([None, "written by a test"]):
        got, want = _both(tmp_path, f"a{i}.pnm",
                          write_pnm(s, kind, maxval, comment=comment,
                                    per_line=7 if i else None))
        _assert_same(got, want, f"P{kind} maxval {maxval}")
        assert want is not None


@pytest.mark.parametrize("kind", [1, 4])
def test_pbm_matches_cv2(tmp_path, kind):
    """Bitmaps (1 black), P1 with and without separators between the
    digits, widths that are and are not a multiple of 8."""
    rng = np.random.default_rng(kind)
    for i, (h, w) in enumerate([(1, 1), (3, 8), (7, 13)]):
        s = rng.integers(0, 2, (h, w))
        for j, packed in enumerate([False, True] if kind == 1 else [False]):
            got, want = _both(tmp_path, f"b{i}{j}.pbm",
                              write_pnm(s, kind, comment="c",
                                        packed_ascii_bits=packed))
            _assert_same(got, want, f"P{kind} {h}x{w}")
            assert want is not None


ASCII_RASTERS = {
    "comment_between_samples": b"P2\n3 2\n255\n1 2 3\n# c\n4 5 6\n",
    "no_byte_after_last": b"P2\n3 2\n255\n1 2 3 4 5 6",
    "more_samples": b"P2\n3 2\n255\n1 2 3 4 5 6\n7 8\n",
    "truncated": b"P2\n3 2\n255\n1 2 3 4 5",
    "p1_spacing": b"P1\n3 2\n101 1\n0\n0\n",
    "p1_no_byte_after": b"P1\n3 2\n101100",
    "p1_truncated": b"P1\n3 2\n10110",
    "leading_zeros": b"P2\n2 1\n255\n0000000000007 9\n",
    "garbage_after": b"P2\n2 1\n255\n7 9\nxyz",
    "letter_terminator": b"P2\n2 1\n255\n7a9\n",
    "too_large": b"P2\n2 1\n255\n7 99999999999\n",
    "too_large_2_64_plus_7": b"P2\n2 1\n255\n7 18446744073709551623\n",
    "p3_every_space": b"P3\n1 2\n255\n1\t2\t3\r\n4\x0b5\x0c6 ",
}


@pytest.mark.parametrize("kind", sorted(ASCII_RASTERS) + ["p3_640x480"])
def test_ascii_raster_matches_cv2(tmp_path, kind):
    """The ASCII raster, read in one pass where it is digits and
    whitespace only and number by number otherwise, against cv2: what
    ends a number, what follows the last one, samples left over, a
    comment among the samples, a short or out-of-range raster, and a
    dataset-sized P3."""
    if kind == "p3_640x480":
        s = np.random.default_rng(3).integers(0, 256, (480, 640, 3))
        data = write_pnm(s, 3)
    else:
        data = ASCII_RASTERS[kind]
    got, want = _both(tmp_path, f"{kind}.pnm", data)
    _assert_same(got, want, kind)
    if kind == "p3_640x480":
        np.testing.assert_array_equal(got, s)


PAM_KINDS = [("BLACKANDWHITE", 1, 1)] + [
    (t, d, m) for t, d in (("GRAYSCALE", 1), ("RGB", 3), (None, 1),
                           (None, 3), ("GRAYSCALE_ALPHA", 2),
                           ("RGB_ALPHA", 4))
    for m in (1, 100, 255, 65535)]


@pytest.mark.parametrize("tupltype,depth,maxval", PAM_KINDS)
def test_pam_matches_cv2(tmp_path, tupltype, depth, maxval):
    """Every tuple type cv2 5.0 knows, with and without the TUPLTYPE line,
    at MAXVAL 1 (cv2's bit mode: each row's bytes as packed bits), below
    and at 255 (as stored) and 65535 (the high byte). The _ALPHA kinds are
    held on the first ceil(width / depth) pixels of each row, the ones cv2
    writes."""
    rng = np.random.default_rng(depth * 10 + maxval)
    h, w = 4, 21
    s = rng.integers(0, maxval + 1, (h, w, depth))
    got, want = _both(tmp_path, "a.pam", write_pam(s, maxval, tupltype,
                                                    comment="x"))
    if tupltype is None and maxval > 255:
        assert want is None and got is None
        return
    assert want is not None and got is not None
    if tupltype and tupltype.endswith("_ALPHA") and maxval > 1:
        n = -(-w // depth)
        np.testing.assert_array_equal(got[:, :n], want[:, :n])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["pam_depth2_untyped", "pam_unknown_type",
                                  "pam_lower_case_type", "pam_no_break",
                                  "pnm_truncated", "pnm_bad_byte",
                                  "pnm_zero_width"])
def test_pnm_kinds_cv2_refuses_raise(tmp_path, kind):
    rng = np.random.default_rng(0)
    s = rng.integers(0, 256, (3, 5, 2))
    if kind == "pam_depth2_untyped":
        data = write_pam(s, 255)
    elif kind == "pam_unknown_type":
        data = write_pam(s, 255, "GRAY_PLUS")
    elif kind == "pam_lower_case_type":
        data = write_pam(s[..., :1], 255, "grayscale")
    elif kind == "pam_no_break":
        data = b"P7 " + write_pam(s, 255, "GRAYSCALE_ALPHA")[3:]
    elif kind == "pnm_truncated":
        data = write_pnm(s[..., 0], 5, 255)[:-4]
    elif kind == "pnm_bad_byte":
        data = b"P2\n3 x\n255\n1 2 3\n"
    else:
        data = b"P5\n0 3\n255\n"
    got, want = _both(tmp_path, f"{kind}.pnm", data)
    assert want is None and got is None
    with pytest.raises(ValueError):
        decode_pnm_rgb(data, "x.pnm")
