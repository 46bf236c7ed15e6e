"""GIF, Sun raster, PFM, Radiance HDR and JPEG without DHT segments as
cv2.imread (5.0) reads them, against the port's cv2-free readers on the
CPU, bit for bit: the committed fixtures (also against the JAX package's
reader), the edge cases of cv2's own decoders (GIF LZW, colour tables and
transparency; the Sun raster types and colour maps cv2 5.0 takes; PFM
headers, byte orders and its float -> 8-bit conversion; HDR headers and
RLE), the files cv2 refuses (each asserted None in cv2 first), and a
detect set of these kinds under .jpg / .png names loaded as the JAX
package's loader loads it."""

import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest

from test_torch_data import make_dataset
from test_torch_jpeg2000 import assert_reads_as_cv2, assert_refused_as_cv2
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data.labels import _read_image_rgb as jax_read_image_rgb
from yolosharp_tpu.data.labels import load_labels as jax_load_labels
from yolosharp_tpu_torch import Config
from yolosharp_tpu_torch.data.image_ops import read_image_rgb
from yolosharp_tpu_torch.data.labels import load_labels

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "data_torch", "images")
sys.path.insert(0, FIXTURES)
sys.path.insert(0, os.path.join(HERE, "data_torch", "jpeg"))
from make_fixtures import encode, smooth_image  # noqa: E402
from writers import (_gif_blocks, float_to_rgbe, write_gif,  # noqa: E402
                     write_hdr, write_pfm, write_sunras)
from j2k_writer import write_j2k  # noqa: E402

PREFIXES = ("gif_", "ras_", "pfm_", "hdr_", "dhtless_")


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(n for n in _manifest()
                                        if n.startswith(PREFIXES)))
def test_fixture_matches_cv2_and_jax(name):
    """Each committed GIF, Sun raster, PFM, HDR and DHT-less JPEG fixture:
    the port's RGB equals cv2.imread's (the manifest's hash) and the JAX
    package's reader's."""
    path = os.path.join(FIXTURES, name)
    img = read_image_rgb(path)
    entry = _manifest()[name]
    assert list(img.shape) == entry["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(img, jax_read_image_rgb(path))


# ---------------------------------------------------------------- JPEG

def drop_dht(data):
    """The JPEG without any DHT segment (a motion-JPEG frame)."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data) - 1:
        if data[pos] == 0xFF and data[pos + 1] == 0xC4:
            (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
            pos += 2 + length
            continue
        out.append(data[pos])
        pos += 1
    return bytes(out + data[pos:])


def table_selector(data, comp, value):
    """The JPEG with its first scan's table selector of comp set to value
    (Td << 4 | Ta)."""
    sos = data.index(b"\xff\xda")
    out = bytearray(data)
    out[sos + 6 + 2 * comp] = value
    return bytes(out)


@pytest.mark.parametrize("sampling,restart", [("420", 0), ("420", 2),
                                              ("444", 0), ("444", 1)])
@pytest.mark.parametrize("progressive", [False, True])
def test_dhtless_jpeg_matches_cv2(tmp_path, sampling, restart, progressive):
    """A JPEG without DHT segments: libjpeg-turbo's sequential decoder
    fills Huffman slots 0 and 1 with the standard tables (jstdhuff.c), so
    cv2 reads it; its progressive decoder does not, so cv2 refuses it."""
    data = drop_dht(encode(smooth_image(48, 64, 3), sampling, 80, restart,
                           0, int(progressive)))
    assert b"\xff\xc4" not in data
    if progressive:
        assert_refused_as_cv2(tmp_path, data, "a.jpg")
    else:
        assert_reads_as_cv2(tmp_path, data, "a.jpg")


@pytest.mark.parametrize("selector,readable", [(0x11, True), (0x01, True),
                                               (0x22, False), (0x12, False),
                                               (0x30, False)])
def test_dhtless_table_slots_match_cv2(tmp_path, selector, readable):
    """Only slots 0 and 1 take the standard tables: a DHT-less scan that
    names slot 2 or 3 is refused, by cv2 and the port."""
    data = table_selector(drop_dht(encode(smooth_image(48, 64, 4), "420",
                                          75, 0, 0, 0)), 0, selector)
    if readable:
        assert_reads_as_cv2(tmp_path, data, "a.jpg")
    else:
        assert_refused_as_cv2(tmp_path, data, "a.jpg")


# ---------------------------------------------------------------- GIF

_PAL = (np.arange(16)[:, None] * np.array([16, 8, 4])).astype(np.uint8)


def lzw_codes(codes, width):
    """Codes of a fixed width packed LSB first."""
    acc = nbits = 0
    out = bytearray()
    for c in codes:
        acc |= c << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    return bytes(out + (bytes([acc]) if nbits else b""))


def tiny_gif(codes, mcs=4, gce=b""):
    """A 4x2 GIF of a 16-colour global table and the given LZW codes (each
    mcs + 1 bits), after the extension bytes ``gce``."""
    return (b"GIF89a" + struct.pack("<HHBBB", 4, 2, 0xF3, 0, 0)
            + _PAL.tobytes() + gce + b"\x2c"
            + struct.pack("<HHHHB", 0, 0, 4, 2, 0) + bytes([mcs])
            + _gif_blocks(lzw_codes(codes, mcs + 1)) + b"\x3b")


EIGHT = [16, 1, 2, 3, 4, 5, 6, 7, 8]          # Clear, then 8 literals
GIF_CASES = {
    # cv2 reads
    "plain": (EIGHT + [17], {}),
    "no_end_code": (EIGHT, {}),
    "kwk_code": ([16, 1, 18, 4, 5, 6, 7, 8, 17], {}),
    "end_then_more": ([16, 1, 2, 3, 4, 17, 16, 5, 6, 7, 8, 17], {}),
    "one_code_past_full": (EIGHT + [9, 17], {}),
    "bad_code_past_full": (EIGHT + [30, 17], {}),
    "two_clears": ([16] + EIGHT + [17], {}),
    "mcs_11": ([2048, 1, 2, 3, 4, 5, 6, 7, 8, 2049], dict(mcs=11)),
    "transparent_past_table": ([32, 1, 20, 3, 4, 5, 6, 7, 8, 33], dict(
        mcs=5, gce=b"\x21\xf9\x04\x01\x00\x00\x14\x00")),
    "two_gces": (EIGHT + [17], dict(
        gce=b"\x21\xf9\x04\x00\x00\x00\x00\x00\x21\xf9\x04\x01\x00\x00"
            b"\x01\x00")),
    # cv2 refuses
    "two_codes_past_full": (EIGHT + [9, 10, 17], {}),
    "short": ([16, 1, 2, 3, 4, 5, 17], {}),
    "code_past_table": ([16, 1, 20, 3, 4, 5, 6, 7, 8, 17], {}),
    "overflowing_string": ([16, 1, 2, 3, 4, 5, 6, 7, 20, 17], {}),
    "mcs_1": ([2, 1, 0, 1, 0, 1, 0, 1, 0, 3], dict(mcs=1)),
    "mcs_12": ([4096, 1, 2, 3, 4, 5, 6, 7, 8, 4097], dict(mcs=12)),
    "index_past_table": ([32, 1, 21, 3, 4, 5, 6, 7, 8, 33], dict(mcs=5)),
    "disposal_7": (EIGHT + [17], dict(
        gce=b"\x21\xf9\x04\x1c\x00\x00\x00\x00")),
}
GIF_REFUSED = {"two_codes_past_full", "short", "code_past_table",
               "overflowing_string", "mcs_1", "mcs_12", "index_past_table",
               "disposal_7"}


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_gif_lzw_matches_cv2(tmp_path, case):
    """cv2's own LZW reading of a 4x2 frame: codes after End, one code
    past a full frame tolerated and a second refused, the KwK code, codes
    past the table, minimum code sizes, a transparent index past the
    table, the last Graphic Control Extension, a disposal method past 3."""
    codes, kw = GIF_CASES[case]
    data = tiny_gif(codes, **kw)
    if case in GIF_REFUSED:
        assert_refused_as_cv2(tmp_path, data, "a.gif")
    else:
        assert_reads_as_cv2(tmp_path, data, "a.gif")


def _gif_case(case):
    rng = np.random.default_rng(2)
    pal = rng.integers(0, 256, (32, 3), np.uint8)
    idx = (smooth_image(30, 40, 2)[..., 0] // 8).astype(np.uint8)
    frame = dict(indices=idx, left=5, top=4)
    if case == "local_over_global":
        frame["palette"] = pal[:16]
        frame["indices"] = idx
        return write_gif([frame], 64, 48, pal, background=2)
    if case == "local_over_short_global":
        frame["palette"] = pal[:16]
        return write_gif([frame], 64, 48, pal[:8])
    if case == "background_past_table":
        return write_gif([frame], 64, 48, pal[:16], background=20)
    if case == "huge_screen":
        return write_gif([frame], 65535, 65535, pal)
    if case == "frame_off_screen":
        return write_gif([dict(frame, left=30)], 64, 48, pal)
    data = write_gif([frame, dict(frame, indices=31 - idx)], 64, 48, pal)
    if case == "no_trailer":
        return data[:-1]
    if case == "cut":
        return data[:len(data) * 3 // 4]
    if case == "unknown_block":
        return data[:-1] + b"\x99\x3b"
    if case == "garbage_after_trailer":
        return data + b"garbage"
    return write_gif([dict(frame, transparent=3, disposal=int(case[-1]))],
                     64, 48, pal, background=6)


@pytest.mark.parametrize("case", [
    "local_over_global", "garbage_after_trailer", "disposal_0",
    "disposal_1", "disposal_2", "disposal_3", "local_over_short_global",
    "background_past_table", "frame_off_screen", "no_trailer", "cut",
    "unknown_block", "huge_screen"])
def test_gif_structure_matches_cv2(tmp_path, case):
    """cv2's canvas (the global background colour whatever the disposal),
    its one colour-table buffer (a local table over the global one, the
    index bound the larger of the two), and its refusals: a background
    index past the table, a frame off the screen, a file without its
    trailer, cut short, or with an unknown block (cv2 walks every block
    first), a screen past cv2's size limits (cv2 raises)."""
    data = _gif_case(case)
    if case in ("local_over_short_global", "background_past_table",
                "frame_off_screen", "no_trailer", "cut", "unknown_block",
                "huge_screen"):
        assert_refused_as_cv2(tmp_path, data, "a.gif")
    else:
        assert_reads_as_cv2(tmp_path, data, "a.gif")


# ---------------------------------------------------------------- Sun raster

def _ras_case(case):
    img = smooth_image(20, 23, 4)
    if case.startswith("type"):
        kind = int(case[4])
        return write_sunras(img[..., 1], 8, kind)
    if case in ("depth4", "depth16"):
        data = bytearray(write_sunras(img[..., 1], 8))
        data[12:16] = struct.pack(">I", int(case[5:]))
        return bytes(data)
    if case == "rgb_with_map":
        data = write_sunras(img, 24)
        head = bytearray(data[:32])
        head[24:32] = struct.pack(">II", 1, 6)
        return bytes(head) + bytes(6) + data[32:]
    if case == "map_too_long":
        return write_sunras(img[..., 0] > 99, 1, 1,
                            np.zeros((3, 3), np.uint8))
    if case == "map_47_bytes":
        data = write_sunras(img[..., 1], 8, 1,
                            np.random.default_rng(1).integers(
                                0, 256, (16, 3), np.uint8))
        head = bytearray(data[:32])
        head[28:32] = struct.pack(">I", 47)
        return bytes(head) + data[32:32 + 47] + data[32 + 48:]
    if case == "cut_padding":
        return write_sunras(img[..., 1], 8)[:-1]
    return write_sunras(img[..., 1], 8) + b"extra"


@pytest.mark.parametrize("case", [
    "type0", "type1", "map_47_bytes", "extra_bytes", "type2", "type3",
    "type5", "depth4", "depth16", "rgb_with_map", "map_too_long",
    "cut_padding"])
def test_sunras_matches_cv2(tmp_path, case):
    """cv2 5.0 reads the old and standard types only (byte-encoded and
    RGB files are refused), depths 1, 8, 24 and 32, a colour map of any
    length up to 3 * 2**depth bytes (length // 3 entries a plane) on
    depths up to 8; every row's padding must be there."""
    data = _ras_case(case)
    if case in ("type0", "type1", "map_47_bytes", "extra_bytes"):
        assert_reads_as_cv2(tmp_path, data, "a.ras")
    else:
        assert_refused_as_cv2(tmp_path, data, "a.ras")


# ---------------------------------------------------------------- PFM

_PFM_HEADERS = {
    "standard": b"PF\n7 5\n-1.0\n", "int_scale": b"PF\n7 5\n-1\n",
    "lines": b"PF\n7\n5\n-1.0\n", "space_after_scale": b"PF\n7 5\n-1.0 ",
    "exponent": b"PF\n7 5\n-1.0e0\n", "plus": b"PF\n7 5\n+4.0\n",
    "scale_third": b"PF\n7 5\n-0.333\n",
    "space_after_pf": b"PF 7 5 -1.0\n", "crlf": b"PF\r\n7 5\n-1.0\n",
    "zero_scale": b"PF\n7 5\n0\n", "double_space": b"PF\n7  5\n-1.0\n",
    "gray": b"Pf\n7 5\n-1.0\n"}
_PFM_REFUSED = {"space_after_pf", "crlf", "zero_scale", "double_space",
                "gray"}


@pytest.mark.parametrize("case", sorted(_PFM_HEADERS))
def test_pfm_matches_cv2(tmp_path, case):
    """PFM headers cv2 takes (any whitespace byte after each number, the
    scale's sign for the byte order, its magnitude dividing) and refuses
    (no line feed after PF, a zero scale, an empty field, Pf as a
    3-channel image); values rounded half to even, NaN, infinities and
    int32 overflows to 0, the rest clamped."""
    rng = np.random.default_rng(3)
    v = rng.uniform(-20, 300, (5, 7, 3)).astype(np.float32)
    v[0, 0] = [0.5, 1.5, np.nan]
    v[1, 1] = [np.inf, 3e9, 254.5]
    header = _PFM_HEADERS[case]
    order = ">f4" if b"+" in header else "<f4"
    data = header + v[::-1].astype(order).tobytes()
    if case == "gray":
        data = header + v[::-1, :, 0].astype(order).tobytes()
    if case in _PFM_REFUSED:
        assert_refused_as_cv2(tmp_path, data, "a.pfm")
    else:
        assert_reads_as_cv2(tmp_path, data, "a.pfm")


def test_pfm_cut_short_refused(tmp_path):
    data = write_pfm(np.ones((5, 7, 3), np.float32) * 9)
    assert_refused_as_cv2(tmp_path, data[:-1], "a.pfm")


# ---------------------------------------------------------------- HDR

_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_HDR_HEADERS = {
    "rgbe_magic": b"#?RGBE\n" + _FORMAT + b"\n-Y 4 +X 20\n",
    "exposure_after_format": b"#?RADIANCE\n" + _FORMAT
    + b"EXPOSURE=1\n\n-Y 4 +X 20\n",
    "xyze_then_rgbe": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n" + _FORMAT
    + b"\n-Y 4 +X 20\n",
    "long_line": b"#?RADIANCE\n" + b"X" * 200 + b"\n" + _FORMAT
    + b"\n-Y 4 +X 20\n",
    "crlf_size": b"#?RADIANCE\n" + _FORMAT + b"\n-Y 4 +X 20\r\n",
    "packed_size": b"#?RADIANCE\n" + _FORMAT + b"\n-Y4+X20\n",
    "plus_y": b"#?RADIANCE\n" + _FORMAT + b"\n+Y 4 +X 20\n",
    "minus_x": b"#?RADIANCE\n" + _FORMAT + b"\n-Y 4 -X 20\n",
    "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 4 +X 20\n",
    "blank_before_format": b"#?RADIANCE\n\n" + _FORMAT + b"\n-Y 4 +X 20\n",
    "line_of_127": b"#?RADIANCE\n" + b"X" * 127 + b"\n" + _FORMAT
    + b"\n-Y 4 +X 20\n",
    "format_space": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n-Y 4 +X 20\n",
    "leading_space_size": b"#?RADIANCE\n" + _FORMAT + b"\n -Y 4 +X 20\n",
    "zero_height": b"#?RADIANCE\n" + _FORMAT + b"\n-Y 0 +X 20\n",
    "huge": b"#?RADIANCE\n" + _FORMAT + b"\n-Y 2000000 +X 20\n",
}
_HDR_READ = {"rgbe_magic", "exposure_after_format", "xyze_then_rgbe",
             "long_line", "crlf_size", "packed_size"}


@pytest.mark.parametrize("case", sorted(_HDR_HEADERS))
def test_hdr_header_matches_cv2(tmp_path, case):
    """cv2's header rules: fgets lines of at most 127 bytes up to a blank
    line, one of them FORMAT=32-bit_rle_rgbe exactly; then -Y h +X w as
    sscanf reads it (other orientations, xyze alone, sizes not positive
    or past cv2's limits refused)."""
    pixels = np.tile(np.array([100, 50, 25, 130], np.uint8), (4, 20, 1))
    data = _HDR_HEADERS[case] + pixels.tobytes()
    if case in _HDR_READ:
        assert_reads_as_cv2(tmp_path, data, "a.hdr")
    else:
        assert_refused_as_cv2(tmp_path, data, "a.hdr")


@pytest.mark.parametrize("case", ["new_narrow", "old_runs", "cut_rle",
                                  "bad_run", "wrong_width", "extra_bytes",
                                  "flat_midway", "zero_exponent"])
def test_hdr_scanlines_match_cv2(tmp_path, case):
    """Scanlines as rgbe.cpp reads them: an image under 8 wide read flat
    (its RLE bytes as pixels), old-style RLE read flat and refused where
    that leaves it short, new-style RLE cut short, with a zero-length run
    or of another width refused; a scanline that does not open 2, 2 turns
    the rest of the image flat; E = 0 is black."""
    img = smooth_image(12, 40, 6).astype(np.float64) / 255
    img[:, 20:] = img[:, 20:21]
    rgbe = float_to_rgbe(img)
    if case == "new_narrow":
        data = write_hdr(rgbe[:, :6], "new")
    elif case == "old_runs":
        data = write_hdr(rgbe, "old")
    elif case == "cut_rle":
        data = write_hdr(rgbe, "new")[:-5]
    elif case == "bad_run":
        data = bytearray(write_hdr(rgbe, "new"))
        at = data.index(b"\n-Y") + len(b"\n-Y 12 +X 40\n") + 4
        data[at] = 0
        data = bytes(data)
    elif case == "wrong_width":
        data = bytearray(write_hdr(rgbe, "new"))
        at = data.index(b"\n-Y") + len(b"\n-Y 12 +X 40\n")
        data[at + 3] = 39
        data = bytes(data)
    elif case == "extra_bytes":
        data = write_hdr(rgbe, "new") + b"tail"
    elif case == "flat_midway":
        head = write_hdr(rgbe[:5], "new")
        data = head.replace(b"-Y 5", b"-Y 12") + rgbe[5:].tobytes()
    else:
        rgbe[::3, ::2, 3] = 0
        data = write_hdr(rgbe, "new")
    if case in ("old_runs", "cut_rle", "bad_run", "wrong_width"):
        assert_refused_as_cv2(tmp_path, data, "a.hdr")
    else:
        assert_reads_as_cv2(tmp_path, data, "a.hdr")


# ---------------------------------------------------------------- a set

def _more_kinds_dataset(root):
    """make_dataset's detect set with each PNG rewritten, cycled, as a lossy
    JP2 under a .jpg name, a GIF, a Sun raster file, an HDR file and a PFM
    file under .png names, a DHT-less JPEG and a J2K codestream of every
    code-block style."""
    make_dataset(root, 6, 4, [(64, 48), (40, 90), (100, 70)], 3, seed=9)
    from PIL import Image
    import io

    def jp2(a):
        bio = io.BytesIO()
        Image.fromarray(a).save(bio, "JPEG2000", irreversible=True, mct=1,
                                quality_mode="rates", quality_layers=[15])
        return bio.getvalue()

    def gif(a):
        q = Image.fromarray(a).quantize(64)
        pal = np.asarray(q.getpalette()[:192], np.uint8).reshape(64, 3)
        return write_gif([dict(indices=np.asarray(q))], a.shape[1],
                         a.shape[0], pal)

    writers = [
        (".jpg", jp2),
        (".png", gif),
        (".png", lambda a: write_sunras(a, 24)),
        (".png", lambda a: write_hdr(float_to_rgbe(a / 255.0), "new")),
        (".png", lambda a: write_pfm(a.astype(np.float32), -1.0)),
        (".jpg", lambda a: drop_dht(encode(a, "420", 85, 0, 0, 0))),
        (".jpg", lambda a: write_j2k(a, levels=2, cblk=(4, 4), styles=63,
                                     mct=True)),
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
def test_more_kinds_detect_set_loads_as_jax(tmp_path, is_val):
    """load_labels of a detect set of JPEG 2000, GIF, Sun raster, HDR, PFM
    and DHT-less JPEG files under admitted names in the port and in the
    JAX package (cv2.imread there): the same files, boxes and image
    arrays, resized to the image size."""
    root = str(tmp_path)
    _more_kinds_dataset(root)
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
