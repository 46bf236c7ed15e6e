"""JPEG 2000 as cv2.imread (5.0, OpenJPEG 2.5) reads it, against the port's
cv2-free reader on the CPU, bit for bit: the committed JP2 / J2K fixtures
(also against the JAX package's reader), seeded lossy files of random
sizes, tiles, levels, layers, precincts and progression orders, the
codestream options only the repo's own encoder writes (every code-block
style, SOP / EPH, POC, RGN, COC / QCC, tile-parts), cv2's mapping of
components and colour spaces to BGR, and the files cv2 refuses (each
asserted None in cv2 first)."""

import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from yolosharp_tpu.data.labels import _read_image_rgb as jax_read_image_rgb
from yolosharp_tpu_torch.data.image_ops import read_image_rgb

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "data_torch", "images")
sys.path.insert(0, FIXTURES)
sys.path.insert(0, os.path.join(HERE, "data_torch", "jpeg"))
from make_fixtures import smooth_image  # noqa: E402
from j2k_writer import (LAZY, PTERM, RESET, SEGSYM, TERMALL,  # noqa: E402
                        VSC, write_j2k)
from writers import jp2_box, jp2_wrap, siz_fields  # noqa: E402

def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def _jp2_fixtures():
    return sorted(n for n in _manifest()
                  if n.startswith(("jp2_", "j2k_")))


def read_both(tmp_path, data, name="a.jp2"):
    """(the port's RGB or None, cv2.imread -> RGB or None) of data written
    to a new file; a cv2 exception counts as None."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        want = cv2.imread(path, cv2.IMREAD_COLOR)
    except cv2.error:
        want = None
    want = None if want is None else cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
    try:
        got = read_image_rgb(path)
    except ValueError as err:
        assert path in str(err) and isinstance(err, FileNotFoundError)
        got = None
    return got, want


def assert_reads_as_cv2(tmp_path, data, name="a.jp2"):
    got, want = read_both(tmp_path, data, name)
    assert want is not None, "cv2 returns no image for this case"
    assert got is not None, "the port refuses a file cv2 reads"
    np.testing.assert_array_equal(got, want)
    return got


def assert_refused_as_cv2(tmp_path, data, name="a.jp2"):
    got, want = read_both(tmp_path, data, name)
    assert want is None, "cv2 reads this case"
    assert got is None, "the port reads a file cv2 refuses"


def pil_jp2(img, **kw):
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG2000", **kw)
    return bio.getvalue()


def _noisy(h, w, seed, sigma=12):
    rng = np.random.default_rng(seed)
    return np.clip(smooth_image(h, w, seed) + rng.normal(0, sigma, (h, w, 3)),
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", _jp2_fixtures())
def test_jp2_fixture_matches_cv2_and_jax(name):
    """Each committed JPEG 2000 fixture (PIL's and cv2's lossless, lossy,
    tiled, layered files in every progression order, gray, gray + alpha,
    RGBA, 16-bit, sYCC, palette, cdef, 12-bit; the repo encoder's code-block
    styles, SOP / EPH / POC / tile-parts and RGN / COC / QCC): the port's
    RGB equals cv2.imread's, the JAX package's reader's and the
    manifest's hash."""
    path = os.path.join(FIXTURES, name)
    img = read_image_rgb(path)
    entry = _manifest()[name]
    assert list(img.shape) == entry["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(img, jax_read_image_rgb(path))


def _seeded_case(seed):
    """A lossy PIL (OpenJPEG) JPEG 2000 of a random size, mode, tiling,
    level count, code-block and precinct size, layers and progression;
    every tile at least 2 pixels a side at its coarsest resolution (the
    encoder asserts otherwise)."""
    rng = np.random.default_rng(1000 + seed)
    h, w = (int(v) for v in rng.integers(8, 72, 2))
    kw = dict(irreversible=bool(rng.random() < 0.8), mct=1,
              progression=str(rng.choice(["LRCP", "RLCP", "RPCL", "PCRL",
                                          "CPRL"])))
    sizes = [h, w]
    if rng.random() < 0.5:
        tw, th = (int(v) for v in rng.integers(16, 48, 2))
        kw["tile_size"] = (tw, th)
        sizes += [v % t for v, t in ((w, tw), (h, th)) if v % t]
        sizes += [min(w, tw), min(h, th)]
    top = max(1, int(np.log2(max(2, min(sizes)))))
    kw["num_resolutions"] = int(rng.integers(1, top + 1))
    if rng.random() < 0.5:
        p = int(2 ** rng.integers(5, 8))
        kw["precinct_size"] = (p, p)
    if rng.random() < 0.5:
        kw["codeblock_size"] = tuple(int(2 ** v) for v in
                                     rng.integers(3, 7, 2))
    n = int(rng.integers(1, 4))
    kw.update(quality_mode="rates", quality_layers=sorted(
        (float(v) for v in rng.choice([4, 8, 16, 32, 64], n)), reverse=True))
    img = _noisy(h, w, seed)
    mode = rng.integers(0, 3)
    if mode == 1:
        img = img[..., 0]
    elif mode == 2:
        img = np.dstack([img, img[..., :1]])
    return pil_jp2(img, **kw)


@pytest.mark.parametrize("seed", range(24))
def test_seeded_lossy_jp2_matches_cv2(tmp_path, seed):
    """Seeded lossy files (the 9/7 and the ICT in float32, OpenJPEG's
    lifting constants and order, round half to even) read to the bit as
    cv2 reads them."""
    assert_reads_as_cv2(tmp_path, _seeded_case(seed))


STYLES = {"bypass": LAZY, "reset": RESET, "termall": TERMALL, "vsc": VSC,
          "pterm": PTERM, "segsym": SEGSYM, "bypass_termall": LAZY | TERMALL,
          "all": LAZY | RESET | TERMALL | VSC | PTERM | SEGSYM}


@pytest.mark.parametrize("style", sorted(STYLES))
def test_code_block_style_matches_cv2(tmp_path, style):
    """The repo encoder's 5/3 files in each code-block style, over three
    layers: cv2 decodes them to the source (the encoder is right) and the
    port to cv2's bytes."""
    img = _noisy(40, 48, 7)
    got = assert_reads_as_cv2(tmp_path, write_j2k(
        img, levels=3, cblk=(4, 3), layers=3, mct=True,
        styles=STYLES[style]), "a.j2k")
    np.testing.assert_array_equal(got, img)


OPTIONS = {
    "sop_eph": dict(sop=True, eph=True, layers=2),
    "poc": dict(poc=[(0, 0, 2, 2, 3, 1), (0, 0, 2, 4, 3, 0)], layers=2),
    "tile_parts": dict(tile=(24, 20), tile_parts=3, layers=2),
    "precincts_rlcp": dict(precincts=[(3, 3), (3, 4), (4, 4), (5, 5)],
                           order=1, layers=3),
    "roi": dict(roi=(1, lambda b, x, y: b == 0 or (x + y) % 4 == 0)),
    "coc_qcc": dict(comp_styles={1: (1, (3, 3), VSC | SEGSYM)},
                    qcc_guard={2: 1}, mct=False),
    "all": dict(sop=True, eph=True, tile=(32, 24), tile_parts=2, layers=2,
                styles=LAZY | SEGSYM, roi=(0, lambda b, x, y: x < 6),
                poc=[(0, 0, 2, 1, 3, 0), (0, 0, 2, 4, 3, 1)]),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_codestream_option_matches_cv2(tmp_path, option):
    """SOP and EPH markers, a POC, tile-parts, precincts, an RGN region,
    COC and QCC segments, alone and together: cv2 decodes them to the
    source and the port to cv2's bytes."""
    img = _noisy(40, 48, 11)
    kw = dict(levels=3, cblk=(4, 4), mct=True)
    kw.update(OPTIONS[option])
    got = assert_reads_as_cv2(tmp_path, write_j2k(img, **kw), "a.j2k")
    np.testing.assert_array_equal(got, img)


def _codestream(nc):
    img = smooth_image(48, 64, nc)
    src = {1: img[..., 0], 2: img[..., :2], 3: img,
           4: np.dstack([img, img[..., :1]])}[nc]
    return pil_jp2(src, no_jp2=True, mct=1 if nc >= 3 else 0)


@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("space", ["raw", "srgb", "gray", "sycc", "cmyk",
                                   "eycc", "unknown", "icc", "no_colr"])
def test_colour_space_maps_as_cv2(tmp_path, space, nc):
    """cv2's mapping of 1-4 components in each colour space: sRGB and the
    spaces it does not name as B, G, R from components 2, 1, 0 (1 or 2
    components refused), greyscale as component 0, sYCC through its YUV ->
    BGR, CMYK and e-YCC refused; equal where cv2 reads, refused (cv2 None
    first) where it does not."""
    cs = _codestream(nc)
    if space == "raw":
        data = cs
    elif space in ("icc", "no_colr"):
        colr = b"" if space == "no_colr" else jp2_box(
            b"colr", struct.pack(">BBB", 2, 0, 0) + bytes(128))
        data = jp2_wrap(cs, colr=colr, nc=nc)
    else:
        data = jp2_wrap(cs, {"srgb": 16, "gray": 17, "sycc": 18, "cmyk": 12,
                             "eycc": 24, "unknown": 20}[space], nc=nc)
    got, want = read_both(tmp_path, data)
    readable = space == "gray" or (nc >= 3 and space not in ("cmyk",
                                                              "eycc"))
    assert (want is not None) == readable
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prec", [7, 9, 12, 16])
def test_precision_maps_as_cv2(tmp_path, prec):
    """A codestream's components declared 7 to 16 bits: below 8 cv2
    refuses the header; above 8 every component is shifted right by
    (precision - 8)."""
    cs = _codestream(3)
    for c in range(3):
        cs = siz_fields(cs, c, prec=prec)
    if prec < 8:
        assert_refused_as_cv2(tmp_path, jp2_wrap(cs))
    else:
        assert_reads_as_cv2(tmp_path, jp2_wrap(cs))


@pytest.mark.parametrize("case", ["mixed_12", "mixed_4", "signed", "dx2"])
def test_component_fields_map_as_cv2(tmp_path, case):
    """One component of an RGB codestream declared 12 bits (all shifted by
    the widest), 4 bits (the widest is 8: no shift), signed (refused) or
    subsampled 2x across (refused)."""
    cs = _codestream(3)
    data = jp2_wrap({"mixed_12": lambda: siz_fields(cs, 1, prec=12),
                     "mixed_4": lambda: siz_fields(cs, 1, prec=4),
                     "signed": lambda: siz_fields(cs, 2, sgnd=1),
                     "dx2": lambda: siz_fields(cs, 1, dx=2)}[case]())
    if case.startswith("mixed"):
        assert_reads_as_cv2(tmp_path, data)
    else:
        assert_refused_as_cv2(tmp_path, data)


@pytest.mark.parametrize("case", ["palette16", "short_palette", "cdef"])
def test_palette_and_cdef_as_cv2(tmp_path, case):
    """OpenJPEG's pclr / cmap (16-bit entries: cv2 casts the shifted value
    to 8 bits; indices past the palette clamp to its last entry) and a
    cdef naming the alpha channel first."""
    img = smooth_image(48, 64, 5)
    idx = img[..., 1] // (16 if case == "palette16" else 4)
    pal = np.random.default_rng(5).integers(0, 60000, (16, 3))
    if case == "cdef":
        cdef = jp2_box(b"cdef", struct.pack(">H", 4) + b"".join(
            struct.pack(">HHH", c, t, a)
            for c, t, a in ((0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3))))
        data = jp2_wrap(_codestream(4), 16, cdef, nc=4)
    else:
        pclr = jp2_box(b"pclr", struct.pack(">HB", 16, 3) + bytes([15] * 3)
                    + pal.astype(">u2").tobytes())
        cmap = jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, c)
                                      for c in range(3)))
        data = jp2_wrap(pil_jp2(idx.astype(np.uint8), no_jp2=True), 16,
                        pclr + cmap, nc=1)
    assert_reads_as_cv2(tmp_path, data)


@pytest.mark.parametrize("cut", ["half", "no_eoc", "end_of_tile",
                                 "lone_sot", "sot_and_2", "image_offset"])
def test_codestream_ends_as_cv2(tmp_path, cut):
    """OpenJPEG 2.5's strict mode: a codestream cut inside a tile-part, at
    the end of one, or without its EOC is refused; one that ends on a lone
    SOT marker after a whole tile-part reads (the tiles it lacks black). An
    image offset from the origin is refused by cv2."""
    img = _noisy(40, 48, 3)
    if cut == "image_offset":
        # the same width from x = 2 on: Xsiz, XOsiz and XTsiz moved by 2
        data = bytearray(pil_jp2(img, no_jp2=True, num_resolutions=3))
        x1, y1, x0, y0, tw = struct.unpack(">IIIII", data[8:28])
        data[8:28] = struct.pack(">IIIII", x1 + 2, y1, 2, y0, tw + 2)
        assert_refused_as_cv2(tmp_path, bytes(data), "a.j2k")
        return
    data = pil_jp2(img, no_jp2=True, tile_size=(24, 24), irreversible=True,
                   quality_mode="rates", quality_layers=[10])
    sot = data.index(b"\xff\x90")
    (psot,) = struct.unpack(">I", data[sot + 6:sot + 10])
    second = sot + psot
    assert data[second:second + 2] == b"\xff\x90"
    data = {"half": data[:len(data) // 2], "no_eoc": data[:-2],
            "end_of_tile": data[:second], "lone_sot": data[:second + 2],
            "sot_and_2": data[:second + 4]}[cut]
    if cut == "lone_sot":
        assert_reads_as_cv2(tmp_path, data, "a.j2k")
    else:
        assert_refused_as_cv2(tmp_path, data, "a.j2k")


def test_palette_past_32_bits_is_refused(tmp_path):
    """A pclr box of 40-bit entries: OpenJPEG reads them past its 32-bit
    value (cv2's pixels are then undefined), the port refuses the file
    naming it."""
    idx = (np.arange(48 * 64).reshape(48, 64) % 16).astype(np.uint8)
    entries = b"".join(int(v).to_bytes(5, "big") for v in range(48))
    pclr = jp2_box(b"pclr", struct.pack(">HB", 16, 3) + bytes([39] * 3)
                   + entries)
    cmap = jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, c)
                                     for c in range(3)))
    path = str(tmp_path / "a.jp2")
    with open(path, "wb") as f:
        f.write(jp2_wrap(pil_jp2(idx, no_jp2=True), 16, pclr + cmap, nc=1))
    with pytest.raises(ValueError, match="40-bit") as err:
        read_image_rgb(path)
    assert path in str(err.value) and isinstance(err.value,
                                                 FileNotFoundError)


def _siz_moved(x0, w, h, dx=None):
    """An untiled 64x48 RGB codestream whose SIZ puts the image at x = x0
    (its single tile with it), w wide and h high, each component
    subsampled dx across where given."""
    img = _noisy(48, 64, 7)
    data = bytearray(pil_jp2(img, no_jp2=True))
    _, _, _, y0, _, _, _, ty0 = struct.unpack(">IIIIIIII", data[8:40])
    data[8:40] = struct.pack(">IIIIIIII", x0 + w, h, x0, y0, w, h, x0, ty0)
    data = bytes(data)
    for c in range(3 if dx else 0):
        data = siz_fields(data, c, dx=dx)
    return data


@pytest.mark.parametrize("case", ["offset_2_31_dx3", "offset_near_2_32_dx3",
                                  "width_past_2_31", "height_past_2_31"])
def test_siz_past_2_31_is_refused_as_cv2(tmp_path, case):
    """SIZ fields at and past 2^31, read as the unsigned values they are:
    an image offset there (with components subsampled by 3, where a
    wrapped ceiling division would size the samples' buffer short) and a
    side past 2^31 are refused, as cv2 refuses them, before anything is
    allocated."""
    data = {"offset_2_31_dx3": lambda: _siz_moved(2 ** 31 + 1, 64, 48, 3),
            "offset_near_2_32_dx3": lambda: _siz_moved(2 ** 32 - 100, 64,
                                                       48, 3),
            "width_past_2_31": lambda: _siz_moved(0, 2 ** 31 + 64, 48),
            "height_past_2_31": lambda: _siz_moved(0, 64, 2 ** 31 + 48),
            }[case]()
    assert_refused_as_cv2(tmp_path, data, "a.j2k")


def test_decode_checks_its_buffer():
    """The host decoder refuses a buffer smaller than the codestream's
    components (status 3) and fills one of their size."""
    import ctypes

    from yolosharp_tpu_torch.kernels.build import load_host
    lib = load_host("jp2_decode")
    stream = np.frombuffer(pil_jp2(_noisy(48, 64, 7), no_jp2=True), np.uint8)
    need = 3 * 48 * 64
    for size, status in ((need - 1, 3), (need, 0)):
        out = np.full(need, -1, np.int32)
        got = lib.ys_j2k_decode(stream.ctypes.data_as(ctypes.c_void_p),
                                ctypes.c_int64(stream.size),
                                out.ctypes.data_as(ctypes.c_void_p),
                                ctypes.c_int64(size))
        assert got == status
    assert out.min() >= 0 and out.max() <= 255
