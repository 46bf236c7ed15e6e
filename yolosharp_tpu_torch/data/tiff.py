"""Baseline TIFF without cv2, to the bit what cv2.imread(IMREAD_COLOR)
returns (cv2 reads an 8-bit image through libtiff's TIFFRGBAImage
interface), converted to RGB.

``parse_ifd`` reads the header (byte order II or MM, classic TIFF) and the
first image file directory, as cv2.imread reads the first page only.
``decode_tiff_rgb`` reads strips or tiles (edge tiles cropped), planar
configuration 1 or 2, compression none, LZW (the host C++ of
``csrc/tiff_decode.cpp``, old-style LSB-first codes included; data that
ends short or turns corrupt leaves zeros and no predictor, as libtiff's
does), Deflate (Python's zlib), PackBits (C++), CCITT modified Huffman,
T.4 1D / 2D and T.6 of either FillOrder (C++, after tif_fax3.c) and JPEG
(Compression 7: each strip or tile through the port's JPEG decoder with
the JPEGTables, YCbCr converted by libjpeg's arithmetic), the horizontal
predictor, and maps the samples as libtiff's RGBA interface does: gray
(min-is-black or min-is-white) of 1, 8 or 16 bits (16 as the high byte), a
palette of 1, 4 or 8 bits through its 16-bit ColorMap (each entry's high
byte, unless every entry is below 256), RGB of 8 or 16 bits (16 as (v +
128) // 257), CMYK of 8 bits (k = 255 - K, r = k (255 - C) / 255), YCbCr of
8 bits in any subsampling libtiff puts (TIFFYCbCrToRGB), extra samples
dropped, unassociated alpha (ExtraSamples 2) premultiplied first ((c a +
127) // 255). The Orientation tag 1-4 is applied as cv2 applies it; 5-8
raise, where cv2.imread returns None. What else cv2.imread returns None
for (float or 32-bit samples, 2-bit gray, an uncompressed strip cut short,
a JPEG strip that is no JPEG stream, old-style JPEG, BigTIFF) raises
ImageReadError naming the file and the tag. No image is ever substituted.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from ..kernels.build import load_host
from . import jpeg
from .errors import ImageReadError

TIFF_SIGNATURES = (b"II*\0", b"MM\0*")
BIGTIFF_SIGNATURES = (b"II+\0", b"MM\0+")

# tags
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, ORIENTATION, SAMPLES = 266, 273, 274, 277
ROWS_PER_STRIP, STRIP_COUNTS, PLANAR, PREDICTOR = 278, 279, 284, 317
COLOR_MAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS = 320, 322, 323, 324
TILE_COUNTS, EXTRA_SAMPLES, SAMPLE_FORMAT = 325, 338, 339
T4_OPTIONS, INK_SET, JPEG_TABLES = 292, 332, 347
YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING, REFERENCE_BW = 529, 530, 532

# field type -> (struct code, bytes); a RATIONAL is two LONGs (read as
# their quotient), DOUBLEs are not needed
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 13: ("I", 4)}
_COMPRESSIONS = {1: "none", 2: "CCITT modified Huffman", 3: "CCITT T.4",
                 4: "CCITT T.6", 5: "LZW", 7: "JPEG", 8: "Deflate",
                 32946: "Deflate", 32773: "PackBits"}
_CCITT = (2, 3, 4)
# photometric -> the bits a sample libtiff's RGBA interface and cv2 take
_PHOTOMETRIC_BITS = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8),
                     5: (8,), 6: (8,)}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _codecs():
    """{compression: the C++ decoder of csrc/tiff_decode.cpp}: LZW and
    PackBits (src, n, dst, size) -> size or a negative error; "fax" the
    CCITT one (src, n, dst, width, rows, mode, options, reverse) -> rows."""
    lib = load_host("tiff_decode")
    fns = {5: lib.ys_tiff_lzw, 32773: lib.ys_tiff_packbits}
    for fn in fns.values():
        fn.restype = ctypes.c_int64
        fn.argtypes = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64)
    fns["fax"] = lib.ys_tiff_fax
    fns["fax"].restype = ctypes.c_int64
    fns["fax"].argtypes = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int)
    return fns


def parse_ifd(data: bytes, name: str = "<bytes>"
              ) -> Tuple[str, Dict[int, tuple]]:
    """(byte order "<" or ">", {tag: values}) of the first image file
    directory; raises ImageReadError naming ``name`` on a file that is not a
    classic TIFF or is cut short."""
    if data[:4] not in TIFF_SIGNATURES:
        if data[:4] in BIGTIFF_SIGNATURES:
            raise ImageReadError(f"{name}: BigTIFF is not read without cv2")
        raise ImageReadError(f"{name}: not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack(e + "I", data[4:8])
    if at + 2 > len(data):
        raise ImageReadError(f"{name}: TIFF truncated: its directory is missing")
    (n,) = struct.unpack(e + "H", data[at:at + 2])
    tags: Dict[int, tuple] = {}
    for i in range(n):
        entry = at + 2 + 12 * i
        if entry + 12 > len(data):
            raise ImageReadError(f"{name}: TIFF truncated in its directory")
        tag, typ, count = struct.unpack(e + "HHI", data[entry:entry + 8])
        if typ not in _TYPES:
            continue                     # a field this reader never needs
        code, size = _TYPES[typ]
        where = entry + 8
        if size * count > 4:
            (where,) = struct.unpack(e + "I", data[entry + 8:entry + 12])
        if where + size * count > len(data):
            raise ImageReadError(f"{name}: TIFF truncated: tag {tag} points "
                             f"past the end of the file")
        values = struct.unpack(e + code * count,
                               data[where:where + size * count])
        if typ == 5:                 # RATIONAL: numerator / denominator
            values = tuple(float(np.float32(a / b)) if b else 0.0
                           for a, b in zip(values[::2], values[1::2]))
        tags[tag] = values
    return e, tags


def unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """(h, width) values of rows (h, stride) of packed 1-, 2- or 4-bit
    samples, the first in each byte's high bits."""
    h = rows.shape[0]
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :width]


def _get(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else v


def _inflate(raw: bytes, size: int, name: str) -> bytes:
    """Deflate data inflated to size bytes (libtiff's ZIPDecode: the data
    past them ignored, fewer of them an error)."""
    try:
        out = zlib.decompressobj().decompress(raw, size)
    except zlib.error as err:
        raise ImageReadError(f"{name}: TIFF Deflate data is corrupt ({err})") \
            from None
    if len(out) < size:
        raise ImageReadError(f"{name}: TIFF Deflate data ends {size - len(out)} "
                         f"bytes short of its chunk")
    return out


def _chunk_bytes(data: bytes, offset: int, count: int, size: int,
                 tags, rows: int, width: int, name: str
                 ) -> Tuple[np.ndarray, bool]:
    """(size bytes of one strip or tile (rows rows of width pixels),
    decompressed; whether it decoded whole). LZW data that ends short or
    hits a code its table does not hold leaves zeros after what it decoded,
    as libtiff's LZWDecode does (cv2 reads such a strip all the same), and
    libtiff then applies no predictor to the strip."""
    compression = _get(tags, COMPRESSION, (1,))[0]
    raw = data[offset:offset + count]
    if len(raw) < count:
        raise ImageReadError(f"{name}: TIFF truncated: a strip or tile runs past "
                         f"the end of the file")
    if compression == 1:
        if len(raw) < size:
            raise ImageReadError(f"{name}: TIFF strip or tile of {len(raw)} "
                             f"bytes, expected {size}")
        return np.frombuffer(raw, np.uint8, size), True
    if compression in (8, 32946):
        return np.frombuffer(_inflate(raw, size, name), np.uint8), True
    src = np.frombuffer(raw, np.uint8)
    out = np.zeros(size, np.uint8)
    if compression in _CCITT:
        options = _get(tags, T4_OPTIONS, (0,))[0] if compression == 3 else 0
        reverse = _get(tags, FILL_ORDER, (1,))[0] == 2
        got = _codecs()["fax"](_ptr(src), src.size, _ptr(out), width, rows,
                               compression, options, int(reverse))
        if got != rows:
            raise ImageReadError(f"{name}: TIFF {_COMPRESSIONS[compression]} "
                             f"data is corrupt or ends short of its strip "
                             f"or tile")
        return out, True
    got = _codecs()[compression](_ptr(src), src.size, _ptr(out), size)
    if got < 0 and compression == 32773:
        raise ImageReadError(f"{name}: TIFF PackBits data ends short of its "
                         f"strip or tile")
    return out, got >= 0


def _predictor(tags) -> int:
    """The Predictor tag where the codec takes one: libtiff's LZW and
    Deflate codecs do, the others ignore it."""
    if _get(tags, COMPRESSION, (1,))[0] not in (5, 8, 32946):
        return 1
    return _get(tags, PREDICTOR, (1,))[0]


def _check(tags, name):
    """The tags this reader takes; raises naming the first one it does
    not. Returns (bits, samples a pixel, photometric)."""
    def refuse(tag, label, value, what):
        raise ImageReadError(f"{name}: TIFF with {label} ({tag}) = {value} is "
                         f"not read without cv2 ({what})")

    compression = _get(tags, COMPRESSION, (1,))[0]
    if compression not in _COMPRESSIONS:
        kind = {6: "old-style JPEG"}.get(compression, "")
        refuse(COMPRESSION, "Compression", f"{compression} {kind}".strip(),
               "none, CCITT, LZW, JPEG, Deflate and PackBits are")
    spp = _get(tags, SAMPLES, (1,))[0]
    extra = _get(tags, EXTRA_SAMPLES, ())
    photometric = tags.get(PHOTOMETRIC, (None,))[0]
    if photometric is None:            # libtiff's default by colour count
        photometric = {1: 1, 3: 2}.get(spp - len(extra))
        if photometric is None:
            raise ImageReadError(f"{name}: TIFF without a Photometric (262) tag "
                             f"is not read without cv2")
    if photometric not in _PHOTOMETRIC_BITS:
        refuse(PHOTOMETRIC, "PhotometricInterpretation", photometric,
               "gray, RGB, palette, CMYK and YCbCr are")
    bits = set(_get(tags, BITS, (1,)))
    if len(bits) != 1 or min(bits) not in _PHOTOMETRIC_BITS[photometric]:
        refuse(BITS, "BitsPerSample", "/".join(map(str, sorted(bits))),
               f"photometric {photometric} takes "
               f"{_PHOTOMETRIC_BITS[photometric]}")
    bits = bits.pop()
    if set(_get(tags, SAMPLE_FORMAT, (1,))) != {1}:
        refuse(SAMPLE_FORMAT, "SampleFormat", _get(tags, SAMPLE_FORMAT),
               "unsigned integers only")
    colours = {2: 3, 5: 4, 6: 3}.get(photometric, 1)
    if spp - len(extra) < colours or spp > colours + 1 or (
            bits < 8 and spp != 1):
        refuse(SAMPLES, "SamplesPerPixel", f"{spp} with {len(extra)} extra",
               f"photometric {photometric}; one extra at most")
    planar = _get(tags, PLANAR, (1,))[0]
    if planar not in (1, 2):
        refuse(PLANAR, "PlanarConfiguration", planar, "1 or 2")
    if compression in _CCITT and (bits != 1 or photometric not in (0, 1)):
        refuse(COMPRESSION, "Compression", compression,
               "CCITT codes bilevel gray only")
    if compression == 7 and (photometric not in (1, 2, 6) or planar != 1):
        refuse(PHOTOMETRIC, "PhotometricInterpretation", photometric,
               "JPEG-in-TIFF of contiguous gray, RGB and YCbCr is read")
    if photometric == 6 and compression != 7:
        sub = tuple(_get(tags, YCBCR_SUBSAMPLING, (2, 2))[:2])
        if planar != 1 or sub not in _YCBCR_SUBSAMPLINGS or spp != 3 or \
                _predictor(tags) != 1:
            refuse(YCBCR_SUBSAMPLING, "YCbCrSubSampling",
                   f"{sub} (planar {planar}, {spp} samples)",
                   "contiguous 3-sample YCbCr at 1, 2 or 4 across and no "
                   "more down is read")
    if photometric == 5 and _get(tags, INK_SET, (1,))[0] != 1:
        refuse(INK_SET, "InkSet", tags[INK_SET][0], "CMYK only")
    predictor = _predictor(tags)
    if predictor not in (1, 2) or (predictor == 2 and bits < 8):
        refuse(PREDICTOR, "Predictor", f"{predictor} at {bits} bits",
               "horizontal differencing of 8- and 16-bit samples only")
    if _get(tags, FILL_ORDER, (1,))[0] != 1 and compression not in _CCITT:
        refuse(FILL_ORDER, "FillOrder", tags[FILL_ORDER][0],
               "most significant bit first only, but for CCITT codes")
    orientation = _get(tags, ORIENTATION, (1,))[0]
    if orientation not in (1, 2, 3, 4):
        raise ImageReadError(f"{name}: TIFF with Orientation (274) = "
                         f"{orientation}: cv2.imread returns no image for it "
                         f"(1-4 are read)")
    if photometric == 3 and len(_get(tags, COLOR_MAP, ())) != 3 << bits:
        raise ImageReadError(f"{name}: palette TIFF without a ColorMap (320) of "
                         f"{3 << bits} entries")
    return bits, spp, photometric


# YCbCrSubSampling (horizontal, vertical) pairs tif_getimage.c puts
_YCBCR_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2),
                       (4, 4))


def _layout(tags, spp, name):
    """The strips or tiles: (chunk width, chunk height, across, down,
    planes, offsets, byte counts, tiled)."""
    w, h = tags[WIDTH][0], tags[HEIGHT][0]
    planes = spp if _get(tags, PLANAR, (1,))[0] == 2 and spp > 1 else 1
    tiled = TILE_WIDTH in tags
    if tiled:
        cw, ch = tags[TILE_WIDTH][0], tags[TILE_LENGTH][0]
        offsets, counts = _get(tags, TILE_OFFSETS), _get(tags, TILE_COUNTS)
    else:
        cw, ch = w, min(_get(tags, ROWS_PER_STRIP, (h,))[0], h)
        offsets, counts = _get(tags, STRIP_OFFSETS), _get(tags, STRIP_COUNTS)
    if not cw or not ch:
        raise ImageReadError(f"{name}: TIFF with an empty strip or tile size")
    across = (w + cw - 1) // cw if tiled else 1
    down = (h + ch - 1) // ch
    offsets, counts = offsets or (), counts or ()
    if min(len(offsets), len(counts)) < across * down * planes:
        raise ImageReadError(f"{name}: TIFF with {len(offsets)} strip or tile "
                         f"offsets and {len(counts)} byte counts, expected "
                         f"{across * down * planes}")
    return cw, ch, across, down, planes, offsets, counts, tiled


def _chunks(tags, spp, name):
    """(index, plane, y0, x0, rows stored, rows in the image, columns in
    the image) of each strip or tile, in file order: a strip holds its rows
    alone, a tile is always whole."""
    w, h = tags[WIDTH][0], tags[HEIGHT][0]
    cw, ch, across, down, planes, _, _, tiled = _layout(tags, spp, name)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                rows = ch if tiled else min(ch, h - y0)
                yield k, p, y0, x0, rows, min(ch, h - y0), min(cw, w - x0)
                k += 1


def _samples(data: bytes, tags, e: str, bits: int, spp: int,
             name: str) -> np.ndarray:
    """(H, W, spp) samples (uint8, or uint16 at 16 bits; 1- and 4-bit values
    one a byte) of the whole image, from its strips or tiles."""
    w, h = tags[WIDTH][0], tags[HEIGHT][0]
    cw, _, _, _, planes, offsets, counts, _ = _layout(tags, spp, name)
    planar = planes > 1
    predictor = _predictor(tags)
    per_chunk = 1 if planar else spp
    dtype = np.dtype(e + "u2") if bits == 16 else np.dtype(np.uint8)
    row_bytes = (cw * per_chunk * bits + 7) // 8
    out = np.empty((h, w, spp), np.uint16 if bits == 16 else np.uint8)
    for k, p, y0, x0, rows, in_h, in_w in _chunks(tags, spp, name):
        buf, whole = _chunk_bytes(data, offsets[k], counts[k],
                                  rows * row_bytes, tags, rows, cw, name)
        if bits < 8:
            vals = unpack_bits(buf.reshape(rows, row_bytes), bits,
                               cw)[..., None]
        else:
            vals = buf.view(dtype).reshape(rows, cw, per_chunk)
            if predictor == 2 and whole:
                vals = np.cumsum(vals, axis=1, dtype=dtype)
        part = vals[:in_h, :in_w]
        if planar:
            out[y0:y0 + in_h, x0:x0 + in_w, p] = part[..., 0]
        else:
            out[y0:y0 + in_h, x0:x0 + in_w] = part
    return out


@functools.lru_cache(maxsize=16)
def _ycbcr_tables(coefficients, reference):
    """tif_color.c TIFFYCbCrToRGBInit in its float32 arithmetic: the tables
    Y, Cr -> R, Cb -> B, Cr -> G and Cb -> G (the last two before their
    >> 16) by sample value, from YCbCrCoefficients (529) and
    ReferenceBlackWhite (532)."""
    f = np.float32
    luma = [f(v) for v in coefficients]
    ref = [f(v) for v in reference]

    def fix(x):                        # FIX(CLAMP(x, 0, 2))
        x = min(max(x, f(0)), f(2))
        return int(float(x * f(65536)) + 0.5)

    def code2v(c, rb, rw, cr):         # Code2V, then CLAMPw and (int32_t)
        den = rw - rb if rw - rb != 0 else f(1)
        v = f(f(np.int32(c) - np.int32(rb)) * f(cr)) / f(den)
        return int(min(max(v, f(-128 * 32)), f(128 * 32)))

    f1 = f(2) - f(2) * luma[0]
    f3 = f(2) - f(2) * luma[2]
    d1, d3 = fix(f1), fix(f3)
    d2 = -fix(luma[0] * f1 / luma[1])
    d4 = -fix(luma[2] * f3 / luma[1])
    x = np.arange(-128, 128)
    cr = np.array([code2v(v, ref[4] - f(128), ref[5] - f(128), 127)
                   for v in x], np.int64)
    cb = np.array([code2v(v, ref[2] - f(128), ref[3] - f(128), 127)
                   for v in x], np.int64)
    y = np.array([code2v(v + 128, ref[0], ref[1], 255) for v in x], np.int64)
    return (y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr,
            d4 * cb + 32768)


def _ycbcr_rgb(data: bytes, tags, name: str) -> np.ndarray:
    """RGB of an uncompressed-colour YCbCr TIFF (Photometric 6, any codec
    but JPEG), as tif_getimage.c's putcontig8bitYCbCr*tile routines put it:
    each block of hs x vs luma samples followed by its Cb and Cr (no
    interpolation), then TIFFYCbCrtoRGB."""
    w, h = tags[WIDTH][0], tags[HEIGHT][0]
    hs, vs = _get(tags, YCBCR_SUBSAMPLING, (2, 2))[:2]
    cw, _, _, _, _, offsets, counts, _ = _layout(tags, 3, name)
    across = (cw + hs - 1) // hs
    unit = hs * vs + 2
    ycc = np.empty((h, w, 3), np.int64)
    for k, _, y0, x0, rows, in_h, in_w in _chunks(tags, 3, name):
        size = (rows + vs - 1) // vs * across * unit
        buf = _chunk_bytes(data, offsets[k], counts[k], size, tags, rows, cw,
                           name)[0].astype(np.int64)
        yy, xx = np.mgrid[0:in_h, 0:in_w]
        base = ((yy // vs) * across + xx // hs) * unit
        ycc[y0:y0 + in_h, x0:x0 + in_w, 0] = buf[base + (yy % vs) * hs
                                                 + xx % hs]
        ycc[y0:y0 + in_h, x0:x0 + in_w, 1] = buf[base + hs * vs]
        ycc[y0:y0 + in_h, x0:x0 + in_w, 2] = buf[base + hs * vs + 1]
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(
        tuple(_get(tags, YCBCR_COEFFICIENTS, (0.299, 0.587, 0.114))[:3]),
        tuple(_get(tags, REFERENCE_BW, (0.0, 255.0, 128.0, 255.0, 128.0,
                                        255.0))[:6]))
    y, cb, cr = y_tab[ycc[..., 0]], ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _jpeg_rgb(data: bytes, tags, photometric: int, name: str) -> np.ndarray:
    """RGB of a JPEG-in-TIFF (Compression 7): each strip or tile an
    abbreviated JPEG stream completed by the JPEGTables (347), decoded as
    tif_jpeg.c has libjpeg decode it: YCbCr converted to RGB
    (JPEGCOLORMODE_RGB, as TIFFRGBAImage asks), RGB and gray as they are
    (JCS_UNKNOWN); upsampling stops at each strip's edge."""
    w, h = tags[WIDTH][0], tags[HEIGHT][0]
    _, _, _, _, _, offsets, counts, _ = _layout(tags, 3, name)
    tables = bytes(_get(tags, JPEG_TABLES, ()))
    head = tables[:-2] if tables[:2] == jpeg.SOI and \
        tables[-2:] == b"\xff\xd9" else jpeg.SOI
    color = {1: jpeg.COLOR_GRAY, 2: jpeg.COLOR_RGB, 6: jpeg.COLOR_YCC}[
        photometric]
    rgb = np.empty((h, w, 3), np.uint8)
    for k, _, y0, x0, rows, in_h, in_w in _chunks(tags, 3, name):
        raw = data[offsets[k]:offsets[k] + counts[k]]
        if raw[:2] != jpeg.SOI:
            raise ImageReadError(f"{name}: TIFF with Compression (259) = 7 "
                             f"(JPEG) whose strip or tile is no JPEG "
                             f"stream")
        part = jpeg.decode_jpeg_rgb(head + raw[2:], name, color)
        if part.shape[0] < in_h or part.shape[1] < in_w:
            raise ImageReadError(f"{name}: TIFF JPEG strip or tile of "
                             f"{part.shape[1]}x{part.shape[0]}, expected "
                             f"{in_w}x{in_h} or more")
        rgb[y0:y0 + in_h, x0:x0 + in_w] = part[:in_h, :in_w]
    return rgb


def decode_tiff_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a TIFF's first page, equal to
    cv2.cvtColor(cv2.imread(path, IMREAD_COLOR), COLOR_BGR2RGB). Raises
    ImageReadError naming ``name`` on what it does not read (see the module's
    docstring)."""
    e, tags = parse_ifd(data, name)
    if WIDTH not in tags or HEIGHT not in tags:
        raise ImageReadError(f"{name}: TIFF without ImageWidth / ImageLength")
    bits, spp, photometric = _check(tags, name)
    if _get(tags, COMPRESSION, (1,))[0] == 7:
        return _orient(_jpeg_rgb(data, tags, photometric, name), tags)
    if photometric == 6:
        return _orient(_ycbcr_rgb(data, tags, name), tags)
    s = _samples(data, tags, e, bits, spp, name)
    if photometric in (0, 1):            # setupMap + makebwmap
        v = s[..., 0].astype(np.int32)
        if bits == 16:
            v >>= 8                      # put16bitbwtile: the high byte
            top = 255
        else:
            top = (1 << bits) - 1
        if photometric == 0:
            v = top - v
        gray = (v * 255 // top).astype(np.uint8)
        rgb = np.repeat(gray[..., None], 3, axis=2)
    elif photometric == 3:               # checkcmap / cvtcmap
        cmap = np.asarray(tags[COLOR_MAP], np.int32).reshape(3, -1)
        if cmap.max() >= 256:
            cmap = cmap >> 8
        rgb = cmap.T.astype(np.uint8)[s[..., 0]]
    elif photometric == 5:               # putRGBcontig8bitCMYKtile
        v = s.astype(np.int32)
        k = 255 - v[..., 3:4]
        rgb = (k * (255 - v[..., :3]) // 255).astype(np.uint8)
    else:
        extra = _get(tags, EXTRA_SAMPLES, ())
        unassociated = spp >= 4 and extra and extra[0] == 2
        if bits == 8 and not unassociated:
            rgb = s[..., :3]
        else:
            v = s.astype(np.int32)
            if bits == 16:               # Bitdepth16To8
                v = (v + 128) // 257
            rgb = v[..., :3]
            if unassociated:             # UaToAa
                rgb = (rgb * v[..., 3:4] + 127) // 255
            rgb = rgb.astype(np.uint8)
    return _orient(rgb, tags)


def _orient(img: np.ndarray, tags) -> np.ndarray:
    """The Orientation 2-4 as cv2 applies it through TIFFReadRGBAStrip /
    TIFFReadRGBATile: up-down flips over the whole image, left-right flips
    over each column of tiles (the whole width for strips), cropped."""
    orientation = _get(tags, ORIENTATION, (1,))[0]
    if orientation in (3, 4):
        img = img[::-1]
    if orientation in (2, 3):
        w = img.shape[1]
        cw = tags[TILE_WIDTH][0] if TILE_WIDTH in tags else w
        img = np.concatenate([img[:, x:min(x + cw, w)][:, ::-1]
                              for x in range(0, w, cw)], axis=1)
    return np.ascontiguousarray(img)
