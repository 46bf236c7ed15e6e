"""Baseline TIFF without cv2, to the bit what cv2.imread(IMREAD_COLOR)
returns (cv2 reads an 8-bit image through libtiff's TIFFRGBAImage
interface), converted to RGB.

``parse_ifd`` reads the header (byte order II or MM, classic TIFF) and the
first image file directory, as cv2.imread reads the first page only.
``decode_tiff_rgb`` reads strips or tiles (edge tiles cropped), planar
configuration 1 or 2, compression none, LZW (the host C++ of
``csrc/tiff_decode.cpp``, old-style LSB-first codes included), Deflate
(Python's zlib) and PackBits (C++), the horizontal predictor, and maps the
samples as libtiff does: gray (min-is-black or min-is-white) of 1, 8 or 16
bits (16 as the high byte), a palette of 1, 4 or 8 bits through its 16-bit
ColorMap (each entry's high byte, unless every entry is below 256), RGB of
8 or 16 bits (16 as (v + 128) // 257), extra samples dropped, unassociated
alpha (ExtraSamples 2) premultiplied first ((c a + 127) // 255). The
Orientation tag 1-4 is applied as cv2 applies it; 5-8 raise, where
cv2.imread returns None. Anything else (JPEG-in-TIFF, YCbCr, CMYK, float or
32-bit samples, other compressions, BigTIFF) raises ImageReadError naming the
file and the tag. No image is ever substituted.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from ..kernels.build import load_host
from .errors import ImageReadError

TIFF_SIGNATURES = (b"II*\0", b"MM\0*")
BIGTIFF_SIGNATURES = (b"II+\0", b"MM\0+")

# tags
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, ORIENTATION, SAMPLES = 266, 273, 274, 277
ROWS_PER_STRIP, STRIP_COUNTS, PLANAR, PREDICTOR = 278, 279, 284, 317
COLOR_MAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS = 320, 322, 323, 324
TILE_COUNTS, EXTRA_SAMPLES, SAMPLE_FORMAT = 325, 338, 339

# field type -> (struct code, bytes); RATIONALs and DOUBLEs are not needed
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 13: ("I", 4)}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                 32773: "PackBits"}
# photometric -> the bits a sample libtiff's RGBA interface and cv2 take
_PHOTOMETRIC_BITS = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8)}
_CORRUPT = -2          # tiff_decode.cpp's kCorrupt


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _codecs():
    """{compression: the C++ decoder of csrc/tiff_decode.cpp}, each
    (src, n, dst, size) -> size or a negative error."""
    lib = load_host("tiff_decode")
    fns = {5: lib.ys_tiff_lzw, 32773: lib.ys_tiff_packbits}
    for fn in fns.values():
        fn.restype = ctypes.c_int64
        fn.argtypes = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64)
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
        tags[tag] = struct.unpack(e + code * count,
                                  data[where:where + size * count])
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
                 compression: int, name: str) -> np.ndarray:
    """size bytes of one strip or tile, decompressed."""
    raw = data[offset:offset + count]
    if len(raw) < count:
        raise ImageReadError(f"{name}: TIFF truncated: a strip or tile runs past "
                         f"the end of the file")
    if compression == 1:
        if len(raw) < size:
            raise ImageReadError(f"{name}: TIFF strip or tile of {len(raw)} "
                             f"bytes, expected {size}")
        return np.frombuffer(raw, np.uint8, size)
    if compression in (8, 32946):
        return np.frombuffer(_inflate(raw, size, name), np.uint8)
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(size, np.uint8)
    got = _codecs()[compression](_ptr(src), src.size, _ptr(out), size)
    if got == _CORRUPT:
        raise ImageReadError(f"{name}: TIFF LZW data is corrupt")
    if got != size:
        raise ImageReadError(f"{name}: TIFF {_COMPRESSIONS[compression]} data "
                         f"ends short of its strip or tile")
    return out


def _predictor(tags) -> int:
    """The Predictor tag where the codec takes one: libtiff's LZW and
    Deflate codecs do, PackBits and no compression ignore it."""
    if _get(tags, COMPRESSION, (1,))[0] in (1, 32773):
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
        kind = {6: "old-style JPEG", 7: "JPEG"}.get(compression, "")
        refuse(COMPRESSION, "Compression", f"{compression} {kind}".strip(),
               "none, LZW, Deflate and PackBits are")
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
               "gray, RGB and palette are")
    bits = set(_get(tags, BITS, (1,)))
    if len(bits) != 1 or min(bits) not in _PHOTOMETRIC_BITS[photometric]:
        refuse(BITS, "BitsPerSample", "/".join(map(str, sorted(bits))),
               f"photometric {photometric} takes "
               f"{_PHOTOMETRIC_BITS[photometric]}")
    bits = bits.pop()
    if set(_get(tags, SAMPLE_FORMAT, (1,))) != {1}:
        refuse(SAMPLE_FORMAT, "SampleFormat", _get(tags, SAMPLE_FORMAT),
               "unsigned integers only")
    if (photometric == 2 and spp - len(extra) < 3) or spp > 4 or (
            bits < 8 and spp != 1):
        refuse(SAMPLES, "SamplesPerPixel", f"{spp} with {len(extra)} extra",
               f"photometric {photometric}; at most 4")
    predictor = _predictor(tags)
    if predictor not in (1, 2) or (predictor == 2 and bits < 8):
        refuse(PREDICTOR, "Predictor", f"{predictor} at {bits} bits",
               "horizontal differencing of 8- and 16-bit samples only")
    if _get(tags, FILL_ORDER, (1,))[0] != 1:
        refuse(FILL_ORDER, "FillOrder", tags[FILL_ORDER][0],
               "most significant bit first only")
    if _get(tags, PLANAR, (1,))[0] not in (1, 2):
        refuse(PLANAR, "PlanarConfiguration", tags[PLANAR][0], "1 or 2")
    orientation = _get(tags, ORIENTATION, (1,))[0]
    if orientation not in (1, 2, 3, 4):
        raise ImageReadError(f"{name}: TIFF with Orientation (274) = "
                         f"{orientation}: cv2.imread returns no image for it "
                         f"(1-4 are read)")
    if photometric == 3 and len(_get(tags, COLOR_MAP, ())) != 3 << bits:
        raise ImageReadError(f"{name}: palette TIFF without a ColorMap (320) of "
                         f"{3 << bits} entries")
    return bits, spp, photometric


def _samples(data: bytes, tags, e: str, bits: int, spp: int,
             name: str) -> np.ndarray:
    """(H, W, spp) samples (uint8, or uint16 at 16 bits; 1- and 4-bit values
    one a byte) of the whole image, from its strips or tiles."""
    w, h = tags[WIDTH][0], tags[HEIGHT][0]
    compression = _get(tags, COMPRESSION, (1,))[0]
    planar = _get(tags, PLANAR, (1,))[0] == 2 and spp > 1
    predictor = _predictor(tags)
    per_chunk = 1 if planar else spp
    planes = spp if planar else 1
    if TILE_WIDTH in tags:
        cw, ch = tags[TILE_WIDTH][0], tags[TILE_LENGTH][0]
        offsets, counts = _get(tags, TILE_OFFSETS), _get(tags, TILE_COUNTS)
        across = (w + cw - 1) // cw
    else:
        cw, ch = w, min(_get(tags, ROWS_PER_STRIP, (h,))[0], h)
        offsets, counts = _get(tags, STRIP_OFFSETS), _get(tags, STRIP_COUNTS)
        across = 1
    if not cw or not ch:
        raise ImageReadError(f"{name}: TIFF with an empty strip or tile size")
    down = (h + ch - 1) // ch
    offsets, counts = offsets or (), counts or ()
    if min(len(offsets), len(counts)) < across * down * planes:
        raise ImageReadError(f"{name}: TIFF with {len(offsets)} strip or tile "
                         f"offsets and {len(counts)} byte counts, expected "
                         f"{across * down * planes}")
    dtype = np.dtype(e + "u2") if bits == 16 else np.dtype(np.uint8)
    row_bytes = (cw * per_chunk * bits + 7) // 8
    out = np.empty((h, w, spp), np.uint16 if bits == 16 else np.uint8)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                # a strip holds its rows alone; a tile is always whole
                rows = min(ch, h - y0) if TILE_WIDTH not in tags else ch
                buf = _chunk_bytes(data, offsets[k], counts[k],
                                   rows * row_bytes, compression, name)
                k += 1
                if bits < 8:
                    vals = unpack_bits(buf.reshape(rows, row_bytes), bits,
                                       cw)[..., None]
                else:
                    vals = buf.view(dtype).reshape(rows, cw, per_chunk)
                    if predictor == 2:
                        vals = np.cumsum(vals, axis=1, dtype=dtype)
                part = vals[:min(ch, h - y0), :min(cw, w - x0)]
                if planar:
                    out[y0:y0 + part.shape[0], x0:x0 + part.shape[1],
                        p] = part[..., 0]
                else:
                    out[y0:y0 + part.shape[0], x0:x0 + part.shape[1]] = part
    return out


def decode_tiff_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a baseline TIFF's first page, equal to
    cv2.cvtColor(cv2.imread(path, IMREAD_COLOR), COLOR_BGR2RGB). Raises
    ImageReadError naming ``name`` on what it does not read (see the module's
    docstring)."""
    e, tags = parse_ifd(data, name)
    if WIDTH not in tags or HEIGHT not in tags:
        raise ImageReadError(f"{name}: TIFF without ImageWidth / ImageLength")
    bits, spp, photometric = _check(tags, name)
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
