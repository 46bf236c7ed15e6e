"""Radiance HDR without cv2, to the bit what cv2.imread(IMREAD_COLOR) 5.0
returns (grfmt_hdr.cpp, rgbe.cpp), converted to RGB.

The header as cv2 reads it: lines of at most 127 bytes (fgets into 128),
the first ``#?RADIANCE`` or ``#?RGBE``, up to a blank line; one of them
``FORMAT=32-bit_rle_rgbe`` exactly (``32-bit_rle_xyze`` alone, or none,
is refused); then the line ``-Y <height> +X <width>`` as sscanf reads it
(any other orientation is refused, as is a size that is not positive).
The scanlines are read by the host C++ of ``csrc/hdr_decode.cpp`` (flat,
or new-style run-length encoded; an old-style RLE file is read flat, its
repeat markers as pixels, and refused where that leaves it short). Each
pixel as cv2's rgbe2float: the mantissas times 2 ** (E - 136) in float32
(0 where E is 0), then times 255 and converted to 8 bits (``pfm.to_u8``).
What cv2.imread returns None for raises ImageReadError naming the file.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np

from ..kernels.build import load_host
from .errors import ImageReadError, check_size
from .pfm import to_u8

HDR_SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
# sscanf("-Y %d +X %d"): %d skips whitespace and takes a sign
_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


def is_hdr(data: bytes) -> bool:
    return data.startswith(HDR_SIGNATURES)


def _fgets(data: bytes, pos: int):
    """C's fgets into a 128-byte buffer: up to 127 bytes, through the first
    line feed; None at the end of the data."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = pos + 127 if end < 0 else end + 1
    return data[pos:end], min(end, len(data))


def decode_hdr_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a Radiance HDR file as cv2.imread
    (IMREAD_COLOR) 5.0 returns it (see the module docstring)."""
    if not is_hdr(data):
        raise ImageReadError(f"{name}: not a Radiance HDR file")
    pos, found = 0, False
    while True:
        line, pos = _fgets(data, pos)
        if line is None:
            raise ImageReadError(f"{name}: HDR header cut short")
        if line[:1] in (b"\n", b"\0"):
            break
        found = found or line == _FORMAT
    if not found:
        raise ImageReadError(f"{name}: HDR without FORMAT=32-bit_rle_rgbe")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line or b"")
    if not m:
        raise ImageReadError(f"{name}: HDR without a -Y <height> +X <width> "
                             f"line (other orientations are refused)")
    h, w = int(m.group(1)), int(m.group(2))
    if h <= 0 or w <= 0:
        raise ImageReadError(f"{name}: HDR of {w}x{h} pixels")
    check_size(w, h, name)
    rgbe = np.empty((h, w, 4), np.uint8)
    body = np.frombuffer(data, np.uint8, len(data) - pos, pos)
    lib = load_host("hdr_decode")
    if lib.ys_hdr_pixels(body.ctypes.data_as(ctypes.c_void_p),
                         ctypes.c_int64(body.size), w, h,
                         rgbe.ctypes.data_as(ctypes.c_void_p)):
        raise ImageReadError(f"{name}: HDR pixel data is corrupt or cut "
                             f"short")
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1), e - 136), 0).astype(
        np.float32)
    with np.errstate(over="ignore"):            # float32, as cv2's
        v = rgbe[..., :3].astype(np.float32) * f[..., None] * np.float32(255)
    return to_u8(v)
