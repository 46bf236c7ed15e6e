"""PFM without cv2, to the bit what cv2.imread(IMREAD_COLOR) 5.0 returns
(grfmt_pfm.cpp), converted to RGB.

``PF`` (colour) then exactly a line feed, the width, the height and the
scale, each ended by one whitespace byte, then float32 rows bottom to top,
little-endian where the scale is negative, big-endian where it is
positive. cv2 divides by the scale's magnitude (a float32 multiply by its
reciprocal) and converts to 8 bits without scaling (``to_u8``). ``Pf``
(gray) files are refused as 3-channel images, as is a zero scale, a
number that does not parse or a file cut short. ``pnm.is_pnm`` does not
claim these files: its signature wants a digit after the ``P``.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from .errors import ImageReadError

_SPACE = b" \t\n\v\f\r"
_INT = re.compile(rb"[+-]?\d+")
_FLOAT = re.compile(rb"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|"
                    rb"inf(?:inity)?|nan)", re.IGNORECASE)


def is_pfm(data: bytes) -> bool:
    """cv2's signature test: ``P``, ``F`` or ``f``, a whitespace byte."""
    return len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"Ff" \
        and data[2] in _SPACE


def to_u8(v: np.ndarray) -> np.ndarray:
    """cv2's float32 -> uint8 (saturate_cast): rounded half to even, then
    clamped to [0, 255]; NaN, infinities and values past the int32 range
    round to INT_MIN (the x86 conversion's overflow value) and so to 0."""
    r = np.rint(np.asarray(v, np.float32).astype(np.float64))
    bad = ~np.isfinite(r) | (r >= 2.0 ** 31) | (r < -2.0 ** 31)
    return np.where(bad, 0, np.clip(np.where(bad, 0, r), 0, 255)).astype(
        np.uint8)


def _token(data: bytes, pos: int, name: str) -> Tuple[bytes, int]:
    """cv2's read_number: the bytes up to the next whitespace byte."""
    end = pos
    while end < len(data) and data[end] not in _SPACE:
        end += 1
    if end >= len(data):
        raise ImageReadError(f"{name}: PFM header cut short")
    return data[pos:end], end + 1


def decode_pfm_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PFM file as cv2.imread(IMREAD_COLOR) 5.0
    returns it (see the module docstring)."""
    if not is_pfm(data) or data[2:3] != b"\n":
        raise ImageReadError(f"{name}: not a PFM file (PF or Pf, then a "
                             f"line feed)")
    if data[1:2] == b"f":
        raise ImageReadError(f"{name}: gray PFM (Pf) is not read as a "
                             f"3-channel image (cv2 refuses it)")
    pos = 3
    fields = []
    for pattern in (_INT, _INT, _FLOAT):
        tok, pos = _token(data, pos, name)
        m = pattern.match(tok)
        if not m:
            raise ImageReadError(f"{name}: PFM header field {tok!r}")
        fields.append(m.group())
    w, h, scale = int(fields[0]), int(fields[1]), float(fields[2])
    if w <= 0 or h <= 0 or not scale:
        raise ImageReadError(f"{name}: PFM of {w}x{h} pixels, scale "
                             f"{scale}")
    if len(data) < pos + 12 * w * h:
        raise ImageReadError(f"{name}: PFM cut short")
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", 3 * w * h, pos)
    v = v.reshape(h, w, 3)[::-1].astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        v = v * np.float32(1.0 / abs(scale))    # float32, as cv2 scales
    return to_u8(v)
