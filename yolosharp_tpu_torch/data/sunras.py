"""Sun raster without cv2, to the bit what cv2.imread(IMREAD_COLOR) 5.0
returns (grfmt_sunras.cpp), converted to RGB.

The 32-byte big-endian header: the signature 0x59A66A95, width, height,
depth, length (not used), type, colour-map type and colour-map length.
cv2 5.0 reads:

- types 0 (old) and 1 (standard) only: byte-encoded (2) and RGB (3)
  files are refused, as is any other type;
- depths 1, 8, 24 and 32; rows padded to 16 bits, every row's bytes
  present (a file cut short is refused);
- no colour map (type 0, length 0): 1-bit samples as black (0) and white
  (1), 8-bit ones as gray; or an RGB colour map (type 1, 1 to 3 * 2**depth
  bytes, depth 8 or less): its R, G and B planes of length // 3 entries
  each, the indices past it black;
- 24-bit pixels as B, G, R and 32-bit ones as X, B, G, R.

What cv2.imread returns None for raises ImageReadError naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from .errors import ImageReadError

SUNRAS_SIGNATURE = b"\x59\xa6\x6a\x95"


def is_sunras(data: bytes) -> bool:
    return data[:4] == SUNRAS_SIGNATURE


def decode_sunras_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a Sun raster file as cv2.imread
    (IMREAD_COLOR) 5.0 returns it (see the module docstring)."""
    if not is_sunras(data) or len(data) < 32:
        raise ImageReadError(f"{name}: not a Sun raster file")
    w, h, depth, _, kind, map_type, map_len = struct.unpack(">7I",
                                                            data[4:32])
    if w == 0 or h == 0 or w >= 1 << 31 or h >= 1 << 31 or \
            depth not in (1, 8, 24, 32):
        raise ImageReadError(f"{name}: Sun raster of {w}x{h} pixels at "
                             f"depth {depth} is not read")
    if kind not in (0, 1):
        raise ImageReadError(f"{name}: Sun raster of type {kind} (cv2 5.0 "
                             f"reads the old and standard types only)")
    palette = np.zeros((256, 3), np.uint8)
    if map_type == 0 and map_len == 0:
        if depth <= 8:
            palette[:1 << depth] = np.linspace(
                0, 255, 1 << depth).astype(np.uint8)[:, None]
    elif map_type == 1 and depth <= 8 and 0 < map_len <= 3 << depth:
        if len(data) < 32 + map_len:
            raise ImageReadError(f"{name}: Sun raster cut short")
        n = map_len // 3
        planes = np.frombuffer(data, np.uint8, 3 * n, 32)
        palette[:n] = planes.reshape(3, n).T
    else:
        raise ImageReadError(f"{name}: Sun raster with colour map type "
                             f"{map_type} of {map_len} bytes is not read")
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    at = 32 + map_len
    if len(data) < at + pitch * h:
        raise ImageReadError(f"{name}: Sun raster cut short")
    rows = np.frombuffer(data, np.uint8, pitch * h, at).reshape(h, pitch)
    if depth == 1:
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return palette[bits]
    if depth == 8:
        return palette[rows[:, :w]]
    step = depth // 8
    px = rows[:, :w * step].reshape(h, w, step)
    return np.ascontiguousarray(px[..., ::-1][..., :3])
