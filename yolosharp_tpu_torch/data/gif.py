"""GIF without cv2, to the bit what cv2.imread(IMREAD_COLOR) 5.0 returns
through its own GIF decoder (grfmt_gif.cpp), converted to RGB: the first
frame, on a canvas of the logical screen.

- The header (GIF87a or GIF89a) and the logical screen; the global colour
  table, whose background index must lie inside it.
- cv2 first walks every block of the file: extensions, image descriptors
  and their data, up to the trailer; a file cut short, or any other block,
  is refused.
- The Graphic Control Extensions before the first frame (the last one
  counts): its transparent index; a disposal method past 3 is refused.
- The frame: its local colour table, else the global one (neither:
  refused), cv2 keeping both in one buffer: the global table with the
  local one over its first entries; inside the screen; its LZW codes
  (the host C++ of ``csrc/gif_decode.cpp``, cv2's rules: a minimum code
  size of 2 to 11, the frame exactly filled) and its four interlace
  passes.
- The canvas: the global table's background colour, or black without a
  global table; a transparent pixel, and the screen around a smaller
  frame, keep it; any other index past the frame's table is refused.

What cv2.imread returns None for raises ImageReadError naming the file.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Tuple

import numpy as np

from ..kernels.build import load_host
from .errors import ImageReadError, check_size

GIF_SIGNATURES = (b"GIF87a", b"GIF89a")


def is_gif(data: bytes) -> bool:
    """cv2's signature test: ``GIF`` (the version is checked after)."""
    return data[:3] == b"GIF"


def _sub_blocks(data: bytes, pos: int, name: str) -> Tuple[List[bytes], int]:
    """The data sub-blocks from pos up to their terminator, and the
    position after it."""
    parts = []
    while True:
        if pos >= len(data):
            raise ImageReadError(f"{name}: GIF cut short")
        n = data[pos]
        if n == 0:
            return parts, pos + 1
        if pos + 1 + n > len(data):
            raise ImageReadError(f"{name}: GIF cut short")
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def _table(data: bytes, pos: int, flags: int, name: str
           ) -> Tuple[np.ndarray, int]:
    n = 1 << ((flags & 7) + 1)
    if pos + 3 * n > len(data):
        raise ImageReadError(f"{name}: GIF cut short")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), \
        pos + 3 * n


def _check_blocks(data: bytes, pos: int, name: str) -> None:
    """cv2's frame count: every block up to the trailer well formed."""
    while True:
        if pos >= len(data):
            raise ImageReadError(f"{name}: GIF without its trailer (cut "
                                 f"short)")
        kind = data[pos]
        if kind == 0x3B:
            return
        if kind == 0x21:
            if pos + 2 > len(data):
                raise ImageReadError(f"{name}: GIF cut short")
            _, pos = _sub_blocks(data, pos + 2, name)
        elif kind == 0x2C:
            if pos + 10 > len(data):
                raise ImageReadError(f"{name}: GIF cut short")
            flags = data[pos + 9]
            pos += 10
            if flags & 0x80:
                pos += 3 << ((flags & 7) + 1)
            _, pos = _sub_blocks(data, pos + 1, name)
        else:
            raise ImageReadError(f"{name}: GIF with an unknown block "
                                 f"0x{kind:02x}")


def decode_gif_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a GIF's first frame as cv2.imread
    (IMREAD_COLOR) 5.0 returns it (see the module docstring)."""
    if data[:6] not in GIF_SIGNATURES:
        raise ImageReadError(f"{name}: not a GIF87a or GIF89a file")
    if len(data) < 13:
        raise ImageReadError(f"{name}: GIF cut short")
    width, height, flags, background = struct.unpack("<HHBB", data[6:12])
    if width == 0 or height == 0:
        raise ImageReadError(f"{name}: GIF of an empty screen")
    check_size(width, height, name)
    pos = 13
    global_table = None
    if flags & 0x80:
        global_table, pos = _table(data, pos, flags, name)
        if background >= len(global_table):
            raise ImageReadError(f"{name}: GIF background index past its "
                                 f"colour table")
    _check_blocks(data, pos, name)
    transparent = None
    while data[pos] == 0x21:                   # the extensions first
        label = data[pos + 1]
        blocks, after = _sub_blocks(data, pos + 2, name)
        if label == 0xF9:
            if not blocks or len(blocks[0]) != 4:
                raise ImageReadError(f"{name}: GIF with a bad graphic "
                                     f"control extension")
            packed, index = blocks[0][0], blocks[0][3]
            if (packed >> 2) & 7 > 3:
                raise ImageReadError(f"{name}: GIF disposal method "
                                     f"{(packed >> 2) & 7}")
            transparent = index if packed & 1 else None
        pos = after
    if data[pos] != 0x2C:
        raise ImageReadError(f"{name}: GIF without an image")
    left, top, w, h, fflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
    if w == 0 or h == 0 or left + w > width or top + h > height:
        raise ImageReadError(f"{name}: GIF frame outside its screen")
    pos += 10
    if fflags & 0x80:
        # cv2's one table buffer: the global table, the local one written
        # over its first entries
        local, pos = _table(data, pos, fflags, name)
        table = local if global_table is None or len(global_table) <= len(
            local) else np.concatenate([local, global_table[len(local):]])
    elif global_table is not None:
        table = global_table
    else:
        raise ImageReadError(f"{name}: GIF frame without a colour table")
    min_code_size = data[pos]
    if not 2 <= min_code_size <= 11:
        raise ImageReadError(f"{name}: GIF LZW minimum code size "
                             f"{min_code_size}")
    blocks, _ = _sub_blocks(data, pos + 1, name)
    codes = np.frombuffer(b"".join(blocks), np.uint8)
    idx = np.empty(w * h, np.uint8)
    lib = load_host("gif_decode")
    if lib.ys_gif_lzw(codes.ctypes.data_as(ctypes.c_void_p),
                      ctypes.c_int64(codes.size), min_code_size,
                      idx.ctypes.data_as(ctypes.c_void_p),
                      ctypes.c_int64(idx.size)):
        raise ImageReadError(f"{name}: GIF image data is corrupt")
    idx = idx.reshape(h, w)
    if fflags & 0x40:                          # the four interlace passes
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    canvas = np.zeros((height, width, 3), np.uint8)
    if global_table is not None:
        canvas[:] = global_table[background]
    opaque = np.ones((h, w), bool) if transparent is None else \
        idx != transparent
    if (idx[opaque] >= len(table)).any():
        raise ImageReadError(f"{name}: GIF index past its colour table")
    region = canvas[top:top + h, left:left + w]
    region[opaque] = table[idx[opaque]]
    return canvas
