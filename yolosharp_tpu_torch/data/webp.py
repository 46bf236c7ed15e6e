"""WebP without cv2: the RIFF container parsed here, the VP8L lossless and
VP8 lossy bitstreams decoded by the host C++ of ``csrc/webp_decode.cpp``
(built with ``c++`` at first use, ``kernels.build.load_host``), to the bit
what cv2.imread(IMREAD_COLOR) 5.0 returns through libwebp, converted to
RGB (tests/test_torch_webp.py holds each against cv2).

- Simple files: ``RIFF`` size ``WEBP`` and one ``VP8 `` (lossy key frame,
  libwebp's fancy upsampling and YUV -> BGR) or ``VP8L`` (lossless) chunk.
- Extended files (``VP8X``): the canvas must be the image's size; an
  ``ALPH`` chunk is decoded and checked (raw, or a VP8L stream; its
  filter and levels do not touch the colours) and its alpha dropped, as
  cv2 drops it for IMREAD_COLOR; ``ICCP`` and ``XMP `` are skipped; an
  ``EXIF`` chunk's Orientation is applied, as cv2 5.0 applies it.
- Animated files (``ANIM`` / ``ANMF``): the first frame on a canvas of
  zeros (transparent black, black once the alpha is dropped) at its
  offset, as cv2 5.0's animation reader returns it for imread.

A truncated file, a chunk whose size does not fit its container, a frame
libwebp refuses (not a key frame, a bad partition, a stream that ends
early, an incomplete prefix code) or any other kind raises ImageReadError
naming the file. No image is ever substituted.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Tuple

import numpy as np

from ..kernels.build import load_host
from .errors import ImageReadError
from .jpeg import apply_orientation, exif_orientation

_MAX_CHUNK = 0xFFFFFFFF - 8 - 1
_ANIMATION = 0x02           # the VP8X flag of an animated file


def is_webp(data: bytes) -> bool:
    """cv2's signature test: ``RIFF``, four size bytes, ``WEBP``."""
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _chunks(data: bytes, pos: int, end: int, name: str
            ) -> List[Tuple[bytes, int, int]]:
    """(fourcc, payload start, payload size) of the chunks from pos to
    end, each padded to an even size; a chunk past `end` fails."""
    out = []
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if size > _MAX_CHUNK or pos + 8 + size > end:
            raise ImageReadError(f"{name}: WebP chunk {kind!r} runs past the "
                                 f"end of its container")
        out.append((kind, pos + 8, size))
        pos += 8 + size + (size & 1)
    return out


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _vp8_size(data: bytes, at: int, size: int, name: str) -> Tuple[int, int]:
    frame = data[at:at + size]
    if size < 10 or frame[3:6] != b"\x9d\x01\x2a":
        raise ImageReadError(f"{name}: WebP VP8 frame without its key-frame "
                             f"header")
    w = struct.unpack("<H", frame[6:8])[0] & 0x3FFF
    h = struct.unpack("<H", frame[8:10])[0] & 0x3FFF
    return w, h


def _vp8l_size(data: bytes, at: int, size: int, name: str
               ) -> Tuple[int, int]:
    if size < 5 or data[at] != 0x2F or data[at + 4] >> 5:
        raise ImageReadError(f"{name}: WebP VP8L stream without its "
                             f"signature")
    (bits,) = struct.unpack("<I", data[at + 1:at + 5])
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _decode_frame(data: bytes, image: Tuple[bytes, int, int],
                  alpha: Optional[Tuple[bytes, int, int]], name: str
                  ) -> np.ndarray:
    """(h, w, 3) B, G, R of a ``VP8 `` or ``VP8L`` chunk, its ALPH chunk
    (if any) decoded and checked."""
    lib = load_host("webp_decode")
    kind, at, size = image
    buf = np.frombuffer(data, np.uint8, size, at)
    if kind == b"VP8 ":
        w, h = _vp8_size(data, at, size, name)
        bgr = np.empty((h, w, 3), np.uint8)
        if w == 0 or h == 0 or lib.ys_webp_lossy(
                _ptr(buf), ctypes.c_int64(size), w, h, _ptr(bgr)):
            raise ImageReadError(f"{name}: WebP lossy frame not decoded "
                                 f"(libwebp refuses it)")
    else:
        w, h = _vp8l_size(data, at, size, name)
        argb = np.empty((h, w), np.uint32)
        if lib.ys_webp_lossless(_ptr(buf), ctypes.c_int64(size), w, h, 0,
                                _ptr(argb)):
            raise ImageReadError(f"{name}: WebP lossless stream not decoded "
                                 f"(libwebp refuses it)")
        bgr = argb.view(np.uint8).reshape(h, w, 4)[..., :3]
    if alpha is not None and kind == b"VP8 ":
        _check_alpha(data, alpha, w, h, name)
    return bgr


def _check_alpha(data: bytes, alpha: Tuple[bytes, int, int], w: int, h: int,
                 name: str) -> None:
    """Decode an ALPH chunk as libwebp does for the BGRA output cv2 asks of
    a file with alpha; its values are dropped, its faults fail the file."""
    _, at, size = alpha
    head = data[at] if size else 0xFF
    method, pre, rsrv = head & 3, (head >> 4) & 3, head >> 6
    if size < 1 or method > 1 or pre > 1 or rsrv:      # any filter 0-3
        raise ImageReadError(f"{name}: WebP ALPH chunk with header "
                             f"0x{head:02x}")
    if method == 0:
        if size - 1 < w * h:
            raise ImageReadError(f"{name}: WebP ALPH chunk truncated")
        return
    lib = load_host("webp_decode")
    buf = np.frombuffer(data, np.uint8, size - 1, at + 1)
    scratch = np.empty((h, w), np.uint32)
    if lib.ys_webp_lossless(_ptr(buf), ctypes.c_int64(size - 1), w, h, 1,
                            _ptr(scratch)):
        raise ImageReadError(f"{name}: WebP ALPH lossless stream not "
                             f"decoded")


def decode_webp_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a WebP file as cv2.imread(IMREAD_COLOR) 5.0
    returns it (see the module docstring)."""
    if not is_webp(data):
        raise ImageReadError(f"{name}: not a WebP file")
    (riff,) = struct.unpack("<I", data[4:8])
    if riff < 12 or riff > _MAX_CHUNK or riff > len(data) - 8:
        raise ImageReadError(f"{name}: WebP RIFF size {riff} does not fit "
                             f"its {len(data)} bytes")
    chunks = _chunks(data, 12, 8 + riff, name)
    if not chunks:
        raise ImageReadError(f"{name}: WebP without an image chunk")
    first = chunks[0][0]
    if first in (b"VP8 ", b"VP8L"):
        return np.ascontiguousarray(
            _decode_frame(data, chunks[0], None, name)[..., ::-1])
    if first != b"VP8X" or chunks[0][2] != 10:
        raise ImageReadError(f"{name}: WebP whose first chunk is {first!r}")
    at = chunks[0][1]
    flags = data[at]
    cw = 1 + int.from_bytes(data[at + 4:at + 7], "little")
    ch = 1 + int.from_bytes(data[at + 7:at + 10], "little")
    orientation = 1
    exif_chunk = next((c for c in chunks if c[0] == b"EXIF"), None)
    if exif_chunk is not None:
        _, eat, esize = exif_chunk
        exif = data[eat:eat + esize]
        if exif[:6] == b"Exif\0\0":
            exif = exif[6:]
        orientation = exif_orientation(exif)
    if flags & _ANIMATION:
        bgr = _first_frame(data, chunks, cw, ch, name)
    else:
        image = alpha = None
        for c in chunks[1:]:
            if c[0] in (b"VP8 ", b"VP8L"):
                image = c
                break
            if c[0] == b"ALPH" and alpha is None:
                alpha = c
        if image is None:
            raise ImageReadError(f"{name}: WebP without a VP8 or VP8L chunk")
        bgr = _decode_frame(data, image, alpha, name)
        if bgr.shape[:2] != (ch, cw):
            raise ImageReadError(f"{name}: WebP canvas {cw}x{ch} is not its "
                                 f"image's {bgr.shape[1]}x{bgr.shape[0]}")
    return apply_orientation(bgr[..., ::-1], orientation)


def _first_frame(data: bytes, chunks, cw: int, ch: int, name: str
                 ) -> np.ndarray:
    """The first ANMF frame of an animation on a zero canvas."""
    frame = next((c for c in chunks if c[0] == b"ANMF"), None)
    if frame is None or frame[2] < 16:
        raise ImageReadError(f"{name}: animated WebP without a frame")
    _, at, size = frame
    x = 2 * int.from_bytes(data[at:at + 3], "little")
    y = 2 * int.from_bytes(data[at + 3:at + 6], "little")
    fw = 1 + int.from_bytes(data[at + 6:at + 9], "little")
    fh = 1 + int.from_bytes(data[at + 9:at + 12], "little")
    sub = _chunks(data, at + 16, at + size, name)
    image = next((c for c in sub if c[0] in (b"VP8 ", b"VP8L")), None)
    alpha = next((c for c in sub if c[0] == b"ALPH"), None)
    if image is None or x + fw > cw or y + fh > ch:
        raise ImageReadError(f"{name}: animated WebP with a bad first frame")
    bgr = _decode_frame(data, image, alpha, name)
    if bgr.shape[:2] != (fh, fw):
        raise ImageReadError(f"{name}: WebP frame {fw}x{fh} is not its "
                             f"image's {bgr.shape[1]}x{bgr.shape[0]}")
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[y:y + fh, x:x + fw] = bgr
    return canvas
