"""BMP without cv2: every kind cv2.imread(IMREAD_COLOR) 5.0 reads, to the
bit (tests/test_torch_bmp_pnm.py holds each against cv2).

- Headers: the 12-byte OS/2 BITMAPCOREHEADER (16-bit sizes, 3-byte
  palette entries, a palette of 2**bpp entries) and every header of 36
  bytes or more (BITMAPINFOHEADER 40, V2 52, V3 56, V4 108, V5 124, OS/2
  2.x 64). Other sizes, BI_JPEG / BI_PNG / BI_ALPHABITFIELDS, 2-bit
  pixels and a palette of more than 256 colours are refused, as cv2
  refuses them.
- 1-, 4- and 8-bit paletted pixels through the palette that follows the
  header (``biClrUsed`` entries, or 2**bpp where it is 0); an index past
  the palette's end reads black.
- 16-bit: 5-5-5 (BI_RGB, or BI_BITFIELDS with the masks 7C00 / 3E0 / 1F)
  or 5-6-5 (BI_BITFIELDS F800 / 7E0 / 1F), each channel's bits shifted to
  the top of its byte with the low bits zero. cv2 reads the masks from
  the 12 bytes after the header whatever its size, so a V3 or later
  header's own masks are not what it reads; any other masks are refused.
- 24-bit B, G, R; 32-bit B, G, R, X. With BI_BITFIELDS and a header of 56
  bytes or more whose R, G and B masks are all non-zero, each channel is
  ``floor(float32(v & mask >> shift) * float32(255 / (mask >> shift)))``
  in float32 (``shift`` the mask's trailing zeros); otherwise the masks
  are ignored and the bytes are B, G, R, X.
- BI_RLE8 (8-bit) and BI_RLE4 (4-bit): encoded runs (RLE4: two values
  alternating), absolute runs, end-of-line, end-of-bitmap and delta
  escapes, decoded as cv2 decodes them: pixels a delta, an end-of-line or
  the end-of-bitmap skips take palette entry 0, a run that would cross
  the end of its row or a stream that ends before the last row fails the
  file, and an RLE8 end-of-line straight after a run that ended its row
  is ignored. cv2's RLE4 drops the rows of its escapes: an end-of-bitmap
  only ends its row (as an end-of-line does) and a delta moves dx pixels
  on, its dy ignored, so the image ends when its last row does.
- Rows bottom-up (a positive height) or top-down (a negative one).

Anything else raises ImageReadError naming the file. No image is ever
substituted.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from .errors import ImageReadError

BMP_SIGNATURE = b"BM"
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
_MASKS_555 = (0x7C00, 0x3E0, 0x1F)
_MASKS_565 = (0xF800, 0x7E0, 0x1F)


class _Stream:
    """Bytes read in order; reading past the end fails the file."""

    def __init__(self, data: bytes, pos: int, name: str):
        self.data, self.pos, self.name = data, pos, name

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ImageReadError(f"{self.name}: BMP truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def decode_bmp_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a BMP of any kind cv2 5.0 reads, as
    cv2.imread(IMREAD_COLOR) reads it (see the module docstring)."""
    if data[:2] != BMP_SIGNATURE or len(data) < 18:
        raise ImageReadError(f"{name}: not a BMP file")
    offset, hsize = struct.unpack("<II", data[10:18])
    if len(data) < 14 + min(hsize, 40):
        raise ImageReadError(f"{name}: BMP truncated in its header")
    palette = np.zeros((256, 3), np.uint8)
    if hsize == 12:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp = BI_RGB                   # 16-bit sizes: always bottom-up
        if bpp not in (1, 4, 8, 24, 32) or w == 0 or h == 0:
            raise ImageReadError(f"{name}: OS/2 BMP of {bpp} bits a pixel, "
                                 f"{w}x{h} is not read")
        if bpp <= 8:
            n = 1 << bpp
            pal = _Stream(data, 26, name).take(3 * n)
            palette[:n] = np.frombuffer(pal, np.uint8).reshape(n, 3)
    elif hsize >= 36:
        w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        (clr_used,) = struct.unpack("<i", data[46:50])
        if comp > BI_BITFIELDS:
            raise ImageReadError(f"{name}: BMP with compression {comp} is "
                                 f"not read")
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == BI_RGB)
            or (bpp in (16, 32) and comp in (BI_RGB, BI_BITFIELDS))
            or (bpp == 4 and comp == BI_RLE4)
            or (bpp == 8 and comp == BI_RLE8))
        if not ok:
            raise ImageReadError(f"{name}: BMP of {bpp} bits a pixel with "
                                 f"compression {comp}, {w}x{h} is not read")
        after = _Stream(data, 14 + hsize, name)
        if bpp <= 8:
            if not 0 <= clr_used <= 256:
                raise ImageReadError(f"{name}: BMP with a palette of "
                                     f"{clr_used} colours")
            n = clr_used or 1 << bpp
            pal = np.frombuffer(after.take(4 * n), np.uint8).reshape(n, 4)
            palette[:n] = pal[:, :3]
        elif bpp == 16:
            masks = (struct.unpack("<III", after.take(12))
                     if comp == BI_BITFIELDS else _MASKS_555)
            if masks == _MASKS_555:
                bpp = 15
            elif masks != _MASKS_565:
                raise ImageReadError(f"{name}: 16-bit BMP with the masks "
                                     f"{[hex(m) for m in masks]} is not "
                                     f"read")
    else:
        raise ImageReadError(f"{name}: BMP with a {hsize}-byte header is "
                             f"not read")
    rows, top_down = abs(int(h)), h < 0
    masks32: Optional[tuple] = None
    if bpp == 32 and comp == BI_BITFIELDS and hsize >= 56:
        masks32 = struct.unpack("<III", data[54:66])
        if not all(masks32):
            masks32 = None
    src = _Stream(data, offset, name)
    if comp in (BI_RLE8, BI_RLE4):
        bgr = _decode_rle(src, w, rows, palette, comp == BI_RLE4)
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        raw = np.frombuffer(src.take(pitch * rows), np.uint8).reshape(
            rows, pitch)
        bgr = _unpack_rows(raw, w, bpp, palette, masks32)
    if not top_down:
        bgr = bgr[::-1]
    return np.ascontiguousarray(bgr[..., ::-1])


def _unpack_rows(raw: np.ndarray, w: int, bpp: int, palette: np.ndarray,
                 masks32: Optional[tuple]) -> np.ndarray:
    """(rows, w, 3) B, G, R of the stored rows (rows, pitch)."""
    if bpp <= 8:
        bits = np.unpackbits(raw, axis=1)[:, :w * bpp]
        if bpp == 1:
            idx = bits
        else:
            weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
            idx = bits.reshape(len(raw), w, bpp) @ weights
        return palette[idx]
    if bpp in (15, 16):
        t = raw[:, :2 * w].copy().view("<u2").astype(np.uint16)
        b = (t << 3) & 0xF8
        if bpp == 15:
            g, r = (t >> 2) & 0xF8, (t >> 7) & 0xF8
        else:
            g, r = (t >> 3) & 0xFC, (t >> 8) & 0xF8
        return np.stack([b, g, r], -1).astype(np.uint8)
    if bpp == 24:
        return raw[:, :3 * w].reshape(len(raw), w, 3)
    px = raw[:, :4 * w].reshape(len(raw), w, 4)
    if masks32 is None:
        return px[..., :3]
    v = raw[:, :4 * w].copy().view("<u4").astype(np.uint32)
    out = []
    for m in (masks32[2], masks32[1], masks32[0]):     # B, G, R
        shift = (m & -m).bit_length() - 1
        top = np.float32(255.0) / np.float32(m >> shift)
        val = ((v & np.uint32(m)) >> np.uint32(shift)).astype(np.float32)
        out.append(np.floor(val * top).astype(np.uint8))
    return np.stack(out, -1)


def _decode_rle(src: _Stream, w: int, rows: int, palette: np.ndarray,
                rle4: bool) -> np.ndarray:
    """(rows, w, 3) B, G, R of RLE8 / RLE4 data in storage order, as cv2's
    BmpDecoder::readData steps through it: ``x`` and ``y`` are its write
    position, FillUniColor its skip that carries over row ends."""
    out = np.empty((rows, w, 3), np.uint8)
    x = y = 0
    eol_after_wrap = False          # RLE8's line_end_flag

    def fill(count: int, color) -> None:
        """FillUniColor: `count` pixels of `color` from (x, y) on, moving to
        the next row at each row end (also when `count` ends there)."""
        nonlocal x, y
        while True:
            n = min(count, w - x)
            out[y, x:x + n] = color
            x += n
            count -= n
            if x >= w:
                x, y = 0, y + 1
                if y >= rows:
                    return
            if count <= 0:
                return

    while True:
        first, code = src.byte(), src.byte()
        if first:                       # an encoded run of `first` pixels
            if x + first > w:
                raise ImageReadError(f"{src.name}: BMP RLE run past the "
                                     f"end of its row")
            if rle4:
                pair = palette[[code >> 4, code & 15]]
                out[y, x:x + first] = pair[np.arange(first) & 1]
                x += first
                eol_after_wrap = False
            else:
                prev_y = y
                fill(first, palette[code])
                eol_after_wrap = y != prev_y
                if y >= rows:
                    break
        elif code > 2:                  # an absolute run of `code` pixels
            if x + code > w:
                raise ImageReadError(f"{src.name}: BMP RLE absolute run "
                                     f"past the end of its row")
            if rle4:
                raw = np.frombuffer(src.take((((code + 1) >> 1) + 1) & ~1),
                                    np.uint8)
                idx = np.stack([raw >> 4, raw & 15], 1).reshape(-1)[:code]
            else:
                idx = np.frombuffer(src.take((code + 1) & ~1),
                                    np.uint8)[:code]
            out[y, x:x + code] = palette[idx]
            x += code
            eol_after_wrap = False
        else:                           # end of line / bitmap, or a delta
            to_row_end = w - x
            if rle4 or code or not eol_after_wrap or to_row_end < w:
                dy = rows - y
                if code == 2:
                    to_row_end, dy = src.byte(), src.byte()
                # RLE4 drops the rows of an end-of-bitmap or a delta: its
                # escapes each fill to the row's end, or dx pixels
                count = to_row_end + (dy * w if code and not rle4 else 0)
                fill(count, palette[0])
                if y >= rows:
                    break
            eol_after_wrap = False
            if y >= rows:
                break
    return out
