"""PNM (P1-P6) and PAM (P7) without cv2, to the bit what
cv2.imread(IMREAD_COLOR) 5.0 returns, converted to RGB
(tests/test_torch_bmp_pnm.py holds each against cv2).

PNM: ``P1`` / ``P4`` bitmaps (1 is black), ``P2`` / ``P5`` graymaps and
``P3`` / ``P6`` pixmaps, ASCII (1-3) or binary (4-6), ``#`` comments
anywhere a number may start. cv2 maps samples to 8 bits so:

- maxval above 255: the 16-bit sample's high byte (``v >> 8``), ASCII or
  binary, whatever the maxval;
- maxval up to 255, ASCII: ``min(v, maxval) * 255 // maxval``;
- maxval up to 255, binary: the byte as stored, unscaled.

PAM: ``P7`` and a line break, then WIDTH, HEIGHT, DEPTH, MAXVAL, an
optional TUPLTYPE and ENDHDR lines (``#`` comment lines allowed, field
names in any case). cv2 reads:

- MAXVAL 1, any tuple type: "bit mode", each row's bytes taken as packed
  bits, most significant first, 1 white: pixel x is bit 7 - x % 8 of the
  row's byte x // 8;
- GRAYSCALE (or DEPTH 1 without a TUPLTYPE): the sample, repeated;
- RGB (or DEPTH 3 without a TUPLTYPE, MAXVAL below 256): the three
  samples as stored into cv2's B, G, R, so the channels come out in the
  file's order reversed;
- GRAYSCALE_ALPHA: the gray sample repeated, RGB_ALPHA: R, G, B; cv2 5.0
  converts only the first ceil(width / depth) pixels of each row and
  leaves the rest of the row unwritten (whatever its memory held), so
  this reader gives every pixel and the tests hold the part cv2 writes;
- 16-bit samples (MAXVAL above 255) as their high byte, 8-bit ones as
  stored, unscaled.

A file cut short, an unknown TUPLTYPE, DEPTH 2 or 4 without one, MAXVAL
above 255 without one, or anything else cv2 refuses raises
ImageReadError naming the file.
"""

from __future__ import annotations

import numpy as np

from .errors import ImageReadError

_SPACE = b" \t\n\v\f\r"
# the tuple types cv2 5.0 knows (matched case-sensitively), and DEPTH
_TUPLTYPES = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2,
              "RGB": 3, "RGB_ALPHA": 4}


def is_pnm(data: bytes) -> bool:
    """cv2's signature test: ``P1``-``P7`` and a whitespace byte."""
    return (len(data) >= 3 and data[0:1] == b"P" and 49 <= data[1] <= 55
            and data[2] in _SPACE)


class _Reader:
    def __init__(self, data: bytes, pos: int, name: str):
        self.data, self.pos, self.name = data, pos, name

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ImageReadError(f"{self.name}: PNM / PAM truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ImageReadError(f"{self.name}: PNM / PAM truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def number(self, maxdigits: int = 0) -> int:
        """cv2's ReadNumber: skip whitespace and ``#`` comments, read up
        to `maxdigits` digits (0: any number) and the byte after them."""
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:                              # '#'
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ImageReadError(
                    f"{self.name}: PNM with a byte 0x{code:02x} where a "
                    f"number should be")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > 0x7FFFFFFF:
                raise ImageReadError(f"{self.name}: PNM number too large")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            code = self.byte()
            if not 48 <= code <= 57:
                break
        return val


def _ascii_numbers(r: _Reader, n: int, maxdigits: int) -> np.ndarray:
    """The next `n` numbers of an ASCII raster as `n` calls of
    ``r.number(maxdigits)`` read them: in one numpy pass where the rest of
    the file is digits and whitespace only (each number then ends at the
    whitespace after it, which ReadNumber swallows) and no number has more
    than 10 digits, else number by number (comments or other bytes among
    the samples, long runs of leading zeros)."""
    body = r.data[r.pos:]
    if not body.translate(None, b"0123456789" + _SPACE):
        if maxdigits == 1:              # P1: every digit is a sample
            digits = body.translate(None, _SPACE)
            if len(digits) < n:
                raise ImageReadError(f"{r.name}: PNM / PAM truncated")
            return np.frombuffer(digits, np.uint8, n).astype(np.int64) - 48
        b = np.frombuffer(body, np.uint8)
        edge = np.diff((b - np.uint8(48) < 10).view(np.int8), prepend=0,
                       append=0)
        starts = np.flatnonzero(edge == 1)
        lens = np.flatnonzero(edge == -1) - starts
        # the n-th number needs a byte after it, as ReadNumber reads one
        if len(starts) < n or (len(starts) == n and body[-1:].isdigit()):
            raise ImageReadError(f"{r.name}: PNM / PAM truncated")
        starts, lens = starts[:n], lens[:n]
        if lens.max() <= 10:
            vals = np.zeros(n, np.int64)
            for k in range(int(lens.max())):    # digit k of each number
                m = lens > k
                vals[m] = vals[m] * 10 + (b[starts[m] + k] - 48)
            if vals.max() > 0x7FFFFFFF:
                raise ImageReadError(f"{r.name}: PNM number too large")
            return vals
    return np.array([r.number(maxdigits) for _ in range(n)], np.int64)


def decode_pnm_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNM or PAM file as cv2 5.0 reads it (see
    the module docstring)."""
    if not is_pnm(data):
        raise ImageReadError(f"{name}: not a PNM or PAM file")
    if data[1] == 55:
        return _decode_pam(data, name)
    kind = data[1] - 48
    r = _Reader(data, 2, name)
    w, h = r.number(), r.number()
    maxval = 1 if kind in (1, 4) else r.number()
    if w <= 0 or h <= 0 or not 0 < maxval < 65536:
        raise ImageReadError(f"{name}: PNM of {w}x{h}, maxval {maxval} is "
                             f"not read")
    ch = 3 if kind in (3, 6) else 1
    if kind in (1, 4):
        if kind == 1:
            bits = (_ascii_numbers(r, w * h, 1) != 0).astype(
                np.uint8).reshape(h, w)
        else:
            rows = np.frombuffer(r.take(((w + 7) // 8) * h), np.uint8)
            bits = np.unpackbits(rows.reshape(h, -1), axis=1)[:, :w]
        gray = (1 - bits) * np.uint8(255)
        return np.repeat(gray[..., None], 3, 2)
    n = w * h * ch
    if kind in (2, 3):
        vals = np.minimum(_ascii_numbers(r, n, 0), maxval)
        out = (vals >> 8 if maxval > 255 else vals * 255 // maxval)
    else:
        wide = maxval > 255
        raw = r.take(n * (2 if wide else 1))
        out = (np.frombuffer(raw, ">u2") >> 8) if wide else np.frombuffer(
            raw, np.uint8)
    img = out.astype(np.uint8).reshape(h, w, ch)
    return np.repeat(img, 3, 2) if ch == 1 else img


def _pam_line(r: _Reader):
    """One PAM header line as cv2's ReadPAMHeaderLine reads it: (field,
    value), ("#", "") for a comment, ("", "") for an empty line."""
    code = r.byte()
    while code in _SPACE and code not in (10, 13):
        code = r.byte()
    if code == 35:
        while code not in (10, 13):
            code = r.byte()
        return "#", ""
    if code in (10, 13):
        return "", ""
    ident = bytearray()
    while code not in _SPACE:
        ident.append(code)
        code = r.byte()
    if code in (10, 13):
        return ident.decode("latin-1").upper(), ""
    while code in _SPACE:
        code = r.byte()
    value = bytearray()
    while code not in (10, 13):
        value.append(code)
        code = r.byte()
    return ident.decode("latin-1").upper(), value.decode("latin-1")


def _decode_pam(data: bytes, name: str) -> np.ndarray:
    if data[2] not in (10, 13):
        raise ImageReadError(f"{name}: PAM without a line break after P7")
    r = _Reader(data, 3, name)
    fields = {}
    tupltype = None
    while True:
        key, value = _pam_line(r)
        if key in ("", "#"):
            continue
        if key == "ENDHDR":
            break
        if key == "TUPLTYPE":
            if value not in _TUPLTYPES:
                raise ImageReadError(f"{name}: PAM TUPLTYPE {value!r} is "
                                     f"not read")
            tupltype = value
        elif key in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL"):
            if key in fields or not value.strip().isdigit():
                raise ImageReadError(f"{name}: PAM field {key} {value!r}")
            fields[key] = int(value)
        else:
            raise ImageReadError(f"{name}: PAM header field {key!r}")
    if len(fields) != 4:
        raise ImageReadError(f"{name}: PAM header without "
                             f"{sorted({'WIDTH', 'HEIGHT', 'DEPTH', 'MAXVAL'} - set(fields))}")
    w, h, ch, maxval = (fields[k] for k in ("WIDTH", "HEIGHT", "DEPTH",
                                            "MAXVAL"))
    if tupltype is None:
        tupltype = ("BLACKANDWHITE" if ch == 1 and maxval == 1 else
                    "GRAYSCALE" if ch == 1 and maxval < 256 else
                    "RGB" if ch == 3 and maxval < 256 else None)
    if (tupltype is None or _TUPLTYPES[tupltype] != ch or w <= 0 or h <= 0
            or not 0 < maxval < 65536):
        raise ImageReadError(f"{name}: PAM of {w}x{h}, DEPTH {ch}, MAXVAL "
                             f"{maxval}, TUPLTYPE {tupltype} is not read")
    wide = maxval > 255
    raw = r.take(w * h * ch * (2 if wide else 1))
    if maxval == 1:                     # bit mode: each row's bytes as bits
        rows = np.frombuffer(raw, np.uint8).reshape(h, w * ch)
        gray = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        return np.repeat(gray[..., None], 3, 2)
    s = ((np.frombuffer(raw, ">u2") >> 8).astype(np.uint8) if wide
         else np.frombuffer(raw, np.uint8)).reshape(h, w, ch)
    if ch <= 2:
        return np.repeat(s[..., :1], 3, 2)
    if ch == 3:
        return np.ascontiguousarray(s[..., ::-1])
    return np.ascontiguousarray(s[..., :3])
