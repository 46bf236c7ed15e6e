"""JPEG 2000 without cv2, to the bit what cv2.imread(IMREAD_COLOR) returns
through OpenJPEG 2.5, converted to RGB.

The codestream is decoded by the host C++ of ``csrc/jp2_decode.cpp``
(built with ``c++`` at first use, ``kernels.build.load_host``): the
markers, the packets of every progression order, EBCOT tier 1 with every
code-block style, the inverse 5/3 and 9/7 DWT, the inverse RCT / ICT and
the DC level shift, as OpenJPEG decodes them. Here: the JP2 boxes
(``jP  ``, ``ftyp``, ``jp2h`` with ``ihdr``, ``colr``, ``pclr``, ``cmap``
and ``cdef``, ``jp2c``; a raw J2K codestream reads too), OpenJPEG's
palette and channel-definition steps, and cv2's mapping of the components
to 8-bit BGR (grfmt_jpeg2000_openjpeg.cpp):

- 1 to 4 components, none signed, the widest of at least 8 bits, else
  cv2 refuses the header;
- every component shifted right by (widest precision - 8) and cast to 8
  bits;
- the colour space from the ``colr`` box: sRGB, and anything cv2 does not
  name (an ICC profile, no ``colr`` box, a raw codestream), takes
  components 2, 1, 0 as B, G, R and refuses 1 or 2 components; greyscale
  repeats component 0; sYCC takes components 0, 1, 2 as Y, U, V through
  cv2's 8-bit YUV -> BGR (14-bit fixed point); CMYK and e-YCC are
  refused;
- an image offset from the origin is refused before the codestream is
  decoded, a subsampled component after it.

What cv2.imread returns None for raises ImageReadError naming the file, as
do the parts no decoder here takes: packed packet headers (PPM / PPT),
HTJ2K code-blocks and palette entries wider than 32 bits (OpenJPEG reads
those past its 32-bit value).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Tuple

import numpy as np

from ..kernels.build import load_host
from .errors import ImageReadError, check_size

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
_MAX_COMPONENTS = 16                     # csrc/jp2_decode.cpp's kMaxComps
_STATUS = {1: "the codestream is corrupt or cut short",
           2: "it uses packed packet headers (PPM / PPT) or HTJ2K, which "
              "are not decoded without cv2",
           3: "its components do not fit the image's buffer"}
_SRGB, _GRAY, _SYCC = 16, 17, 18
_REFUSED_SPACES = {12: "CMYK", 24: "e-YCC"}
# cv2's COLOR_YUV2BGR for 8 bits: B = Y + 2.032 U, G = Y - 0.395 U -
# 0.581 V, R = Y + 1.140 V, in 14-bit fixed point
_YUV_SHIFT = 14
_YUV_B_U, _YUV_G_U, _YUV_G_V, _YUV_R_V = 33292, -6472, -9519, 18678


def is_jpeg2000(data: bytes) -> bool:
    """cv2's signatures: the JP2 signature box, or a codestream's SOC and
    SIZ markers."""
    return data[:12] == JP2_SIGNATURE or data[:4] == J2K_SIGNATURE


def _boxes(data: bytes, start: int, end: int, name: str
           ) -> List[Tuple[bytes, int, int]]:
    """(type, body start, body end) of each box in data[start:end]."""
    out, pos = [], start
    while pos + 8 <= end:
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if length == 1:
            if pos + 16 > end:
                break
            (length,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            if kind == b"jp2c":          # a codestream cut short
                out.append((kind, pos + head, end))
                break
            raise ImageReadError(f"{name}: JP2 box {kind!r} is cut short")
        out.append((kind, pos + head, pos + length))
        pos += length
    return out


def _parse_jp2(data: bytes, name: str) -> Dict:
    """The codestream and the header boxes OpenJPEG applies."""
    info: Dict = {"enumcs": None, "pclr": None, "cmap": None, "cdef": None}
    boxes = _boxes(data, 0, len(data), name)
    if len(boxes) < 2 or boxes[1][0] != b"ftyp":
        raise ImageReadError(f"{name}: JP2 without its ftyp box")
    header = [b for b in boxes if b[0] == b"jp2h"]
    stream = [b for b in boxes if b[0] == b"jp2c"]
    if not header or not stream:
        raise ImageReadError(f"{name}: JP2 without a jp2h or jp2c box")
    _, at, end = stream[0]
    info["codestream"] = data[at:end]
    colr_seen = False
    for kind, at, end in _boxes(data, header[0][1], header[0][2], name):
        body = data[at:end]
        if kind == b"colr" and not colr_seen:
            colr_seen = True              # OpenJPEG keeps the first
            if len(body) < 3:
                raise ImageReadError(f"{name}: JP2 colr box is cut short")
            if body[0] == 1:
                if len(body) < 7:
                    raise ImageReadError(f"{name}: JP2 colr box is cut "
                                         f"short")
                (info["enumcs"],) = struct.unpack(">I", body[3:7])
        elif kind == b"pclr":
            info["pclr"] = _parse_pclr(body, name)
        elif kind == b"cmap":
            if len(body) % 4:
                raise ImageReadError(f"{name}: JP2 cmap box is corrupt")
            info["cmap"] = [struct.unpack(">HBB", body[i:i + 4])
                            for i in range(0, len(body), 4)]
        elif kind == b"cdef":
            (n,) = struct.unpack(">H", body[:2])
            if len(body) < 2 + 6 * n or n == 0:
                raise ImageReadError(f"{name}: JP2 cdef box is corrupt")
            info["cdef"] = [list(struct.unpack(">HHH", body[2 + 6 * i:
                                                          8 + 6 * i]))
                            for i in range(n)]
    return info


def _parse_pclr(body: bytes, name: str) -> Tuple[np.ndarray, List[int],
                                                  List[int]]:
    """(entries (n, channels) int64, bit depth, signedness) of a pclr box."""
    if len(body) < 3:
        raise ImageReadError(f"{name}: JP2 pclr box is cut short")
    n, channels = struct.unpack(">HB", body[:3])
    if n == 0 or n > 1024 or channels == 0 or len(body) < 3 + channels:
        raise ImageReadError(f"{name}: JP2 pclr box is corrupt")
    sizes = [(b & 0x7F) + 1 for b in body[3:3 + channels]]
    signs = [b >> 7 for b in body[3:3 + channels]]
    if max(sizes) > 32:
        raise ImageReadError(f"{name}: JP2 palette of {max(sizes)}-bit "
                             f"entries is not decoded without cv2 (32 "
                             f"bits at most)")
    entries = np.zeros((n, channels), np.int64)
    pos = 3 + channels
    for i in range(n):
        for c in range(channels):
            size = (sizes[c] + 7) // 8
            if pos + size > len(body):
                raise ImageReadError(f"{name}: JP2 pclr box is cut short")
            entries[i, c] = int.from_bytes(body[pos:pos + size], "big")
            pos += size
    return entries, sizes, signs


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _decode_codestream(stream: bytes, name: str
                       ) -> Tuple[Tuple[int, int, int, int], List[Dict]]:
    """The image box (x0, y0, x1, y1) and each component's dx, dy,
    precision, signedness, size and origin, from the codestream's SIZ."""
    lib = load_host("jp2_decode")
    buf = np.frombuffer(stream, np.uint8)
    hdr = np.zeros(5 + 4 * _MAX_COMPONENTS, np.int64)
    status = lib.ys_j2k_header(_ptr(buf), ctypes.c_int64(buf.size), _ptr(hdr))
    if status:
        raise ImageReadError(f"{name}: JPEG 2000 not decoded: "
                             f"{_STATUS[status]}")
    x0, y0, x1, y1, n = (int(v) for v in hdr[:5])
    comps = []
    for c in range(n):
        dx, dy, prec, sgnd = (int(v) for v in hdr[5 + 4 * c:9 + 4 * c])
        w = -(-x1 // dx) - -(-x0 // dx)
        h = -(-y1 // dy) - -(-y0 // dy)
        comps.append(dict(dx=dx, dy=dy, prec=prec, sgnd=sgnd, w=w, h=h,
                          x0=-(-x0 // dx), y0=-(-y0 // dy), alpha=0))
    return (x0, y0, x1, y1), comps


def _samples(stream: bytes, comps: List[Dict], name: str) -> None:
    """Each component's decoded samples, as ``data``."""
    lib = load_host("jp2_decode")
    buf = np.frombuffer(stream, np.uint8)
    out = np.empty(sum(c["w"] * c["h"] for c in comps), np.int32)
    status = lib.ys_j2k_decode(_ptr(buf), ctypes.c_int64(buf.size), _ptr(out),
                               ctypes.c_int64(out.size))
    if status:
        raise ImageReadError(f"{name}: JPEG 2000 not decoded: "
                             f"{_STATUS[status]}")
    at = 0
    for c in comps:
        c["data"] = out[at:at + c["w"] * c["h"]].reshape(c["h"], c["w"])
        at += c["w"] * c["h"]


def _apply_pclr(comps: List[Dict], pclr, cmap, name: str) -> List[Dict]:
    """OpenJPEG's opj_jp2_apply_pclr: each cmap channel a component as it
    is (type 0) or a palette column of its indices, clamped to the
    palette."""
    entries, sizes, signs = pclr
    if len(cmap) != entries.shape[1]:
        raise ImageReadError(f"{name}: JP2 cmap and pclr boxes disagree")
    out = []
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        if cmp >= len(comps) or (mtyp == 1 and pcol >= entries.shape[1]):
            raise ImageReadError(f"{name}: JP2 cmap box names a missing "
                                 f"component or palette column")
        src = comps[cmp]
        new = dict(src, prec=sizes[i], sgnd=signs[i])
        if mtyp == 0:
            new["data"] = src["data"].copy()
        else:
            k = np.clip(src["data"], 0, entries.shape[0] - 1)
            new["data"] = entries[k, pcol].astype(np.int32)
        out.append(new)
    return out


def _apply_cdef(comps: List[Dict], cdef: List[List[int]]) -> None:
    """OpenJPEG's opj_jp2_apply_cdef: a colour channel associated with
    another position swaps into it; the type marks alpha."""
    for i, (cn, typ, asoc) in enumerate(cdef):
        if cn >= len(comps):
            continue
        if asoc in (0, 65535):
            comps[cn]["alpha"] = typ
            continue
        acn = asoc - 1
        if acn >= len(comps):
            continue
        if cn != acn and typ == 0:
            comps[cn], comps[acn] = comps[acn], comps[cn]
            for later in cdef[i + 1:]:
                if later[0] == cn:
                    later[0] = acn
                elif later[0] == acn:
                    later[0] = cn
        comps[cn]["alpha"] = typ


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(COLOR_YUV2BGR) of 8-bit Y, U, V planes."""
    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    u, v = u - 128, v - 128
    half = 1 << (_YUV_SHIFT - 1)
    b = y + ((u * _YUV_B_U + half) >> _YUV_SHIFT)
    g = y + ((u * _YUV_G_U + v * _YUV_G_V + half) >> _YUV_SHIFT)
    r = y + ((v * _YUV_R_V + half) >> _YUV_SHIFT)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def decode_jp2_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JP2 file or a raw J2K codestream as
    cv2.imread(IMREAD_COLOR) 5.0 returns it (see the module docstring)."""
    if data[:12] == JP2_SIGNATURE:
        info = _parse_jp2(data, name)
    elif data[:4] == J2K_SIGNATURE:
        info = {"codestream": data, "enumcs": None, "pclr": None,
                "cmap": None, "cdef": None}
    else:
        raise ImageReadError(f"{name}: not a JPEG 2000 file")
    stream = info["codestream"]
    (x0, y0, x1, y1), comps = _decode_codestream(stream, name)
    # every component of an offset image starts past its origin, which
    # cv2's readData refuses; refused here before anything is allocated
    if x0 or y0:
        raise ImageReadError(f"{name}: JPEG 2000 with an image offset "
                             f"(cv2 refuses it)")
    check_size(x1, y1, name)
    # cv2's readHeader, on the codestream's components
    if not 1 <= len(comps) <= 4:
        raise ImageReadError(f"{name}: JPEG 2000 of {len(comps)} components "
                             f"(cv2 reads 1 to 4)")
    if any(c["sgnd"] for c in comps):
        raise ImageReadError(f"{name}: JPEG 2000 with a signed component "
                             f"(cv2 refuses it)")
    max_prec = max(c["prec"] for c in comps)
    if max_prec < 8:
        raise ImageReadError(f"{name}: JPEG 2000 of {max_prec}-bit samples "
                             f"(cv2 reads 8 bits and more)")
    enumcs = info["enumcs"]
    if enumcs in _REFUSED_SPACES:
        raise ImageReadError(f"{name}: JPEG 2000 in the "
                             f"{_REFUSED_SPACES[enumcs]} colour space (cv2 "
                             f"refuses it)")
    _samples(stream, comps, name)
    # OpenJPEG's opj_jp2_decode: the palette, then the channel definitions
    if info["pclr"] is not None and info["cmap"] is not None:
        comps = _apply_pclr(comps, info["pclr"], info["cmap"], name)
    if info["cdef"] is not None:
        _apply_cdef(comps, [list(e) for e in info["cdef"]])
    # cv2's readData
    h, w = y1 - y0, x1 - x0
    for c in comps:
        if (c["dx"], c["dy"], c["x0"], c["y0"], c["w"], c["h"]) != \
                (1, 1, 0, 0, w, h):
            raise ImageReadError(f"{name}: JPEG 2000 with a subsampled "
                                 f"component (cv2 refuses it)")
    shift = max(0, max_prec - 8)

    def plane(i):
        return (comps[i]["data"] >> shift).astype(np.uint8)

    if enumcs == _GRAY:
        gray = plane(0)
        return np.stack([gray] * 3, -1)
    if len(comps) < 3:
        raise ImageReadError(f"{name}: JPEG 2000 of {len(comps)} components "
                             f"in an RGB or YUV colour space (cv2 refuses "
                             f"it)")
    if enumcs == _SYCC:
        return np.ascontiguousarray(
            yuv_to_bgr(plane(0), plane(1), plane(2))[..., ::-1])
    return np.stack([plane(0), plane(1), plane(2)], -1)
