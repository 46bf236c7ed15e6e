"""Baseline JPEG without cv2: the markers parsed here, the scan decoded by
the host C++ of ``csrc/jpeg_decode.cpp`` (built with ``c++`` at first use,
``kernels.build.load_host``), to the bit what cv2.imread(IMREAD_COLOR)
returns through libjpeg-turbo's defaults (ISLOW IDCT, fancy upsampling),
converted to RGB, its EXIF orientation applied.

``parse_jpeg`` reads SOI, APPn (APP1's EXIF Orientation in either byte
order, APP0's JFIF, APP14's Adobe transform), COM, DQT (8- and 16-bit
tables), DHT, DRI, SOF0 / SOF1 and the one SOS, up to EOI. Anything this
module does not decode raises ValueError naming the file and the reason:
progressive (SOF2), lossless, hierarchical and arithmetic-coded frames,
12-bit samples, 2 or 4 components (CMYK / YCCK), a frame of several scans
and a stream cut short. No image is ever substituted.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..kernels.build import load_host

SOI = b"\xff\xd8"
# the zig-zag index of each row-major coefficient position, inverted:
# a DQT table arrives in zig-zag order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNSUPPORTED = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded progressive "
    "(SOF10)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCC: "arithmetic-coded (DAC)", 0xCD: "arithmetic-coded hierarchical "
    "(SOF13)", 0xCE: "arithmetic-coded hierarchical (SOF14)",
    0xCF: "arithmetic-coded hierarchical (SOF15)",
    0xDC: "a DNL marker"}
_ERRORS = {1: "the stream is truncated (its data ends before the last "
              "block)", 2: "a Huffman code or table is invalid",
           3: "its sampling factors are not decodable",
           4: "a restart marker is missing"}
COLOR_GRAY, COLOR_YCC, COLOR_RGB = 0, 1, 2


@dataclass
class JpegInfo:
    """What the decode needs of a baseline JPEG's markers."""
    width: int = 0
    height: int = 0
    comp_ids: List[int] = field(default_factory=list)
    comp_h: List[int] = field(default_factory=list)
    comp_v: List[int] = field(default_factory=list)
    comp_tq: List[int] = field(default_factory=list)
    scan_comp: List[int] = field(default_factory=list)
    scan_td: List[int] = field(default_factory=list)
    scan_ta: List[int] = field(default_factory=list)
    qtables: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 64), np.uint16))
    dc_bits: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 17), np.uint8))
    dc_vals: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 256), np.uint8))
    ac_bits: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 17), np.uint8))
    ac_vals: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 256), np.uint8))
    table_present: int = 0
    restart_interval: int = 0
    jfif: bool = False
    adobe_transform: Optional[int] = None
    orientation: int = 1
    scan: bytes = b""

    @property
    def color(self) -> int:
        """libjpeg's jpeg_color_space of the frame (jdapimin.c): JFIF means
        YCbCr, else an Adobe transform 0 means RGB, else the ids 'R' 'G'
        'B' do; YCbCr otherwise."""
        if len(self.comp_ids) == 1:
            return COLOR_GRAY
        if self.jfif:
            return COLOR_YCC
        if self.adobe_transform is not None:
            return COLOR_RGB if self.adobe_transform == 0 else COLOR_YCC
        return COLOR_RGB if self.comp_ids == [82, 71, 66] else COLOR_YCC


def exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 of EXIF data (a TIFF header and
    its IFDs), read as OpenCV's ExifReader reads it: little- ("II") or
    big-endian ("MM"); 1 where there is none, it is not 1-8 or the data is
    not TIFF."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(end + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, _, _ = struct.unpack(end + "HHI", tiff[at:at + 8])
        if tag == 0x0112:
            (value,) = struct.unpack(end + "H", tiff[at + 8:at + 10])
            return value if 1 <= value <= 8 else 1
    return 1


def parse_jpeg(data: bytes, name: str = "<bytes>") -> JpegInfo:
    """The markers of a baseline JPEG up to its EOI (see the module's
    docstring); raises ValueError naming ``name`` on anything else."""
    if data[:2] != SOI:
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    info = JpegInfo()
    app1 = None
    pos, n = 2, len(data)
    seen_sof = False
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1                     # garbage between segments
        while pos < n and data[pos] == 0xFF:
            pos += 1                     # fill bytes
        if pos >= n:
            raise ValueError(f"{name}: JPEG truncated: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                     # stray RSTn / TEM: no length
        if pos + 2 > n:
            raise ValueError(f"{name}: JPEG truncated in a marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if length < 2 or pos + length > n:
            raise ValueError(f"{name}: JPEG truncated in a marker segment "
                             f"0xFF{marker:02X}")
        pos += length
        if marker in _UNSUPPORTED:
            raise ValueError(f"{name}: {_UNSUPPORTED[marker]} JPEG is not "
                             f"decoded without cv2 (baseline only)")
        if marker in (0xC0, 0xC1):
            if seen_sof:
                raise ValueError(f"{name}: JPEG with two frames")
            seen_sof = True
            if len(body) < 6 or len(body) < 6 + 3 * body[5]:
                raise ValueError(f"{name}: JPEG with a short frame header")
            precision, h, w, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit JPEG is not "
                                 f"decoded without cv2 (8-bit only)")
            if nf not in (1, 3):
                kind = "CMYK / YCCK" if nf == 4 else f"{nf}-component"
                raise ValueError(f"{name}: {kind} JPEG is not decoded "
                                 f"without cv2 (gray and 3-component only)")
            if h == 0 or w == 0:
                raise ValueError(f"{name}: JPEG of size {w}x{h}")
            info.width, info.height = w, h
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                info.comp_ids.append(cid)
                info.comp_h.append(hv >> 4)
                info.comp_v.append(hv & 15)
                info.comp_tq.append(tq & 3)
        elif marker == 0xC4:
            at = 0
            while at < len(body):
                tc, th = body[at] >> 4, body[at] & 3
                counts = np.frombuffer(body[at + 1:at + 17], np.uint8)
                total = int(counts.sum())
                vals = np.frombuffer(body[at + 17:at + 17 + total], np.uint8)
                if len(counts) < 16 or len(vals) < total or total > 256:
                    raise ValueError(f"{name}: JPEG with a bad DHT segment")
                bits, syms = ((info.ac_bits, info.ac_vals) if tc
                              else (info.dc_bits, info.dc_vals))
                bits[th, 1:] = counts
                syms[th] = 0
                syms[th, :total] = vals
                info.table_present |= 1 << (th + (4 if tc else 0))
                at += 17 + total
        elif marker == 0xDB:
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 3
                size = 128 if pq else 64
                raw = body[at + 1:at + 1 + size]
                if len(raw) < size:
                    raise ValueError(f"{name}: JPEG with a bad DQT segment")
                q = np.frombuffer(raw, ">u2" if pq else np.uint8)
                info.qtables[tq, _ZIGZAG] = q
                at += 1 + size
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError(f"{name}: JPEG with a short DRI segment")
            (info.restart_interval,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0:
            info.jfif = info.jfif or body[:5] == b"JFIF\0"
        elif marker == 0xE1:
            if app1 is None and body[:6] == b"Exif\0\0":
                app1 = body
        elif marker == 0xEE:
            if body[:5] == b"Adobe" and len(body) >= 12:
                info.adobe_transform = body[11]
        elif marker == 0xDA:
            if not seen_sof:
                raise ValueError(f"{name}: JPEG scan before its frame")
            if info.scan:
                raise ValueError(f"{name}: JPEG of several scans is not "
                                 f"decoded without cv2 (one scan only)")
            ns = body[0] if body else 0
            if len(body) < 1 + 2 * ns:
                raise ValueError(f"{name}: JPEG with a short scan header")
            for i in range(ns):
                cs, t = body[1 + 2 * i:3 + 2 * i]
                if cs not in info.comp_ids:
                    raise ValueError(f"{name}: JPEG scan of an unknown "
                                     f"component {cs}")
                info.scan_comp.append(info.comp_ids.index(cs))
                info.scan_td.append(t >> 4 & 3)
                info.scan_ta.append(t & 3)
            if ns != len(info.comp_ids):
                raise ValueError(f"{name}: JPEG whose scan holds {ns} of "
                                 f"{len(info.comp_ids)} components is not "
                                 f"decoded without cv2 (one scan only)")
            # the entropy-coded data: up to the first marker that is not
            # a stuffed 0xFF 0x00 or an RSTn
            end = pos
            while True:
                end = data.find(b"\xff", end)
                if end < 0 or end + 1 >= n:
                    raise ValueError(f"{name}: JPEG truncated: the file "
                                     f"ends inside its scan")
                nxt = data[end + 1]
                if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
                    end += 1 if nxt == 0xFF else 2
                    continue
                break
            info.scan = data[pos:end]
            pos = end
    if not info.scan:
        raise ValueError(f"{name}: JPEG without a scan")
    if app1 is not None:
        info.orientation = exif_orientation(app1[6:])   # the first EXIF
    return info


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation (1-8) applied as OpenCV's ExifTransform applies
    it: 2 flips left-right, 3 turns 180, 4 flips up-down, 5 transposes,
    6 transposes and flips left-right (90 clockwise), 7 transposes and
    turns 180, 8 transposes and flips up-down (90 anticlockwise)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def decode_jpeg_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a baseline JPEG, equal to
    cv2.cvtColor(cv2.imread(path, IMREAD_COLOR), COLOR_BGR2RGB): grayscale
    repeated to three channels, the EXIF orientation applied. Raises
    ValueError naming ``name`` on what it does not decode (see the
    module's docstring)."""
    info = parse_jpeg(data, name)
    lib = load_host("jpeg_decode")
    out = np.empty((info.height, info.width, 3), np.uint8)
    i32 = [np.asarray(v, np.int32) for v in (
        info.comp_h, info.comp_v, info.comp_tq, info.scan_comp,
        info.scan_td, info.scan_ta)]
    scan = np.frombuffer(info.scan, np.uint8)
    status = lib.ys_jpeg_decode(
        _ptr(scan), ctypes.c_int64(len(scan)), info.width, info.height,
        len(info.comp_ids), _ptr(i32[0]), _ptr(i32[1]), _ptr(i32[2]),
        len(info.scan_comp), _ptr(i32[3]), _ptr(i32[4]), _ptr(i32[5]),
        _ptr(info.qtables), _ptr(info.dc_bits), _ptr(info.dc_vals),
        _ptr(info.ac_bits), _ptr(info.ac_vals), info.table_present,
        info.restart_interval, info.color, _ptr(out))
    if status:
        raise ValueError(f"{name}: JPEG not decoded: "
                         f"{_ERRORS.get(status, f'error {status}')}")
    return apply_orientation(out, info.orientation)
