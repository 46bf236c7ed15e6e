"""JPEG without cv2: the markers parsed here, the scans decoded by the host
C++ of ``csrc/jpeg_decode.cpp`` (built with ``c++`` at first use,
``kernels.build.load_host``), to the bit what cv2.imread(IMREAD_COLOR)
returns through libjpeg-turbo's defaults (ISLOW IDCT, fancy upsampling),
converted to RGB, its EXIF orientation applied.

``parse_jpeg`` reads SOI, APPn (APP1's EXIF Orientation in either byte
order, APP0's JFIF, APP14's Adobe transform), COM, DQT (8- and 16-bit
tables), DHT, DRI, SOF0 / SOF1 (baseline and extended sequential, one scan
of every component) or SOF2 (progressive Huffman, any number of scans,
with the tables and the restart interval in force at each SOS), up to EOI.
Frames of 1 (gray), 3 (YCbCr or RGB) or 4 components (CMYK: no Adobe
marker or transform 0, converted as cv2 converts it) are decoded. Anything
else raises ImageReadError naming the file and the reason: lossless,
hierarchical and arithmetic-coded frames, 12-bit samples, 2 components,
YCCK (Adobe transform 2), a sequential frame of several scans, a
progressive one whose scans leave low coefficients unrefined (libjpeg
smooths such blocks) and a stream cut short. No image is ever
substituted.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..kernels.build import load_host
from .errors import ImageReadError

SOI = b"\xff\xd8"
# the zig-zag index of each row-major coefficient position, inverted:
# a DQT table arrives in zig-zag order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNSUPPORTED = {
    0xC3: "lossless (SOF3)",
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
           4: "a restart marker is missing",
           5: "a scan header does not fit its frame"}
COLOR_GRAY, COLOR_YCC, COLOR_RGB, COLOR_CMYK = 0, 1, 2, 3
# natural-order positions of the DC and the first 9 AC coefficients in
# zig-zag order: libjpeg's block smoothing looks at these (SAVED_COEFS)
_SMOOTHED = _ZIGZAG[:10]


@dataclass
class JpegInfo:
    """What the decode needs of a JPEG's markers: the frame, and for each
    scan its header fields, Huffman tables and entropy-coded bytes."""
    width: int = 0
    height: int = 0
    progressive: bool = False
    comp_ids: List[int] = field(default_factory=list)
    comp_h: List[int] = field(default_factory=list)
    comp_v: List[int] = field(default_factory=list)
    comp_tq: List[int] = field(default_factory=list)
    # the quantisation table each component latched at its first scan
    comp_q: List[Optional[np.ndarray]] = field(default_factory=list)
    # each scan's int32 fields for the C++ (its kScanFields): Ns, then for
    # each of 4 slots the component index, its DC and AC table, then Ss,
    # Se, Ah, Al and the restart interval in force
    fields: List[List[int]] = field(default_factory=list)
    dc_bits: List[np.ndarray] = field(default_factory=list)
    dc_vals: List[np.ndarray] = field(default_factory=list)
    ac_bits: List[np.ndarray] = field(default_factory=list)
    ac_vals: List[np.ndarray] = field(default_factory=list)
    tables: List[int] = field(default_factory=list)
    scans: List[bytes] = field(default_factory=list)
    jfif: bool = False
    adobe_transform: Optional[int] = None
    orientation: int = 1

    @property
    def qtables(self) -> np.ndarray:
        """(components, 64) quantisation values in natural order, the table
        each component latched; zeros for a component no scan holds (its
        coefficients stay 0)."""
        return np.stack([np.zeros(64, np.uint16) if q is None else q
                         for q in self.comp_q])

    @property
    def color(self) -> int:
        """libjpeg's jpeg_color_space of the frame (jdapimin.c): one
        component is gray; of three, JFIF means YCbCr, else an Adobe
        transform 0 means RGB, else the ids 'R' 'G' 'B' do, YCbCr
        otherwise; of four, CMYK without an Adobe marker or with transform
        0, YCCK otherwise."""
        if len(self.comp_ids) == 1:
            return COLOR_GRAY
        if len(self.comp_ids) == 4:
            return (COLOR_CMYK if self.adobe_transform in (None, 0)
                    else -1)
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


def _scan_end(data: bytes, pos: int, name: str) -> int:
    """Where the entropy-coded data that starts at ``pos`` ends: the first
    marker that is not a stuffed 0xFF 0x00 or an RSTn."""
    end, n = pos, len(data)
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= n:
            raise ImageReadError(f"{name}: JPEG truncated: the file ends inside "
                             f"its scan")
        nxt = data[end + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            end += 1 if nxt == 0xFF else 2
            continue
        return end


def _check_scan(info: JpegInfo, ns: int, ss: int, se: int, ah: int,
                al: int, name: str) -> None:
    """libjpeg's checks of a scan header (jdphuff.c start_pass): a DC scan
    has Se 0, an AC scan one component and Ss <= Se <= 63, a refinement
    takes one bit (Al = Ah - 1), Al <= 13. A sequential frame's one scan
    holds every component."""
    if not info.progressive:
        if info.scans:
            raise ImageReadError(f"{name}: JPEG of several sequential scans is "
                             f"not decoded without cv2 (one scan a "
                             f"sequential frame)")
        if ns != len(info.comp_ids):
            raise ImageReadError(f"{name}: JPEG whose sequential scan holds {ns} "
                             f"of {len(info.comp_ids)} components is not "
                             f"decoded without cv2 (one scan a sequential "
                             f"frame)")
        return
    bad = (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
    if bad or (ah != 0 and al != ah - 1) or al > 13:
        raise ImageReadError(f"{name}: progressive JPEG with a bad scan (Ss {ss}, "
                         f"Se {se}, Ah {ah}, Al {al}, {ns} components)")


def _check_smoothing(info: JpegInfo, coef_bits: np.ndarray,
                     name: str) -> None:
    """Raise where libjpeg-turbo would smooth the blocks of a progressive
    frame (jdcoefct.c smoothing_ok): every component's DC at least partly
    known, the quantisers of the DC and the first 9 AC coefficients not 0,
    and one of those 9 AC coefficients of some component not refined to
    its last bit (Al 0) by the last scan."""
    if not info.progressive or (coef_bits[:, 0] < 0).any():
        return
    for q in info.comp_q:
        if q is None or not q[_SMOOTHED].all():
            return
    if (coef_bits[:, 1:10] != 0).any():
        raise ImageReadError(f"{name}: progressive JPEG whose scans leave low "
                         f"coefficients unrefined is not decoded without "
                         f"cv2 (libjpeg smooths its blocks)")


def parse_jpeg(data: bytes, name: str = "<bytes>") -> JpegInfo:
    """The markers of a JPEG up to its EOI (see the module's docstring);
    raises ImageReadError naming ``name`` on anything it does not decode."""
    if data[:2] != SOI:
        raise ImageReadError(f"{name}: not a JPEG file (no SOI marker)")
    info = JpegInfo()
    app1 = None
    pos, n = 2, len(data)
    seen_sof = False
    qtables = np.zeros((4, 64), np.uint16)
    dc_bits, ac_bits = (np.zeros((4, 17), np.uint8) for _ in range(2))
    dc_vals, ac_vals = (np.zeros((4, 256), np.uint8) for _ in range(2))
    present = restart_interval = 0
    coef_bits = None
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1                     # garbage between segments
        while pos < n and data[pos] == 0xFF:
            pos += 1                     # fill bytes
        if pos >= n:
            raise ImageReadError(f"{name}: JPEG truncated: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                     # stray RSTn / TEM: no length
        if pos + 2 > n:
            raise ImageReadError(f"{name}: JPEG truncated in a marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if length < 2 or pos + length > n:
            raise ImageReadError(f"{name}: JPEG truncated in a marker segment "
                             f"0xFF{marker:02X}")
        pos += length
        if marker in _UNSUPPORTED:
            raise ImageReadError(f"{name}: {_UNSUPPORTED[marker]} JPEG is not "
                             f"decoded without cv2 (baseline, extended "
                             f"sequential and progressive Huffman only)")
        if marker in (0xC0, 0xC1, 0xC2):
            if seen_sof:
                raise ImageReadError(f"{name}: JPEG with two frames")
            seen_sof = True
            info.progressive = marker == 0xC2
            if len(body) < 6 or len(body) < 6 + 3 * body[5]:
                raise ImageReadError(f"{name}: JPEG with a short frame header")
            precision, h, w, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ImageReadError(f"{name}: {precision}-bit JPEG is not "
                                 f"decoded without cv2 (8-bit only)")
            if nf not in (1, 3, 4):
                raise ImageReadError(f"{name}: {nf}-component JPEG is not "
                                 f"decoded without cv2 (1, 3 or 4 only)")
            if h == 0 or w == 0:
                raise ImageReadError(f"{name}: JPEG of size {w}x{h}")
            info.width, info.height = w, h
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                info.comp_ids.append(cid)
                info.comp_h.append(hv >> 4)
                info.comp_v.append(hv & 15)
                info.comp_tq.append(tq & 3)
            info.comp_q = [None] * nf
            coef_bits = np.full((nf, 64), -1, np.int32)
        elif marker == 0xC4:
            at = 0
            while at < len(body):
                tc, th = body[at] >> 4, body[at] & 3
                counts = np.frombuffer(body[at + 1:at + 17], np.uint8)
                total = int(counts.sum())
                vals = np.frombuffer(body[at + 17:at + 17 + total], np.uint8)
                if len(counts) < 16 or len(vals) < total or total > 256:
                    raise ImageReadError(f"{name}: JPEG with a bad DHT segment")
                bits, syms = (ac_bits, ac_vals) if tc else (dc_bits, dc_vals)
                bits[th, 1:] = counts
                syms[th] = 0
                syms[th, :total] = vals
                present |= 1 << (th + (4 if tc else 0))
                at += 17 + total
        elif marker == 0xDB:
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 3
                size = 128 if pq else 64
                raw = body[at + 1:at + 1 + size]
                if len(raw) < size:
                    raise ImageReadError(f"{name}: JPEG with a bad DQT segment")
                q = np.frombuffer(raw, ">u2" if pq else np.uint8)
                qtables[tq, _ZIGZAG] = q
                at += 1 + size
        elif marker == 0xDD:
            if len(body) < 2:
                raise ImageReadError(f"{name}: JPEG with a short DRI segment")
            (restart_interval,) = struct.unpack(">H", body[:2])
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
                raise ImageReadError(f"{name}: JPEG scan before its frame")
            ns = body[0] if body else 0
            if len(body) < 4 + 2 * ns or not 1 <= ns <= 4:
                raise ImageReadError(f"{name}: JPEG with a short scan header")
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahl >> 4, ahl & 15
            _check_scan(info, ns, ss, se, ah, al, name)
            fields = [ns] + [0] * 12 + [ss, se, ah, al, restart_interval]
            for i in range(ns):
                cs, t = body[1 + 2 * i:3 + 2 * i]
                if cs not in info.comp_ids:
                    raise ImageReadError(f"{name}: JPEG scan of an unknown "
                                     f"component {cs}")
                c = info.comp_ids.index(cs)
                fields[1 + 3 * i:4 + 3 * i] = [c, t >> 4 & 3, t & 3]
                if info.comp_q[c] is None:       # latch_quant_tables
                    info.comp_q[c] = qtables[info.comp_tq[c]].copy()
                if info.progressive:
                    coef_bits[c, ss:se + 1] = al
            end = _scan_end(data, pos, name)
            info.fields.append(fields)
            info.dc_bits.append(dc_bits.copy())
            info.dc_vals.append(dc_vals.copy())
            info.ac_bits.append(ac_bits.copy())
            info.ac_vals.append(ac_vals.copy())
            info.tables.append(present)
            info.scans.append(data[pos:end])
            pos = end
    if not info.scans:
        raise ImageReadError(f"{name}: JPEG without a scan")
    if info.color < 0:
        raise ImageReadError(f"{name}: YCCK JPEG (Adobe transform "
                         f"{info.adobe_transform}) is not decoded without "
                         f"cv2 (gray, YCbCr, RGB and CMYK only)")
    _check_smoothing(info, coef_bits, name)
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
    """(H, W, 3) uint8 RGB of a JPEG, equal to
    cv2.cvtColor(cv2.imread(path, IMREAD_COLOR), COLOR_BGR2RGB): grayscale
    repeated to three channels, the EXIF orientation applied. Raises
    ImageReadError naming ``name`` on what it does not decode (see the
    module's docstring)."""
    info = parse_jpeg(data, name)
    lib = load_host("jpeg_decode")
    out = np.empty((info.height, info.width, 3), np.uint8)
    comp_h, comp_v = (np.asarray(v, np.int32)
                      for v in (info.comp_h, info.comp_v))
    offsets = np.cumsum([0] + [len(s) for s in info.scans]).astype(np.int64)
    scans = np.frombuffer(b"".join(info.scans), np.uint8)
    fields = np.asarray(info.fields, np.int32)
    dc_bits, dc_vals, ac_bits, ac_vals = (
        np.ascontiguousarray(np.stack(v)) for v in (
            info.dc_bits, info.dc_vals, info.ac_bits, info.ac_vals))
    tables = np.asarray(info.tables, np.int32)
    qtables = info.qtables
    status = lib.ys_jpeg_decode(
        info.width, info.height, len(info.comp_ids), _ptr(comp_h),
        _ptr(comp_v), int(info.progressive), len(info.scans), _ptr(scans),
        _ptr(offsets), _ptr(fields), _ptr(dc_bits), _ptr(dc_vals),
        _ptr(ac_bits), _ptr(ac_vals), _ptr(tables), _ptr(qtables),
        info.color, _ptr(out))
    if status:
        raise ImageReadError(f"{name}: JPEG not decoded: "
                         f"{_ERRORS.get(status, f'error {status}')}")
    return apply_orientation(out, info.orientation)
