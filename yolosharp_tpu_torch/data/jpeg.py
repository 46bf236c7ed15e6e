"""JPEG without cv2: the markers parsed here, the scans decoded by the host
C++ of ``csrc/jpeg_decode.cpp`` (built with ``c++`` at first use,
``kernels.build.load_host``), to the bit what cv2.imread(IMREAD_COLOR)
returns through libjpeg-turbo's defaults (ISLOW IDCT, fancy upsampling),
converted to RGB, its EXIF orientation applied.

``parse_jpeg`` reads SOI, APPn (APP1's EXIF Orientation in either byte
order, APP0's JFIF, APP14's Adobe transform), COM, DQT (8- and 16-bit
tables), DHT, DAC, DRI, SOF0 / SOF1 (baseline and extended sequential:
one scan of every component, or scans of some components each), SOF2
(progressive), SOF9 (arithmetic-coded sequential) or SOF10
(arithmetic-coded progressive), with the tables, conditioning and restart
interval in force at each SOS, as libjpeg reads them: past the end of the
file fake EOIs, so a stream cut inside a scan decodes; a sequential
Huffman frame decodes with the standard tables (ITU T.81 K.3) in the DC
and AC slots 0 and 1 no DHT defines, as jdhuff.c's std_huff_tables fills
them (a motion-JPEG frame carries none; a progressive frame gets no such
tables and is refused, as by cv2). The scans are
decoded as libjpeg-turbo 3.1 decodes them: the MCUs past the data a scan
holds keep their coefficients (zero, or an earlier scan's), restart
markers misnumbered or missing are resynchronised (jdmarker.c), a bad
Huffman or arithmetic code is recovered from as jdhuff.c / jdarith.c do,
and a progressive frame whose scans leave low coefficients inexact has its
blocks smoothed (jdcoefct.c). Frames of 1 (gray), 3 (YCbCr or RGB) or 4
components (CMYK: no Adobe marker or transform 0; YCCK: transform 2;
converted to BGR as cv2 converts CMYK) are decoded. What cv2.imread
returns None for raises ImageReadError naming the file and the reason: a
file cut before its first scan, lossless (SOF3; cv2 reads it only as
gray), hierarchical frames, 12-bit samples, 2 components, a bad
progression, an unknown marker. No image is ever substituted.
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
    0xC7: "hierarchical lossless (SOF7)", 0xC8: "JPG extension (0xFFC8)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical (SOF14)",
    0xCF: "arithmetic-coded hierarchical (SOF15)",
    0xDC: "a DNL marker"}
# SOFn -> (progressive, arithmetic-coded)
_FRAMES = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False),
           0xC9: (False, True), 0xCA: (True, True)}
_ERRORS = {2: "a Huffman table is invalid",
           3: "its sampling factors are not decodable",
           5: "a scan header does not fit its frame",
           6: "a scan ends at an unknown marker"}
COLOR_GRAY, COLOR_YCC, COLOR_RGB, COLOR_CMYK, COLOR_YCCK = 0, 1, 2, 3, 4
# natural-order positions of the DC and the first 9 AC coefficients in
# zig-zag order: libjpeg's block smoothing looks at these (SAVED_COEFS)
_SMOOTHED = _ZIGZAG[:10]
# the DHT body of ITU T.81 Annex K.3's tables: DC and AC luminance in slot
# 0, chrominance in slot 1 (libjpeg's jstdhuff.c)
_STD_DHT = bytes.fromhex(
    "00" "00010501010101010100000000000000" "000102030405060708090a0b"
    "10" "0002010303020403050504040000017d"
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272"
    "82090a161718191a25262728292a3435363738393a434445464748494a53545556575859"
    "5a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3"
    "a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
    "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"
    "01" "00030101010101010101010000000000" "000102030405060708090a0b"
    "11" "00020102040403040705040400010277"
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d1"
    "0a162434e125f11718191a262728292a35363738393a434445464748494a535455565758"
    "595a636465666768696a737475767778797a82838485868788898a92939495969798999a"
    "a2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
    "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
# what jdatasrc.c hands the decoder once a file ends: a fake EOI, again and
# again
_EOI = b"\xff\xd9"


class _Refused(Exception):
    """What _parse refuses, and where in the (padded) data."""

    def __init__(self, pos: int, reason: str):
        super().__init__(reason)
        self.pos, self.reason = pos, reason


@dataclass
class JpegInfo:
    """What the decode needs of a JPEG's markers: the frame, and for each
    scan its header fields, Huffman tables and entropy-coded bytes."""
    width: int = 0
    height: int = 0
    progressive: bool = False
    arithmetic: bool = False
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
    # where libjpeg smooths the blocks (progressive only): of each component
    # its coef_bits_latch (the Al of the last scan of each of the first 10
    # coefficients, -1 for none), then the latch of the bits before its last
    # scan
    coef_bits: Optional[np.ndarray] = None

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
                    else COLOR_YCCK)
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


def _scan_end(data: bytes, pos: int) -> int:
    """Where the entropy-coded data that starts at ``pos`` ends: at the
    first marker that is not a stuffed 0xFF 0x00, an RSTn or one below 0xC0
    (those the entropy decoder meets and resyncs past). The data is padded
    with fake EOIs, so there is one."""
    end = pos
    while True:
        end = data.find(b"\xff", end)
        nxt = data[end + 1]
        if nxt == 0xFF:
            end += 1
        elif nxt < 0xC0 or 0xD0 <= nxt <= 0xD7:
            end += 2
        else:
            return end


def _check_scan(info: JpegInfo, ns: int, ss: int, se: int, ah: int,
                al: int, pos: int) -> None:
    """libjpeg's checks of a progressive scan header (jdphuff.c /
    jdarith.c start_pass): a DC scan has Se 0, an AC scan one component
    and Ss <= Se <= 63, a refinement takes one bit (Al = Ah - 1), Al <= 13.
    A sequential scan's Ss, Se, Ah and Al are not checked (a warning)."""
    bad = (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
    if info.progressive and (bad or (ah != 0 and al != ah - 1) or al > 13):
        kind = "arithmetic-coded " if info.arithmetic else ""
        raise _Refused(pos, f"{kind}progressive JPEG with a bad scan "
                            f"(Ss {ss}, Se {se}, Ah {ah}, Al {al}, {ns} "
                            "components)")


def _smoothing(info: JpegInfo, coef_bits: np.ndarray, prev_bits: np.ndarray
               ) -> Optional[np.ndarray]:
    """libjpeg-turbo's coef_bits_latch and its latch of the bits before each
    component's last scan (components x 20) where it smooths the blocks of a
    progressive frame (jdcoefct.c smoothing_ok), else None:
    every component's quantisation table latched with the DC and the first
    9 AC quantisers not 0, every component's DC at least partly known, and
    one of those 9 AC coefficients of some component not refined to its
    last bit (Al 0) by the last scan."""
    if not info.progressive or (coef_bits[:, 0] < 0).any():
        return None
    for q in info.comp_q:
        if q is None or not q[_SMOOTHED].all():
            return None
    if not (coef_bits[:, 1:10] != 0).any():
        return None
    prev = prev_bits[:, :10] if len(info.scans) > 1 else np.full_like(
        prev_bits[:, :10], -1)
    return np.ascontiguousarray(np.concatenate([coef_bits[:, :10], prev], 1))


def _frame(info: JpegInfo, marker: int, body: bytes, pos: int) -> None:
    """An SOFn segment (jdmarker.c get_sof)."""
    info.progressive, info.arithmetic = _FRAMES[marker]
    if len(body) < 6:
        raise _Refused(pos, "JPEG with a short frame header")
    precision, h, w, nf = struct.unpack(">BHHB", body[:6])
    if h == 0 or w == 0 or nf == 0:
        raise _Refused(pos, f"JPEG of size {w}x{h}, {nf} components")
    if len(body) != 6 + 3 * nf:
        raise _Refused(pos, "JPEG with a frame header of the wrong "
                            "length")
    if precision != 8:
        raise _Refused(pos, f"{precision}-bit JPEG is not "
                            "decoded without cv2 (8-bit only)")
    if nf not in (1, 3, 4):
        raise _Refused(pos, f"{nf}-component JPEG is not "
                            "decoded without cv2 (1, 3 or 4 only)")
    info.width, info.height = w, h
    for i in range(nf):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        info.comp_ids.append(cid)
        info.comp_h.append(hv >> 4)
        info.comp_v.append(hv & 15)
        info.comp_tq.append(tq)
    info.comp_q = [None] * nf


def parse_jpeg(data: bytes, name: str = "<bytes>") -> JpegInfo:
    """The markers of a JPEG (see _parse); an error met past the end of a
    file cut short says so."""
    n = len(data)
    try:
        return _parse(data)
    except _Refused as err:
        if err.pos > n:
            raise ImageReadError(f"{name}: JPEG truncated at byte {n}: "
                                 f"{err.reason}") from None
        raise ImageReadError(f"{name}: {err.reason}") from None


def _dht(body: bytes, pos: int, dc_bits: np.ndarray, dc_vals: np.ndarray,
         ac_bits: np.ndarray, ac_vals: np.ndarray) -> int:
    """The Huffman tables of a DHT segment's body written into their slots;
    the slots it defines, as bit t of a DC and bit 4 + t of an AC table."""
    at = present = 0
    while len(body) - at > 16:
        index = body[at]
        counts = np.frombuffer(body[at + 1:at + 17], np.uint8)
        total = int(counts.sum())
        if total > 256 or total > len(body) - at - 17:
            raise _Refused(pos, "JPEG with a bad DHT segment")
        tc, th = index >> 4 & 1, index & ~0x10
        if th > 3:
            raise _Refused(pos, f"JPEG with a DHT table index {th}")
        vals = np.frombuffer(body[at + 17:at + 17 + total], np.uint8)
        bits, syms = (ac_bits, ac_vals) if tc else (dc_bits, dc_vals)
        bits[th, 1:] = counts
        syms[th] = 0
        syms[th, :total] = vals
        present |= 1 << (th + (4 if tc else 0))
        at += 17 + total
    if at != len(body):
        raise _Refused(pos, "JPEG with a bad DHT segment")
    return present


def _parse(data: bytes) -> JpegInfo:
    """The markers of a JPEG (see the module's docstring) as libjpeg reads
    them for cv2.imread: a sequential frame whose first scan holds every
    component up to that scan's data (cv2 has the image before it reads
    further, and errors past it do not take it away), any other frame up to
    its EOI; past the end of the file a fake EOI, again and again (so a
    file cut inside a scan decodes). Raises _Refused on anything it does
    not decode."""
    if data[:2] != SOI:
        raise _Refused(0, "not a JPEG file (no SOI marker)")
    info = JpegInfo()
    app1 = None
    pos = 2
    data = data + _EOI * 4
    seen_sof = False
    qtables = np.zeros((4, 64), np.uint16)
    dc_bits, ac_bits = (np.zeros((4, 17), np.uint8) for _ in range(2))
    dc_vals, ac_vals = (np.zeros((4, 256), np.uint8) for _ in range(2))
    # the standard tables wait in slots 0 and 1: a sequential Huffman frame
    # decodes with them where no DHT defines the slot (jdhuff.c's
    # std_huff_tables; motion-JPEG frames carry no DHT), a progressive one
    # does not (jdphuff.c)
    _dht(_STD_DHT, 0, dc_bits, dc_vals, ac_bits, ac_vals)
    present = restart_interval = 0
    dc_cond, ac_k = [0x10] * 16, [5] * 16   # DAC defaults: L 0, U 1, Kx 5
    coef_bits = None
    while True:
        while data[pos] != 0xFF:
            pos += 1                     # garbage between segments
        while data[pos] == 0xFF:
            pos += 1                     # fill bytes
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0x00, 0x01):
            continue                     # stray RSTn / TEM / FF 00
        if not (0xC0 <= marker <= 0xFE) or marker in (0xD8, 0xDE, 0xDF) or \
                0xF0 <= marker <= 0xFD:
            raise _Refused(pos, "JPEG with an unknown marker "
                                f"0xFF{marker:02X}")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if length < 2:
            raise _Refused(pos, "JPEG with a marker segment "
                                f"0xFF{marker:02X} of length {length}")
        if pos + length + 4 > len(data):
            data += _EOI * ((pos + length + 4 - len(data)) // 2 + 1)
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED:
            raise _Refused(pos, f"{_UNSUPPORTED[marker]} JPEG is not "
                                "decoded without cv2 (baseline, extended "
                                "sequential and progressive, Huffman or "
                                "arithmetic-coded, only)")
        if marker in _FRAMES:
            if seen_sof:
                raise _Refused(pos, "JPEG with two frames")
            seen_sof = True
            _frame(info, marker, body, pos)
            if not info.progressive and not info.arithmetic:
                present |= 0x33
            coef_bits = np.full((len(info.comp_ids), 64), -1, np.int32)
            prev_bits = np.zeros_like(coef_bits)
        elif marker == 0xC4:
            present |= _dht(body, pos, dc_bits, dc_vals, ac_bits, ac_vals)
        elif marker == 0xCC:
            if len(body) % 2:
                raise _Refused(pos, "JPEG with a bad DAC segment")
            for at in range(0, len(body), 2):
                index, val = body[at:at + 2]      # Tc << 4 | Tb, then Cs
                if index > 31 or (index < 16 and val & 15 > val >> 4):
                    raise _Refused(pos, "JPEG with a bad DAC segment")
                if index < 16:
                    dc_cond[index] = val
                else:
                    ac_k[index - 16] = val
        elif marker == 0xDB:
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                size = 128 if pq else 64
                raw = body[at + 1:at + 1 + size]
                if len(raw) < size or tq > 3:
                    raise _Refused(pos, "JPEG with a bad DQT segment")
                q = np.frombuffer(raw, ">u2" if pq else np.uint8)
                qtables[tq, _ZIGZAG] = q
                at += 1 + size
        elif marker == 0xDD:
            if len(body) != 2:
                raise _Refused(pos, "JPEG with a bad DRI segment")
            (restart_interval,) = struct.unpack(">H", body)
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
                raise _Refused(pos, "JPEG scan before its frame")
            ns = body[0] if body else 0
            if len(body) != 4 + 2 * ns or not 1 <= ns <= 4:
                raise _Refused(pos, "JPEG with a bad scan header")
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahl >> 4, ahl & 15
            _check_scan(info, ns, ss, se, ah, al, pos)
            fields = ([ns] + [0] * 12 + [ss, se, ah, al, restart_interval]
                      + dc_cond + ac_k)
            for i in range(ns):
                cs, t = body[1 + 2 * i:3 + 2 * i]
                if cs not in info.comp_ids:
                    raise _Refused(pos, "JPEG scan of an unknown "
                                        f"component {cs}")
                c = info.comp_ids.index(cs)
                fields[1 + 3 * i:4 + 3 * i] = [c, t >> 4, t & 15]
                if info.comp_q[c] is None:       # latch_quant_tables
                    tq = info.comp_tq[c]
                    if tq > 3:
                        raise _Refused(pos, "JPEG component of "
                                            f"quantisation table {tq}")
                    info.comp_q[c] = qtables[tq].copy()
                if info.progressive:          # jdphuff.c start_pass
                    lo, hi = min(ss, 1), max(se, 9) + 1
                    prev_bits[c, lo:hi] = coef_bits[c, lo:hi] if info.scans \
                        else 0
                    coef_bits[c, ss:se + 1] = al
            end = _scan_end(data, pos)
            info.fields.append(fields)
            info.dc_bits.append(dc_bits.copy())
            info.dc_vals.append(dc_vals.copy())
            info.ac_bits.append(ac_bits.copy())
            info.ac_vals.append(ac_vals.copy())
            info.tables.append(present)
            info.scans.append(data[pos:end + 2])   # with its marker
            pos = end
            if not info.progressive and len(info.scans) == 1 and \
                    ns == len(info.comp_ids):
                break                    # one scan: the image is out
    if not info.scans:
        raise _Refused(pos, "JPEG without a scan")
    if info.progressive:
        info.coef_bits = _smoothing(info, coef_bits, prev_bits)
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


def decode_jpeg_rgb(data: bytes, name: str = "<bytes>",
                    color: Optional[int] = None) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG, equal to
    cv2.cvtColor(cv2.imread(path, IMREAD_COLOR), COLOR_BGR2RGB): grayscale
    repeated to three channels, the EXIF orientation applied. ``color``
    overrides the colour space the markers give (libtiff sets it for
    JPEG-in-TIFF). Raises ImageReadError naming ``name`` on what it does
    not decode (see the module's docstring)."""
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
    coef_bits = None if info.coef_bits is None else _ptr(info.coef_bits)
    status = lib.ys_jpeg_decode(
        info.width, info.height, len(info.comp_ids), _ptr(comp_h),
        _ptr(comp_v), int(info.progressive) | 2 * int(info.arithmetic),
        len(info.scans), _ptr(scans), _ptr(offsets), _ptr(fields),
        _ptr(dc_bits), _ptr(dc_vals), _ptr(ac_bits), _ptr(ac_vals),
        _ptr(tables), _ptr(qtables), coef_bits,
        info.color if color is None else color, _ptr(out))
    if status:
        raise ImageReadError(f"{name}: JPEG not decoded: "
                         f"{_ERRORS.get(status, f'error {status}')}")
    return apply_orientation(out, info.orientation)
