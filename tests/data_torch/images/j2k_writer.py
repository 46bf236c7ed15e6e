"""A small JPEG 2000 encoder for the codestream options cv2 and PIL do not
write: every code-block style (bypass, RESET, TERMALL, vertically causal,
predictable termination, segmentation symbols), SOP and EPH markers, POC,
RGN (a maximum-shift region), COC and QCC per component, tile-parts and
layers, on the reversible 5/3 path (with the RCT where asked). numpy and
struct only; the tests hold what cv2.imread makes of its files against
the port's reader.

    write_j2k(img, levels=3, cblk=(4, 4), styles=0, layers=2, ...)

``img`` is (h, w) or (h, w, c) uint8. The progression is LRCP or RLCP (or
the POC entries given); packets follow OpenJPEG's iteration for those
orders, each at most once."""

import struct

import numpy as np

# the MQ coder's states: (Qe, NMPS, NLPS, SWITCH), ITU T.800 Table C.2
_MQ = [(0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
       (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
       (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
       (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
       (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
       (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
       (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
       (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
       (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
       (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
       (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
       (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
       (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
       (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
       (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
       (0x0001, 45, 43, 0), (0x5601, 46, 46, 0)]
AGG, UNI = 17, 18
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32


class _Mq:
    """The MQ encoder of Annex C.2; flush() ends a segment."""

    def __init__(self):
        self.reset_states()
        self.start()

    def reset_states(self):
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[UNI], self.state[AGG], self.state[0] = 46, 3, 4

    def start(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray([0])           # the byte before the segment

    def _byteout(self):
        if self.out[-1] == 0xFF:
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[-1] += 1
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, d, cx):
        qe, nmps, nlps, sw = _MQ[self.state[cx]]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000 == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.state[cx] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if sw:
                self.mps[cx] ^= 1
            self.state[cx] = nlps
            self._renorm()

    def flush(self):
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        data = bytes(self.out[1:])
        if data.endswith(b"\xff"):
            data = data[:-1]
        return data


class _Raw:
    """The bypass bits: MSB first, 7 bits in the byte after a 0xFF."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def bit(self, b):
        self.acc = self.acc << 1 | b
        self.n += 1
        room = 7 if self.out and self.out[-1] == 0xFF else 8
        if self.n == room:
            self.out.append(self.acc)
            self.acc = self.n = 0

    def flush(self):
        if self.n:
            room = 7 if self.out and self.out[-1] == 0xFF else 8
            self.out.append(self.acc << (room - self.n))
        data = bytes(self.out)
        if data.endswith(b"\xff"):
            data = data[:-1]
        return data


def _zc(h, v, d, orient):
    if orient == 3:
        hv = h + v
        if d == 0:
            return 0 if hv == 0 else 1 if hv == 1 else 2
        if d == 1:
            return 3 if hv == 0 else 4 if hv == 1 else 5
        return (6 if hv == 0 else 7) if d == 2 else 8
    if orient == 1:
        h, v = v, h
    if h == 0:
        if v == 0:
            return 0 if d == 0 else 1 if d == 1 else 2
        return 3 if v == 1 else 4
    if h == 1:
        return (5 if d == 0 else 6) if v == 0 else 7
    return 8


def encode_cblk(coefs, orient, styles, numbps, roishift=0):
    """The coding passes of a code-block's integer coefficients (h, w) over
    its numbps planes (roishift of them the region's shift): [(segment
    bytes, passes)] in order, and the number of passes."""
    h, w = coefs.shape
    mag = np.abs(coefs).astype(np.int64)
    neg = coefs < 0
    sig = np.zeros((h + 2, w + 2), np.int8)
    sgn = np.zeros((h + 2, w + 2), np.int8)        # +1 / -1 where significant
    visited = np.zeros((h, w), bool)
    refined = np.zeros((h, w), bool)
    mq, raw = _Mq(), None
    segments, seg_passes = [], 0
    vsc = bool(styles & VSC)

    def hidden(y):
        return vsc and y % 4 == 3

    def neigh(x, y):
        s = sig
        hh = s[y + 1, x] + s[y + 1, x + 2]
        vv = s[y, x + 1] + (0 if hidden(y) else s[y + 2, x + 1])
        dd = s[y, x] + s[y, x + 2] + (0 if hidden(y) else s[y + 2, x] +
                                      s[y + 2, x + 2])
        return int(hh), int(vv), int(dd)

    def sign_ctx(x, y):
        hc = int(sgn[y + 1, x]) + int(sgn[y + 1, x + 2])
        vc = int(sgn[y, x + 1]) + (0 if hidden(y) else int(sgn[y + 2, x + 1]))
        hc, vc = max(-1, min(1, hc)), max(-1, min(1, vc))
        xorbit = 0
        if hc < 0 or (hc == 0 and vc < 0):
            hc, vc, xorbit = -hc, -vc, 1
        if hc == 0:
            return 9 + (0 if vc == 0 else 1), xorbit
        return 9 + (4 if vc == 1 else 3 if vc == 0 else 2), xorbit

    def set_sig(x, y):
        sig[y + 1, x + 1] = 1
        sgn[y + 1, x + 1] = -1 if neg[y, x] else 1

    def code_sign(x, y, coder):
        if coder is raw:
            raw.bit(int(neg[y, x]))
        else:
            cx, xorbit = sign_ctx(x, y)
            mq.encode(int(neg[y, x]) ^ xorbit, cx)
        set_sig(x, y)

    def order():
        for k in range(0, h, 4):
            for x in range(w):
                for y in range(k, min(k + 4, h)):
                    yield x, y, k

    def sigpass(bp, coder):
        for x, y, _ in order():
            if sig[y + 1, x + 1] or sum(neigh(x, y)) == 0:
                continue
            bit = int(mag[y, x] >> bp & 1)
            if coder is raw:
                raw.bit(bit)
            else:
                mq.encode(bit, _zc(*neigh(x, y), orient))
            if bit:
                code_sign(x, y, coder)
            visited[y, x] = True

    def refpass(bp, coder):
        for x, y, _ in order():
            if not sig[y + 1, x + 1] or visited[y, x]:
                continue
            bit = int(mag[y, x] >> bp & 1)
            if coder is raw:
                raw.bit(bit)
            else:
                cx = 16 if refined[y, x] else (15 if sum(neigh(x, y)) else 14)
                mq.encode(bit, cx)
            refined[y, x] = True

    def clnpass(bp):
        full = h & ~3
        for k in range(0, h, 4):
            for x in range(w):
                y0 = k
                if k < full and all(
                        not sig[y + 1, x + 1] and not visited[y, x]
                        and sum(neigh(x, y)) == 0 for y in range(k, k + 4)):
                    bits = [int(mag[y, x] >> bp & 1) for y in range(k, k + 4)]
                    if not any(bits):
                        mq.encode(0, AGG)
                        continue
                    mq.encode(1, AGG)
                    run = bits.index(1)
                    mq.encode(run >> 1, UNI)
                    mq.encode(run & 1, UNI)
                    code_sign(x, k + run, mq)
                    y0 = k + run + 1
                for y in range(y0, min(k + 4, h)):
                    if sig[y + 1, x + 1] or visited[y, x]:
                        continue
                    bit = int(mag[y, x] >> bp & 1)
                    mq.encode(bit, _zc(*neigh(x, y), orient))
                    if bit:
                        code_sign(x, y, mq)
                for y in range(k, min(k + 4, h)):
                    visited[y, x] = False
        if styles & SEGSYM:
            for b in (1, 0, 1, 0):
                mq.encode(b, UNI)

    if numbps <= 0:
        return [], 0
    kinds = [(2, numbps - 1)] + [(t, bp) for bp in range(numbps - 2, -1, -1)
                                 for t in (0, 1, 2)]
    # each pass's segment (OpenJPEG's maxpasses: 1 each with TERMALL; 10,
    # then 2 and 1 in turn with bypass; else one), and whether a segment
    # is raw: bypass, opening on a significance or refinement pass at or
    # below the fourth plane under the block's planes without the shift
    if styles & TERMALL:
        seg_of = list(range(len(kinds)))
    elif styles & LAZY:
        seg_of, seg, left, size = [], 0, 10, 10
        for _ in kinds:
            seg_of.append(seg)
            left -= 1
            if left == 0:
                seg += 1
                size = 2 if size in (1, 10) else 1
                left = size
    else:
        seg_of = [0] * len(kinds)
    first = {}
    for i, sg in enumerate(seg_of):
        first.setdefault(sg, i)
    raw_seg = {sg: bool(styles & LAZY) and kinds[i][0] < 2
               and kinds[i][1] + 1 <= numbps - roishift - 4
               for sg, i in first.items()}
    passes = 0
    for i, (t, bp) in enumerate(kinds):
        is_raw = raw_seg[seg_of[i]]
        if is_raw and raw is None:
            raw = _Raw()
        coder = raw if is_raw else mq
        if t == 0:
            sigpass(bp, coder)
        elif t == 1:
            refpass(bp, coder)
        else:
            clnpass(bp)
        passes += 1
        seg_passes += 1
        if (styles & RESET) and not is_raw:
            mq.reset_states()
        if i == len(kinds) - 1 or seg_of[i + 1] != seg_of[i]:
            if is_raw:
                segments.append((raw.flush(), seg_passes))
                raw = None
            else:
                segments.append((mq.flush(), seg_passes))
                mq.start()
            seg_passes = 0
    return segments, passes


def _fwd53_1d(x, cas):
    """The forward 5/3 lifting of a 1-D integer signal whose first sample
    sits at parity cas: (low, high)."""
    n = len(x)
    x = x.astype(np.int64).copy()
    if n == 1:
        return (x, x[:0]) if cas == 0 else (x[:0], x * 2)
    ext = lambda i: x[i if 0 <= i < n else (-i if i < 0 else 2 * (n - 1) - i)]
    hi_idx = list(range(1 - cas, n, 2))
    lo_idx = list(range(cas, n, 2))
    y = x.copy()
    for i in hi_idx:
        y[i] = x[i] - ((ext(i - 1) + ext(i + 1)) >> 1)
    x2 = y

    def ext2(i):
        return x2[i if 0 <= i < n else (-i if i < 0 else 2 * (n - 1) - i)]
    z = x2.copy()
    for i in lo_idx:
        z[i] = x2[i] + ((ext2(i - 1) + ext2(i + 1) + 2) >> 2)
    return z[lo_idx], z[hi_idx]


def fwd53(tile, levels, x0=0, y0=0):
    """The forward 5/3 DWT of a tile-component at (x0, y0): the coefficient
    array in OpenJPEG's layout (each level's low band top-left)."""
    a = tile.astype(np.int64).copy()
    h, w = a.shape
    rx0, ry0, rx1, ry1 = x0, y0, x0 + w, y0 + h
    for _ in range(levels):
        rw, rh = rx1 - rx0, ry1 - ry0
        sub = a[:rh, :rw]
        cols = []
        for i in range(rw):
            lo, hi = _fwd53_1d(sub[:, i], ry0 & 1)
            cols.append(np.concatenate([lo, hi]))
        sub = np.stack(cols, 1) if cols else sub
        rows = []
        for j in range(rh):
            lo, hi = _fwd53_1d(sub[j], rx0 & 1)
            rows.append(np.concatenate([lo, hi]))
        a[:rh, :rw] = np.stack(rows, 0)
        rx0, ry0 = -(-rx0 // 2), -(-ry0 // 2)
        rx1, ry1 = -(-rx1 // 2), -(-ry1 // 2)
    return a


def _ceil_pow2(a, b):
    return -(-a // (1 << b))


class _Bits:
    """Packet-header bits: MSB first, 7 bits in the byte after a 0xFF."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v, n=1):
        for i in range(n - 1, -1, -1):
            self.acc = self.acc << 1 | (v >> i & 1)
            self.n += 1
            room = 7 if self.out and self.out[-1] == 0xFF else 8
            if self.n == room:
                self.out.append(self.acc)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            room = 7 if self.out and self.out[-1] == 0xFF else 8
            self.out.append(self.acc << (room - self.n))
            self.acc = self.n = 0
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTree:
    def __init__(self, values):
        h, w = values.shape
        self.levels = [values.astype(np.int64)]
        while h * w > 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            prev = self.levels[-1]
            nxt = np.full((h, w), 1 << 30, np.int64)
            for j in range(prev.shape[0]):
                for i in range(prev.shape[1]):
                    nxt[j // 2, i // 2] = min(nxt[j // 2, i // 2], prev[j, i])
            self.levels.append(nxt)
        self.low = [np.zeros_like(v) for v in self.levels]
        self.known = [np.zeros(v.shape, bool) for v in self.levels]

    def encode(self, bits, leaf, threshold):
        w0 = self.levels[0].shape[1]
        j, i = divmod(leaf, w0)
        path = []
        for k in range(len(self.levels)):
            path.append((k, j, i))
            j, i = j // 2, i // 2
        low = 0
        for k, j, i in reversed(path):
            if low > self.low[k][j, i]:
                self.low[k][j, i] = low
            else:
                low = self.low[k][j, i]
            while low < threshold:
                if low >= self.levels[k][j, i]:
                    if not self.known[k][j, i]:
                        bits.put(1)
                        self.known[k][j, i] = True
                    break
                bits.put(0)
                low += 1
            self.low[k][j, i] = low


def _numpasses(bits, n):
    if n == 1:
        bits.put(0)
    elif n == 2:
        bits.put(2, 2)
    elif n <= 5:
        bits.put(3, 2)
        bits.put(n - 3, 2)
    elif n <= 36:
        bits.put(15, 4)
        bits.put(n - 6, 5)
    else:
        bits.put(511, 9)
        bits.put(n - 37, 7)


def _segment(marker, body):
    return struct.pack(">HH", marker, len(body) + 2) + body


def _spcod(levels, cblk, styles, precincts):
    out = struct.pack(">BBBBB", levels, cblk[0] - 2, cblk[1] - 2, styles, 1)
    if precincts:
        out += bytes(py << 4 | px for px, py in precincts)
    return out


def write_j2k(img, levels=3, cblk=(4, 4), styles=0, layers=1, order=0,
              precincts=None, tile=None, mct=False, sop=False, eph=False,
              poc=None, roi=None, comp_styles=None, guard=2, qcc_guard=None,
              tile_parts=1, comment=b"writers"):
    """A raw J2K codestream of img (uint8) on the reversible path.

    levels, cblk (log2 width, height), styles (the code-block style bits:
    LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM), layers (each code-block's
    passes spread over them), order (0 LRCP, 1 RLCP), precincts (a log2
    (width, height) for each resolution), tile ((tw, th) or None), mct
    (the RCT over the first three components), sop / eph (the markers),
    poc ([(res0, comp0, layer1, res1, comp1, order)]), roi ((component,
    mask): mask(bandno, x, y) True for the band coefficients of the region,
    shifted up by the least shift that clears the background),
    comp_styles ({component: (levels, cblk, styles)}: a COC each),
    guard / qcc_guard ({component: guard bits}: a QCC each), tile_parts
    (each tile's packets over that many tile-parts)."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    h, w, nc = a.shape
    tw, th = tile or (w, h)
    params = {c: (levels, cblk, styles) for c in range(nc)}
    params.update(comp_styles or {})
    guards = {c: guard for c in range(nc)}
    guards.update(qcc_guard or {})
    out = bytearray(b"\xff\x4f")
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, tw, th, 0, 0, nc)
    siz += b"".join(struct.pack(">BBB", 7, 1, 1) for _ in range(nc))
    out += _segment(0xFF51, siz)
    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    out += _segment(0xFF52, struct.pack(">BBHB", scod, order, layers,
                                        1 if mct else 0)
                    + _spcod(levels, cblk, styles,
                             precincts and precincts[:levels + 1]))
    for c, (lv, cb, st) in (comp_styles or {}).items():
        out += _segment(0xFF53, struct.pack(">BB", c, 1 if precincts else 0)
                        + _spcod(lv, cb, st, precincts and precincts[:lv + 1]))
    # the data, then the exponents each band needs
    samples = a.astype(np.int64) - 128
    if mct:
        r, g, b = samples[..., 0], samples[..., 1], samples[..., 2]
        y = (r + 2 * g + b) >> 2
        samples = samples.copy()
        samples[..., 0], samples[..., 1], samples[..., 2] = y, b - g, r - g
    ntx, nty = -(-w // tw), -(-h // th)
    tiles = []
    for q in range(nty):
        for p in range(ntx):
            x0, y0 = p * tw, q * th
            x1, y1 = min(x0 + tw, w), min(y0 + th, h)
            comps = []
            for c in range(nc):
                lv = params[c][0]
                coefs = fwd53(samples[y0:y1, x0:x1, c], lv, x0, y0)
                comps.append((coefs, _bands(x0, y0, x1, y1, lv)))
            tiles.append((x0, y0, x1, y1, comps))
    if roi:
        # the region's coefficients shifted up past twice the largest
        # background magnitude (the maximum-shift method)
        comp, mask = roi
        cells, top = [], 0
        for *_, comps in tiles:
            coefs, bands = comps[comp]
            for _, bandno, bx0, by0, bx1, by1, ox, oy in bands:
                for j in range(by1 - by0):
                    for i in range(bx1 - bx0):
                        if mask(bandno, bx0 + i, by0 + j):
                            cells.append((coefs, oy + j, ox + i))
                        else:
                            top = max(top, abs(int(coefs[oy + j, ox + i])))
        shift = (2 * top + 1).bit_length()
        for coefs, j, i in cells:
            v = int(coefs[j, i])
            coefs[j, i] = (-1 if v < 0 else 1) * (abs(v) << shift)
        roi = (comp, shift)
    maxbits = {}
    for *_, comps in tiles:
        for c, (coefs, bands) in enumerate(comps):
            for r_, bandno, bx0, by0, bx1, by1, ox, oy in bands:
                part = coefs[oy:oy + by1 - by0, ox:ox + bx1 - bx0]
                bits = int(np.abs(part).max()).bit_length() if part.size \
                    else 0
                if roi and roi[0] == c:
                    bits = max(bits - roi[1], 0)
                key = (c, r_, bandno)
                maxbits[key] = max(maxbits.get(key, 0), bits)
    # each band's exponent: enough for the widest coefficient of any
    # component with as many levels (one QCD), a QCC for the others
    for c in range(nc):
        lv = params[c][0]
        exps = []
        for r_ in range(lv + 1):
            for bandno in ([0] if r_ == 0 else [1, 2, 3]):
                need = max(maxbits.get((k, r_, bandno), 0) for k in range(nc)
                           if params[k][0] == lv)
                exps.append(max(need - guards[c] + 1, 0))
        body = bytes([guards[c] << 5]) + bytes(e << 3 for e in exps)
        if c == 0:
            out += _segment(0xFF5C, body)
        elif lv != params[0][0] or guards[c] != guards[0]:
            out += _segment(0xFF5D, bytes([c]) + body)
        params[c] = params[c] + (exps, guards[c])
    if roi:
        out += _segment(0xFF5E, struct.pack(">BBB", roi[0], 0, roi[1]))
    if poc:
        out += _segment(0xFF5F, b"".join(struct.pack(">BBHBBB", *e)
                                         for e in poc))
    out += _segment(0xFF64, b"\x00\x01" + comment)
    for t, (x0, y0, x1, y1, comps) in enumerate(tiles):
        packets = _packets(comps, params, layers, order, poc, x0, y0, x1,
                           y1, precincts, sop, eph, roi, nc)
        k = max(1, min(tile_parts, len(packets)))
        cuts = [len(packets) * i // k for i in range(k + 1)]
        for tp in range(k):
            body = b"".join(packets[cuts[tp]:cuts[tp + 1]])
            sot = struct.pack(">HHHIBB", 0xFF90, 10, t, 14 + len(body), tp,
                              k)
            out += sot + b"\xff\x93" + body
    return bytes(out + b"\xff\xd9")


def _bands(x0, y0, x1, y1, levels):
    """(resolution, bandno, band x0, y0, x1, y1, x offset, y offset in the
    coefficient array) of a tile-component."""
    out = []
    for r in range(levels + 1):
        lvl = levels - r
        if r == 0:
            bx0, by0 = _ceil_pow2(x0, lvl), _ceil_pow2(y0, lvl)
            bx1, by1 = _ceil_pow2(x1, lvl), _ceil_pow2(y1, lvl)
            out.append((0, 0, bx0, by0, bx1, by1, 0, 0))
            continue
        prev = levels - r + 1
        pw = _ceil_pow2(x1, prev) - _ceil_pow2(x0, prev)
        ph = _ceil_pow2(y1, prev) - _ceil_pow2(y0, prev)
        for bandno in (1, 2, 3):
            xo, yo = bandno & 1, bandno >> 1
            bx0 = _ceil_pow2(x0 - (xo << lvl), lvl + 1)
            by0 = _ceil_pow2(y0 - (yo << lvl), lvl + 1)
            bx1 = _ceil_pow2(x1 - (xo << lvl), lvl + 1)
            by1 = _ceil_pow2(y1 - (yo << lvl), lvl + 1)
            out.append((r, bandno, bx0, by0, bx1, by1, pw if xo else 0,
                        ph if yo else 0))
    return out


def _packets(comps, params, layers, order, poc, x0, y0, x1, y1, precincts,
             sop, eph, roi, nc):
    """Every packet of a tile, coded, in progression order."""
    # each (component, resolution): its precincts' code-blocks, coded
    state = {}
    for c, (coefs, bands) in enumerate(comps):
        lv, cb, st, exps, guard_bits = params[c]
        for r in range(lv + 1):
            lvl = lv - r
            rx0, ry0 = _ceil_pow2(x0, lvl), _ceil_pow2(y0, lvl)
            rx1, ry1 = _ceil_pow2(x1, lvl), _ceil_pow2(y1, lvl)
            pdx, pdy = precincts[r] if precincts else (15, 15)
            px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            pw = 0 if rx0 == rx1 else (-(-rx1 // (1 << pdx)) * (1 << pdx)
                                       - px0) >> pdx
            ph = 0 if ry0 == ry1 else (-(-ry1 // (1 << pdy)) * (1 << pdy)
                                       - py0) >> pdy
            if r == 0:
                cgx0, cgy0, cgw, cgh = px0, py0, pdx, pdy
            else:
                cgx0, cgy0 = _ceil_pow2(px0, 1), _ceil_pow2(py0, 1)
                cgw, cgh = pdx - 1, pdy - 1
            cbw, cbh = min(cb[0], cgw), min(cb[1], cgh)
            rbands = [b for b in bands if b[0] == r]
            precs = []
            for pn in range(pw * ph):
                sx = cgx0 + (pn % pw) * (1 << cgw)
                sy = cgy0 + (pn // pw) * (1 << cgh)
                per_band = []
                for (_, bandno, bx0, by0, bx1, by1, ox, oy) in rbands:
                    if bx1 <= bx0 or by1 <= by0:
                        per_band.append(None)
                        continue
                    qx0, qy0 = max(sx, bx0), max(sy, by0)
                    qx1, qy1 = min(sx + (1 << cgw), bx1), min(sy + (1 << cgh),
                                                              by1)
                    if qx1 <= qx0 or qy1 <= qy0:
                        per_band.append(dict(cw=0, ch=0, blocks=[]))
                        continue
                    kx0, ky0 = (qx0 >> cbw) << cbw, (qy0 >> cbh) << cbh
                    cw = (-(-qx1 // (1 << cbw)) * (1 << cbw) - kx0) >> cbw
                    ch = (-(-qy1 // (1 << cbh)) * (1 << cbh) - ky0) >> cbh
                    stepno = 0 if r == 0 else 3 * (r - 1) + bandno
                    numbps = exps[stepno] + guard_bits - 1
                    blocks = []
                    for k in range(cw * ch):
                        ax = max(kx0 + (k % cw) * (1 << cbw), qx0)
                        ay = max(ky0 + (k // cw) * (1 << cbh), qy0)
                        bx = min(kx0 + (k % cw + 1) * (1 << cbw), qx1)
                        by = min(ky0 + (k // cw + 1) * (1 << cbh), qy1)
                        part = coefs[oy + ay - by0:oy + by - by0,
                                     ox + ax - bx0:ox + bx - bx0]
                        total = numbps + (roi[1] if roi and roi[0] == c
                                          else 0)
                        top = int(np.abs(part).max()).bit_length() if \
                            part.size else 0
                        zero = total - top
                        segs, npass = encode_cblk(
                            part, bandno, st, top,
                            roi[1] if roi and roi[0] == c else 0)
                        blocks.append(dict(segs=segs, npass=npass, zero=zero,
                                           lblock=3, first=None, sent=0))
                    # each block's passes over the layers
                    for bl in blocks:
                        n = bl["npass"]
                        bl["split"] = [n * (l + 1) // layers - n * l // layers
                                       for l in range(layers)]
                        firsts = [l for l in range(layers) if bl["split"][l]]
                        bl["first"] = firsts[0] if firsts else layers + 100
                    incl = np.array([bl["first"] for bl in blocks]).reshape(
                        ch, cw)
                    zeros = np.array([bl["zero"] for bl in blocks]).reshape(
                        ch, cw)
                    per_band.append(dict(cw=cw, ch=ch, blocks=blocks,
                                         incl=_TagTree(incl),
                                         imsb=_TagTree(zeros)))
                precs.append(per_band)
            state[c, r] = dict(pw=pw, ph=ph, precs=precs, st=st)
    maxres = max(p[0] for p in params.values()) + 1
    entries = poc or [(0, 0, layers, maxres, nc, order)]
    done, seq = set(), []
    for r0, c0, l1, r1, c1, prg in entries:
        l1, c1 = min(l1, layers), min(c1, nc)
        if prg == 0:
            loops = [(l, r) for l in range(l1) for r in range(r0, r1)]
        else:
            loops = [(l, r) for r in range(r0, r1) for l in range(l1)]
        for l, r in loops:
            for c in range(c0, c1):
                if (c, r) not in state:
                    continue
                s = state[c, r]
                for pn in range(s["pw"] * s["ph"]):
                    if (l, r, c, pn) not in done:
                        done.add((l, r, c, pn))
                        seq.append((l, r, c, pn))
    out = []
    for n, (l, r, c, pn) in enumerate(seq):
        s = state[c, r]
        out.append(_packet(s["precs"][pn], l, s["st"], sop, eph, n))
    return out


def _packet(per_band, layer, styles, sop, eph, seqno):
    bits = _Bits()
    body = bytearray()
    any_new = any(b and any(bl["split"][layer] for bl in b["blocks"])
                  for b in per_band)
    head = struct.pack(">HHH", 0xFF91, 4, seqno % 65536) if sop else b""
    if not any_new:
        bits.put(0)
        hdr = bits.flush()
        return head + hdr + (b"\xff\x92" if eph else b"")
    bits.put(1)
    for b in per_band:
        if b is None:
            continue
        for k, bl in enumerate(b["blocks"]):
            n = bl["split"][layer]
            if bl["sent"] == 0 and not any(bl["split"][:layer]):
                b["incl"].encode(bits, k, layer + 1)
            else:
                bits.put(1 if n else 0)
            if not n:
                continue
            if not any(bl["split"][:layer]):
                b["imsb"].encode(bits, k, bl["zero"] + 1)
            _numpasses(bits, n)
            # the segments these passes touch, and the bytes each gets now
            first = sum(bl["split"][:layer])
            parts = []
            at = 0
            for data, np_ in bl["segs"]:
                lo, hi = at, at + np_
                at = hi
                new = max(0, min(hi, first + n) - max(lo, first))
                if new == 0:
                    continue
                done = hi <= first + n
                parts.append((new, data if done else b""))
            lens = [(new, len(d)) for new, d in parts]
            lblock = bl["lblock"]
            need = max(max(ln.bit_length() - (new.bit_length() - 1), 0)
                       for new, ln in lens)
            inc = max(0, need - lblock)
            bits.put((1 << inc) - 1 << 1, inc + 1)
            bl["lblock"] = lblock + inc
            for new, ln in lens:
                bits.put(ln, bl["lblock"] + new.bit_length() - 1)
            for _, d in parts:
                body += d
            bl["sent"] += n
    hdr = bits.flush()
    return head + hdr + (b"\xff\x92" if eph else b"") + bytes(body)
