"""Small image writers for the kinds cv2 and PIL do not write: PNG of any
colour type, bit depth and filter mix, Adam7-interlaced or not, and TIFF
with strips or tiles, either planar configuration, either byte order, LZW
(current or old-style codes), Deflate or PackBits, the horizontal
predictor, any photometric, orientation, extra samples and colour map.
numpy, zlib and struct only, so chip_smoke.py can write its files on a
machine without cv2; the tests hold what they write against cv2.imread."""

import struct
import zlib

import numpy as np

# the seven Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def pack_rows(samples, depth):
    """(h, stride) bytes of (h, w, c) samples at ``depth`` bits: 16-bit
    big-endian, 1- / 2- / 4-bit packed from each byte's high bits, every
    row padded to a whole byte."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    v = samples.reshape(h, w * c).astype(np.uint8)
    pad = (-v.shape[1]) % per
    v = np.pad(v, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = (depth * np.arange(per - 1, -1, -1)).astype(np.uint8)
    return (v << shifts).sum(-1, dtype=np.uint8)


def filter_rows(rows, bpp, ftypes):
    """PNG scanlines of unfiltered rows (h, stride): row y filtered by
    ftypes[y] (0-4) against the left neighbour bpp bytes back."""
    x = rows.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, bpp:] = x[:, :-bpp]
    b[1:] = x[:-1]
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
    out = cand[np.asarray(ftypes), np.arange(len(x))].astype(np.uint8)
    return np.concatenate([np.asarray(ftypes, np.uint8)[:, None], out], 1)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(samples, depth, color, interlace=0, palette=None, seed=0):
    """PNG bytes of (h, w, c) samples (values below 2**depth) of colour
    type ``color`` (0 gray, 2 RGB, 3 paletted with ``palette`` (n, 3), 4
    gray + alpha, 6 RGBA), Adam7-interlaced where ``interlace``; each row
    takes a filter type drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += filter_rows(pack_rows(sub, depth), bpp,
                               rng.integers(0, 5, sub.shape[0])).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def packbits(data):
    """PackBits runs of bytes: runs of 2-128 equal bytes, literals of at
    most 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 255, data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n
                                             and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw(data, compat=False):
    """TIFF LZW codes of bytes: MSB-first, the width growing one code early
    (TIFF 6.0), a Clear code when the table fills; or (compat) the old
    LSB-first codes whose width grows one code later."""
    out = bytearray()
    acc = nacc = 0
    nbits, nxt = 9, 258

    def emit(code):
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nbits) | code
            nacc += nbits
            while nacc >= 8:
                nacc -= 8
                out.append((acc >> nacc) & 255)
            acc &= (1 << nacc) - 1

    def grow():
        nonlocal nbits, nxt
        nxt += 1
        if nxt >= (1 << nbits) + compat and nbits < 12:
            nbits += 1

    table = {}
    emit(256)
    w = -1
    for c in data:
        if w < 0:
            w = c
            continue
        key = (w << 8) | c
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w)
        table[key] = nxt
        grow()
        if nxt == 4094:
            emit(256)
            table = {}
            nbits, nxt = 9, 258
        w = c
    if w >= 0:
        emit(w)
        grow()
    emit(257)
    if nacc:
        out.append(acc & 255 if compat else (acc << (8 - nacc)) & 255)
    return bytes(out)


def write_tiff(img, compression=1, predictor=1, planar=1, tile=None,
               rows_per_strip=None, big_endian=False, photometric=None,
               orientation=None, extra=None, colormap=None, bits=8,
               compat=False):
    """TIFF bytes of (h, w, s) samples (uint8, uint16 at 16 bits, values
    below 2**bits at 1 / 2 / 4 bits): strips of ``rows_per_strip`` rows
    (all rows by default) or ``tile`` (tw, th) tiles, zero-padded at the
    edges; ``compression`` 1, 5 (LZW; ``compat`` the old codes), 8 / 32946
    (Deflate) or 32773 (PackBits, row by row); ``predictor`` 2 differences
    each row before it is compressed; tags for ``photometric`` (2 for 3
    samples or more, else 1 by default), ``orientation``, ``extra``
    (ExtraSamples) and ``colormap`` ((2**bits, 3) 16-bit)."""
    e = ">" if big_endian else "<"
    h, w, spp = img.shape
    if photometric is None:
        photometric = 2 if spp >= 3 else 1

    def encode(a):
        if predictor == 2:
            d = a.astype(np.int64)
            d[:, 1:] -= a[:, :-1].astype(np.int64)
            a = (d % (1 << bits)).astype(a.dtype)
        if bits < 8:
            raw = pack_rows(a, bits).tobytes()
        else:
            raw = a.astype(e + ("u2" if bits == 16 else "u1")).tobytes()
        if compression == 5:
            return lzw(raw, compat)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            rb = len(raw) // a.shape[0]
            return b"".join(packbits(raw[i * rb:(i + 1) * rb])
                            for i in range(a.shape[0]))
        return raw

    planes = ([img[..., s:s + 1] for s in range(spp)] if planar == 2
              else [img])
    chunks = []
    for p in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), img.dtype)
                    part = p[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(t))
        else:
            rps = rows_per_strip or h
            chunks += [encode(p[y:y + rps]) for y in range(0, h, rps)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if orientation:
        tags[274] = (3, [orientation])
    if extra is not None:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    body, offsets = bytearray(), []
    for c in chunks:
        offsets.append(8 + len(body))
        body += c + b"\0" * (len(c) % 2)
    counts = [len(c) for c in chunks]
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]]),
                     324: (4, offsets), 325: (4, counts)})
    else:
        tags.update({278: (4, [rows_per_strip or h]), 273: (4, offsets),
                     279: (4, counts)})
    ifd_at = 8 + len(body)
    ext_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd, ext = bytearray(struct.pack(e + "H", len(tags))), bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        data = struct.pack(e + ("H" if typ == 3 else "I") * len(vals), *vals)
        if len(data) <= 4:
            ifd += struct.pack(e + "HHI", tag, typ, len(vals))
            ifd += data.ljust(4, b"\0")
        else:
            ifd += struct.pack(e + "HHII", tag, typ, len(vals),
                               ext_at + len(ext))
            ext += data + b"\0" * (len(data) % 2)
    ifd += struct.pack(e + "I", 0)
    head = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42,
                                                          ifd_at)
    return bytes(head + body + ifd + ext)


# ----------------------------------------------------------------- BMP
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def pack_bits_msb(idx, bpp):
    """(h, stride) bytes of (h, w) indices of 1, 4, 8 or 16 bits (16-bit
    little-endian), the first pixel in a byte's high bits, each row padded
    to 4 bytes as a BMP row is."""
    h, w = idx.shape[:2]
    if bpp == 16:
        rows = idx.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    elif bpp == 32:
        rows = idx.astype("<u4").view(np.uint8).reshape(h, 4 * w)
    elif bpp == 24:
        rows = idx.reshape(h, 3 * w).astype(np.uint8)
    else:
        per = 8 // bpp
        v = idx.astype(np.uint8)
        v = np.pad(v, ((0, 0), (0, (-w) % per)))
        v = v.reshape(h, -1, per)
        rows = np.zeros(v.shape[:2], np.uint8)
        for i in range(per):
            rows |= v[..., i] << (8 - bpp * (i + 1))
    return np.pad(rows, ((0, 0), (0, (-rows.shape[1]) % 4)))


def rle_encode(idx, bpp, ops=None):
    """BI_RLE8 (bpp 8) or BI_RLE4 (bpp 4) data of (h, w) indices, stored
    bottom-up: runs of equal pixels (RLE4: alternating pairs) as encoded
    runs, the rest in absolute runs, an end-of-line after each row and an
    end-of-bitmap at the end. ``ops`` replaces that: a list of ("run", n,
    value), ("abs", values), ("eol",), ("delta", dx, dy), ("eob",) and
    ("raw", bytes) written as given."""
    out = bytearray()
    if ops is None:
        ops = []
        for row in idx[::-1]:
            x, w = 0, len(row)
            while x < w:
                n = 1
                while x + n < w and n < 255 and row[x + n] == row[x]:
                    n += 1
                if n >= 3 or w - x < 3:
                    ops.append(("run", n, int(row[x])))
                    x += n
                else:
                    m = min(w - x, 255, max(3, n))
                    ops.append(("abs", [int(v) for v in row[x:x + m]]))
                    x += m
            ops.append(("eol",))
        ops.append(("eob",))
    for op in ops:
        kind = op[0]
        if kind == "run":
            n, v = op[1], op[2]
            out += bytes([n, v if bpp == 8 else (v & 15) * 17])
        elif kind == "pairrun":           # RLE4: two alternating values
            out += bytes([op[1], (op[2] << 4) | op[3]])
        elif kind == "abs":
            vals = op[1]
            out += bytes([0, len(vals)])
            if bpp == 8:
                data = bytes(vals)
            else:
                v = list(vals) + [0] * (len(vals) % 2)
                data = bytes((v[i] << 4) | v[i + 1]
                             for i in range(0, len(v), 2))
            out += data + b"\0" * (len(data) % 2)
        elif kind == "eol":
            out += b"\0\0"
        elif kind == "eob":
            out += b"\0\1"
        elif kind == "delta":
            out += bytes([0, 2, op[1], op[2]])
        elif kind == "raw":
            out += op[1]
    return bytes(out)


def write_bmp(pixels, bpp, header=40, compression=BI_RGB, palette=None,
              masks=None, top_down=False, clr_used=None, rle=None,
              pal_entry=None):
    """BMP bytes of ``pixels``: (h, w) palette indices for 1, 4 and 8
    bits, (h, w) 16- or 32-bit values for 16 and 32, (h, w, 3) B, G, R for
    24. ``header``: 12 (OS/2 BITMAPCOREHEADER: 16-bit sizes, 3-byte
    palette entries), 40, 52, 56, 108 or 124 bytes. ``palette``: (n, 3)
    B, G, R (n may be below 2**bpp; ``clr_used`` defaults to n, 0 writes
    0). ``masks``: the R, G, B (and A) masks of BI_BITFIELDS, after a
    40-byte header or inside a longer one. ``rle``: the data of BI_RLE8 /
    BI_RLE4 (rle_encode), else the rows are packed. Rows are stored
    bottom-up unless ``top_down`` (a negative height)."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    if rle is not None:
        data = rle
    else:
        rows = pack_bits_msb(px, bpp)
        data = (rows if top_down else rows[::-1]).tobytes()
    pal = b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        ent = pal_entry or (3 if header == 12 else 4)
        p = np.zeros((len(palette), ent), np.uint8)
        p[:, :3] = palette
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        n = len(palette) if palette is not None else 0
        used = n if clr_used is None else clr_used
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bpp, compression, len(data), 2835, 2835,
                           used, 0)
        extra = b""
        if masks is not None:
            extra = struct.pack("<%dI" % len(masks), *masks)
        if header == 40:
            info += extra
        else:
            info += extra.ljust(header - 40, b"\0")[:header - 40]
            if header >= 108:           # LCS_sRGB colour space
                info = info[:56] + struct.pack("<I", 0x73524742) + info[60:]
    offset = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
    return head + info + pal + data


# ------------------------------------------------------------ PNM / PAM
def write_pnm(samples, kind, maxval=255, comment=None, per_line=None,
              packed_ascii_bits=False):
    """PNM bytes of (h, w) or (h, w, 3) samples below maxval + 1: ``kind``
    1 / 4 bitmap (samples 0 or 1, 1 black), 2 / 5 graymap, 3 / 6 pixmap;
    1-3 ASCII, 4-6 binary (16-bit big-endian samples above maxval 255).
    ``comment`` puts a ``#`` line after the magic number and another
    inside the header; ``per_line`` breaks the ASCII data after that many
    samples (default: one row a line); ``packed_ascii_bits`` writes P1
    digits without separators."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    head = b"P%d\n" % kind
    if comment:
        head += b"# " + comment.encode() + b"\n"
    head += b"%d %d\n" % (w, h)
    if comment:
        head += b"#" + comment.encode() + b"\r\n"
    if kind not in (1, 4):
        head += b"%d\n" % maxval
    flat = s.reshape(h, -1)
    if kind == 4:
        bits = np.packbits(flat.astype(np.uint8), axis=1)
        return head + bits.tobytes()
    if kind in (5, 6):
        dt = ">u2" if maxval > 255 else np.uint8
        return head + flat.astype(dt).tobytes()
    lines = []
    for row in flat:
        vals = [str(int(v)) for v in row]
        step = per_line or len(vals)
        sep = "" if packed_ascii_bits else " "
        for i in range(0, len(vals), step):
            lines.append(sep.join(vals[i:i + step]))
    return head + "\n".join(lines).encode() + b"\n"


def write_pam(samples, maxval=255, tupltype=None, comment=None):
    """PAM (P7) bytes of (h, w, depth) samples below maxval + 1 with the
    given TUPLTYPE line (none where ``tupltype`` is None), 16-bit
    big-endian above maxval 255."""
    s = np.asarray(samples)
    h, w, d = s.shape
    head = b"P7\n"
    if comment:
        head += b"# " + comment.encode() + b"\n"
    head += b"WIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, d, maxval)
    if tupltype:
        head += b"TUPLTYPE " + tupltype.encode() + b"\n"
    head += b"ENDHDR\n"
    dt = ">u2" if maxval > 255 else np.uint8
    return head + s.astype(dt).tobytes()
