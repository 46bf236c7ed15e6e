"""Small image writers for the kinds cv2 and PIL do not write: PNG of any
colour type, bit depth and filter mix, Adam7-interlaced or not, and TIFF
with strips or tiles, either planar configuration, either byte order, LZW
(current or old-style codes), Deflate or PackBits, the horizontal
predictor, any photometric, orientation, extra samples and colour map;
GIF (any tables, interlace, transparency, frames, LZW code patterns),
Sun raster (every type, depth and colour map), PFM, Radiance HDR (flat,
old- and new-style RLE) and JP2 boxes around a codestream.
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


def ycbcr_blocks(ycc, hs, vs):
    """(rows, bytes) of full-resolution YCbCr samples (h, w, 3) laid out as
    TIFF stores subsampled YCbCr: each hs x vs block of Y samples, then the
    block's Cb and Cr (the means of its samples), edge blocks padded by
    replication; one row a block row."""
    h, w, _ = ycc.shape
    bh, bw = -(-h // vs), -(-w // hs)
    p = np.pad(ycc.astype(np.float64), ((0, bh * vs - h), (0, bw * hs - w),
                                        (0, 0)), mode="edge")
    blocks = p.reshape(bh, vs, bw, hs, 3).transpose(0, 2, 1, 3, 4)
    y = blocks[..., 0].reshape(bh, bw, hs * vs)
    c = blocks[..., 1:].mean((2, 3))
    return np.clip(np.round(np.concatenate([y, c], -1)), 0, 255).astype(
        np.uint8).reshape(bh, -1)


def write_tiff(img, compression=1, predictor=1, planar=1, tile=None,
               rows_per_strip=None, big_endian=False, photometric=None,
               orientation=None, extra=None, colormap=None, bits=8,
               compat=False, subsampling=None, chunks=None, tags=None):
    """TIFF bytes of (h, w, s) samples (uint8, uint16 at 16 bits, values
    below 2**bits at 1 / 2 / 4 bits): strips of ``rows_per_strip`` rows
    (all rows by default) or ``tile`` (tw, th) tiles, zero-padded at the
    edges; ``compression`` 1, 5 (LZW; ``compat`` the old codes), 8 / 32946
    (Deflate) or 32773 (PackBits, row by row); ``predictor`` 2 differences
    each row before it is compressed; tags for ``photometric`` (2 for 3
    samples or more, else 1 by default), ``orientation``, ``extra``
    (ExtraSamples) and ``colormap`` ((2**bits, 3) 16-bit). ``subsampling``
    (hs, vs) writes YCbCr samples (photometric 6) in subsampled blocks
    (ycbcr_blocks) with their YCbCrSubSampling tag; ``chunks`` gives the
    strips' bytes as they are (compressed already), ``tags`` more
    {tag: (type, values)}."""
    e = ">" if big_endian else "<"
    h, w, spp = img.shape
    if photometric is None:
        photometric = 2 if spp >= 3 else 1

    def encode(a):
        if subsampling:
            a = ycbcr_blocks(a, *subsampling)
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
    given, chunks = chunks, []
    for p in planes if given is None else []:
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
    chunks = chunks if given is None else list(given)
    more, tags = tags or {}, {256: (4, [w]), 257: (4, [h]),
                              258: (3, [bits] * spp), 259: (3, [compression]),
                              262: (3, [photometric]), 277: (3, [spp]),
                              284: (3, [planar])}
    tags.update(more)
    if subsampling:
        tags[530] = (3, list(subsampling))
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
        data = (bytes(vals) if typ in (1, 7) else struct.pack(
            e + ("H" if typ == 3 else "I") * len(vals), *vals))
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


# ----------------------------------------------------------------- JPEG
# the natural (row-major) index of each zig-zag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# T.81 Table K.1 / K.2, natural order
_LUMA_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
           14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
           18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
           92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
           103, 99]
_CHROMA_Q = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
_CHROMA_Q += [99] * 32
# T.81 Table D.3 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), the
# probability estimation of the arithmetic coder; entry 113 is the fixed
# 0.5 of sign and refinement bits
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


def ycc_planes(rgb):
    """The Y, Cb and Cr planes (float) of (h, w, 3) RGB, as JFIF defines
    them."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


def quant_table(chroma, quality):
    """libjpeg's quantisation table at a quality (natural order)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = np.asarray(_CHROMA_Q if chroma else _LUMA_Q, np.int64)
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def jpeg_coefficients(planes, factors, qtables, tq):
    """Quantised DCT coefficients of component planes ((h, w) float,
    0-255) at sampling factors [(h, v)]: each plane padded by edge
    replication to whole MCUs, box-averaged down by its factors, level
    shifted, transformed (float DCT) and divided by its table qtables[tq[c]]
    (rounded). Returns one (blocks down, blocks across, 64) int array a
    component, natural order, the MCU grid's dummy blocks included."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    height, width = planes[0].shape
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    n = np.arange(8)
    dct = np.sqrt(np.where(n == 0, 1, 2) / 8)[:, None] * np.cos(
        (2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    out = []
    for plane, (h, v), t in zip(planes, factors, tq):
        sy, sx = vmax // v, hmax // h
        p = np.pad(plane, ((0, mcuy * 8 * vmax - height),
                           (0, mcux * 8 * hmax - width)), mode="edge")
        p = p.reshape(p.shape[0] // sy, sy, p.shape[1] // sx, sx).mean((1, 3))
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = (p - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dct @ blocks @ dct.T
        q = np.asarray(qtables[t], np.float64).reshape(8, 8)
        out.append(np.round(coef / q).astype(np.int64).reshape(bh, bw, 64))
    return out


class _Bits:
    """A Huffman-coded segment: bits MSB first, 0xFF stuffed with 0x00,
    padded with 1 bits at the end."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, nbits):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        data = bytes(self.out)
        self.out = bytearray()
        return data


class _Arith:
    """jcarith.c's QM encoder: arith_encode, with its byte output and
    stuffing, and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = \
            0, 0x10000, 0, 0, 11, -1

    def _byte(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._byte(0)
            self.zc -= 1

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nlps, nmps, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (switch << 7 | nlps)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._byte(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._byte(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._byte(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._byte(0xFF)
                            self._byte(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._byte(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._byte(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._byte(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._byte(0xFF)
                    self._byte(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._byte((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._byte(0)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._byte(0)
        data = bytes(self.out)
        self.out = bytearray()
        self.reset()
        return data


def _category(v):
    return int(abs(v)).bit_length()


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _arith_magnitude(enc, stats, st, v, x1):
    """Figures F.8 and F.9: the magnitude category of v - 1 from bin st
    (the next ones from x1), then its bits from st + 14."""
    m = 0
    v -= 1
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v >> 1
        if x1 is None:                    # DC: X1 = 20
            st = 20
            while v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        elif v2:
            enc.encode(stats, st, 1)
            m <<= 1
            st = x1
            v2 >>= 1
            while v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
    enc.encode(stats, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(stats, st, 1 if m & v else 0)
        m >>= 1


class _ScanCoder:
    """The entropy coding of one scan, Huffman (jchuff.c / jcphuff.c:
    sequential, DC first and refine, AC first) or arithmetic (jcarith.c:
    sequential and all four progressive kinds), with the statistics and
    predictions of its components."""

    def __init__(self, arithmetic, ns, ss, se, ah, al, progressive, kx):
        self.arith, self.ns = arithmetic, ns
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.progressive, self.kx = progressive, kx
        self.bits = _Bits()
        self.enc = _Arith()
        self.fixed = [113]
        self.restart()

    def restart(self):
        self.last = [0] * self.ns
        self.context = [0] * self.ns
        self.eobrun = 0
        # every component codes with tables 0: one statistics area each
        self.dc_stats = [0] * 64
        self.ac_stats = [0] * 256

    def flush(self):
        if self.arith:
            return self.enc.finish()
        self._eobrun()
        return self.bits.flush()

    # Huffman: DC symbols s (< 12) in 4 bits, AC symbols in 8 bits (the
    # two largest in 9), the tables write_jpeg defines
    def _dc(self, s):
        self.bits.put(s, 4)

    def _ac(self, s):
        if s < 254:
            self.bits.put(s, 8)
        else:
            self.bits.put(0x1FC + s - 254, 9)

    def _value(self, v):
        n = _category(v)
        self.bits.put(v if v >= 0 else v - 1 + (1 << n), n)

    def _eobrun(self):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self._ac(n << 4)
            self.bits.put(self.eobrun - (1 << n), n)
            self.eobrun = 0

    def block(self, k, blk):
        """Code one block of the scan's k-th component (natural order)."""
        if not self.arith:
            self._huffman(k, blk)
        elif not self.progressive:
            self._arith_dc(k, int(blk[0]))
            self._arith_ac(blk, 1, 63, 0)
        elif self.ss == 0 and self.ah == 0:
            self._arith_dc(k, int(blk[0]) >> self.al)
        elif self.ss == 0:
            self.enc.encode(self.fixed, 0, (int(blk[0]) >> self.al) & 1)
        elif self.ah == 0:
            self._arith_ac(blk, self.ss, self.se, self.al)
        else:
            self._arith_ac_refine(blk)

    def _huffman(self, k, blk):
        if not self.progressive or (self.ss == 0 and self.ah == 0):
            dc = int(blk[0]) >> (self.al if self.progressive else 0)
            diff = dc - self.last[k]
            self.last[k] = dc
            self._dc(_category(diff))
            self._value(diff)
            if self.progressive:
                return
            run = 0
            for i in range(1, 64):
                v = int(blk[ZIGZAG[i]])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    self._ac(0xF0)
                    run -= 16
                self._ac(run << 4 | _category(v))
                self._value(v)
                run = 0
            if run:
                self._ac(0)
        elif self.ss == 0:
            self.bits.put((int(blk[0]) >> self.al) & 1, 1)
        elif self.ah == 0:
            run = 0
            for i in range(self.ss, self.se + 1):
                v = int(blk[ZIGZAG[i]])
                v = (v >> self.al) if v >= 0 else -((-v) >> self.al)
                if v == 0:
                    run += 1
                    continue
                self._eobrun()
                while run > 15:
                    self._ac(0xF0)
                    run -= 16
                self._ac(run << 4 | _category(v))
                self._value(v)
                run = 0
            if run:
                self.eobrun += 1
                if self.eobrun == 0x7FFF:
                    self._eobrun()
        else:
            raise ValueError("Huffman AC refinement is not written")

    def _arith_dc(self, k, m):
        e, stats = self.enc, self.dc_stats
        st = self.context[k]
        v = m - self.last[k]
        if v == 0:
            e.encode(stats, st, 0)
            self.context[k] = 0
            return
        self.last[k] = m
        e.encode(stats, st, 1)
        if v > 0:
            e.encode(stats, st + 1, 0)
            st += 2
            self.context[k] = 4
        else:
            v = -v
            e.encode(stats, st + 1, 1)
            st += 3
            self.context[k] = 8
        # the context of the next difference (L 0, U 1): large where the
        # magnitude category's m exceeds 1
        if v - 1 >= 2:
            self.context[k] += 8
        _arith_magnitude(e, stats, st, v, None)

    def _arith_ac(self, blk, ss, se, al):
        e, stats = self.enc, self.ac_stats

        def scaled(i):
            v = int(blk[ZIGZAG[i]])
            return (v >> al) if v >= 0 else -((-v) >> al)

        ke = se
        while ke >= ss and scaled(ke) == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            e.encode(stats, st, 0)
            while scaled(k) == 0:
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            v = scaled(k)
            e.encode(stats, st + 1, 1)
            e.encode(self.fixed, 0, 0 if v > 0 else 1)
            _arith_magnitude(e, stats, st + 2, abs(v),
                             189 if k <= self.kx else 217)
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)

    def _arith_ac_refine(self, blk):
        e, stats = self.enc, self.ac_stats

        def shifted(i, by):
            v = abs(int(blk[ZIGZAG[i]]))
            return v >> by

        ke = self.se
        while ke > 0 and shifted(ke, self.al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and shifted(kex, self.ah) == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                e.encode(stats, st, 0)
            while True:
                v = shifted(k, self.al)
                if v:
                    if v >> 1:
                        e.encode(stats, st + 2, v & 1)
                    else:
                        e.encode(stats, st + 1, 1)
                        e.encode(self.fixed, 0,
                                 0 if blk[ZIGZAG[k]] > 0 else 1)
                    break
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= self.se:
            e.encode(stats, 3 * (k - 1), 1)


def write_jpeg(coefs, qtables, tq, factors, width, height, scans,
               arithmetic=False, progressive=False, restart=0,
               adobe_transform=None, jfif=True, kx=5):
    """JPEG bytes of quantised coefficients (jpeg_coefficients' arrays, one
    a component, natural order): the frame SOF0 / SOF2 (Huffman) or SOF9
    / SOF10 (arithmetic), the scans ``scans`` [(components, Ss, Se, Ah,
    Al)] in that order, a restart interval of ``restart`` MCUs, an APP0
    JFIF marker or an APP14 Adobe one with ``adobe_transform``. Huffman
    scans take fixed tables (4-bit DC and 8-bit AC codes) defined before
    each scan; arithmetic ones the default conditioning but Kx = ``kx``
    (a DAC segment where it is not 5)."""
    out = bytearray(b"\xff\xd8")
    if adobe_transform is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                     adobe_transform))
    elif jfif:
        out += _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))
    for t, q in enumerate(qtables):
        out += _segment(0xDB, bytes([t]) + bytes(
            int(v) for v in np.asarray(q)[ZIGZAG]))
    sof = (0xCA if progressive else 0xC9) if arithmetic else (
        0xC2 if progressive else 0xC0)
    body = struct.pack(">BHHB", 8, height, width, len(coefs))
    for c, ((h, v), t) in enumerate(zip(factors, tq)):
        body += bytes([c + 1, h << 4 | v, t])
    out += _segment(sof, body)
    if arithmetic and kx != 5:
        out += _segment(0xCC, bytes([0x10, kx]))     # AC table 0
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for comps, ss, se, ah, al in scans:
        if not arithmetic:
            dc = bytes([0] * 3 + [12] + [0] * 12) + bytes(range(12))
            ac = bytes([0] * 7 + [254, 2] + [0] * 7) + bytes(range(256))
            out += _segment(0xC4, b"\x00" + dc + b"\x10" + ac)
        body = bytes([len(comps)])
        for c in comps:
            body += bytes([c + 1, 0])
        out += _segment(0xDA, body + bytes([ss, se, ah << 4 | al]))
        coder = _ScanCoder(arithmetic, len(comps), ss, se, ah, al,
                           progressive, kx)
        if len(comps) > 1:
            units = [[(k, coefs[c][my * factors[c][1] + y,
                                   mx * factors[c][0] + x])
                      for k, c in enumerate(comps)
                      for y in range(factors[c][1])
                      for x in range(factors[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        else:
            c = comps[0]
            h, v = factors[c]
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            units = [[(0, coefs[c][y, x])] for y in range(bh)
                     for x in range(bw)]
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                out += coder.flush() + bytes([0xFF, 0xD0 + (
                    i // restart - 1) % 8])
                coder.restart()
            for k, blk in unit:
                coder.block(k, blk)
        out += coder.flush()
    return bytes(out + b"\xff\xd9")


def _split_tables(stream):
    """(the table segments DQT / DHT, the rest) of a JPEG stream's marker
    segments before its scan data; the scan data and EOI stay with the
    rest."""
    pos, tables, rest = 2, b"", b""
    while stream[pos + 1] != 0xDA:
        n, = struct.unpack(">H", stream[pos + 2:pos + 4])
        seg = stream[pos:pos + 2 + n]
        if stream[pos + 1] in (0xDB, 0xC4):
            tables += seg
        elif stream[pos + 1] not in (0xE0, 0xEE):
            rest += seg
        pos += 2 + n
    return tables, rest + stream[pos:]


def write_jpeg_tiff(rgb, rows_per_strip, factors, quality, photometric=6):
    """A JPEG-in-TIFF (Compression 7) of (h, w, 3) RGB: each strip of
    rows_per_strip rows its own baseline JPEG (write_jpeg) of YCbCr
    (photometric 6, YCbCrSubSampling from the luma's factors) or of RGB as
    it is (photometric 2), abbreviated: its tables in the JPEGTables tag
    (347), the first strip's (every strip's are the same)."""
    h, w, _ = rgb.shape
    qt = [quant_table(False, quality), quant_table(True, quality)]
    tq = [0, 1, 1]
    strips, tables = [], None
    for y in range(0, h, rows_per_strip):
        part = rgb[y:y + rows_per_strip]
        planes = (ycc_planes(part) if photometric == 6
                  else [part[..., i].astype(np.float64) for i in range(3)])
        coefs = jpeg_coefficients(planes, factors, qt, tq)
        stream = write_jpeg(coefs, qt, tq, factors, w, part.shape[0],
                            [((0, 1, 2), 0, 63, 0, 0)], jfif=False)
        segs, rest = _split_tables(stream)
        tables = tables or b"\xff\xd8" + segs + b"\xff\xd9"
        strips.append(b"\xff\xd8" + rest)
    more = {347: (7, list(tables))}
    if photometric == 6:
        more[530] = (3, list(factors[0]))
    return write_tiff(rgb, compression=7, photometric=photometric,
                      rows_per_strip=rows_per_strip, chunks=strips,
                      tags=more)


def gif_lzw(indices, min_code_size, clear_every=None,
            no_clear_when_full=False):
    """GIF LZW codes of a flat index sequence, packed LSB first: a Clear
    code first, the code width growing as the decoder's does, a Clear
    again each ``clear_every`` codes (or when the table fills at 4096),
    End last. ``no_clear_when_full`` keeps coding with a full table and
    12-bit codes, adding no entry (the deferred clear GIF allows)."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    codes, table, nxt, width = [clear], {}, end + 1, min_code_size + 1
    widths = [width]
    prefix, emitted = None, 0
    for v in [int(i) for i in indices] + [None]:
        if prefix is None:
            prefix = (v,)
            continue
        cand = prefix + (v,) if v is not None else None
        if cand is not None and cand in table:
            prefix = cand
            continue
        codes.append(prefix[0] if len(prefix) == 1 else table[prefix])
        widths.append(width)
        emitted += 1
        if v is None:
            break
        if nxt < 4096:
            table[cand] = nxt
            nxt += 1
            if nxt > 1 << width and width < 12:
                width += 1
        if (nxt >= 4096 and not no_clear_when_full) or (
                clear_every and emitted % clear_every == 0):
            codes.append(clear)
            widths.append(width)
            table, nxt, width = {}, end + 1, min_code_size + 1
        prefix = (v,)
    codes.append(end)
    widths.append(width)
    acc = nbits = 0
    out = bytearray()
    for c, w in zip(codes, widths):
        acc |= c << nbits
        nbits += w
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _gif_blocks(data):
    out = bytearray()
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out += bytes([len(part)]) + part
    return bytes(out + b"\0")


def write_gif(frames, width, height, global_palette=None, background=0,
              version=b"GIF89a", loop=None):
    """GIF bytes of frames, each a dict: ``indices`` (h, w) uint8, and
    optionally ``left``, ``top``, ``palette`` (a local table, (n, 3) with
    n a power of two from 2 to 256), ``interlace``, ``transparent`` (an
    index), ``disposal`` (0-3), ``min_code_size``, ``clear_every``,
    ``no_clear_when_full`` (see gif_lzw). A Graphic Control Extension is
    written for a frame with ``transparent`` or ``disposal``."""
    out = bytearray(version)
    flags = 0
    if global_palette is not None:
        n = len(global_palette)
        flags = 0x80 | 0x70 | (n.bit_length() - 2)
    out += struct.pack("<HHBBB", width, height, flags, background, 0)
    if global_palette is not None:
        out += np.asarray(global_palette, np.uint8).tobytes()
    if loop is not None:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) \
            + b"\0"
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        h, w = idx.shape
        if "transparent" in f or "disposal" in f:
            packed = (f.get("disposal", 0) << 2) | int("transparent" in f)
            out += b"\x21\xf9\x04" + struct.pack(
                "<BHB", packed, 10, f.get("transparent", 0)) + b"\0"
        flags = 0
        if f.get("palette") is not None:
            flags |= 0x80 | (len(f["palette"]).bit_length() - 2)
        if f.get("interlace"):
            flags |= 0x40
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0),
                                     f.get("top", 0), w, h, flags)
        if f.get("palette") is not None:
            out += np.asarray(f["palette"], np.uint8).tobytes()
        rows = idx
        if f.get("interlace"):
            order = (list(range(0, h, 8)) + list(range(4, h, 8))
                     + list(range(2, h, 4)) + list(range(1, h, 2)))
            rows = idx[order]
        mcs = f.get("min_code_size", max(2, int(idx.max()).bit_length()))
        out += bytes([mcs]) + _gif_blocks(gif_lzw(
            rows.reshape(-1), mcs, f.get("clear_every"),
            f.get("no_clear_when_full", False)))
    return bytes(out + b"\x3b")


def _ras_rle(data):
    """Sun raster byte encoding: a run of 3 or more (or any run of 0x80)
    as 0x80, count - 1, value; a lone 0x80 as 0x80 0x00."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        n = j - i
        if n >= 3 or data[i] == 0x80:
            if n == 1:
                out += b"\x80\x00"
            else:
                out += bytes([0x80, n - 1, data[i]])
        else:
            out += bytes(data[i:j])
        i = j
    return bytes(out)


def write_sunras(pixels, depth, ras_type=1, colormap=None, length=None):
    """Sun raster bytes of (h, w) indices (depth 1 or 8) or (h, w, 3) RGB
    (depth 24: stored B, G, R, or R, G, B for type 3; depth 32: X, B, G,
    R): type 0 (old), 1 (standard), 2 (byte-encoded) or 3 (RGB); a
    colormap (n, 3) RGB written as its R, G and B planes; each row padded
    to 16 bits (the padding encoded with the row in type 2)."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    if depth == 1:
        rows = pack_rows(px[..., None], 1)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, w)
    elif depth == 24:
        rows = (px if ras_type == 3 else px[..., ::-1]).reshape(h, w * 3)
    else:
        rows = np.concatenate([np.zeros((h, w, 1), np.uint8),
                               px[..., ::-1]], -1).reshape(h, w * 4)
    rows = np.asarray(rows, np.uint8)
    if rows.shape[1] % 2:
        rows = np.pad(rows, ((0, 0), (0, 1)))
    body = rows.tobytes()
    if ras_type == 2:
        body = _ras_rle(body)
    cmap = b""
    if colormap is not None:
        cmap = np.asarray(colormap, np.uint8).T.tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth,
                       len(body) if length is None else length, ras_type,
                       1 if colormap is not None else 0, len(cmap))
    return head + cmap + body


def write_pfm(values, scale=-1.0, header=None):
    """PFM bytes of (h, w, 3) or (h, w) float32 values (PF or Pf), rows
    bottom to top, little-endian for a negative scale, big-endian for a
    positive one."""
    v = np.asarray(values, np.float32)
    h, w = v.shape[:2]
    kind = b"PF" if v.ndim == 3 else b"Pf"
    order = "<f4" if scale < 0 else ">f4"
    if header is None:
        header = kind + b"\n%d %d\n%s\n" % (w, h, repr(float(scale)).encode())
    return header + v[::-1].astype(order).tobytes()


def float_to_rgbe(rgb):
    """(h, w, 4) RGBE bytes of (h, w, 3) float values (Walter's
    float2rgbe: the mantissas of the largest channel's frexp)."""
    v = np.asarray(rgb, np.float64)
    m = v.max(-1)
    mant, exp = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.where(m > 0, m, 1), 0)
    out = np.zeros(v.shape[:2] + (4,), np.uint8)
    out[..., :3] = (v * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(m > 1e-32, exp + 128, 0)
    return out


def _hdr_new_rle(line):
    """One new-style RLE scanline of (w, 4) RGBE bytes: 2, 2, w >> 8,
    w & 255, then each channel as runs (128 + n, v) and dumps (n, ...)."""
    w = len(line)
    out = bytearray([2, 2, w >> 8, w & 255])
    for c in range(4):
        ch = line[:, c]
        i = 0
        while i < w:
            j = i
            while j < w and ch[j] == ch[i] and j - i < 127:
                j += 1
            if j - i >= 3:
                out += bytes([128 + j - i, ch[i]])
                i = j
                continue
            k = i
            while k < w and k - i < 128:
                if k + 2 < w and ch[k] == ch[k + 1] == ch[k + 2]:
                    break
                k += 1
            out += bytes([k - i]) + ch[i:k].tobytes()
            i = k
    return bytes(out)


def _hdr_old_rle(line):
    """One old-style (Radiance 1) scanline: a pixel repeated as the pixel
    then (1, 1, 1, count) markers, count < 256."""
    out, i, w = bytearray(), 0, len(line)
    while i < w:
        j = i + 1
        while j < w and (line[j] == line[i]).all() and j - i < 255:
            j += 1
        out += line[i].tobytes()
        if j - i > 2:
            out += bytes([1, 1, 1, j - i - 1])
        else:
            out += line[i + 1:j].tobytes()
        i = j
    return bytes(out)


def write_hdr(rgbe, rle="new", header=None, magic=b"#?RADIANCE"):
    """Radiance HDR bytes of (h, w, 4) RGBE bytes: the header (``magic``,
    FORMAT=32-bit_rle_rgbe, a blank line, -Y h +X w) unless ``header`` is
    given, then the scanlines flat (``rle`` "flat"), old-style RLE ("old")
    or new-style RLE ("new")."""
    px = np.asarray(rgbe, np.uint8)
    h, w = px.shape[:2]
    if header is None:
        header = (magic + b"\nSOFTWARE=writers.py\nFORMAT=32-bit_rle_rgbe"
                  b"\n\n-Y %d +X %d\n" % (h, w))
    lines = {"flat": lambda line: line.tobytes(), "old": _hdr_old_rle,
             "new": _hdr_new_rle}[rle]
    return header + b"".join(lines(px[y]) for y in range(h))


def jp2_box(kind, body):
    """A JP2 box of ``kind`` (4 bytes) holding ``body``."""
    return struct.pack(">I4s", 8 + len(body), kind) + body


def jp2_wrap(codestream, enumcs=16, extra=b"", colr=None, nc=3, h=48, w=64):
    """A JP2 file of a raw J2K codestream: the signature, ftyp, jp2h (ihdr,
    the colr box of enumerated colour space ``enumcs``, or the ``colr``
    bytes given (b"" for none), then the ``extra`` boxes) and jp2c."""
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    if colr is None:
        colr = jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (jp2_box(b"jP  ", b"\r\n\x87\n")
            + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + jp2_box(b"jp2h", ihdr + colr + extra)
            + jp2_box(b"jp2c", codestream))


def siz_fields(codestream, comp, prec=None, sgnd=None, dx=None):
    """The J2K codestream with component ``comp``'s SIZ precision,
    signedness or horizontal subsampling changed."""
    data = bytearray(codestream)
    at = 42 + 3 * comp                  # SOC, SIZ, Lsiz .. Csiz, then Ssiz
    p = (data[at] & 0x7F) + 1 if prec is None else prec
    s = data[at] >> 7 if sgnd is None else sgnd
    data[at] = s << 7 | (p - 1)
    if dx:
        data[at + 1] = dx
    return bytes(data)
