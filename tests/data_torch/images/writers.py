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
