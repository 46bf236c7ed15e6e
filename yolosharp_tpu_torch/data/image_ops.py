"""The host pixel work of the data path without cv2 (the port's own module;
the JAX package does this with cv2). Each function equals its cv2 5.0
counterpart bit for bit, as cv2 computes it on an x86-64 CPU with AVX2
and FMA3 (its vector code, IPP's AVX2 code): on a CPU without them cv2
itself rounds some values otherwise.

- ``read_image_rgb``: cv2.imread(IMREAD_COLOR) -> RGB without cv2, by the
  file's magic bytes: PNG of every standard kind (gray, RGB, paletted,
  with alpha; 1 to 16 bits; Adam7 or not) inflated here with zlib and its
  rows unfiltered by the host C++ of ``csrc/png_unfilter.cpp``; baseline,
  extended sequential (of one scan or several) and progressive JPEG,
  Huffman or arithmetic-coded, gray, YCbCr, RGB, CMYK or YCCK, cut short
  or corrupt as libjpeg-turbo recovers from it, by ``jpeg.decode_jpeg_rgb``
  (libjpeg-turbo's arithmetic, its EXIF orientation applied); every BMP
  kind by ``bmp.decode_bmp_rgb``; TIFF of gray, palette, RGB, CMYK and
  YCbCr, uncompressed, LZW, Deflate, PackBits, CCITT or JPEG, by
  ``tiff.decode_tiff_rgb`` (libtiff's RGBA mapping); PNM
  and PAM by ``pnm.decode_pnm_rgb``; lossy, lossless and extended WebP by
  ``webp.decode_webp_rgb`` (host C++, ``csrc/webp_decode.cpp``); JP2 and
  raw J2K JPEG 2000 by ``jp2.decode_jp2_rgb`` (host C++,
  ``csrc/jp2_decode.cpp``: OpenJPEG's tiers 1 and 2, DWT and component
  transforms); GIF's first frame by ``gif.decode_gif_rgb`` (LZW in
  ``csrc/gif_decode.cpp``); Sun raster by ``sunras.decode_sunras_rgb``;
  PFM by ``pfm.decode_pfm_rgb``; Radiance HDR by ``hdr.decode_hdr_rgb``
  (scanlines in ``csrc/hdr_decode.cpp``). AVIF, the one kind cv2 reads
  that no decoder here takes, and anything else raise ImageReadError (a
  FileNotFoundError and a ValueError) that names the file and what it is;
  no image is ever substituted.
- ``resize_linear``: cv2.resize(INTER_LINEAR) of uint8 images and masks in
  cv2's fixed-point arithmetic (11-bit weights, the vertical pass on rows
  >> 4 with a rounding >> 2); ``resize_linear_f32`` the float32 resize of
  a tensor's maps, on its device (IPP's fused blends where both source
  sides exceed one pixel, OpenCV's own resize otherwise).
- the classify augmentations' pixel work: ``gaussian_blur3_u8``
  (cv2.GaussianBlur 3x3, sigma 0), ``equalize_hist_u8`` (cv2.equalizeHist)
  and ``rotation_matrix_2d`` (cv2.getRotationMatrix2D)
  (tests/test_torch_cls_data.py).
- ``warp_affine`` / ``warp_perspective``: cv2.warpAffine /
  cv2.warpPerspective with INTER_LINEAR and a constant border, in numpy,
  as OpenCV 5's warp kernels compute them: the forward matrix inverted in
  float64, each output pixel's source coordinate a fused multiply-add in
  float32 (formed in one order in the 16-pixel vector steps of a row and
  in another in its scalar tail), the bilinear blend fused multiply-adds
  in float32, corners outside the image blending in as the border value,
  the result rounded half to even (tests/test_torch_mosaic.py).
- the segment masks' pixel work, as the JAX package does it with cv2:
  ``fill_poly`` (cv2.fillPoly of one polygon, 8-connected), ``warp_affine``
  / ``warp_perspective`` with ``nearest=True`` (INTER_NEAREST, the mapped
  coordinate rounded half to even), ``resize_linear`` of a uint8 (H, W)
  mask (its ids blend, as through cv2) and INTER_NEAREST's indices
  (``nearest_indices``: src = floor(dst / (dst_n / src_n)))
  (tests/test_torch_seg_data.py; fill_poly with vertices in or out of the
  mask).
- ``rgb_to_hsv_u8`` / ``hsv_to_rgb_u8``: OpenCV's 8-bit HSV (H in [0, 180)),
  with its fixed-point division tables one way and its float formula the
  other, evaluated once a process for every 8-bit input into a table, so
  that a conversion is one gather (numpy's elementwise passes took ~50 ms
  for a 640x480 image on one host core; cv2 takes under 1 ms).
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Dict

import numpy as np
import torch

from ..kernels.build import load_host
from . import gif, hdr, jp2, jpeg, pfm, pnm, sunras, tiff, webp
from .bmp import BMP_SIGNATURE, decode_bmp_rgb
from .errors import ImageReadError

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_PNG_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")
# the seven Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def read_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG, JPEG, BMP, TIFF, PNM / PAM, WebP, JPEG
    2000, GIF, Sun raster, PFM or Radiance HDR file, as
    cv2.cvtColor(cv2.imread(path, IMREAD_COLOR), COLOR_BGR2RGB)
    gives it (an EXIF or TIFF orientation applied), told apart by its
    first bytes as cv2 tells them apart, whatever the file's name. A file
    cv2 reads through its codecs' recovery (a JPEG cut short or with
    restart markers out of order, an LZW strip that ends short) reads the
    same. What cv2.imread returns None for, and the kinds no decoder here
    takes (jpeg.py's, tiff.py's and jp2.py's docstrings list them), raise
    ImageReadError naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return decode_png_rgb(data, path)
    if data[:2] == jpeg.SOI:
        return jpeg.decode_jpeg_rgb(data, path)
    if data[:2] == BMP_SIGNATURE:
        return decode_bmp_rgb(data, path)
    if data[:4] in tiff.TIFF_SIGNATURES + tiff.BIGTIFF_SIGNATURES:
        return tiff.decode_tiff_rgb(data, path)
    if pnm.is_pnm(data):
        return pnm.decode_pnm_rgb(data, path)
    if webp.is_webp(data):
        return webp.decode_webp_rgb(data, path)
    if jp2.is_jpeg2000(data):
        return jp2.decode_jp2_rgb(data, path)
    if gif.is_gif(data):
        return gif.decode_gif_rgb(data, path)
    if sunras.is_sunras(data):
        return sunras.decode_sunras_rgb(data, path)
    if pfm.is_pfm(data):
        return pfm.decode_pfm_rgb(data, path)
    if hdr.is_hdr(data):
        return hdr.decode_hdr_rgb(data, path)
    raise ImageReadError(f"{path}: not a PNG, JPEG, BMP, TIFF, PNM, PAM or "
                         f"WebP file, nor a JPEG 2000, GIF, Sun raster, PFM "
                         f"or HDR one (cv2.imread reads AVIF too; the port "
                         f"does not yet)")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left a, up b and upper-left c (int16)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_samples(rows: np.ndarray, width: int, depth: int,
                 channels: int) -> np.ndarray:
    """(h, width, channels) 8-bit samples of unfiltered PNG rows (h,
    stride): a 16-bit sample's high byte (libpng's png_set_strip_16), the
    packed 1-, 2- or 4-bit values unpacked (one channel)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, width, channels, 2)[..., 0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    return tiff.unpack_bits(rows, depth, width)[..., None]


def decode_png_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG of any standard kind, as
    cv2.imread(IMREAD_COLOR) returns it through libpng: gray (1, 2 and
    4 bits scaled to 8 as png_set_expand_gray_1_2_4_to_8 scales them) and
    gray + alpha repeated to three channels, paletted (1-8 bits) through
    its PLTE (tRNS ignored), alpha dropped, 16-bit samples as their high
    byte, Adam7-interlaced images put together from their seven passes,
    an eXIf chunk's orientation applied. A critical chunk whose CRC fails,
    image data that does not inflate to the image's size, and any other
    header raise, naming the file."""
    if data[:8] != PNG_SIGNATURE:
        raise ImageReadError(f"{name}: not a PNG file")
    pos, idat, header, orientation, palette = 8, [], None, 1, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        if kind in _PNG_CRITICAL and (
                len(data) < pos + 12 + length or zlib.crc32(
                    data[pos + 4:pos + 8 + length]) != struct.unpack(
                    ">I", data[pos + 8 + length:pos + 12 + length])[0]):
            raise ImageReadError(f"{name}: PNG chunk {kind.decode()} is corrupt "
                             f"(its CRC does not match, or it is cut short)")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)      # libpng's 256 slots
            n = min(length // 3, 256)
            palette[:n] = np.frombuffer(chunk, np.uint8, 3 * n).reshape(n, 3)
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"eXIf":
            orientation = jpeg.exif_orientation(chunk)
        elif kind == b"IEND":
            break
    if header is None:
        raise ImageReadError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, color, comp, filt, interlace = header
    if (depth not in _PNG_DEPTHS.get(color, ()) or comp or filt
            or interlace > 1 or w == 0 or h == 0):
        raise ImageReadError(
            f"{name}: PNG with bit depth {depth}, colour type {color}, "
            f"interlace {interlace} is not a PNG kind that is read")
    if color == 3 and palette is None:
        raise ImageReadError(f"{name}: paletted PNG without a PLTE chunk")
    channels = _CHANNELS[color]
    bpp = max(1, depth * channels // 8)
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as err:
        raise ImageReadError(f"{name}: PNG image data is corrupt ({err})") \
            from None
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [((w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy)
             for x0, y0, dx, dy in passes]
    strides = [(pw * depth * channels + 7) // 8 for pw, _ in sizes]
    need = sum(ph * (st + 1) for (pw, ph), st in zip(sizes, strides) if pw)
    if raw.size != need:
        raise ImageReadError(f"{name}: PNG image data has {raw.size} bytes, "
                         f"expected {need}")
    img = np.empty((h, w, channels), np.uint8)
    unfilter = load_host("png_unfilter").ys_png_unfilter
    at = 0
    for (x0, y0, dx, dy), (pw, ph), stride in zip(passes, sizes, strides):
        if pw == 0 or ph == 0:
            continue                 # an empty pass has no bytes at all
        part = raw[at:at + ph * (stride + 1)]
        rows = np.empty((ph, stride), np.uint8)
        bad = unfilter(part.ctypes.data_as(ctypes.c_void_p), ph, stride, bpp,
                       rows.ctypes.data_as(ctypes.c_void_p))
        if bad:
            raise ImageReadError(f"{name}: PNG filter type "
                             f"{part[(bad - 1) * (stride + 1)]} does not "
                             f"exist")
        img[y0::dy, x0::dx] = _png_samples(rows, pw, depth, channels)
        at += ph * (stride + 1)
    if color == 3:
        img = palette[img[..., 0]]
    elif color in (0, 4):
        gray = img[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        img = np.repeat(gray[..., None], 3, axis=2)
    else:
        img = img[..., :3]
    return jpeg.apply_orientation(img, orientation)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit gray (H, W), RGB or RGBA (H, W, 3 or 4) uint8 image as PNG
    bytes, each row filtered as libpng's adaptive filtering picks: the
    filter whose output has the least sum of bytes taken as signed. Writes
    datasets where cv2 is absent."""
    img = img[..., None] if img.ndim == 2 else img
    h, w, bpp = img.shape
    x = img.reshape(h, w * bpp).astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, bpp:] = x[:, :-bpp]
    b[1:] = x[:-1]
    c[1:, bpp:] = x[:-1, :-bpp]
    filtered = np.stack([x, x - a, x - b, x - ((a + b) >> 1),
                         x - _paeth(a, b, c)]).astype(np.uint8)
    cost = np.abs(filtered.astype(np.int8).astype(np.int32)).sum(-1)
    ftypes = cost.argmin(0)
    raw = np.concatenate([ftypes[:, None].astype(np.uint8),
                          filtered[ftypes, np.arange(h)]], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def _round_to_odd(s, p, c, int64, where):
    """The float64 sum s = p + c moved to its odd neighbour where it is
    inexact (its TwoSum error e is not 0) and its last bit even: rounded
    to float32 it then rounds as the exact sum would."""
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(int64)
    # bits + 1 makes |s| larger, whatever its sign
    odd = where((e > 0) == (s > 0), bits + 1, bits - 1)
    return where((e != 0) & (bits & 1 == 0), odd, bits)


def _fma32_t(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors, on their device, as the CPU's fused
    multiply-add rounds it, once, to float32 (the product is exact in
    float64; _round_to_odd makes the rounding of the sum single)."""
    p, c = a.double() * b.double(), c.double()
    bits = _round_to_odd(p + c, p, c, torch.int64, torch.where)
    return bits.view(torch.float64).float()


# the float64 bits below a float32's last bit: 1000...0 is a midpoint
# between two float32 values, where rounding twice can go wrong
_BELOW_F32 = (1 << 29) - 1
_MIDPOINT = 1 << 28


def _fma32(a, b, c) -> np.ndarray:
    """_fma32_t of float32 arrays, broadcast as numpy does: the float64 sum
    is rounded to float32 directly except where it lies on a midpoint of
    two float32 values (the only place where a second rounding differs
    from one), and there made single by _round_to_odd."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    flat = s.reshape(-1)
    mid = np.flatnonzero(flat.view(np.int64) & _BELOW_F32 == _MIDPOINT)
    if mid.size:
        p, c = (np.broadcast_to(v, s.shape).reshape(-1)[mid] for v in (p, c))
        flat[mid] = _round_to_odd(flat[mid], p, c, np.int64,
                                  np.where).view(np.float64)
    return s.astype(np.float32)


def _sample_linear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                   border: int) -> np.ndarray:
    """Bilinear samples of img (H, W[, C]) uint8 at float32 source
    coordinates, as OpenCV 5's warps take them: p0 + a (p1 - p0) a fused
    multiply-add in float32, along x and then along y, a corner outside the
    image taking ``border``, rounded half to even."""
    h, w = img.shape[:2]
    # two pixels of border around the image: a corner clipped to it is
    # outside, and a pair of corners clipped together stays outside
    src = np.pad(img.reshape(h, w, -1), ((2, 2), (2, 2), (0, 0)),
                 constant_values=border)
    src = src.reshape(-1, src.shape[-1])
    with np.errstate(invalid="ignore"):
        fx = np.floor(sx)
        fy = np.floor(sy)
        a = (sx - fx)[..., None]
        b = (sy - fy)[..., None]
        x0 = np.clip(np.nan_to_num(fx, nan=-2), -2, w).astype(np.int64) + 2
        y0 = np.clip(np.nan_to_num(fy, nan=-2), -2, h).astype(np.int64) + 2
    i00 = y0 * (w + 4) + x0
    p00, p01, p10, p11 = (src[i00 + k].astype(np.float32)
                          for k in (0, 1, w + 4, w + 5))
    top = _fma32(a, p01 - p00, p00)
    bot = _fma32(a, p11 - p10, p10)
    out = np.rint(_fma32(b, bot - top, top))
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        sx.shape + img.shape[2:])


def _sample_nearest(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                    border: int) -> np.ndarray:
    """Samples of img (H, W[, C]) at float32 source coordinates rounded half
    to even (cv2's INTER_NEAREST warps), ``border`` outside the image."""
    h, w = img.shape[:2]
    lim = 1 << 20
    ix = np.clip(np.nan_to_num(np.rint(sx), nan=-lim), -lim, lim)
    iy = np.clip(np.nan_to_num(np.rint(sy), nan=-lim), -lim, lim)
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    v = img[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
    ok = ok.reshape(ok.shape + (1,) * (v.ndim - ok.ndim))
    return np.where(ok, v, border).astype(img.dtype)


def _sample(img, sx, sy, border, nearest):
    return (_sample_nearest if nearest else _sample_linear)(img, sx, sy,
                                                           border)


# OpenCV 5's warp kernels step 2 vectors of float32 lanes an iteration (16
# output pixels in its AVX2 code, which it dispatches on any x86-64 CPU
# with AVX2 and FMA3; its AVX-512 build of them is not used) and finish a
# row's last out_w % 16 pixels in scalar code, which forms the coordinate
# in another order
_WARP_STEP = 16


def _source(row: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """One source coordinate (h, w) of a warp for the float32 matrix row
    (m0, m1, m2), as OpenCV 5's kernels form it: fma(m0, x, m1 y + m2) (the
    row's term in float32) in the vector steps; (fma(x, m0, m1 y)) + m2 in
    the scalar tail of each row."""
    x = np.arange(out_w, dtype=np.float32)[None, :]
    y = np.arange(out_h, dtype=np.float32)[:, None]
    vec = _fma32(row[0], x, row[1] * y + row[2])
    tail = _fma32(x, row[0], row[1] * y) + row[2]
    return np.where(x < out_w - out_w % _WARP_STEP, vec, tail)


def warp_affine(img: np.ndarray, M: np.ndarray, out_w: int, out_h: int,
                border: int = 114, nearest: bool = False) -> np.ndarray:
    """cv2.warpAffine(img, M, (out_w, out_h), borderValue=border) with
    INTER_LINEAR (INTER_NEAREST with ``nearest``), bit-exact: M (2, 3) maps
    source to output pixels. It is inverted in float64, as cv2 inverts it;
    each output pixel's source coordinate is then _source's of the float32
    inverse."""
    m = np.asarray(M, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    mi = np.array([[a11, a12, b1], [a21, a22, b2]], np.float32)
    return _sample(img, _source(mi[0], out_w, out_h),
                   _source(mi[1], out_w, out_h), border, nearest)


def warp_perspective(img: np.ndarray, M: np.ndarray, out_w: int,
                     out_h: int, border: int = 114,
                     nearest: bool = False) -> np.ndarray:
    """cv2.warpPerspective(img, M, (out_w, out_h), borderValue=border) with
    INTER_LINEAR (INTER_NEAREST with ``nearest``), bit-exact: M (3, 3) maps
    source to output pixels. Its inverse (in float64) gives each output
    pixel's homogeneous source coordinate (_source, float32), divided by
    its w."""
    mi = np.linalg.inv(np.asarray(M, np.float64)).astype(np.float32)
    X, Y, W = (_source(mi[r], out_w, out_h) for r in range(3))
    with np.errstate(divide="ignore", invalid="ignore"):
        return _sample(img, X / W, Y / W, border, nearest)


def _linear_taps(dst: int, src: int):
    """cv2.resize INTER_LINEAR's taps along one axis: the first source index
    and its float32 fraction, (dst + 0.5) * src / dst - 0.5 in float64 cut
    to float32."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst)
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _fixed(f: np.ndarray) -> np.ndarray:
    """A float32 weight as cv2's 11-bit fixed point (round half to even)."""
    return np.rint(f * np.float32(2048)).astype(np.int32)


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a uint8
    (H, W) or (H, W, C) array, bit-exact: the horizontal pass sums two
    pixels times 11-bit weights (the edge taps clamped to one pixel at
    weight 2048), the vertical pass blends those sums as cv2's uint8 kernel
    does, (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2,
    every channel alike. An id mask blends ids here, as it does through
    cv2. The integer passes run as torch ops on the CPU (its intra-op
    threads: 4-6x numpy's time at 4 threads)."""
    H, W = img.shape[:2]
    if (H, W) == (h, w):
        return img.copy()

    def cpu(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    src = cpu(img.reshape(H, W, -1)).to(torch.int32)
    sx, fx = _linear_taps(w, W)
    fx = np.where((sx < 0) | (sx >= W - 1), np.float32(0), fx)
    sx = np.clip(sx, 0, W - 1)
    a0 = cpu(_fixed(np.float32(1) - fx))[:, None]
    a1 = cpu(_fixed(fx))[:, None]
    rows = (src.index_select(1, cpu(sx)) * a0
            + src.index_select(1, cpu(np.minimum(sx + 1, W - 1))) * a1) >> 4
    sy, fy = _linear_taps(h, H)
    r0 = rows.index_select(0, cpu(np.clip(sy, 0, H - 1)))
    r1 = rows.index_select(0, cpu(np.clip(sy + 1, 0, H - 1)))
    b0 = cpu(_fixed(np.float32(1) - fy))[:, None, None]
    b1 = cpu(_fixed(fy))[:, None, None]
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8).numpy().reshape(
        (h, w) + img.shape[2:])


def resize_linear_f32(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """cv2.resize(m, (w, h), interpolation=INTER_LINEAR) of each float32
    (H, W) map m of a tensor (..., H, W), on the tensor's device,
    bit-exact. cv2 5.0 takes Intel IPP's resize where both source sides
    are > 1: taps (i + 0.5) * src / dst - 0.5 in float64, the fraction cut
    to float32 (0 at the edges), each pass p0 + f (p1 - p0) a fused
    multiply-add in float32, along x and then along y. A one-pixel side
    takes OpenCV's own resize: float32 taps, p0 (1 - f) + p1 f in float32
    without fusing, the rows' fractions kept at the edges (the clamped row
    blends with itself). Returns float32 (..., h, w)."""
    H, W = x.shape[-2:]
    x = x.to(torch.float32)
    if (H, W) == (h, w):
        return x.clone()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(x.device)

    if H > 1 and W > 1:
        def taps(dst, n):
            f = (np.arange(dst, dtype=np.float64) + 0.5) * (n / dst) - 0.5
            s = np.floor(f).astype(np.int64)
            fr = np.where((s < 0) | (s >= n - 1), 0,
                          f - s).astype(np.float32)
            s = np.clip(s, 0, n - 1)
            return dev(s), dev(np.minimum(s + 1, n - 1)), dev(fr)

        s0, s1, fx = taps(w, W)
        p0 = x[..., s0]
        rows = _fma32_t(fx, x[..., s1] - p0, p0)
        s0, s1, fy = taps(h, H)
        p0 = rows[..., s0, :]
        return _fma32_t(fy[:, None], rows[..., s1, :] - p0, p0)

    def taps32(dst, n):
        f = ((np.arange(dst, dtype=np.float64) + 0.5) * (n / dst)
             - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        return s, (f - s).astype(np.float32)

    one = np.float32(1)
    sx, fx = taps32(w, W)
    fx = np.where((sx < 0) | (sx >= W - 1), np.float32(0), fx)
    sx = np.clip(sx, 0, W - 1)
    rows = (x[..., dev(sx)] * dev(one - fx)
            + x[..., dev(np.minimum(sx + 1, W - 1))] * dev(fx))
    sy, fy = taps32(h, H)
    return (rows[..., dev(np.clip(sy, 0, H - 1)), :] * dev(one - fy)[:, None]
            + rows[..., dev(np.clip(sy + 1, 0, H - 1)), :]
            * dev(fy)[:, None])


def gaussian_blur3_u8(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), 0) of a uint8 (H, W[, C]) image: the
    kernel (1, 2, 1) / 4 along each axis, which cv2's fixed-point uint8
    path applies exactly, so the result is the 3x3 sum with weights
    (1 2 1; 2 4 2; 1 2 1) rounded half up, (s + 8) >> 4; the border
    BORDER_REFLECT_101 (numpy's "reflect")."""
    pad = ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img.astype(np.int32), pad, mode="reflect")
    rows = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]
    out = rows[:-2] + 2 * rows[1:-1] + rows[2:]
    return ((out + 8) >> 4).astype(np.uint8)


def equalize_hist_u8(img: np.ndarray) -> np.ndarray:
    """cv2.equalizeHist of a uint8 (H, W) image: the lowest present level
    maps to 0 and level v to round(cdf(v) * (255 / (n - its count))) in
    float32, rounded half to even; an image of one level stays as it is."""
    hist = np.bincount(img.ravel(), minlength=256)
    lo = int(np.flatnonzero(hist)[0])
    total = img.size
    if hist[lo] == total:
        return img.copy()
    scale = np.float32(255) / np.float32(total - hist[lo])
    cdf = np.cumsum(hist) - hist[lo]
    lut = np.clip(np.rint(cdf.astype(np.float32) * scale), 0, 255)
    lut[:lo + 1] = 0
    return lut.astype(np.uint8)[img]


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): the (2, 3) float64
    matrix of a rotation by `angle` degrees (counter-clockwise, y down)
    about `center` (taken as float32, as cv2's Point2f)."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = float(angle) * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def nearest_indices(src: int, dst: int) -> np.ndarray:
    """cv2.resize INTER_NEAREST's source index of each of dst samples along
    an axis of src: floor(i * (1 / (dst / src))) in float64, clamped to the
    last."""
    idx = np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64)
    return np.minimum(idx, src - 1)


_XY_SHIFT = 16      # cv2's fixed-point polygon coordinates


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine to the (w, h) image: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int,
           color: int) -> None:
    """cv2.line(mask, (x1, y1), (x2, y2), color) with LINE_8: clipped to the
    image, then Bresenham from the left end."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, step = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, step = -dy, -1
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err, x, y = major - 2 * minor, x1, y1
    for _ in range(major + 1):
        mask[y, x] = color
        if steep:
            y += step
            x += err < 0
        else:
            x += 1
            y += step * (err < 0)
        err += -2 * minor + (2 * major if err < 0 else 0)


def fill_poly(mask: np.ndarray, polygon: np.ndarray, color: int) -> None:
    """cv2.fillPoly(mask, [polygon], color) of one int32 polygon (n, 2) on a
    uint8 (h, w) mask, in place (8-connected, no shift): every edge drawn as
    a LINE_8 line, then each row filled between the pairs of the edges'
    crossings sorted by x, from ceil(left) to floor(right), the crossings in
    cv2's 16-bit fixed point (an edge's x steps by a truncated slope; an
    edge that leaves the image starts from its clipped line, or, where the
    clipped line is level, runs between its clipped ends at its own
    rows)."""
    h, w = mask.shape
    pts = np.asarray(polygon, np.int64).reshape(-1, 2)
    one = 1 << _XY_SHIFT
    rows, xs = [], []
    for i in range(len(pts)):
        (x0, y0), (x1, y1) = (int(v) for v in pts[i - 1]), (int(v)
                                                            for v in pts[i])
        _line8(mask, x0, y0, x1, y1, color)
        if y0 == y1:
            continue
        c0, c1 = (x0 << _XY_SHIFT, y0), (x1 << _XY_SHIFT, y1)
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            # the edge starts from its clipped line; where that line is
            # level, from its clipped x at the unclipped y
            _, a, b, c, d = _clip_line(w, h, x0, y0, x1, y1)
            if b != d:
                c0, c1 = (a << _XY_SHIFT, b), (c << _XY_SHIFT, d)
            else:
                c0, c1 = (a << _XY_SHIFT, y0), (c << _XY_SHIFT, y1)
        num, den = c1[0] - c0[0], c1[1] - c0[1]
        dx = abs(num) // abs(den) * (1 if (num >= 0) == (den > 0) else -1)
        top, start = (y0, c0) if y0 < y1 else (y1, c1)
        x_top = start[0] + (top - start[1]) * dx
        ys = np.arange(max(top, 0), min(max(y0, y1), h), dtype=np.int64)
        rows.append(ys)
        xs.append(x_top + (ys - top) * dx)
    if len(rows) < 2:
        return
    rows, xs = np.concatenate(rows), np.concatenate(xs)
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # each row crosses the closed polygon an even number of times
    r, xl, xr = rows[0::2], xs[0::2], xs[1::2]
    x1 = (xl + one - 1) >> _XY_SHIFT
    x2 = xr >> _XY_SHIFT
    keep = (x1 < w) & (x2 >= 0) & (x1 <= x2)
    r, x1, x2 = r[keep], np.maximum(x1[keep], 0), np.minimum(x2[keep], w - 1)
    runs = np.zeros((h, w + 1), np.int32)
    np.add.at(runs, (r, x1), 1)
    np.add.at(runs, (r, x2 + 1), -1)
    mask[np.cumsum(runs[:, :w], axis=1) > 0] = color


# OpenCV's RGB2HSV_b tables (hsv_shift = 12): round((255 << 12) / v) and
# round((180 << 12) / (6 * diff)), 0 at 0
_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT)
                                     / np.arange(1, 256))]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT)
                                     / (6.0 * np.arange(1, 256)))]
                       ).astype(np.int32)


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's RGB2HSV_b arithmetic, uint8 (..., 3) -> uint8 (..., 3)."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h[h < 0] += 180
    return np.stack([h, s, v], -1).astype(np.uint8)


def _hsv_to_rgb(hsv: np.ndarray, truncate: bool = True) -> np.ndarray:
    """OpenCV's HSV2RGB_b: the float formula (H scaled by 6/180, S and V by
    1/255, 1 - s h and 1 - s (1 - h) fused multiply-adds), each channel
    x * 255 truncated, as its vector loop converts it, or rounded half to
    even (``truncate=False``), as its scalar loop does; uint8 (..., 3) ->
    (..., 3)."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h, f32(6.0))            # h >= 0 for uint8 input
    sector = h.astype(np.int32)         # floor
    h -= sector
    p = v * (f32(1) - s)
    q = v * _fma32(-s, h, f32(1))
    t = v * _fma32(-s, f32(1) - h, f32(1))
    rgb = (np.choose(sector, [v, q, p, p, t, v]),
           np.choose(sector, [t, v, v, q, p, p]),
           np.choose(sector, [p, p, t, v, v, q]))
    out = np.empty(hsv.shape, np.uint8)
    for i, c in enumerate(rgb):
        c = np.where(s == 0, v, c) * f32(255.0)
        out[..., i] = np.clip(np.trunc(c) if truncate else np.rint(c), 0, 255)
    return out


_tables: Dict[str, np.ndarray] = {}
_tables_lock = threading.Lock()


def _table(name: str) -> np.ndarray:
    """Every 8-bit input's conversion, built once a process: 2^24 uint32
    (64 MiB), each the three output bytes packed as the input's index
    packs them; a conversion is then one gather."""
    with _tables_lock:
        if name not in _tables:
            every = np.arange(1 << 24, dtype=np.uint32)
            triples = np.stack([every >> 16, (every >> 8) & 255,
                                every & 255], -1).astype(np.uint8)
            fn = _rgb_to_hsv if name == "rgb2hsv" else _hsv_to_rgb
            packed = np.zeros((1 << 24, 4), np.uint8)
            for i in range(0, 1 << 24, 1 << 18):
                packed[i:i + (1 << 18), :3] = fn(triples[i:i + (1 << 18)])
            _tables[name] = packed.view(np.uint32).reshape(-1)
        return _tables[name]


def _convert(name: str, img: np.ndarray) -> np.ndarray:
    a = img.astype(np.int32)
    out = np.take(_table(name), (a[..., 0] << 16) | (a[..., 1] << 8)
                  | a[..., 2])
    return np.ascontiguousarray(
        out.view(np.uint8).reshape(*img.shape[:-1], 4)[..., :3])


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> uint8 HSV, as cv2.cvtColor(img, COLOR_RGB2HSV)."""
    return _convert("rgb2hsv", img)


# cv2's HSV2RGB_b converts 32 pixels of a row a vector step (its AVX2 code)
# and the last width % 32 of each row in scalar code, which rounds
_HSV_STEP = 32


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (H in [0, 180); larger H wraps as in OpenCV) (H, W, 3) ->
    uint8 RGB, as cv2.cvtColor(hsv, COLOR_HSV2RGB), bit-exact: the table
    of the vector loop, and the scalar loop's rounding on each row's last
    W % 32 pixels."""
    out = _convert("hsv2rgb", hsv)
    w = hsv.shape[-2]
    tail = w - w % _HSV_STEP
    if tail < w:
        out[..., tail:, :] = _hsv_to_rgb(hsv[..., tail:, :], truncate=False)
    return out
