"""The host pixel work of the data path without a hard dependency on cv2
(the port's own module; the JAX package does this with cv2).

- ``read_image_rgb``: cv2 where it imports (the only JPEG decoder there
  could be); otherwise PNG decoded here with zlib and numpy (8-bit gray, RGB
  and RGBA, not interlaced, all five row filters). Anything else raises an
  error that names the file; no image is ever substituted.
- ``resize_linear``: cv2.resize(INTER_LINEAR) of uint8 images and masks in
  cv2's fixed-point arithmetic (11-bit weights, the vertical pass on rows
  >> 4 with a rounding >> 2), bit-exact; ``resize_linear_f32`` the float32
  resize of a tensor's maps, on its device, within one float32 rounding.
- the classify augmentations' pixel work: ``gaussian_blur3_u8``
  (cv2.GaussianBlur 3x3, sigma 0), ``equalize_hist_u8`` (cv2.equalizeHist)
  and ``rotation_matrix_2d`` (cv2.getRotationMatrix2D), each bit-exact
  against cv2 5.0 (tests/test_torch_cls_data.py).
- ``warp_affine`` / ``warp_perspective``: cv2.warpAffine /
  cv2.warpPerspective with INTER_LINEAR and a constant border, in numpy,
  as OpenCV 5 computes them: the forward matrix inverted in float64, each
  output pixel's source coordinate (a fused multiply-add) and its
  bilinear blend in float32,
  corners outside the image blending in as the border value, the result
  rounded half to even. (OpenCV 4 cut the coordinate to 1/32 px and the
  weights to 15 bits.) Against OpenCV 5.0 ~5 values in 1e6 differ, by
  one level (the blend's float32 rounding order; tests/test_torch_mosaic.py).
- the segment masks' pixel work, as the JAX package does it with cv2:
  ``fill_poly`` (cv2.fillPoly of one polygon, 8-connected), ``warp_affine``
  / ``warp_perspective`` with ``nearest=True`` (INTER_NEAREST, the mapped
  coordinate rounded half to even), ``resize_linear`` of a uint8 (H, W)
  mask (its ids blend, as through cv2) and INTER_NEAREST's indices
  (``nearest_indices``: src = floor(dst / (dst_n / src_n))).
  Against cv2 5.0 (tests/test_torch_seg_data.py): fill_poly (vertices in
  or out of the mask), both resizes and the affine warp bit-exact; the
  perspective warp off on ~2e-7 of the pixels (a coordinate on a .5
  boundary rounded the other way after the division).
- ``rgb_to_hsv_u8`` / ``hsv_to_rgb_u8``: OpenCV's 8-bit HSV (H in [0, 180)),
  with its fixed-point division tables one way and its float formula the
  other, evaluated once a process for every 8-bit input into a table, so
  that a conversion is one gather (numpy's elementwise passes took ~50 ms
  for a 640x480 image on one host core; cv2 takes under 1 ms).
"""

from __future__ import annotations

import struct
import threading
import zlib
from typing import Dict

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}      # PNG colour type -> samples a pixel


def read_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image file."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"failed to read image {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    with open(path, "rb") as f:
        data = f.read()
    return decode_png_rgb(data, path)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left a, up b and upper-left c (int16)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftypes: np.ndarray, lines: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Scanlines of None, Sub and Up filters reconstructed row by row."""
    out = np.empty_like(lines)
    prev = np.zeros(lines.shape[1], np.uint8)
    for y, ftype in enumerate(ftypes.tolist()):
        line = lines[y]
        if ftype == 1:      # Sub: a running sum per channel, mod 256
            line = line.reshape(-1, bpp).cumsum(0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            line = line + prev
        prev = out[y] = line
    return out


def _unfilter_diagonals(ftypes: np.ndarray, lines: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Scanlines of any filters, Average and Paeth among them, reconstructed
    together along the anti-diagonals x + y = d of the pixel grid: a
    pixel's predictor reads its left, upper and upper-left neighbours, which
    lie on the two diagonals before its own, so h + w - 1 numpy steps over
    a diagonal's pixels replace a loop over every byte."""
    h, stride = lines.shape
    w = stride // bpp
    # the grid skewed: pixel (y, x) at [x + y + 2, y + 1], so that a
    # diagonal's pixels are contiguous; the zeros before both axes are the
    # neighbours outside the image
    yy, xx = np.mgrid[0:h, 0:w]
    skew = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    raw = np.zeros_like(skew)
    raw[xx + yy + 2, yy + 1] = lines.reshape(h, w, bpp)
    rows = {f: np.concatenate([[0], ftypes == f]).astype(np.int16)[:, None]
            for f in range(1, 5) if (ftypes == f).any()}
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1) + 1, min(h - 1, d) + 2
        left, up = skew[d + 1, y0:y1], skew[d + 1, y0 - 1:y1 - 1]
        acc = raw[d + 2, y0:y1].copy()
        for f, row in rows.items():
            if f == 1:
                pred = left
            elif f == 2:
                pred = up
            elif f == 3:
                pred = (left + up) >> 1
            else:
                pred = _paeth(left, up, skew[d, y0 - 1:y1 - 1])
            acc += row[y0:y1] * pred
        skew[d + 2, y0:y1] = acc & 0xFF
    return skew[xx + yy + 2, yy + 1].reshape(h, stride).astype(np.uint8)


def decode_png_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit gray, RGB or RGBA PNG that is not
    interlaced (gray repeated to three channels, alpha dropped, as
    cv2.imread(IMREAD_COLOR) returns them)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file; JPEG and the other "
                         f"formats need cv2")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"{name}: PNG with bit depth {depth}, colour type {color}, "
            f"interlace {interlace}; without cv2 only 8-bit gray, RGB and "
            f"RGBA that are not interlaced are read")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: PNG image data has {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    ftypes = rows[:, 0]
    if ftypes.max() > 4:
        raise ValueError(f"{name}: PNG filter type {ftypes.max()} does not "
                         f"exist")
    unfilter = (_unfilter_diagonals if (ftypes >= 3).any()
                else _unfilter_rows)
    img = unfilter(ftypes, rows[:, 1:], bpp).reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


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

    color = {v: k for k, v in _CHANNELS.items()}[bpp]
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def _sample_linear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                   border: int) -> np.ndarray:
    """Bilinear samples of img (H, W[, C]) uint8 at float32 source
    coordinates, as OpenCV 5's warps take them: blended in float32 along x,
    then along y, a corner outside the image taking ``border``, rounded half
    to even."""
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    a = (sx - x0)[..., None]
    b = (sy - y0)[..., None]
    lim = 1 << 20       # far outside any image, inside int32
    x0 = np.clip(x0, -lim, lim).astype(np.int64)
    y0 = np.clip(y0, -lim, lim).astype(np.int64)

    def corner(dy, dx):
        cy, cx = y0 + dy, x0 + dx
        ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        v = src[np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)]
        return np.where(ok[..., None], v, border).astype(np.float32)

    p00, p01 = corner(0, 0), corner(0, 1)
    p10, p11 = corner(1, 0), corner(1, 1)
    top = p00 + a * (p01 - p00)
    bot = p10 + a * (p11 - p10)
    out = np.rint(top + b * (bot - top))
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


def _grid(out_w: int, out_h: int):
    return (np.arange(out_w, dtype=np.float32)[None, :],
            np.arange(out_h, dtype=np.float32)[:, None])


def _source(row: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """One source coordinate (h, w) of a warp for the float32 matrix row
    (m0, m1, m2), as OpenCV 5 computes it: fma(m0, x, m1 y + m2), one
    rounding to float32 after the fused multiply-add (the float32 product
    is exact in float64)."""
    x, y = _grid(out_w, out_h)
    inner = (row[1] * y + row[2]).astype(np.float64)
    return (np.float64(row[0]) * x.astype(np.float64)
            + inner).astype(np.float32)


def warp_affine(img: np.ndarray, M: np.ndarray, out_w: int, out_h: int,
                border: int = 114, nearest: bool = False) -> np.ndarray:
    """cv2.warpAffine(img, M, (out_w, out_h), borderValue=border) with
    INTER_LINEAR (INTER_NEAREST with ``nearest``): M (2, 3) maps source to
    output pixels. It is inverted in float64, as cv2 inverts it; each
    output pixel's source coordinate is then _source's fma of the float32
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
    INTER_LINEAR (INTER_NEAREST with ``nearest``): M (3, 3) maps source to
    output pixels. Its inverse (in float64) gives each output pixel's
    homogeneous source coordinate (_source, float32), divided by its w."""
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
    (H, W) map m of a tensor (..., H, W), on the tensor's device, to within
    one float32 rounding: the taps of the uint8 resize with each fraction
    kept in float64 (cv2 5.0's float weights are the float64 fractions, not
    the float32 ones of its uint8 path), each pass's blend evaluated in
    float64 and rounded to float32. cv2's own order of products and sums is
    not known: on values in [0, 1] up to a quarter of the outputs differ
    from it, by at most 1.2e-7, one float32 step below 1
    (tests/test_torch_cls_data.py). Returns float32 (..., h, w)."""
    H, W = x.shape[-2:]
    x = x.to(torch.float32)
    if (H, W) == (h, w):
        return x.clone()

    def taps(dst, n):
        f = (np.arange(dst, dtype=np.float64) + 0.5) * (n / dst) - 0.5
        s = np.floor(f)
        return s.astype(np.int64), f - s

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(x.device)

    sx, fx = taps(w, W)
    fx = np.where((sx < 0) | (sx >= W - 1), 0.0, fx)
    sx = np.clip(sx, 0, W - 1)
    x64 = x.double()
    rows = (x64[..., dev(sx)] * dev(1 - fx)
            + x64[..., dev(np.minimum(sx + 1, W - 1))] * dev(fx))
    rows = rows.float().double()
    sy, fy = taps(h, H)
    out = (rows[..., dev(np.clip(sy, 0, H - 1)), :] * dev(1 - fy)[:, None]
           + rows[..., dev(np.clip(sy + 1, 0, H - 1)), :]
           * dev(fy)[:, None])
    return out.float()


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


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """OpenCV's HSV2RGB_b: the float formula (H scaled by 6/180, S and V by
    1/255), each channel rounded from x * 255; uint8 (..., 3) -> (..., 3)."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h, f32(6.0))            # h >= 0 for uint8 input
    sector = h.astype(np.int32)         # floor
    h -= sector
    p = v * (f32(1) - s)
    q = v * (f32(1) - s * h)
    t = v * (f32(1) - s * (f32(1) - h))
    rgb = (np.choose(sector, [v, q, p, p, t, v]),
           np.choose(sector, [t, v, v, q, p, p]),
           np.choose(sector, [p, p, t, v, v, q]))
    out = np.empty(hsv.shape, np.uint8)
    for i, c in enumerate(rgb):
        c = np.where(s == 0, v, c) * f32(255.0)
        out[..., i] = np.clip(np.rint(c), 0, 255)
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


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (H in [0, 180); larger H wraps as in OpenCV) -> uint8 RGB,
    as cv2.cvtColor(hsv, COLOR_HSV2RGB)."""
    return _convert("hsv2rgb", hsv)
