"""Write the committed image fixtures of this folder and their manifest:
the JPEG kinds beyond baseline (progressive, Adobe CMYK), the PNG kinds
beyond 8-bit gray / RGB / RGBA, baseline TIFF kinds, BMP kinds beyond 8-,
24- and 32-bit (1 / 4 / 16 bits, bit fields, RLE, OS/2), PNM and PAM, and
WebP (lossy, lossless, alpha, EXIF, animated, the simple loop filter, and
WebP bytes under a .jpg name).

    python tests/data_torch/images/make_fixtures.py          # missing ones
    python tests/data_torch/images/make_fixtures.py --all    # all of them
    python tests/data_torch/images/make_fixtures.py --time   # time decodes

The kinds cv2.imread reads through OpenJPEG and its own decoders: JPEG
2000 (PIL's lossless, lossy, tiled, layered files in every progression
order, gray, gray + alpha, RGBA, 16-bit, a 640x480 lossy one; cv2's own;
sYCC, palette, cdef and 12-bit JP2 boxes around PIL codestreams; the
j2k_writer.py encoder's code-block styles, SOP / EPH / POC / tile-parts
and RGN / COC / QCC; JP2 bytes under a .jpg name), GIF (writers.py's
global and local tables, interlaced, transparent, a small frame, two
frames, a full LZW table; PIL's; GIF bytes under a .png name), Sun raster
(cv2's, 1-bit with and without a colour map, 8-bit indexed, 32-bit), PFM
(both byte orders) and Radiance HDR (new-style RLE, flat, old-style RLE,
narrow), and JPEGs without DHT segments.

The kinds cv2.imread reads with libjpeg-turbo's and libtiff's recovery
and rarer codecs: JPEG cut short (baseline and progressive), without EOI,
with restart markers misnumbered or missing, progressive with low
coefficients left unrefined (block smoothing), YCCK, sequential of several
scans, arithmetic-coded (sequential with restarts, progressive); TIFF of
uncompressed YCbCr (4:2:0, 4:2:2), an LZW strip that ends short,
JPEG-in-TIFF (YCbCr, PIL's RGB, cv2's gray), CCITT (modified Huffman, T.4
2D, T.6 with FillOrder 2) and CMYK (PIL's LZW, planar).

Needs cv2 and PIL (the machines that only read the fixtures need neither):
cv2.imencode and PIL write what they write, ``writers.py`` the kinds
neither writes (Adam7 PNG, tiled, planar, big-endian, min-is-white,
old-style LZW and oriented TIFF, the BMP kinds, ASCII and odd-maxval PNM,
PAM), tests/libwebp_encode.py the VP8 options only libwebp's advanced API
sets. Each file holds the smooth synthetic content of
../jpeg/make_fixtures.py. The fixtures on disk are kept unless ``--all``
is given; the manifest is rewritten from them: its entry records how each
was written, its size, the shape of cv2.imread(IMREAD_COLOR) -> RGB and
the SHA-256 of those RGB bytes: the port's reader must give the same
bytes.
``--time`` writes nothing: it prints the host ms of the port's
read_image_rgb and of cv2.imread for each fixture (the median of 50), on
this machine's CPU."""

import hashlib
import io
import json
import os
import struct
import sys
import time

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "jpeg"))
from make_fixtures import encode, smooth_image  # noqa: E402
from writers import (BI_BITFIELDS, BI_RLE4, BI_RLE8,  # noqa: E402
                     float_to_rgbe, jp2_box, jp2_wrap, jpeg_coefficients,
                     quant_table, rle_encode, siz_fields, write_bmp,
                     write_gif, write_hdr, write_jpeg, write_jpeg_tiff,
                     write_pam, write_pfm, write_png, write_pnm, write_sunras,
                     write_tiff, ycc_planes)
from j2k_writer import (LAZY, PTERM, RESET, SEGSYM, TERMALL,  # noqa: E402
                        VSC, write_j2k)


def _pil(img, fmt, mode=None, **kw):
    bio = io.BytesIO()
    Image.fromarray(img, mode).save(bio, fmt, **kw)
    return bio.getvalue()


def _pil_image(im, **kw):
    bio = io.BytesIO()
    im.save(bio, "TIFF", **kw)
    return bio.getvalue()


def _pil_quantized(img, colors, fmt, **kw):
    bio = io.BytesIO()
    Image.fromarray(img).quantize(colors).save(bio, fmt, **kw)
    return bio.getvalue()


def _cv2(img, ext, params=()):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


def _cmyk(h, w, seed):
    """uint8 CMYK: the smooth content inverted, K from another draw."""
    rgb = smooth_image(h, w, seed)
    return np.dstack([255 - rgb, smooth_image(h, w, seed + 1)[..., 0]])


def _wide(h, w, seed):
    """uint16 RGB: the smooth content scaled to 16 bits, low bits random."""
    rng = np.random.default_rng(seed)
    return (smooth_image(h, w, seed).astype(np.uint16) * 256
            + rng.integers(0, 256, (h, w, 3)).astype(np.uint16))


# name: (how it is written, a function of the fixture's index giving bytes)
FIXTURES = {
    "cmyk_q90_96x64.jpg": (
        "PIL, Adobe CMYK (APP14 transform 0), quality 90",
        lambda i: _pil(_cmyk(64, 96, i), "JPEG", "CMYK", quality=90)),
    "cmyk_progressive_q85_80x60.jpg": (
        "PIL, Adobe CMYK, progressive, quality 85",
        lambda i: _pil(_cmyk(60, 80, i), "JPEG", "CMYK", quality=85,
                       progressive=True)),
    "progressive_q75_641x479.jpg": (
        "cv2, progressive 4:2:0, quality 75",
        lambda i: encode(smooth_image(479, 641, i), "420", 75, 0, 0, 1)),
    "progressive_pil_s422_opt_150x100.jpg": (
        "PIL, progressive 4:2:2, optimised tables, quality 85",
        lambda i: _pil(smooth_image(100, 150, i), "JPEG", quality=85,
                       progressive=True, optimize=True, subsampling=1)),
    "progressive_rst2_s444_120x80.jpg": (
        "cv2, progressive 4:4:4, restart interval 2, quality 90",
        lambda i: encode(smooth_image(80, 120, i), "444", 90, 2, 0, 1)),
    "progressive_gray_64x48.jpg": (
        "cv2, progressive grayscale, quality 80",
        lambda i: encode(smooth_image(48, 64, i)[..., 1], "gray", 80, 0, 0,
                         1)),
    "palette8_trns_64x48.png": (
        "PIL, paletted 8-bit (200 colours) with a tRNS chunk",
        lambda i: _pil_quantized(smooth_image(48, 64, i), 200, "PNG",
                                 transparency=bytes(range(0, 200)))),
    "palette4_64x48.png": (
        "PIL, paletted 4-bit",
        lambda i: _pil_quantized(smooth_image(48, 64, i), 16, "PNG", bits=4)),
    "gray1_64x48.png": (
        "PIL, 1-bit gray",
        lambda i: _pil(smooth_image(48, 64, i)[..., 0] > 128, "PNG")),
    "gray_alpha_64x48.png": (
        "PIL, 8-bit gray + alpha",
        lambda i: _pil(smooth_image(48, 64, i)[..., :2], "PNG", "LA")),
    "rgb16_64x48.png": (
        "cv2, 16-bit RGB",
        lambda i: _cv2(_wide(48, 64, i)[..., ::-1], ".png")),
    "gray16_64x48.png": (
        "cv2, 16-bit gray",
        lambda i: _cv2(_wide(48, 64, i)[..., 0], ".png")),
    "rgb_adam7_64x48.png": (
        "writers.write_png, 8-bit RGB, Adam7, random filters",
        lambda i: write_png(smooth_image(48, 64, i), 8, 2, interlace=1,
                            seed=i)),
    "gray2_adam7_52x36.png": (
        "writers.write_png, 2-bit gray, Adam7, random filters",
        lambda i: write_png(smooth_image(36, 52, i)[..., :1] >> 6, 2, 0,
                            interlace=1, seed=i)),
    "lzw_pred2_64x48.tif": (
        "PIL, RGB, LZW with the horizontal predictor",
        lambda i: _pil(smooth_image(48, 64, i), "TIFF",
                       compression="tiff_lzw", tiffinfo={317: 2})),
    "deflate_64x48.tif": (
        "PIL, RGB, Deflate (Adobe, 8)",
        lambda i: _pil(smooth_image(48, 64, i), "TIFF",
                       compression="tiff_adobe_deflate")),
    "packbits_64x48.tif": (
        "PIL, RGB, PackBits",
        lambda i: _pil(smooth_image(48, 64, i), "TIFF",
                       compression="packbits")),
    "tiled_lzw_100x70.tif": (
        "writers.write_tiff, RGB, 32x32 tiles (edge tiles cropped), LZW "
        "with the predictor",
        lambda i: write_tiff(smooth_image(70, 100, i), compression=5,
                             predictor=2, tile=(32, 32))),
    "planar_deflate_64x48.tif": (
        "writers.write_tiff, RGB, planar configuration 2, Deflate with the "
        "predictor, strips of 16 rows",
        lambda i: write_tiff(smooth_image(48, 64, i), compression=8,
                             predictor=2, planar=2, rows_per_strip=16)),
    "palette_lzw_64x48.tif": (
        "PIL, paletted 8-bit, LZW",
        lambda i: _pil_quantized(smooth_image(48, 64, i), 64, "TIFF",
                                 compression="tiff_lzw")),
    "rgba_unassoc_64x48.tif": (
        "PIL, RGBA (ExtraSamples 2, unassociated alpha), LZW",
        lambda i: _pil(np.dstack([smooth_image(48, 64, i),
                                  smooth_image(48, 64, i + 1)[..., 0]]),
                       "TIFF", "RGBA", compression="tiff_lzw")),
    "gray16_mm_miniswhite_64x48.tif": (
        "writers.write_tiff, big-endian (MM), 16-bit gray min-is-white, LZW "
        "with the predictor",
        lambda i: write_tiff(_wide(48, 64, i)[..., :1], bits=16,
                             photometric=0, big_endian=True, compression=5,
                             predictor=2)),
    "bilevel_packbits_64x48.tif": (
        "PIL, 1-bit, PackBits",
        lambda i: _pil(smooth_image(48, 64, i)[..., 0] > 128, "TIFF",
                       compression="packbits")),
    "orient3_lzw_64x48.tif": (
        "writers.write_tiff, RGB, Orientation 3, LZW, strips of 10 rows",
        lambda i: write_tiff(smooth_image(48, 64, i), compression=5,
                             orientation=3, rows_per_strip=10)),
    "lzw_old_style_64x48.tif": (
        "writers.write_tiff, RGB, old-style (LSB-first) LZW codes",
        lambda i: write_tiff(smooth_image(48, 64, i), compression=5,
                             compat=True)),
}


def _index(img, n):
    """(h, w) palette indices of `img` in n levels of its gray, and the n
    colours (B, G, R) of a palette along the content's colours."""
    gray = img.astype(np.int32).sum(-1) * n // (3 * 256)
    pal = np.stack([np.linspace(20, 250, n), np.linspace(240, 10, n),
                    (np.arange(n) * 97) % 256], -1).astype(np.uint8)
    return gray, pal


def _rle_ops(idx):
    """RLE ops of (h, w) indices (stored bottom-up) that use a delta to
    skip a run of index 0 and an end-of-line to end each row early where
    it ends in index 0."""
    ops = []
    for row in idx[::-1]:
        x, w = 0, len(row)
        end = w
        while end > 0 and row[end - 1] == 0:
            end -= 1
        while x < end:
            if row[x] == 0 and x + 3 < end and not row[x:x + 3].any():
                n = 3
                while x + n < end and row[x + n] == 0:
                    n += 1
                ops.append(("delta", n, 0))
                x += n
                continue
            n = 1
            while x + n < end and n < 255 and row[x + n] == row[x]:
                n += 1
            ops.append(("run", n, int(row[x])))
            x += n
        ops.append(("eol",))
    ops.append(("eob",))
    return ops


def _webp(img, **kw):
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "WEBP", **kw)
    return bio.getvalue()


def _exif(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()


def _animation(i):
    frames = [Image.fromarray(smooth_image(48, 64, i + k)) for k in range(3)]
    bio = io.BytesIO()
    frames[0].save(bio, "WEBP", save_all=True, append_images=frames[1:],
                   duration=100, quality=80)
    return bio.getvalue()


def _libwebp(img, **kw):
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import libwebp_encode

    return libwebp_encode.encode(img, **kw)


def _gray(i, h=48, w=64):
    return smooth_image(h, w, i)[..., 1]


FIXTURES.update({
    "bmp1_os2_64x48.bmp": (
        "writers.write_bmp, OS/2 12-byte header, 1-bit, 2 colours",
        lambda i: write_bmp(_index(smooth_image(48, 64, i), 2)[0], 1,
                            header=12, palette=_index(smooth_image(
                                48, 64, i), 2)[1])),
    "bmp4_short_palette_64x48.bmp": (
        "writers.write_bmp, 4-bit, a palette of 12 colours",
        lambda i: write_bmp(_index(smooth_image(48, 64, i), 12)[0], 4,
                            palette=_index(smooth_image(48, 64, i), 12)[1])),
    "bmp16_565_64x48.bmp": (
        "writers.write_bmp, 16-bit BI_BITFIELDS 5-6-5, 40-byte header",
        lambda i: write_bmp(_565(smooth_image(48, 64, i)), 16,
                            compression=BI_BITFIELDS,
                            masks=(0xF800, 0x7E0, 0x1F))),
    "bmp16_555_v5_topdown_64x48.bmp": (
        "writers.write_bmp, 16-bit BI_RGB (5-5-5), V5 header, top-down",
        lambda i: write_bmp(_555(smooth_image(48, 64, i)), 16, header=124,
                            top_down=True)),
    "bmp32_bitfields10_v4_64x48.bmp": (
        "writers.write_bmp, 32-bit BI_BITFIELDS 10-10-10 masks, V4 header",
        lambda i: write_bmp(_ten_bit(smooth_image(48, 64, i)), 32,
                            header=108, compression=BI_BITFIELDS,
                            masks=(0x3FF00000, 0xFFC00, 0x3FF, 0))),
    "bmp_rle8_deltas_64x48.bmp": (
        "writers.write_bmp, RLE8: runs, deltas, early end-of-lines",
        lambda i: write_bmp(np.zeros((48, 64), int), 8, compression=BI_RLE8,
                            palette=_index(smooth_image(48, 64, i), 40)[1],
                            rle=rle_encode(None, 8, _rle_ops(np.where(
                                _index(smooth_image(48, 64, i), 40)[0] < 12,
                                0, _index(smooth_image(48, 64, i), 40)[0]))))),
    "bmp_rle4_64x48.bmp": (
        "writers.write_bmp, RLE4, runs and absolute runs",
        lambda i: write_bmp(np.zeros((48, 64), int), 4, compression=BI_RLE4,
                            palette=_index(smooth_image(48, 64, i), 16)[1],
                            rle=rle_encode(_index(smooth_image(48, 64, i),
                                                  16)[0], 4))),
    "p2_maxval100_40x30.pgm": (
        "writers.write_pnm, P2 (ASCII), maxval 100, comments",
        lambda i: write_pnm(_gray(i, 30, 40) * 100 // 255, 2, 100,
                            comment="fixture", per_line=17)),
    "p3_maxval1000_40x30.ppm": (
        "writers.write_pnm, P3 (ASCII), maxval 1000",
        lambda i: write_pnm(smooth_image(30, 40, i).astype(int) * 1000 // 255,
                            3, 1000)),
    "p4_64x48.pbm": (
        "writers.write_pnm, P4 (binary bitmap)",
        lambda i: write_pnm(_gray(i) < 128, 4)),
    "p5_maxval65535_64x48.pgm": (
        "writers.write_pnm, P5, 16-bit samples",
        lambda i: write_pnm(_gray(i).astype(np.int64) * 257 + 3, 5, 65535)),
    "p6_64x48.ppm": (
        "writers.write_pnm, P6",
        lambda i: write_pnm(smooth_image(48, 64, i), 6)),
    "pam_rgb_64x48.pam": (
        "writers.write_pam, TUPLTYPE RGB, MAXVAL 255",
        lambda i: write_pam(smooth_image(48, 64, i), 255, "RGB")),
    "pam_gray16_64x48.pam": (
        "writers.write_pam, TUPLTYPE GRAYSCALE, MAXVAL 65535",
        lambda i: write_pam(_gray(i)[..., None].astype(np.int64) * 257,
                            65535, "GRAYSCALE")),
    "pam_blackandwhite_64x48.pam": (
        "writers.write_pam, TUPLTYPE BLACKANDWHITE (cv2's bit mode)",
        lambda i: write_pam((_gray(i) < 128)[..., None], 1,
                            "BLACKANDWHITE")),
    "webp_lossy_q80_640x480.webp": (
        "PIL, lossy, quality 80, method 4",
        lambda i: _webp(smooth_image(480, 640, i), quality=80)),
    "webp_lossless_48colours_640x480.webp": (
        "PIL, lossless, the content quantised to 48 colours",
        lambda i: _webp(np.asarray(Image.fromarray(smooth_image(
            480, 640, i)).quantize(48).convert("RGB")), lossless=True)),
    "webp_alpha_lossy_96x64.webp": (
        "PIL, RGBA: VP8X, compressed ALPH, VP8 quality 70",
        lambda i: _webp(np.dstack([smooth_image(64, 96, i),
                                   _gray(i + 1, 64, 96)]), quality=70)),
    "webp_exif6_64x48.webp": (
        "PIL, lossy, an EXIF chunk with Orientation 6",
        lambda i: _webp(smooth_image(48, 64, i), quality=85,
                        exif=_exif(6))),
    "webp_animated_64x48.webp": (
        "PIL, an animation of 3 lossy frames (imread: the first)",
        _animation),
    "webp_simple_filter_96x64.webp": (
        "libwebp WebPEncode: simple loop filter, strength 70, 4 segments",
        lambda i: _libwebp(smooth_image(64, 96, i), filter_type=0,
                           filter_strength=70, segments=4)),
    "webp_bytes_64x48.jpg": (
        "PIL, lossy WebP quality 75 under a .jpg name",
        lambda i: _webp(smooth_image(48, 64, i), quality=75)),
})


def _cut(data, frac):
    """A JPEG cut inside its first scan's data, frac of the way through
    (cv2 reads it, warning "Premature end of JPEG file")."""
    sos = data.index(b"\xff\xda")
    return data[:sos + int((len(data) - sos) * frac)]


def _renumber_restart(data, k, new):
    """The k-th RSTn of a JPEG's scan data given the number new, or
    removed (new None)."""
    pos = data.index(b"\xff\xda")
    for _ in range(k + 1):
        pos = data.index(b"\xff", pos + 2)
        while not 0xD0 <= data[pos + 1] <= 0xD7:
            pos = data.index(b"\xff", pos + 2)
    if new is None:
        return data[:pos] + data[pos + 2:]
    return data[:pos + 1] + bytes([0xD0 + new]) + data[pos + 2:]


def _unrefined(data):
    """A progressive JPEG without its last scan (cv2's script ends with the
    luma AC refinement to Al 0), so libjpeg smooths its blocks."""
    return data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"


# the progressive scan script of libjpeg's jpeg_simple_progression (3
# components)
PROGRESSION = ([((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)])


def _numpy_jpeg(img, factors, quality, scans=None, **kw):
    """writers.write_jpeg of an RGB image's YCbCr planes."""
    qt = [quant_table(False, quality), quant_table(True, quality)]
    coefs = jpeg_coefficients(ycc_planes(img), factors, qt, [0, 1, 1])
    return write_jpeg(coefs, qt, [0, 1, 1], factors, img.shape[1],
                      img.shape[0], scans or [((0, 1, 2), 0, 63, 0, 0)], **kw)


def _ycck(i, quality=90):
    """writers.write_jpeg of CMYK as YCCK (Adobe transform 2): Y, Cb, Cr
    of the inverted C, M, Y, then K; 4:2:0 chroma."""
    cmyk = _cmyk(48, 64, i)
    planes = ycc_planes(255 - cmyk[..., :3]) + [
        cmyk[..., 3].astype(np.float64)]
    qt = [quant_table(False, quality), quant_table(True, quality)]
    tq = [0, 1, 1, 0]
    factors = [(2, 2), (1, 1), (1, 1), (2, 2)]
    return write_jpeg(jpeg_coefficients(planes, factors, qt, tq), qt, tq,
                      factors, 64, 48, [((0, 1, 2, 3), 0, 63, 0, 0)],
                      adobe_transform=2)


def _ycbcr_tiff(i, subsampling):
    ycc = np.clip(np.round(np.stack(ycc_planes(smooth_image(48, 64, i)),
                                    -1)), 0, 255).astype(np.uint8)
    return write_tiff(ycc, photometric=6, subsampling=subsampling,
                      rows_per_strip=16)


def _short_lzw(i):
    """An LZW TIFF (strips of 16 rows, the predictor) whose second strip's
    byte count is cut to 60%: libtiff decodes it short, leaves zeros and
    drops that strip's predictor."""
    data = bytearray(write_tiff(smooth_image(48, 64, i), compression=5,
                                predictor=2, rows_per_strip=16))
    count_at = data.index(struct.pack("<HHI", 279, 4, 3))
    at = struct.unpack("<I", data[count_at + 8:count_at + 12])[0] + 4
    (count,) = struct.unpack("<I", data[at:at + 4])
    data[at:at + 4] = struct.pack("<I", count * 6 // 10)
    return bytes(data)


def _bilevel(i):
    return Image.fromarray(smooth_image(48, 64, i)[..., 0] > 128)


FIXTURES.update({
    "cut_baseline_q75_64x48.jpg": (
        "cv2.imencode 4:2:0 q75, cut 60% into its scan",
        lambda i: _cut(encode(smooth_image(48, 64, i), "420", 75, 0, 0, 0),
                       0.6)),
    "cut_progressive_q75_64x48.jpg": (
        "cv2.imencode progressive 4:2:0 q75, cut 45% into its scans",
        lambda i: _cut(encode(smooth_image(48, 64, i), "420", 75, 0, 0, 1),
                       0.45)),
    "no_eoi_q85_64x48.jpg": (
        "cv2.imencode 4:4:4 q85 without its EOI marker",
        lambda i: encode(smooth_image(48, 64, i), "444", 85, 0, 0, 0)[:-2]),
    "rst_misnumbered_64x48.jpg": (
        "cv2.imencode 4:2:0 q80, restart interval 1, RST2 numbered RST5",
        lambda i: _renumber_restart(encode(smooth_image(48, 64, i), "420", 80,
                                           1, 0, 0), 2, 5)),
    "rst_missing_64x48.jpg": (
        "cv2.imencode progressive 4:2:2 q80, restart interval 1, its "
        "fourth RSTn removed",
        lambda i: _renumber_restart(encode(smooth_image(48, 64, i), "422", 80,
                                           1, 0, 1), 3, None)),
    "progressive_unrefined_64x48.jpg": (
        "cv2.imencode progressive 4:2:0 q75 without its last scan (block "
        "smoothing)",
        lambda i: _unrefined(encode(smooth_image(48, 64, i), "420", 75, 0, 0,
                                    1))),
    "ycck_q90_64x48.jpg": (
        "writers.write_jpeg, YCCK (Adobe transform 2), 4:2:0 chroma, q90",
        _ycck),
    "sequential_3scans_64x48.jpg": (
        "writers.write_jpeg, baseline 4:2:0 q80 in three scans of one "
        "component each",
        lambda i: _numpy_jpeg(smooth_image(48, 64, i), [(2, 2), (1, 1),
                                                        (1, 1)], 80,
                              [((0,), 0, 63, 0, 0), ((1,), 0, 63, 0, 0),
                               ((2,), 0, 63, 0, 0)])),
    "arith_rst2_64x48.jpg": (
        "writers.write_jpeg, arithmetic-coded (SOF9) 4:2:0 q80, restart "
        "interval 2",
        lambda i: _numpy_jpeg(smooth_image(48, 64, i), [(2, 2), (1, 1),
                                                        (1, 1)], 80,
                              arithmetic=True, restart=2)),
    "arith_progressive_64x48.jpg": (
        "writers.write_jpeg, arithmetic-coded progressive (SOF10) 4:4:4 "
        "q85, jpeg_simple_progression's scans",
        lambda i: _numpy_jpeg(smooth_image(48, 64, i), [(1, 1)] * 3, 85,
                              PROGRESSION, arithmetic=True,
                              progressive=True)),
    "ycbcr420_64x48.tif": (
        "writers.write_tiff, uncompressed YCbCr 2x2 subsampled, strips of "
        "16 rows",
        lambda i: _ycbcr_tiff(i, (2, 2))),
    "ycbcr422_64x48.tif": (
        "writers.write_tiff, uncompressed YCbCr 2x1 subsampled, strips of "
        "16 rows",
        lambda i: _ycbcr_tiff(i, (2, 1))),
    "lzw_short_strip_64x48.tif": (
        "writers.write_tiff, LZW with the predictor, its second strip cut "
        "to 60%", _short_lzw),
    "jpeg_ycbcr420_64x48.tif": (
        "writers.write_jpeg_tiff, JPEG-in-TIFF YCbCr 4:2:0 q80, strips of "
        "16 rows, JPEGTables",
        lambda i: write_jpeg_tiff(smooth_image(48, 64, i), 16,
                                  [(2, 2), (1, 1), (1, 1)], 80)),
    "jpeg_rgb_pil_64x48.tif": (
        "PIL, RGB, JPEG-in-TIFF (Photometric 2)",
        lambda i: _pil(smooth_image(48, 64, i), "TIFF", compression="jpeg")),
    "jpeg_gray_cv2_64x48.tif": (
        "cv2.imencode, gray, IMWRITE_TIFF_COMPRESSION 7",
        lambda i: _cv2(_gray(i), ".tif", (cv2.IMWRITE_TIFF_COMPRESSION, 7))),
    "ccitt_mh_64x48.tif": (
        "PIL, 1-bit, CCITT modified Huffman (Compression 2)",
        lambda i: _pil_image(_bilevel(i), compression="tiff_ccitt")),
    "ccitt_g3_2d_64x48.tif": (
        "PIL, 1-bit, CCITT T.4 2D (Compression 3, Group3Options 1)",
        lambda i: _pil_image(_bilevel(i), compression="group3",
                             tiffinfo={292: 1})),
    "ccitt_g4_lsb_64x48.tif": (
        "PIL, 1-bit, CCITT T.6 (Compression 4), FillOrder 2",
        lambda i: _pil_image(_bilevel(i), compression="group4",
                             tiffinfo={266: 2})),
    "cmyk_lzw_64x48.tif": (
        "PIL, CMYK, LZW",
        lambda i: _pil(_cmyk(48, 64, i), "TIFF", "CMYK",
                       compression="tiff_lzw")),
    "cmyk_planar_64x48.tif": (
        "writers.write_tiff, CMYK, PlanarConfiguration 2, uncompressed",
        lambda i: write_tiff(_cmyk(48, 64, i), photometric=5, planar=2)),
})


def _565(img):
    b, g, r = (img[..., 2].astype(int), img[..., 1].astype(int),
               img[..., 0].astype(int))
    return ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)


def _555(img):
    b, g, r = (img[..., 2].astype(int), img[..., 1].astype(int),
               img[..., 0].astype(int))
    return ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)


def _ten_bit(img):
    r, g, b = (img[..., c].astype(np.uint64) * 4 + 1 for c in range(3))
    return (r << np.uint64(20)) | (g << np.uint64(10)) | b


def _jp2(img, **kw):
    """PIL's JPEG 2000 (OpenJPEG) of an array (its mode as fromarray
    infers it: L, LA, RGB, RGBA or I;16)."""
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG2000", **kw)
    return bio.getvalue()


def _palette_jp2(i):
    """A JP2 of 4-bit indices (a 1-component codestream) with a 16-entry
    RGB palette (pclr) mapped through cmap."""
    idx = smooth_image(48, 64, i)[..., 1] // 16
    pal = np.random.default_rng(i).integers(0, 256, (16, 3), np.uint8)
    pclr = jp2_box(b"pclr", struct.pack(">HB", 16, 3) + bytes([7, 7, 7])
                + pal.tobytes())
    cmap = jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, c)
                                  for c in range(3)))
    return jp2_wrap(_jp2(idx, no_jp2=True), 16, pclr + cmap, nc=1)


def _cdef_jp2(i):
    """An RGB JP2 whose cdef box swaps its first and third channels."""
    cdef = jp2_box(b"cdef", struct.pack(">H", 3) + b"".join(
        struct.pack(">HHH", c, 0, a) for c, a in ((0, 3), (1, 2), (2, 1))))
    return jp2_wrap(_jp2(smooth_image(48, 64, i), no_jp2=True, mct=1), 16,
                    cdef)


def _noisy(i, h=48, w=64, sigma=12):
    rng = np.random.default_rng(i)
    return np.clip(smooth_image(h, w, i) + rng.normal(0, sigma, (h, w, 3)),
                   0, 255).astype(np.uint8)


def _indices(i, n, h=48, w=64):
    """(h, w) indices in n levels of the smooth content's first channel."""
    return (smooth_image(h, w, i)[..., 0].astype(int) * n // 256).astype(
        np.uint8)


def _palette(i, n):
    return np.random.default_rng(i).integers(0, 256, (n, 3), np.uint8)


def _gif_small_frame(i):
    idx = _indices(i, 32, 30, 40)
    return write_gif([dict(indices=idx, left=13, top=9)], 64, 48,
                     _palette(i, 32), background=7)


def _gif_animated(i):
    idx = _indices(i, 64)
    return write_gif([dict(indices=idx, disposal=2),
                      dict(indices=63 - idx[:20, :30], left=5, top=5,
                           palette=_palette(i + 1, 64))],
                     64, 48, _palette(i, 64), loop=0)


def _gif_full_table(i):
    """Noise in 256 colours: the LZW table fills at 4096 entries and the
    coder goes on without a Clear code (12-bit codes, no new entries)."""
    rng = np.random.default_rng(i)
    idx = rng.integers(0, 256, (80, 100), np.uint8)
    return write_gif([dict(indices=idx, no_clear_when_full=True)], 100, 80,
                     _palette(i, 256))


def _hdr(i, w=64, h=48, scale=1.0, runs=False):
    img = smooth_image(h, w, i).astype(np.float64) / 255 * scale
    if runs:
        img[:, w // 2:] = img[:, w // 2:w // 2 + 1]
    return float_to_rgbe(img)


def _hdr_old_padded(i):
    """Old-style RLE scanlines (repeat markers 1, 1, 1, n) padded with
    zero bytes to the flat size: cv2 reads them flat, the markers as
    pixels."""
    rgbe = _hdr(i, runs=True)
    data = write_hdr(rgbe, "old")
    flat = len(write_hdr(rgbe, "flat"))
    return data + bytes(flat - len(data))


def _pfm_values(i, h=48, w=64):
    rng = np.random.default_rng(i)
    v = smooth_image(h, w, i).astype(np.float32) + rng.uniform(
        -0.5, 0.5, (h, w, 3)).astype(np.float32)
    v[0, :4] = [[0.5, 1.5, 2.5], [254.5, 255.5, -3.0],
                [np.nan, np.inf, -np.inf], [1e12, 300.0, 127.5]]
    return v


def _dhtless(data):
    """A JPEG without its DHT segments (a motion-JPEG frame)."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        if data[pos] == 0xFF and data[pos + 1] == 0xC4:
            (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
            pos += 2 + length
            continue
        if data[pos] == 0xFF and data[pos + 1] == 0xDA:
            return bytes(out + data[pos:])
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out)


FIXTURES.update({
    "jp2_lossless_rct_64x48.jp2": (
        "PIL (OpenJPEG), lossless 5/3 with the RCT, 6 resolutions",
        lambda i: _jp2(smooth_image(48, 64, i), mct=1)),
    "jp2_irreversible_r20_64x48.jp2": (
        "PIL, irreversible 9/7 with the ICT, rate 20",
        lambda i: _jp2(_noisy(i), irreversible=True, mct=1,
                       quality_mode="rates", quality_layers=[20])),
    "jp2_tiled_layers3_64x48.jp2": (
        "PIL, 9/7, tiles of 32x16, three quality layers (rates 40, 20, "
        "8)",
        lambda i: _jp2(_noisy(i), irreversible=True, mct=1,
                       tile_size=(32, 16), quality_mode="rates",
                       quality_layers=[40, 20, 8])),
    "jp2_rlcp_db35_64x48.jp2": (
        "PIL, 9/7, RLCP, quality 35 dB, 4 resolutions",
        lambda i: _jp2(_noisy(i), irreversible=True, mct=1,
                       progression="RLCP", quality_mode="dB",
                       quality_layers=[35], num_resolutions=4)),
    "jp2_rpcl_precincts_64x48.jp2": (
        "PIL, 9/7, RPCL, precincts of 32, code-blocks of 16x8, two layers",
        lambda i: _jp2(_noisy(i), irreversible=True, mct=1,
                       progression="RPCL", precinct_size=(32, 32),
                       codeblock_size=(16, 8), quality_mode="rates",
                       quality_layers=[30, 10])),
    "jp2_pcrl_precincts_64x48.jp2": (
        "PIL, lossless, PCRL, precincts of 16, tiles of 48x40",
        lambda i: _jp2(smooth_image(48, 64, i), progression="PCRL",
                       precinct_size=(16, 16), num_resolutions=3,
                       tile_size=(48, 40))),
    "jp2_cprl_plt_64x48.jp2": (
        "PIL, 9/7, CPRL, PLT markers, code-blocks of 8x32",
        lambda i: _jp2(_noisy(i), irreversible=True, progression="CPRL",
                       plt=True, codeblock_size=(8, 32),
                       quality_mode="rates", quality_layers=[15])),
    "j2k_raw_codestream_64x48.j2k": (
        "PIL, a raw J2K codestream (no JP2 boxes), 9/7, rate 10",
        lambda i: _jp2(_noisy(i), irreversible=True, mct=1, no_jp2=True,
                       quality_mode="rates", quality_layers=[10])),
    "jp2_gray_64x48.jp2": (
        "PIL, gray (colr greyscale), 9/7, rate 12",
        lambda i: _jp2(_noisy(i)[..., 0], irreversible=True,
                       quality_mode="rates", quality_layers=[12])),
    "jp2_gray_alpha_64x48.jp2": (
        "PIL, gray + alpha (cdef), lossless",
        lambda i: _jp2(smooth_image(48, 64, i)[..., :2])),
    "jp2_rgba_64x48.jp2": (
        "PIL, RGBA (cdef alpha), 9/7, rate 16",
        lambda i: _jp2(np.dstack([_noisy(i), smooth_image(48, 64, i)[
            ..., :1]]), irreversible=True, mct=1,
            quality_mode="rates", quality_layers=[16])),
    "jp2_gray16_64x48.jp2": (
        "PIL, 16-bit gray, lossless (cv2 shifts by 8)",
        lambda i: _jp2(smooth_image(48, 64, i)[..., 0].astype(np.uint16)
                       * 257)),
    "jp2_cv2_lossy_64x48.jp2": (
        "cv2.imencode .jp2 at its default (lossy) compression",
        lambda i: _cv2(smooth_image(48, 64, i), ".jp2")),
    "jp2_sycc_64x48.jp2": (
        "a PIL codestream in a JP2 whose colr says sYCC (cv2's YUV -> BGR)",
        lambda i: jp2_wrap(_jp2(smooth_image(48, 64, i), no_jp2=True), 18)),
    "jp2_palette_64x48.jp2": (
        "4-bit indices (PIL codestream) with a pclr / cmap RGB palette",
        _palette_jp2),
    "jp2_cdef_swap_64x48.jp2": (
        "RGB (PIL codestream) whose cdef swaps the first and third channel",
        _cdef_jp2),
    "jp2_12bit_64x48.jp2": (
        "a PIL lossless codestream declared 12 bits (cv2 shifts by 4)",
        lambda i: jp2_wrap(siz_fields(siz_fields(siz_fields(
            _jp2(smooth_image(48, 64, i), no_jp2=True), 0, 12), 1, 12),
            2, 12))),
    "j2k_styles_all_64x48.j2k": (
        "j2k_writer, 5/3 + RCT, every code-block style (bypass, RESET, "
        "TERMALL, vertically causal, PTERM, segmentation symbols), three "
        "layers",
        lambda i: write_j2k(_noisy(i), levels=3, cblk=(4, 4), layers=3,
                            mct=True, styles=LAZY | RESET | TERMALL | VSC
                            | PTERM | SEGSYM)),
    "j2k_bypass_vsc_64x48.j2k": (
        "j2k_writer, 5/3, bypass and vertically causal code-blocks, RLCP, "
        "two layers",
        lambda i: write_j2k(_noisy(i), levels=2, cblk=(5, 4), layers=2,
                            order=1, styles=LAZY | VSC)),
    "j2k_sop_eph_poc_64x48.j2k": (
        "j2k_writer, SOP and EPH markers, a POC (RLCP over resolutions "
        "0-1, then LRCP), precincts, tiles of 40x32 in three tile-parts "
        "each",
        lambda i: write_j2k(_noisy(i), levels=3, cblk=(3, 3), layers=2,
                            mct=True, sop=True, eph=True, tile=(40, 32),
                            tile_parts=3, precincts=[(4, 4), (4, 4),
                                                     (5, 5), (5, 5)],
                            poc=[(0, 0, 2, 2, 3, 1), (0, 0, 2, 4, 3, 0)])),
    "j2k_roi_coc_qcc_64x48.j2k": (
        "j2k_writer, an RGN region (maximum shift) on component 0, a COC "
        "(2 levels, code-blocks 8x8, segmentation symbols) and a QCC (3 "
        "guard bits) on component 2",
        lambda i: write_j2k(_noisy(i), levels=3, cblk=(4, 4), layers=2,
                            roi=(0, lambda b, x, y: b == 0 or x < 8),
                            comp_styles={2: (2, (3, 3), SEGSYM)},
                            qcc_guard={2: 3})),
    "jp2_lossy_named_64x48.jpg": (
        "PIL JP2, 9/7 rate 20, under a .jpg name",
        lambda i: _jp2(_noisy(i), irreversible=True, mct=1,
                       quality_mode="rates", quality_layers=[20])),
    "gif_global_64x48.gif": (
        "writers.write_gif, GIF89a, a 256-colour global table",
        lambda i: write_gif([dict(indices=_indices(i, 256))], 64, 48,
                            _palette(i, 256))),
    "gif_local_interlaced_64x48.gif": (
        "writers.write_gif, GIF87a, interlaced, a 16-colour local table "
        "only (black canvas)",
        lambda i: write_gif([dict(indices=_indices(i, 16), interlace=True,
                                  palette=_palette(i, 16))], 64, 48,
                            version=b"GIF87a")),
    "gif_transparent_64x48.gif": (
        "writers.write_gif, a transparent index (its pixels take the "
        "background colour), Clear codes every 100 codes",
        lambda i: write_gif([dict(indices=_indices(i, 32), transparent=9,
                                  clear_every=100)], 64, 48,
                            _palette(i, 32), background=3)),
    "gif_small_frame_64x48.gif": (
        "writers.write_gif, a 40x30 frame at (13, 9) on a 64x48 screen of "
        "background 7",
        _gif_small_frame),
    "gif_animated_64x48.gif": (
        "writers.write_gif, two frames and a NETSCAPE loop (cv2 reads the "
        "first)",
        _gif_animated),
    "gif_full_table_100x80.gif": (
        "writers.write_gif, 256-colour noise, the LZW table full without a "
        "Clear code",
        _gif_full_table),
    "gif_pil_64x48.gif": (
        "PIL, quantised to 64 colours",
        lambda i: _pil_quantized(smooth_image(48, 64, i), 64, "GIF")),
    "gif_named_64x48.png": (
        "writers.write_gif under a .png name",
        lambda i: write_gif([dict(indices=_indices(i, 128))], 64, 48,
                            _palette(i, 128))),
    "ras_cv2_rgb_63x48.ras": (
        "cv2.imencode .ras, 24-bit standard, odd width (padded rows)",
        lambda i: _cv2(smooth_image(48, 63, i), ".ras")),
    "ras_cv2_gray_64x48.sr": (
        "cv2.imencode .sr, 8-bit gray",
        lambda i: _cv2(smooth_image(48, 64, i)[..., 1], ".sr")),
    "ras_1bit_63x48.ras": (
        "writers.write_sunras, 1-bit, no colour map (0 black, 1 white)",
        lambda i: write_sunras(smooth_image(48, 63, i)[..., 0] > 128, 1)),
    "ras_1bit_cmap_64x48.ras": (
        "writers.write_sunras, 1-bit, a 2-entry RGB colour map, type 0",
        lambda i: write_sunras(smooth_image(48, 64, i)[..., 0] > 128, 1, 0,
                               _palette(i, 2))),
    "ras_8bit_cmap_64x48.ras": (
        "writers.write_sunras, 8-bit indices, a 200-entry colour map (the "
        "indices past it black)",
        lambda i: write_sunras(smooth_image(48, 64, i)[..., 1], 8, 1,
                               _palette(i, 200))),
    "ras_32bit_64x48.ras": (
        "writers.write_sunras, 32-bit X, B, G, R",
        lambda i: write_sunras(smooth_image(48, 64, i), 32)),
    "pfm_le_64x48.pfm": (
        "writers.write_pfm, PF, scale -1 (little-endian), halves, NaN, "
        "infinities and values past 255",
        lambda i: write_pfm(_pfm_values(i), -1.0)),
    "pfm_be_scale2_64x48.pfm": (
        "writers.write_pfm, PF, scale 2 (big-endian, values halved)",
        lambda i: write_pfm(_pfm_values(i), 2.0)),
    "hdr_rle_64x48.hdr": (
        "writers.write_hdr, #?RADIANCE, new-style RLE scanlines",
        lambda i: write_hdr(_hdr(i, runs=True), "new")),
    "hdr_flat_rgbe_64x48.hdr": (
        "writers.write_hdr, #?RGBE, flat scanlines, values up to 3.0",
        lambda i: write_hdr(_hdr(i, scale=3.0), "flat", magic=b"#?RGBE")),
    "hdr_old_rle_64x48.hdr": (
        "writers.write_hdr, old-style RLE padded to the flat size (read "
        "flat, the repeat markers as pixels)",
        _hdr_old_padded),
    "hdr_narrow_6x40.hdr": (
        "writers.write_hdr, 6 pixels wide (flat whatever the coding)",
        lambda i: write_hdr(_hdr(i, 6, 40), "flat")),
    "dhtless_baseline_420_64x48.jpg": (
        "cv2.imencode 4:2:0 q75 without its DHT segments (the standard "
        "tables apply)",
        lambda i: _dhtless(encode(smooth_image(48, 64, i), "420", 75, 0, 0,
                                  0))),
    "dhtless_rst_444_64x48.jpg": (
        "cv2.imencode 4:4:4 q85, restart interval 2, without its DHT "
        "segments",
        lambda i: _dhtless(encode(smooth_image(48, 64, i), "444", 85, 2, 0,
                                  0))),
    "dhtless_gray_64x48.jpg": (
        "cv2.imencode gray q80 without its DHT segment",
        lambda i: _dhtless(encode(smooth_image(48, 64, i)[..., 1], "gray",
                                  80, 0, 0, 0))),
    "dhtless_optimized_64x48.jpg": (
        "cv2.imencode 4:2:0 q75 with optimised tables, its DHT segments "
        "removed (decoded with the standard tables: libjpeg's corrupt-data "
        "recovery)",
        lambda i: _dhtless(encode(smooth_image(48, 64, i), "420", 75, 0, 1,
                                  0))),
    "jp2_lossy_r16_640x480.jp2": (
        "PIL, 9/7 with the ICT, rate 16, 640x480 (the decode chip_smoke "
        "times)",
        lambda i: _jp2(_noisy(i, 480, 640, 6), irreversible=True, mct=1,
                       quality_mode="rates", quality_layers=[16])),
})


def main(rewrite=False):
    manifest = {}
    for i, (name, (how, make)) in enumerate(FIXTURES.items()):
        path = os.path.join(HERE, name)
        if rewrite or not os.path.exists(path):
            data = make(100 + i)
            with open(path, "wb") as f:
                f.write(data)
        else:
            with open(path, "rb") as f:
                data = f.read()
        rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
        manifest[name] = dict(written=how, bytes=len(data),
                              shape=list(rgb.shape),
                              sha256=hashlib.sha256(rgb.tobytes()).hexdigest())
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(manifest)} fixtures, "
          f"{sum(m['bytes'] for m in manifest.values())} bytes")


def time_decodes(reps=50):
    """The median host ms of read_image_rgb and of cv2.imread a fixture."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))))
    from yolosharp_tpu_torch.data.image_ops import read_image_rgb

    for name in FIXTURES:
        path = os.path.join(HERE, name)
        read_image_rgb(path)              # builds the decoders once
        times = {}
        for label, fn in (("port", read_image_rgb), ("cv2", cv2.imread)):
            t = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(path)
                t.append(time.perf_counter() - t0)
            times[label] = np.median(t) * 1e3
        print(f"{name}: read_image_rgb {times['port']:.3f} ms, cv2.imread "
              f"{times['cv2']:.3f} ms (median of {reps})")


if __name__ == "__main__":
    if sys.argv[1:] == ["--time"]:
        time_decodes()
    else:
        main(rewrite=sys.argv[1:] == ["--all"])
