"""Write the committed image fixtures of this folder and their manifest:
the JPEG kinds beyond baseline (progressive, Adobe CMYK), the PNG kinds
beyond 8-bit gray / RGB / RGBA, and baseline TIFF kinds.

    python tests/data_torch/images/make_fixtures.py          # write them
    python tests/data_torch/images/make_fixtures.py --time   # time decodes

Needs cv2 and PIL (the machines that only read the fixtures need neither):
cv2.imencode and PIL write what they write, ``writers.py`` the kinds
neither writes (Adam7 PNG, tiled, planar, big-endian, min-is-white,
old-style LZW and oriented TIFF). Each file holds the smooth synthetic
content of ../jpeg/make_fixtures.py. Its manifest entry records how it was
written, its size, the shape of cv2.imread(IMREAD_COLOR) -> RGB and the
SHA-256 of those RGB bytes: the port's reader must give the same bytes.
``--time`` writes nothing: it prints the host ms of the port's
read_image_rgb and of cv2.imread for each fixture (the median of 50), on
this machine's CPU."""

import hashlib
import io
import json
import os
import sys
import time

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "jpeg"))
from make_fixtures import encode, smooth_image  # noqa: E402
from writers import write_png, write_tiff  # noqa: E402


def _pil(img, fmt, mode=None, **kw):
    bio = io.BytesIO()
    Image.fromarray(img, mode).save(bio, fmt, **kw)
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


def main():
    manifest = {}
    for i, (name, (how, make)) in enumerate(FIXTURES.items()):
        data = make(100 + i)
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
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
        main()
