"""Write the committed JPEG fixtures of this folder and their manifest.

    python tests/data_torch/jpeg/make_fixtures.py          # write them
    python tests/data_torch/jpeg/make_fixtures.py --time   # time decodes

Needs cv2 (its libjpeg-turbo encodes them; the machines that only read the
fixtures need none). Each file is smooth synthetic content (gradients, a
disc and a bar, a little noise), encoded with the settings its manifest
entry records, which also holds the shape of cv2.imread(IMREAD_COLOR) ->
RGB and the SHA-256 of those RGB bytes: the port's decoder must give the
same bytes, for the progressive file too. ``--time`` writes nothing: it prints the host ms of the port's read_image_rgb and of
cv2.imread for each fixture (the median of 50), on this machine's CPU."""

import hashlib
import json
import os
import struct
import sys
import time

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# name: (height, width, sampling or "gray", quality, restart interval,
# optimised Huffman tables, progressive, EXIF orientation)
FIXTURES = {
    "s420_q75_641x479.jpg": (479, 641, "420", 75, 0, 0, 0, 1),
    "s444_q95_67x45.jpg": (45, 67, "444", 95, 0, 0, 0, 1),
    "s422_q50_320x240.jpg": (240, 320, "422", 50, 0, 0, 0, 1),
    "s440_q75_200x150.jpg": (150, 200, "440", 75, 0, 0, 0, 1),
    "s411_q95_160x120.jpg": (120, 160, "411", 95, 0, 0, 0, 1),
    "gray_q75_256x192.jpg": (192, 256, "gray", 75, 0, 0, 0, 1),
    "s420_q75_rst3_240x180.jpg": (180, 240, "420", 75, 3, 0, 0, 1),
    "s422_q75_opt_300x200.jpg": (200, 300, "422", 75, 0, 1, 0, 1),
    "s444_q100_1x1.jpg": (1, 1, "444", 100, 0, 0, 0, 1),
    "s420_q100_7x9.jpg": (9, 7, "420", 100, 0, 0, 0, 1),
    "s420_q75_exif6_96x64.jpg": (64, 96, "420", 75, 0, 0, 0, 6),
    "progressive_q75_128x96.jpg": (96, 128, "420", 75, 0, 0, 1, 1),
}


def smooth_image(h, w, seed):
    """uint8 RGB: three gradients, a disc and a bar, noise of sigma 3."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                    128 + 100 * np.sin((xx + yy) / 11.0)], -1)
    cy, cx = rng.uniform(0.3, 0.7, 2) * (h, w)
    disc = (yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) / 4) ** 2
    img[disc] = rng.uniform(0, 255, 3)
    img[int(h * 0.7):int(h * 0.8), int(w * 0.1):int(w * 0.6)] = \
        rng.uniform(0, 255, 3)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def exif_app1(orientation, little_endian=True):
    """An APP1 segment of EXIF data whose IFD0 holds one tag, Orientation
    (SHORT), in either byte order."""
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def encode(img, sampling, quality, rst, optimize, progressive):
    """JPEG bytes of an RGB (or 2-D gray) uint8 image through
    cv2.imencode."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive]
    if sampling != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def main():
    manifest = {}
    for i, (name, spec) in enumerate(FIXTURES.items()):
        h, w, sampling, quality, rst, optimize, progressive, orient = spec
        img = smooth_image(h, w, i)
        if sampling == "gray":
            img = img[..., 1]
        data = encode(img, sampling, quality, rst, optimize, progressive)
        if orient != 1:
            data = data[:2] + exif_app1(orient) + data[2:]
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
        manifest[name] = dict(
            sampling=sampling, quality=quality, restart_interval=rst,
            optimize=optimize, progressive=progressive,
            exif_orientation=orient, bytes=len(data),
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
        read_image_rgb(path)              # builds the decoder once
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
