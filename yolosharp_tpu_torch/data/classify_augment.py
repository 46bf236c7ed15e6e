"""Classification augmentation policies: AutoAugment (ImageNet policy),
RandAugment, AugMix, RandomErasing (a copy of
yolosharp_tpu/data/classify_augment.py without cv2).

Parity targets: the torchvision transform stack built in
Data/ClassificationDataset.cs:90-131 and the custom RandomErasing
(ClassificationDataset.cs:166-226). The ops draw from the generator in the
JAX module's order; its cv2 calls are image_ops' cv2-free equivalents:
warpAffine (INTER_LINEAR, border 128) is ``warp_affine``,
getRotationMatrix2D ``rotation_matrix_2d``, GaussianBlur 3x3
``gaussian_blur3_u8`` and equalizeHist ``equalize_hist_u8``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .image_ops import (equalize_hist_u8, gaussian_blur3_u8,
                        rotation_matrix_2d, warp_affine)


# --------------------------------------------------------------------------
# primitive ops on uint8 RGB (H, W, 3)

def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = a.astype(np.float32) + factor * (b.astype(np.float32)
                                           - a.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def shear_x(img, mag):
    h, w = img.shape[:2]
    m = np.float32([[1, mag, 0], [0, 1, 0]])
    return warp_affine(img, m, w, h, border=128)


def shear_y(img, mag):
    h, w = img.shape[:2]
    m = np.float32([[1, 0, 0], [mag, 1, 0]])
    return warp_affine(img, m, w, h, border=128)


def translate_x(img, frac):
    h, w = img.shape[:2]
    m = np.float32([[1, 0, frac * w], [0, 1, 0]])
    return warp_affine(img, m, w, h, border=128)


def translate_y(img, frac):
    h, w = img.shape[:2]
    m = np.float32([[1, 0, 0], [0, 1, frac * h]])
    return warp_affine(img, m, w, h, border=128)


def rotate(img, deg):
    h, w = img.shape[:2]
    m = rotation_matrix_2d((w / 2, h / 2), deg, 1.0)
    return warp_affine(img, m, w, h, border=128)


def color(img, factor):
    gray = img.mean(-1, keepdims=True).repeat(3, -1)
    return _blend(gray.astype(np.uint8), img, factor)


def posterize(img, bits):
    shift = 8 - int(bits)
    return ((img >> shift) << shift).astype(np.uint8)


def solarize(img, threshold):
    return np.where(img >= threshold, 255 - img, img).astype(np.uint8)


def contrast(img, factor):
    mean = int(img.astype(np.float32).mean() + 0.5)
    return _blend(np.full_like(img, mean), img, factor)


def sharpness(img, factor):
    blurred = gaussian_blur3_u8(img)
    return _blend(blurred, img, factor)


def brightness(img, factor):
    return _blend(np.zeros_like(img), img, factor)


def autocontrast(img):
    out = img.astype(np.float32)
    for c in range(3):
        lo, hi = out[..., c].min(), out[..., c].max()
        if hi > lo:
            out[..., c] = (out[..., c] - lo) * 255.0 / (hi - lo)
    return np.clip(out, 0, 255).astype(np.uint8)


def equalize(img):
    out = img.copy()
    for c in range(3):
        out[..., c] = equalize_hist_u8(img[..., c])
    return out


def invert(img):
    return (255 - img).astype(np.uint8)


# op name -> (fn(img, magnitude), magnitude range, signed)
_OPS = {
    "ShearX": (lambda im, m: shear_x(im, m), (0.0, 0.3), True),
    "ShearY": (lambda im, m: shear_y(im, m), (0.0, 0.3), True),
    "TranslateX": (lambda im, m: translate_x(im, m), (0.0, 0.4533), True),
    "TranslateY": (lambda im, m: translate_y(im, m), (0.0, 0.4533), True),
    "Rotate": (lambda im, m: rotate(im, m), (0.0, 30.0), True),
    "Color": (lambda im, m: color(im, 1.0 + m), (0.0, 0.9), True),
    "Posterize": (lambda im, m: posterize(im, 8 - m), (0, 4), False),
    "Solarize": (lambda im, m: solarize(im, int(m)), (255, 0), False),
    "Contrast": (lambda im, m: contrast(im, 1.0 + m), (0.0, 0.9), True),
    "Sharpness": (lambda im, m: sharpness(im, 1.0 + m), (0.0, 0.9), True),
    "Brightness": (lambda im, m: brightness(im, 1.0 + m), (0.0, 0.9), True),
    "AutoContrast": (lambda im, m: autocontrast(im), (0, 0), False),
    "Equalize": (lambda im, m: equalize(im), (0, 0), False),
    "Invert": (lambda im, m: invert(im), (0, 0), False),
}

# torchvision AutoAugment ImageNet policy: (op, prob, magnitude_idx) pairs
_IMAGENET_POLICY: List[Tuple[Tuple[str, float, int], Tuple[str, float, int]]] = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, 8)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, 9)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 3)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
]


def _magnitude(op: str, idx: int, rng) -> float:
    lo, hi = _OPS[op][1]
    signed = _OPS[op][2]
    m = lo + (hi - lo) * idx / 9.0
    if signed and rng.uniform() < 0.5:
        m = -m
    return m


def auto_augment(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """torchvision-style AutoAugment with the ImageNet policy."""
    pair = _IMAGENET_POLICY[int(rng.integers(0, len(_IMAGENET_POLICY)))]
    for op, prob, mag_idx in pair:
        if rng.uniform() <= prob:
            img = _OPS[op][0](img, _magnitude(op, mag_idx, rng))
    return img


def rand_augment(img: np.ndarray, rng: np.random.Generator, n: int = 2,
                 magnitude: int = 9) -> np.ndarray:
    names = list(_OPS)
    for _ in range(n):
        op = names[int(rng.integers(0, len(names)))]
        img = _OPS[op][0](img, _magnitude(op, magnitude, rng))
    return img


def augmix(img: np.ndarray, rng: np.random.Generator, width: int = 3,
           depth: int = -1, alpha: float = 1.0) -> np.ndarray:
    ws = rng.dirichlet([alpha] * width).astype(np.float32)
    m = np.float32(rng.beta(alpha, alpha))
    names = [n for n in _OPS if n not in ("Invert",)]
    mix = np.zeros_like(img, np.float32)
    for i in range(width):
        aug = img.copy()
        d = depth if depth > 0 else int(rng.integers(1, 4))
        for _ in range(d):
            op = names[int(rng.integers(0, len(names)))]
            aug = _OPS[op][0](aug, _magnitude(op, int(rng.integers(0, 10)),
                                              rng))
        mix += ws[i] * aug.astype(np.float32)
    out = (1 - m) * img.astype(np.float32) + m * mix
    return np.clip(out, 0, 255).astype(np.uint8)


def random_erasing(img: np.ndarray, rng: np.random.Generator,
                   p: float = 0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3)
                   ) -> np.ndarray:
    """torchvision RandomErasing with per-pixel normal fill
    (ClassificationDataset.cs:166-226)."""
    if rng.uniform() > p:
        return img
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        erase_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        eh = int(round(math.sqrt(erase_area * aspect)))
        ew = int(round(math.sqrt(erase_area / aspect)))
        if eh < h and ew < w:
            i = int(rng.integers(0, h - eh + 1))
            j = int(rng.integers(0, w - ew + 1))
            img = img.copy()
            img[i:i + eh, j:j + ew] = np.clip(
                rng.normal(0, 1, (eh, ew, 3)) * 64 + 128, 0, 255
            ).astype(np.uint8)
            return img
    return img
