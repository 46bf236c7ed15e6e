"""Host augmentations of the letterbox path, detect task (a copy of
yolosharp_tpu/data/augment.py:223-330 with the pixel work in ``image_ops``
instead of cv2; the same rng draws in the same order).

Parity targets: Data/Augment.cs LetterBox (703-778), Rectangle (780-857),
FlipLR/FlipUD (860-966; the flipped xyxy corners are re-sorted, a fix of
the reference's order) and RandomHSV (968-989). Mosaic and
RandomPerspective are not ported yet (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import numpy as np

from .image_ops import hsv_to_rgb_u8, resize_linear, rgb_to_hsv_u8
from .labels import LabelRecord


def _resize_pad(img: np.ndarray, target_h: int, target_w: int,
                resized_h: int, resized_w: int, color) -> tuple:
    """Aspect-preserving resize into (resized) then center-pad to target."""
    ih, iw = img.shape[:2]
    ratio = min(resized_w / iw, resized_h / ih)
    nw, nh = int(iw * ratio), int(ih * ratio)
    img = resize_linear(img, nh, nw)
    pl = (target_w - nw) // 2
    pu = (target_h - nh) // 2
    out = np.full((target_h, target_w) + img.shape[2:], color, img.dtype)
    out[pu:pu + nh, pl:pl + nw] = img
    return pl, pu, out


def _shift_labels(label: LabelRecord, pl: int, pu: int) -> None:
    if label.bboxes is not None and len(label.bboxes):
        label.bboxes = label.bboxes + [pl, pu, pl, pu]


def letterbox(label: LabelRecord, width: int, height: int,
              color: int = 114) -> LabelRecord:
    out = label.copy()
    pl, pu, out.img = _resize_pad(label.img, height, width, height, width,
                                  color)
    _shift_labels(out, pl, pu)
    out.resized_shape = (height, width)
    return out


def rectangle(label: LabelRecord, color: int = 114) -> LabelRecord:
    """Val-time aspect-preserving pad to the per-batch rectangle shape."""
    rh, rw = label.resized_shape
    th, tw = label.rectangle_shape
    out = label.copy()
    pl, pu, out.img = _resize_pad(label.img, th, tw, rh, rw, color)
    _shift_labels(out, pl, pu)
    out.resized_shape = (th, tw)
    return out


def flip_lr(label: LabelRecord) -> LabelRecord:
    out = label.copy()
    out.img = label.img[:, ::-1].copy()
    w = label.resized_shape[1]
    if out.bboxes is not None and len(out.bboxes):
        x1 = w - out.bboxes[:, 2]
        x2 = w - out.bboxes[:, 0]
        out.bboxes[:, 0], out.bboxes[:, 2] = x1, x2
    return out


def flip_ud(label: LabelRecord) -> LabelRecord:
    out = label.copy()
    out.img = label.img[::-1].copy()
    h = label.resized_shape[0]
    if out.bboxes is not None and len(out.bboxes):
        y1 = h - out.bboxes[:, 3]
        y2 = h - out.bboxes[:, 1]
        out.bboxes[:, 1], out.bboxes[:, 3] = y1, y2
    return out


def random_hsv(label: LabelRecord, hgain: float, sgain: float, vgain: float,
               rng: np.random.Generator) -> LabelRecord:
    """ColorJitter-style brightness / saturation / hue jitter
    (Augment.cs:968-989)."""
    out = label.copy()
    bf = rng.uniform(max(0, 1 - vgain), 1 + vgain)
    sf = rng.uniform(max(0, 1 - sgain), 1 + sgain)
    hf = rng.uniform(-hgain, hgain)

    # each channel's jitter is a function of its 8-bit value: the JAX
    # version's float32 arithmetic, evaluated once for each of the 256
    x = np.arange(256, dtype=np.float32)
    luts = ((x + hf * 180.0) % 180.0, np.clip(x * sf, 0, 255),
            np.clip(x * bf, 0, 255))
    hsv = rgb_to_hsv_u8(label.img)
    hsv = np.stack([lut.astype(np.uint8)[hsv[..., i]]
                    for i, lut in enumerate(luts)], -1)
    out.img = hsv_to_rgb_u8(hsv)
    return out
