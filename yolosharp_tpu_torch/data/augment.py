"""Host augmentations of the detect, segment, pose and OBB tasks (a copy of
yolosharp_tpu/data/augment.py with the pixel work in ``image_ops`` instead
of cv2; the same rng draws in the same order).

Parity targets: Data/Augment.cs Mosaic (126-275), RandomPerspective
(278-700), LetterBox (703-778), Rectangle (780-857), FlipLR/FlipUD (860-966;
the flipped xyxy corners are re-sorted, a fix of the reference's order) and
RandomHSV (968-989). The segment masks (overlap ids at 1 / mask_ratio) go
through every transform: tiled with their ids offset in mosaic4, warped
nearest with border 0, resized through ``image_ops.resize_linear`` (as
cv2 INTER_LINEAR blends ids), flipped, and renumbered 1..n after the
mosaic's and the warp's box filters. The pose keypoints go through every
transform too: shifted by the letterbox and rectangle pads (an invisible
keypoint at (0, 0) as well), offset and filtered with their boxes in
mosaic4, warped with visibility 0 outside the canvas in
random_perspective, and mirrored by the flips without a swap of left and
right keypoints, as the JAX package does. The OBB corners go through every
transform as points: offset and filtered with their boxes in mosaic4,
warped and clipped to the canvas in random_perspective, shifted by the pads
and mirrored by the flips (the corner order is left as it is: the collate's
minimum-area rectangle re-derives the box).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .image_ops import (hsv_to_rgb_u8, resize_linear, rgb_to_hsv_u8,
                        warp_affine, warp_perspective)
from .labels import LabelRecord


def _box_area(b: np.ndarray) -> np.ndarray:
    return np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)


def mosaic4(main: LabelRecord, picks: Sequence[LabelRecord], imgsz: int,
            rng: np.random.Generator) -> LabelRecord:
    """2x2 mosaic onto a (2s, 2s) canvas (Augment.cs:147-275)."""
    s = imgsz
    border = -s // 2
    yc = int(rng.integers(-border, 2 * s + border))
    xc = int(rng.integers(-border, 2 * s + border))
    canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
    mr = main.mask_ratio
    mask4 = (np.zeros((2 * s // mr, 2 * s // mr), np.uint8)
             if main.mask is not None else None)

    cls_l, box_l, kpt_l, cor_l = [], [], [], []
    mask_instance_offset = 0
    for i, rec in enumerate([main, *picks]):
        h, w = rec.resized_shape
        if i == 0:    # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:  # top-right
            x1a, y1a = xc, max(yc - h, 0)
            x2a, y2a = min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
            x2b, y2b = min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a = max(xc - w, 0), yc
            x2a, y2a = xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
            x2b, y2b = w, min(y2a - y1a, h)
        else:         # bottom-right
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
            x2b, y2b = min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = rec.img[y1b:y2b, x1b:x2b]
        if mask4 is not None and rec.mask is not None:
            ya, yb2 = y1a // mr, y2a // mr
            xa, xb2 = x1a // mr, x2a // mr
            src = rec.mask[y1b // mr:y1b // mr + (yb2 - ya),
                           x1b // mr:x1b // mr + (xb2 - xa)]
            dst = mask4[ya:ya + src.shape[0], xa:xa + src.shape[1]]
            # instance ids stay unique across the 4 tiles
            shifted = np.where(src > 0, src.astype(np.int32)
                               + mask_instance_offset, 0)
            np.copyto(dst, shifted.astype(np.uint8), where=src > 0)
        padw, padh = x1a - x1b, y1a - y1b
        if rec.cls is None or len(rec.cls) == 0:
            mask_instance_offset += 0 if rec.cls is None else len(rec.cls)
            continue
        box = rec.bboxes + [padw, padh, padw, padh]
        cls_l.append(rec.cls)
        box_l.append(box)
        if rec.keypoints is not None:
            k = rec.keypoints.copy()
            k[..., 0] += padw
            k[..., 1] += padh
            kpt_l.append(k)
        if rec.obb_corners is not None:
            c = rec.obb_corners.copy()
            c[..., 0] += padw
            c[..., 1] += padh
            cor_l.append(c)
        mask_instance_offset += len(rec.cls)

    cls = np.concatenate(cls_l) if cls_l else np.zeros(0, np.float32)
    boxes = np.concatenate(box_l) if box_l else np.zeros((0, 4), np.float32)
    org_areas = _box_area(boxes)
    boxes = np.clip(boxes, 0, 2 * s)
    areas = _box_area(boxes)
    good = (areas > 0) & (areas > 0.7 * org_areas)

    out = LabelRecord(im_file=main.im_file, img=canvas,
                      org_shape=main.org_shape, resized_shape=(2 * s, 2 * s),
                      mask_ratio=mr, mosaic_border=(border, border))
    out.cls = cls[good]
    out.bboxes = boxes[good]
    if kpt_l:
        out.keypoints = np.concatenate(kpt_l)[good]
    if cor_l:
        out.obb_corners = np.concatenate(cor_l)[good]
    out.mask = mask4
    if mask4 is not None:
        # the surviving instances renumbered 1..n_good, in label order
        out.mask = _renumber(good)[mask4]
    return out


def _renumber(good: np.ndarray) -> np.ndarray:
    """The id lookup that maps instance k + 1 to its rank among the
    surviving (good) instances, and the others to 0."""
    remap = np.zeros(len(good) + 1, np.uint8)
    remap[np.flatnonzero(good) + 1] = np.arange(1, int(good.sum()) + 1)
    return remap


def random_perspective(label: LabelRecord, degrees: float, translate: float,
                       scale: float, shear: float, perspective: float,
                       rng: np.random.Generator) -> LabelRecord:
    """Full C/P/R/S/T 3x3 matrix warp (Augment.cs:316-700), the pixels
    through ``image_ops.warp_perspective`` / ``warp_affine`` (the mask
    nearest, with border 0, through the matrix conjugated to mask scale)."""
    img = label.img
    h, w = label.resized_shape
    bw, bh = label.mosaic_border
    out_w, out_h = w + bw * 2, h + bh * 2

    C = np.eye(3, dtype=np.float32)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3, dtype=np.float32)
    P[2, 0] = (rng.uniform(-1, 1)) * perspective
    P[2, 1] = (rng.uniform(-1, 1)) * perspective
    R = np.eye(3, dtype=np.float32)
    a = rng.uniform(-1, 1) * degrees
    sc = 1 + rng.uniform(-1, 1) * scale
    rad = math.radians(a)
    alpha, beta = math.cos(rad) * sc, math.sin(rad) * sc
    R[:2] = [[alpha, beta, 0], [-beta, alpha, 0]]
    S = np.eye(3, dtype=np.float32)
    S[0, 1] = math.tan(rng.uniform(-1, 1) * shear * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-1, 1) * shear * math.pi / 180)
    T = np.eye(3, dtype=np.float32)
    T[0, 2] = (0.5 + rng.uniform(-1, 1) * translate) * out_w
    T[1, 2] = (0.5 + rng.uniform(-1, 1) * translate) * out_h
    M = T @ S @ R @ P @ C

    if perspective > 0:
        warped = warp_perspective(img, M, out_w, out_h)
    else:
        warped = warp_affine(img, M[:2], out_w, out_h)
    out = label.copy()
    out.img = warped
    out.resized_shape = (out_h, out_w)
    out.mosaic_border = (0, 0)
    if label.mask is not None:
        r = float(label.mask_ratio)
        Sm = np.diag([r, r, 1]).astype(np.float32)
        Sinv = np.diag([1 / r, 1 / r, 1]).astype(np.float32)
        Mm = Sinv @ M @ Sm
        mw, mh2 = int(out_w / r), int(out_h / r)
        if perspective > 0:
            out.mask = warp_perspective(label.mask, Mm, mw, mh2, border=0,
                                        nearest=True)
        else:
            out.mask = warp_affine(label.mask, Mm[:2], mw, mh2, border=0,
                                   nearest=True)

    n = len(label.cls) if label.cls is not None else 0
    if n == 0:
        out.cls = np.zeros(0, np.float32)
        out.bboxes = np.zeros((0, 4), np.float32)
        return out

    # boxes: transform 4 corners, take min/max (Augment.cs:546-568)
    b = label.bboxes
    corner_idx = [0, 1, 2, 3, 0, 3, 2, 1]
    pts = b[:, corner_idx].reshape(-1, 2)
    ones = np.ones((pts.shape[0], 1), np.float32)
    xy = np.concatenate([pts, ones], 1) @ M.T
    xy = (xy[:, :2] / xy[:, 2:3]) if perspective > 0 else xy[:, :2]
    xy = xy.reshape(n, 4, 2)
    boxes = np.concatenate([xy.min(1), xy.max(1)], 1)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, out_w)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, out_h)
    good = _box_area(boxes) > 0

    out.cls = label.cls[good]
    out.bboxes = boxes[good]

    if label.keypoints is not None:
        k = label.keypoints
        nk = k.shape[1]
        pts = k[..., :2].reshape(-1, 2)
        xy = np.concatenate([pts, np.ones((pts.shape[0], 1), np.float32)], 1) @ M.T
        xy = xy[:, :2] / xy[:, 2:3]
        vis = k[..., 2].reshape(-1).copy() if k.shape[-1] == 3 else np.ones(len(xy))
        oob = ((xy[:, 0] < 0) | (xy[:, 1] < 0)
               | (xy[:, 0] > out_w) | (xy[:, 1] > out_h))
        vis[oob] = 0
        kt = np.concatenate([xy, vis[:, None]], 1).reshape(n, nk, 3)
        kt[..., 0] = kt[..., 0].clip(0, out_w)
        kt[..., 1] = kt[..., 1].clip(0, out_h)
        out.keypoints = kt[good][..., :k.shape[-1]]
    if label.obb_corners is not None:
        c = label.obb_corners.reshape(-1, 2)
        xy = np.concatenate([c, np.ones((c.shape[0], 1), np.float32)], 1) @ M.T
        xy = (xy[:, :2] / xy[:, 2:3]) if perspective > 0 else xy[:, :2]
        ct = xy.reshape(n, 4, 2)
        ct[..., 0] = ct[..., 0].clip(0, out_w)
        ct[..., 1] = ct[..., 1].clip(0, out_h)
        out.obb_corners = ct[good]
    if out.mask is not None:
        out.mask = _renumber(good)[out.mask]
    return out


def _resize_pad(img: np.ndarray, target_h: int, target_w: int,
                resized_h: int, resized_w: int, color) -> tuple:
    """Aspect-preserving resize into (resized) then center-pad to target;
    an image or a 2-D uint8 mask, bit-exact to cv2 INTER_LINEAR."""
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
    for pts in (label.keypoints, label.obb_corners):
        if pts is not None and len(pts):
            pts[..., 0] += pl
            pts[..., 1] += pu


def letterbox(label: LabelRecord, width: int, height: int,
              mask_ratio: int = 4, color: int = 114) -> LabelRecord:
    out = label.copy()
    pl, pu, out.img = _resize_pad(label.img, height, width, height, width,
                                  color)
    if label.mask is not None:
        _, _, out.mask = _resize_pad(label.mask, height // mask_ratio,
                                     width // mask_ratio,
                                     height // mask_ratio,
                                     width // mask_ratio, 0)
    _shift_labels(out, pl, pu)
    out.resized_shape = (height, width)
    return out


def rectangle(label: LabelRecord, mask_ratio: int = 4,
              color: int = 114) -> LabelRecord:
    """Val-time aspect-preserving pad to the per-batch rectangle shape."""
    rh, rw = label.resized_shape
    th, tw = label.rectangle_shape
    out = label.copy()
    pl, pu, out.img = _resize_pad(label.img, th, tw, rh, rw, color)
    if label.mask is not None:
        _, _, out.mask = _resize_pad(label.mask, th // mask_ratio,
                                     tw // mask_ratio, rh // mask_ratio,
                                     rw // mask_ratio, 0)
    _shift_labels(out, pl, pu)
    out.resized_shape = (th, tw)
    return out


def flip_lr(label: LabelRecord) -> LabelRecord:
    out = label.copy()
    out.img = label.img[:, ::-1].copy()
    if label.mask is not None:
        out.mask = label.mask[:, ::-1].copy()
    w = label.resized_shape[1]
    if out.bboxes is not None and len(out.bboxes):
        x1 = w - out.bboxes[:, 2]
        x2 = w - out.bboxes[:, 0]
        out.bboxes[:, 0], out.bboxes[:, 2] = x1, x2
    for pts in (out.keypoints, out.obb_corners):
        if pts is not None and len(pts):
            pts[..., 0] = w - pts[..., 0]
    return out


def flip_ud(label: LabelRecord) -> LabelRecord:
    out = label.copy()
    out.img = label.img[::-1].copy()
    if label.mask is not None:
        out.mask = label.mask[::-1].copy()
    h = label.resized_shape[0]
    if out.bboxes is not None and len(out.bboxes):
        y1 = h - out.bboxes[:, 3]
        y2 = h - out.bboxes[:, 1]
        out.bboxes[:, 1], out.bboxes[:, 3] = y1, y2
    for pts in (out.keypoints, out.obb_corners):
        if pts is not None and len(pts):
            pts[..., 1] = h - pts[..., 1]
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
