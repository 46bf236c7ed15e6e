"""Box-format conversions, keypoint clipping and the OBB corner forms
(counterpart of yolosharp_tpu/ops/boxes.py; ``xyxyxyxy2xywhr`` runs the
cv2-free minimum-area rectangle of ``ops/rect.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .rect import min_area_rect


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the last axis."""
    cxy, half = x[..., :2], x[..., 2:4] * 0.5
    return torch.cat([cxy - half, cxy + half], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) on the last axis."""
    p1, p2 = x[..., :2], x[..., 2:4]
    return torch.cat([(p1 + p2) * 0.5, p2 - p1], dim=-1)


def xyxy2xywhn(x: torch.Tensor, w: float = 640, h: float = 640,
               clip: bool = False, eps: float = 0.0) -> torch.Tensor:
    """xyxy -> xywh normalised by the image width and height; clip first
    clips to (h - eps, w - eps)."""
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    return xyxy2xywh(x) / x.new_tensor([w, h, w, h])


def xywhn2xyxy(x: torch.Tensor, w: float = 640, h: float = 640,
               padw: float = 0, padh: float = 0) -> torch.Tensor:
    """Normalised xywh -> absolute xyxy, shifted by (padw, padh)."""
    return (xywh2xyxy(x * x.new_tensor([w, h, w, h]))
            + x.new_tensor([padw, padh, padw, padh]))


def clip_boxes(x: torch.Tensor, shape) -> torch.Tensor:
    """Clip xyxy boxes to the image (height, width)."""
    h, w = shape[0], shape[1]
    return torch.minimum(x.clamp(min=0), x.new_tensor([w, h, w, h]))


def clip_keypoints(kpts: torch.Tensor, shape) -> torch.Tensor:
    """Clip keypoints (..., 2|3) to the image (height, width); a keypoint
    outside it (before the clip) gets visibility 0."""
    h, w = shape[0], shape[1]
    x, y = kpts[..., 0], kpts[..., 1]
    xy = torch.stack([x.clamp(0, w), y.clamp(0, h)], -1)
    if kpts.shape[-1] == 3:
        oob = (x < 0) | (x > w) | (y < 0) | (y > h)
        vis = torch.where(oob, torch.zeros_like(kpts[..., 2]), kpts[..., 2])
        return torch.cat([xy, vis[..., None]], -1)
    return xy


def clip_obb_corners(corners: torch.Tensor, shape) -> torch.Tensor:
    """Clip OBB corner points (..., 2) to the image (height, width)."""
    h, w = shape[0], shape[1]
    return torch.stack([corners[..., 0].clamp(0, w),
                        corners[..., 1].clamp(0, h)], -1)


def xywhr2xyxyxyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h, r) -> the 4 corners (..., 4, 2): ctr + v1 + v2,
    ctr + v1 - v2, ctr - v1 - v2, ctr - v1 + v2 with v1 = (w/2 cos, w/2 sin)
    and v2 = (-h/2 sin, h/2 cos) (Ops.cs:13-37)."""
    ctr = x[..., 0:2]
    w, h, r = x[..., 2:3], x[..., 3:4], x[..., 4:5]
    cos, sin = torch.cos(r), torch.sin(r)
    v1 = torch.cat([w / 2 * cos, w / 2 * sin], -1)
    v2 = torch.cat([-h / 2 * sin, h / 2 * cos], -1)
    return torch.stack([ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2,
                        ctr - v1 + v2], -2)


def xyxyxyxy2xywhr(corners) -> np.ndarray:
    """Corner sets (..., 4, 2) -> (..., 5) float32 (cx, cy, w, h, r): OpenCV
    5.0's minAreaRect of each set (``ops.rect.min_area_rect``), its angle
    in radians. Host-side label preparation (Ops.cs:44-61)."""
    arr = np.asarray(corners, dtype=np.float32)
    out = min_area_rect(arr.reshape(-1, 4, 2))
    out[:, 4] = out[:, 4].astype(np.float64) * math.pi / 180.0
    return out.reshape(arr.shape[:-2] + (5,))


def sort_obb_corners(corners: torch.Tensor) -> torch.Tensor:
    """Corner points (n, 4, 2) sorted by their angle around the centre
    (Ops.cs:204-218)."""
    d = corners - corners.mean(-2, keepdim=True)
    order = torch.atan2(d[..., 1], d[..., 0]).argsort(-1)
    return corners.gather(-2, order[..., None].expand_as(corners))


def cxcywhr2xyxyxyxy(x) -> np.ndarray:
    """One (cx, cy, w, h, r) -> its 8 corner coordinates, float32, in the
    demo drawing's order (Ops.cs:491-513)."""
    cx, cy, w, h, r = x
    c, s = np.cos(r), np.sin(r)
    wh, hh = w / 2, h / 2
    return np.array([
        cx - wh * c + hh * s, cy - wh * s - hh * c,
        cx + wh * c + hh * s, cy + wh * s - hh * c,
        cx + wh * c - hh * s, cy + wh * s + hh * c,
        cx - wh * c - hh * s, cy - wh * s + hh * c,
    ], dtype=np.float32)
