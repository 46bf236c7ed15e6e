"""Box-format conversions and keypoint clipping (counterpart of
yolosharp_tpu/ops/boxes.py)."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the last axis."""
    cxy, half = x[..., :2], x[..., 2:4] * 0.5
    return torch.cat([cxy - half, cxy + half], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) on the last axis."""
    p1, p2 = x[..., :2], x[..., 2:4]
    return torch.cat([(p1 + p2) * 0.5, p2 - p1], dim=-1)


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
