"""Box-format conversions (counterpart of yolosharp_tpu/ops/boxes.py)."""

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
