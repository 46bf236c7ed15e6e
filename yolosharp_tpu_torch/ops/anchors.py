"""Anchor grid and distance <-> box transforms of the DFL head
(counterpart of yolosharp_tpu/ops/anchors.py)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(feat_shapes: Sequence[Tuple[int, int]],
                 strides: Sequence[int],
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres (cell centres, offset 0.5) + per-anchor stride for
    (H, W) feature maps: returns (anchor_points (A, 2) in grid units,
    stride_tensor (A, 1)), float32."""
    points, strides_out = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        sy = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        syy, sxx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([sxx, syy], -1).reshape(-1, 2))
        strides_out.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(points), torch.cat(strides_out)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = True) -> torch.Tensor:
    """ltrb distances (last axis) -> boxes around anchor points (xywh or
    xyxy)."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor,
              reg_max: float | None = None) -> torch.Tensor:
    """xyxy boxes -> ltrb distances from anchor points, clamped to reg_max."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1)
    if reg_max is not None:
        dist = dist.clamp(0, reg_max - 0.01)
    return dist


def dfl_decode(pred_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """DFL integral: (..., 4*reg_max) logits -> (..., 4) distances, the
    softmax expectation over the fixed arange bins, in float32."""
    x = pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max).float()
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (x.softmax(-1) * proj).sum(-1)
