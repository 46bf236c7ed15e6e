"""Anchor grid and distance <-> box transforms of the DFL head, rotated
ones included (counterpart of yolosharp_tpu/ops/anchors.py)."""

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


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor,
              anchor_points: torch.Tensor) -> torch.Tensor:
    """Rotated ltrb distances + angle (last axis) -> (cx, cy, w, h): the
    centre offset (rb - lt) / 2 rotated by the angle, around the anchor."""
    lt, rb = pred_dist.chunk(2, dim=-1)
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf, yf = ((rb - lt) / 2).chunk(2, dim=-1)
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)


def rbox2dist(target_bboxes: torch.Tensor, anchor_points: torch.Tensor,
              target_angle: torch.Tensor,
              reg_max: float | None = None) -> torch.Tensor:
    """Inverse of dist2rbox: rotated (cx, cy, w, h) + angle -> ltrb
    distances, clamped to reg_max."""
    xy, wh = target_bboxes.chunk(2, dim=-1)
    ox, oy = (xy - anchor_points).chunk(2, dim=-1)
    cos, sin = torch.cos(target_angle), torch.sin(target_angle)
    xf = ox * cos + oy * sin
    yf = -ox * sin + oy * cos
    w, h = wh.chunk(2, dim=-1)
    dist = torch.cat([w / 2 - xf, h / 2 - yf, w / 2 + xf, h / 2 + yf], -1)
    if reg_max is not None:
        dist = dist.clamp(0, reg_max - 0.01)
    return dist


def dfl_decode(pred_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """DFL integral: (..., 4*reg_max) logits -> (..., 4) distances, the
    softmax expectation over the fixed arange bins, in float32."""
    x = pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max).float()
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (x.softmax(-1) * proj).sum(-1)
