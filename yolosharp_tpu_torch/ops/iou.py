"""Pairwise box IoU (counterpart of yolosharp_tpu/ops/iou.py::box_iou)."""

from __future__ import annotations

import torch


def box_iou(box1: torch.Tensor, box2: torch.Tensor,
            eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M).
    Leading dimensions broadcast (the NMS passes a batch of images)."""
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:4]
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:4]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0)
    inter = inter.prod(-1)
    area1 = (a2 - a1).prod(-1)
    area2 = (b2 - b1).prod(-1)
    return inter / (area1 + area2 - inter + eps)
