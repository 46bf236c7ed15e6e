"""Segment mask ops: crop to boxes, decode from prototypes (counterpart of
yolosharp_tpu/ops/masks.py; parity target YoloSharp/Utils/Ops.cs:409-489),
the vectorized grid-compare path."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each xyxy box: masks (N, H, W), boxes
    (N, 4) in mask pixels; a pixel (c, r) is inside when x1 <= c < x2 and
    y1 <= r < y2."""
    _, h, w = masks.shape
    x1, y1, x2, y2 = boxes[:, :, None].split(1, dim=1)      # (N, 1, 1)
    r = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, None]
    c = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    inside = (r >= x1) & (r < x2) & (c >= y1) & (c < y2)
    return masks * inside


def process_mask(protos: torch.Tensor, masks_in: torch.Tensor,
                 bboxes: torch.Tensor, shape: Tuple[int, int],
                 upsample: bool = False) -> torch.Tensor:
    """Binary instance masks from prototypes and coefficients, in float32:
    protos (C, mh, mw), masks_in (N, C), bboxes xyxy (N, 4) in input-image
    pixels, shape = (ih, iw). The masks are cropped to their boxes at mask
    scale, then (upsample) bilinearly resized to (ih, iw) with half-pixel
    centres (jax.image.resize's weights renormalised at the borders equal
    F.interpolate's clamped ones when upsampling). Returns bool (N, ih, iw)
    if upsample else (N, mh, mw)."""
    c, mh, mw = protos.shape
    ih, iw = shape
    masks = (masks_in.float() @ protos.reshape(c, -1).float()).reshape(
        -1, mh, mw)
    ratio = torch.tensor([mw / iw, mh / ih, mw / iw, mh / ih],
                         dtype=bboxes.dtype, device=bboxes.device)
    masks = crop_mask(masks, bboxes * ratio)
    if upsample:
        masks = F.interpolate(masks[None], size=(ih, iw), mode="bilinear",
                              align_corners=False)[0]
    return masks > 0.0
