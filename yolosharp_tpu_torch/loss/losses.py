"""Loss helpers (counterpart of yolosharp_tpu/loss/losses.py). Only the
level-flattening helper the predict path needs is ported so far."""

from __future__ import annotations

import torch


def flatten_levels(maps) -> torch.Tensor:
    """[(B, C, H, W)] x levels -> (B, A, C), anchors in row-major order
    per level (a view per level when the maps are channels-last)."""
    b = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, m.shape[1])
                      for m in maps], dim=1)
