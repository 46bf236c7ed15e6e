"""Detection head (counterpart of yolosharp_tpu/nn/heads.py: _Branch,
Detect). The head returns RAW per-level maps; decoding lives in
``predict.py``. End2End heads carry ``one2one_*`` towers, run on detached
features (Head.cs:92-101)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .common import Conv2d, ConvBN, DWConv


class _Branch(nn.Sequential):
    """A tower ending in `out` channels; ``self[2]`` is the final Conv2d.
    legacy (v8): ConvBN 3x3 -> ConvBN 3x3 -> Conv2d 1x1. Otherwise (v12
    class towers): (DWConv 3x3 -> ConvBN 1x1) twice -> Conv2d 1x1, with keys
    ``{i}.0.0`` ... ``{i}.1.1`` as in the JAX tree."""

    def __init__(self, cin: int, mid: int, out: int, legacy: bool = True):
        if legacy:
            super().__init__(ConvBN(cin, mid, 3), ConvBN(mid, mid, 3),
                             Conv2d(mid, out, 1))
        else:
            super().__init__(
                nn.Sequential(DWConv(cin, cin, 3), ConvBN(cin, mid, 1)),
                nn.Sequential(DWConv(mid, mid, 3), ConvBN(mid, mid, 1)),
                Conv2d(mid, out, 1))


class DFL(nn.Module):
    """Holds the fixed DFL projection (arange over the bins) that
    Ultralytics checkpoints carry as ``dfl.conv.weight``. The decode
    (``ops.anchors.dfl_decode``) computes the same expectation directly."""

    def __init__(self, reg_max: int = 16):
        super().__init__()
        self.conv = nn.Conv2d(reg_max, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(
                torch.arange(reg_max, dtype=torch.float32).view(1, reg_max,
                                                                1, 1))


class Detect(nn.Module):
    """Anchor-free detection head (box DFL + cls towers per level). The
    box towers are always legacy; `legacy` picks the class towers' form."""

    def __init__(self, nc: int = 80, reg_max: int = 16,
                 ch: Sequence[int] = (64, 128, 256), legacy: bool = True,
                 end2end: bool = False):
        super().__init__()
        self.nc, self.reg_max, self.ch = nc, reg_max, tuple(ch)
        self.legacy, self.end2end = legacy, end2end
        c2, c3 = self.head_dims()

        def towers():
            return (nn.ModuleList(_Branch(c, c2, 4 * reg_max) for c in ch),
                    nn.ModuleList(_Branch(c, c3, nc, legacy) for c in ch))

        self.cv2, self.cv3 = towers()
        if end2end:
            self.one2one_cv2, self.one2one_cv3 = towers()
        self.dfl = DFL(reg_max)

    def head_dims(self):
        c2 = max(16, self.ch[0] // 4, self.reg_max * 4)
        c3 = max(self.ch[0], min(self.nc, 100))
        return c2, c3

    def forward(self, feats, skip_one2many: bool = False) -> Dict:
        def run(cv2, cv3, xs):
            return {"box": tuple(m(x) for m, x in zip(cv2, xs)),
                    "cls": tuple(m(x) for m, x in zip(cv3, xs))}

        preds = {}
        if not (skip_one2many and self.end2end):
            preds["one2many"] = run(self.cv2, self.cv3, feats)
        if self.end2end:
            detached = tuple(f.detach() for f in feats)
            preds["one2one"] = run(self.one2one_cv2, self.one2one_cv3,
                                   detached)
        return preds
