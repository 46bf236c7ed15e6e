"""Detection, segment, pose, OBB and classify heads (counterpart of
yolosharp_tpu/nn/heads.py: _Branch, _SimpleBranch, Detect, Segment, Pose,
Obb, Classify).
The heads return RAW per-level maps; decoding lives in ``predict.py``.
End2End heads carry ``one2one_*`` towers, run on detached features
(Head.cs:92-101)."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv2d, ConvBN, DWConv, Proto

# mask prototypes of the segment head (yolosharp_tpu/nn/model.py:200)
NM = 32


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

    def towers(self, one2one: bool) -> Dict[str, nn.ModuleList]:
        """The per-level towers of one branch, by the name of their maps."""
        p = "one2one_" if one2one else ""
        return {"box": getattr(self, p + "cv2"),
                "cls": getattr(self, p + "cv3")}

    def forward(self, feats, skip_one2many: bool = False) -> Dict:
        def run(one2one, xs):
            return {k: tuple(m(x) for m, x in zip(t, xs))
                    for k, t in self.towers(one2one).items()}

        preds = {}
        if not (skip_one2many and self.end2end):
            preds["one2many"] = run(False, feats)
        if self.end2end:
            preds["one2one"] = run(True, tuple(f.detach() for f in feats))
        return preds


class _SimpleBranch(nn.Sequential):
    """ConvBN 3x3 -> ConvBN 3x3 -> Conv2d 1x1 (always legacy): the segment
    head's mask-coefficient towers, the pose head's keypoint towers and the
    OBB head's angle towers, cv4."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__(ConvBN(cin, mid, 3), ConvBN(mid, mid, 3),
                         Conv2d(mid, out, 1))


class Segment(Detect):
    """Detect + mask prototypes (Proto on the stride-8 features, ch[0]
    channels wide, NM out) + per-level mask-coefficient towers cv4 of c4 =
    max(ch[0] // 4, NM) channels (Head.cs:280-330). The proto is shared:
    the one2one branch gets it detached, and End2End predict
    (skip_one2many) still computes it."""

    def __init__(self, nc: int = 80, reg_max: int = 16,
                 ch: Sequence[int] = (64, 128, 256), legacy: bool = True,
                 end2end: bool = False):
        super().__init__(nc, reg_max, ch, legacy, end2end)
        c4 = max(self.ch[0] // 4, NM)

        def towers():
            return nn.ModuleList(_SimpleBranch(c, c4, NM) for c in self.ch)

        self.cv4 = towers()
        if end2end:
            self.one2one_cv4 = towers()
        self.proto = Proto(self.ch[0], self.ch[0], NM)

    def towers(self, one2one: bool) -> Dict[str, nn.ModuleList]:
        out = super().towers(one2one)
        out["mask"] = getattr(self, ("one2one_" if one2one else "") + "cv4")
        return out

    def forward(self, feats, skip_one2many: bool = False) -> Dict:
        proto = self.proto(feats[0])
        preds = super().forward(feats, skip_one2many)
        for name, p in (("one2many", proto), ("one2one", proto.detach())):
            if name in preds:
                preds[name]["proto"] = p
        return preds


class Pose(Detect):
    """Detect + per-level keypoint towers cv4 of c4 = max(ch[0] // 4, K kd)
    channels, K kd out (Head.cs:526-563): raw "kpt" maps, decoded in
    predict and the loss. No proto."""

    def __init__(self, nc: int = 80, reg_max: int = 16,
                 ch: Sequence[int] = (64, 128, 256), legacy: bool = True,
                 end2end: bool = False, kpt_num: int = 17, kpt_dim: int = 3):
        super().__init__(nc, reg_max, ch, legacy, end2end)
        self.kpt_num, self.kpt_dim = kpt_num, kpt_dim
        nk = kpt_num * kpt_dim
        c4 = max(self.ch[0] // 4, nk)

        def towers():
            return nn.ModuleList(_SimpleBranch(c, c4, nk) for c in self.ch)

        self.cv4 = towers()
        if end2end:
            self.one2one_cv4 = towers()

    def towers(self, one2one: bool) -> Dict[str, nn.ModuleList]:
        out = super().towers(one2one)
        out["kpt"] = getattr(self, ("one2one_" if one2one else "") + "cv4")
        return out


class Obb(Detect):
    """Detect + per-level angle towers cv4 of c4 = max(ch[0] // 4, ne)
    channels, ne = 1 out (Head.cs:410-452). The "angle" maps come out as
    (sigmoid - 0.25) * pi, in [-pi/4, 3pi/4), in the network's dtype, as
    the JAX head computes them."""

    def __init__(self, nc: int = 80, reg_max: int = 16,
                 ch: Sequence[int] = (64, 128, 256), legacy: bool = True,
                 end2end: bool = False, ne: int = 1):
        super().__init__(nc, reg_max, ch, legacy, end2end)
        self.ne = ne
        c4 = max(self.ch[0] // 4, ne)

        def towers():
            return nn.ModuleList(_SimpleBranch(c, c4, ne) for c in self.ch)

        self.cv4 = towers()
        if end2end:
            self.one2one_cv4 = towers()

    def towers(self, one2one: bool) -> Dict[str, nn.ModuleList]:
        out = super().towers(one2one)
        out["angle"] = getattr(self, ("one2one_" if one2one else "") + "cv4")
        return out

    def forward(self, feats, skip_one2many: bool = False) -> Dict:
        preds = super().forward(feats, skip_one2many)
        for branch in preds.values():
            branch["angle"] = tuple((a.sigmoid() - 0.25) * math.pi
                                    for a in branch["angle"])
        return preds


class Classify(nn.Module):
    """Conv + global average pool + linear classifier (Head.cs:612-644, the
    JAX Classify): a 1x1 ConvBN to 1280 channels, the mean over H and W in
    the activations' type (summed in float32 and rounded once), then
    ``linear`` (1280 -> nc) in float32, as the JAX head multiplies its
    activations by a float32 kernel. Returns {"cls": float32 logits}."""

    C_ = 1280

    def __init__(self, c1: int, nc: int):
        super().__init__()
        self.conv = ConvBN(c1, self.C_, 1, 1)
        self.linear = nn.Linear(self.C_, nc)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.conv(x).mean((2, 3))
        w = self.linear.weight
        return {"cls": F.linear(y.float(), w.float(),
                                self.linear.bias.float())}
