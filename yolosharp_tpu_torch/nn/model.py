"""Model assembly for the v5u, v8, v11 and v12 detect, segment, pose, OBB
and classify networks
(counterpart of yolosharp_tpu/nn/model.py: _v8_layers, _v5u_layers,
_v11_layers, _v12_layers, _CLS_KEEP, build_arch, YoloNet).

Layers live in ``self.model`` (an ``nn.ModuleList`` with parameter-free
placeholders at the Upsample and Concat indices), so state-dict keys read
``model.{i}.…`` as in Ultralytics checkpoints; the head is index 22 (v8),
24 (v5u), 23 (v11) or 21 (v12), and for classify 9 (v8) or 11 (v5u, v11,
v12: v12 classify takes the v11 trunk).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .attention import A2C2f, C2PSA
from .common import C2f, C3, C3k2, Concat, ConvBN, SPPF, Upsample
from .heads import DFL, Classify, Detect, Obb, Pose, Segment


class ArchCfg(NamedTuple):
    """Static architecture configuration."""

    version: str = "v8"
    size: str = "n"
    task: str = "detect"
    nc: int = 80
    reg_max: int = 16
    kpt_num: int = 17
    kpt_dim: int = 3
    end2end: bool = False


def _widths(wm: float, max_channels: Optional[int]) -> Tuple[int, ...]:
    base = (64, 128, 256, 512, 1024)
    if max_channels is None:
        return tuple(int(w * wm) for w in base)
    return tuple(min(int(w * wm), max_channels) for w in base)


def _v8_layers(size: str):
    """(layers, out_idx, concat_idx, widths) of the v8 backbone + neck.
    Each layer is a constructor taking the input channels, or "up" / "cat"."""
    dm, wm, maxc = {
        "n": (0.34, 0.25, 1024), "s": (0.34, 0.5, 1024),
        "m": (0.67, 0.75, 576), "l": (1.0, 1.0, 512), "x": (1.0, 1.25, 640),
    }[size]
    w = _widths(wm, maxc)
    d = tuple(int(x * dm) for x in (3, 6, 9))

    def conv(c2, k, s):
        return lambda c1: ConvBN(c1, c2, k, s)

    def c2f(c2, n, shortcut=False):
        return lambda c1: C2f(c1, c2, n, shortcut)

    layers = [
        conv(w[0], 3, 2), conv(w[1], 3, 2), c2f(w[1], d[0], True),
        conv(w[2], 3, 2), c2f(w[2], d[1], True),
        conv(w[3], 3, 2), c2f(w[3], d[1], True),
        conv(w[4], 3, 2), c2f(w[4], d[0], True),
        lambda c1: SPPF(c1, w[4], 5),
        "up", "cat", c2f(w[3], d[0]),
        "up", "cat", c2f(w[2], d[0]),
        conv(w[2], 3, 2), "cat", c2f(w[3], d[0]),
        conv(w[3], 3, 2), "cat", c2f(w[4], d[0]),
    ]
    return layers, (4, 6, 9, 12, 15, 18, 21), (1, 0, 3, 2), w


def _v5u_layers(size: str):
    """(layers, out_idx, concat_idx, widths) of the v5u backbone + neck: C3
    blocks and a 6x6 stride-2 stem with padding 2 (autopad would give 3;
    the 3x3 kernel does not take it, so it runs F.conv2d folded)."""
    dm, wm = {
        "n": (0.34, 0.25), "s": (0.34, 0.5), "m": (0.67, 0.75),
        "l": (1.0, 1.0), "x": (1.34, 1.25),
    }[size]
    w = _widths(wm, None)
    d = tuple(int(x * dm) for x in (3, 6, 9))

    def conv(c2, k, s, p=None):
        return lambda c1: ConvBN(c1, c2, k, s, p)

    def c3(c2, n, shortcut=True):
        return lambda c1: C3(c1, c2, n, shortcut)

    layers = [
        conv(w[0], 6, 2, 2), conv(w[1], 3, 2), c3(w[1], d[0]),
        conv(w[2], 3, 2), c3(w[2], d[1]),
        conv(w[3], 3, 2), c3(w[3], d[2]),
        conv(w[4], 3, 2), c3(w[4], d[0]),
        lambda c1: SPPF(c1, w[4], 5),
        conv(w[3], 1, 1), "up", "cat", c3(w[3], d[0], False),
        conv(w[2], 1, 1), "up", "cat", c3(w[2], d[0], False),
        conv(w[2], 3, 2), "cat", c3(w[3], d[0], False),
        conv(w[3], 3, 2), "cat", c3(w[4], d[0], False),
    ]
    return layers, (4, 6, 10, 14, 17, 20, 23), (1, 0, 3, 2), w


def _v11_layers(size: str):
    """(layers, out_idx, concat_idx, widths) of the v11 backbone + neck:
    C3k2 blocks, SPPF and C2PSA."""
    dm, wm, maxc, use_c3k = {
        "n": (0.5, 0.25, 1024, False), "s": (0.5, 0.5, 1024, False),
        "m": (0.5, 1.0, 512, True), "l": (1.0, 1.0, 512, True),
        "x": (1.0, 1.5, 768, True),
    }[size]
    w = _widths(wm, maxc)
    ds = int(2 * dm)

    def conv(c2, k, s):
        return lambda c1: ConvBN(c1, c2, k, s)

    def c3k2(c2, c3k, e=0.5):
        return lambda c1: C3k2(c1, c2, ds, c3k, e)

    layers = [
        conv(w[0], 3, 2), conv(w[1], 3, 2), c3k2(w[2], use_c3k, 0.25),
        conv(w[2], 3, 2), c3k2(w[3], use_c3k, 0.25),
        conv(w[3], 3, 2), c3k2(w[3], True),
        conv(w[4], 3, 2), c3k2(w[4], True),
        lambda c1: SPPF(c1, w[4], 5),
        lambda c1: C2PSA(c1, w[4], ds),
        "up", "cat", c3k2(w[3], use_c3k),
        "up", "cat", c3k2(w[2], use_c3k),
        conv(w[2], 3, 2), "cat", c3k2(w[3], use_c3k),
        conv(w[3], 3, 2), "cat", c3k2(w[4], True),
    ]
    return layers, (4, 6, 10, 13, 16, 19, 22), (1, 0, 3, 2), w


def _v12_layers(size: str):
    """(layers, out_idx, concat_idx, widths) of the v12 backbone + neck."""
    dm, wm, maxc, use_c3k, n_mult, residual, mlp_ratio = {
        "n": (0.5, 0.25, 1024, False, 1, False, 2.0),
        "s": (0.5, 0.5, 1024, False, 1, False, 2.0),
        "m": (0.5, 1.0, 512, True, 1, False, 2.0),
        "l": (1.0, 1.0, 512, True, 2, True, 1.2),
        "x": (1.0, 1.5, 768, True, 2, True, 1.2),
    }[size]
    w = _widths(wm, maxc)
    ds = int(2 * dm)

    def conv(c2, k, s):
        return lambda c1: ConvBN(c1, c2, k, s)

    def c3k2(c2, c3k, e=0.5):
        return lambda c1: C3k2(c1, c2, ds, c3k, e)

    def a2c2f(c2, n, a2, area):
        return lambda c1: A2C2f(c1, c2, n, a2, area, residual, mlp_ratio)

    layers = [
        conv(w[0], 3, 2), conv(w[1], 3, 2), c3k2(w[2], use_c3k, 0.25),
        conv(w[2], 3, 2), c3k2(w[3], use_c3k, 0.25),
        conv(w[3], 3, 2), a2c2f(w[3], 2 * n_mult, True, 4),
        conv(w[4], 3, 2), a2c2f(w[4], 2 * n_mult, True, 1),
        "up", "cat", a2c2f(w[3], n_mult, False, -1),
        "up", "cat", a2c2f(w[2], n_mult, False, -1),
        conv(w[2], 3, 2), "cat", a2c2f(w[3], n_mult, False, -1),
        conv(w[3], 3, 2), "cat", c3k2(w[4], True),
    ]
    return layers, (4, 6, 8, 11, 14, 17, 20), (1, 0, 3, 2), w


# version -> (its layers function, legacy head: v8 / v5u class towers are two
# 3x3 ConvBNs, v11 / v12 ones depthwise)
_BUILDERS = {"v8": (_v8_layers, True), "v5u": (_v5u_layers, True),
             "v11": (_v11_layers, False), "v12": (_v12_layers, False)}

# how many leading layers of the detect trunk the classify nets keep
# (Yolo.cs:518-592); v12 classify takes the v11 trunk
_CLS_KEEP = {"v8": 9, "v5u": 11, "v11": 11}
_CLS_TRUNK = {"v8": "v8", "v5u": "v5u", "v11": "v11", "v12": "v11"}


def build_arch(cfg: ArchCfg):
    """(layers, out_idx, concat_idx, head) for the detect, segment, pose,
    OBB or classify task; the segment head's Proto is ch[0] wide with NM =
    32 prototypes (yolosharp_tpu/nn/model.py:200-206), the pose head's
    keypoints are kpt_num x kpt_dim, the OBB head has one angle channel.
    The classify head is a constructor of its input channels (the last
    kept layer's)."""
    if cfg.version not in _BUILDERS or cfg.task not in (
            "detect", "segment", "pose", "obb", "classify"):
        raise NotImplementedError(
            f"the torch port has v5u, v8, v11 and v12 detect, segment, "
            f"pose, OBB and classify, not {cfg.version} {cfg.task}")
    if cfg.task == "classify":
        trunk = _CLS_TRUNK[cfg.version]
        layers, out_idx, concat_idx, _ = _BUILDERS[trunk][0](cfg.size)
        return (layers[:_CLS_KEEP[trunk]], out_idx, concat_idx,
                lambda c1: Classify(c1, cfg.nc))
    builder, legacy = _BUILDERS[cfg.version]
    layers, out_idx, concat_idx, w = builder(cfg.size)
    ch = (w[2], w[3], w[4])
    if cfg.task == "segment":
        head = Segment(cfg.nc, cfg.reg_max, ch, legacy, cfg.end2end)
    elif cfg.task == "pose":
        head = Pose(cfg.nc, cfg.reg_max, ch, legacy, cfg.end2end,
                    cfg.kpt_num, cfg.kpt_dim)
    elif cfg.task == "obb":
        head = Obb(cfg.nc, cfg.reg_max, ch, legacy, cfg.end2end)
    else:
        head = Detect(cfg.nc, cfg.reg_max, ch, legacy, cfg.end2end)
    return layers, out_idx, concat_idx, head


STRIDES = (8, 16, 32)


def init_weights(net: nn.Module, generator: torch.Generator) -> None:
    """torch.nn.Conv2d's and nn.Linear's default init (U(+-1/sqrt(fan_in))
    for weights and biases, as the JAX package's torch_kernel_init and
    torch_linear_init; a ConvTranspose2d's fan_in is Cin k k, as the JAX
    package's), drawn from `generator`; BatchNorm stays at identity
    statistics and A2C2f's gamma at 0.01."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, DFL):
                continue
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) \
                    and m.weight.requires_grad:
                fan_in = (m.weight.shape[0] * m.weight[0, 0].numel()
                          if isinstance(m, nn.ConvTranspose2d)
                          else m.weight[0].numel())
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)


def _out_channels(mod: nn.Module) -> int:
    """Output channels of a layer: its last conv (cv3 of a C3, else cv2 of
    a CSP block, else its own conv)."""
    last = mod.cv3 if isinstance(mod, C3) else getattr(mod, "cv2", mod)
    return last.conv.out_channels


class YoloNet(nn.Module):
    """v5u / v8 / v11 / v12 detect, segment, pose, OBB or classify network.
    forward(x) takes (B, 3, H, W) in [0, 1] and returns the head's raw maps
    {"one2many": {"box", "cls"[, "mask", "proto" | "kpt" | "angle"]},
    ["one2one"]}, or a classify net's {"cls": (B, nc) float32 logits}."""

    def __init__(self, cfg: ArchCfg, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        layers, out_idx, concat_idx, head = build_arch(cfg)
        self.out_idx, self.concat_idx = set(out_idx), concat_idx
        mods, chans, outputs = [], 3, []
        cat_count = 0
        for i, layer in enumerate(layers):
            if layer == "up":
                mods.append(Upsample())
            elif layer == "cat":
                mods.append(Concat())
                chans += outputs[concat_idx[cat_count]]
                cat_count += 1
            else:
                mod = layer(chans)
                mods.append(mod)
                chans = _out_channels(mod)
            if i in self.out_idx:
                outputs.append(chans)
        mods.append(head(chans) if cfg.task == "classify" else head)
        self.model = nn.ModuleList(mods)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor, skip_one2many: bool = False):
        """skip_one2many: End2End predict runs only the one2one towers."""
        outputs, cat_count = [], 0
        for i, m in enumerate(self.model):
            if isinstance(m, Detect):
                return m(outputs[-3:], skip_one2many=skip_one2many)
            if isinstance(m, Classify):
                return m(x)
            if isinstance(m, Concat):
                x = m([x, outputs[self.concat_idx[cat_count]]])
                cat_count += 1
            else:
                x = m(x)
            if i in self.out_idx:
                outputs.append(x)
        raise AssertionError("architecture has no head layer")
