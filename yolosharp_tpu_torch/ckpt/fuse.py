"""Detection-head bias priors and inference Conv+BN folding, for torch
modules (counterpart of yolosharp_tpu/ckpt/fuse.py).

bias_init: the Ultralytics prior the reference intends (Head.cs:129-150):
box-tower final bias 1.0, class-tower final bias log(5/nc/(640/stride)^2)
per level, one2one towers included.

fold_bn: kernel' = kernel * mul, bias' = beta + (conv_bias - mean) * mul
with mul = gamma/sqrt(var+eps) (conv_bias 0 for a conv without one),
computed once in float32 and stored on the modules in the layout their
route reads (HWIO for the 3x3 kernel, the packed C2f kernel weights); the
checkpointed parameters are left as they are. Every foldable shape the JAX
fold_bn names: each ConvBN (DWConv and the ConvBNs inside every block
included), Conv2 (its 1x1 kernel joined to the centre tap, both scaled by
the shared mul) and ConvTranspose's ``conv_transpose`` kernel (mul over
its output channels, dim 1 of torch's (Cin, Cout, k, k)). RepConv's
identity BatchNorm has no conv to fold into and stays a real BN. The JAX
package's fold_bn leaves a conv bias unscaled (beta - mean * mul +
conv_bias), which differs from the eval-BN forward wherever mul != 1; this
one equals it.

int8 (Config.int8_predict): given calibration stats (``quant_stats``, the
JAX package's flat "quant_stats" keys: each conv's dotted flax path +
".absmax"), fold_bn quantises each int8-eligible ConvBN that has a stat from
its float32 folded weight (``ConvBN.set_int8``) before the cast to the
compute type, and leaves its C2f unpacked. ``start_calibration`` /
``calibration_stats`` flag the eligible ConvBNs of a folded float32 copy
and read back what they recorded.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..nn.common import C2f, ConvBN, ConvTranspose
from ..nn.heads import Detect
from ..nn.model import STRIDES


@torch.no_grad()
def bias_init(net: nn.Module, nc: int) -> nn.Module:
    """Detection-prior head bias init, in place; returns net. The prior
    uses the 640 constant whatever the image size (Head.cs:135)."""
    head = net.model[-1]
    if not isinstance(head, Detect):
        raise TypeError(f"bias_init needs a detection head, got {type(head)}")
    towers = [("cv2", head.cv2), ("cv3", head.cv3)]
    if head.end2end:
        towers += [("cv2", head.one2one_cv2), ("cv3", head.one2one_cv3)]
    for kind, tower in towers:
        for level, branch in enumerate(tower):
            val = (1.0 if kind == "cv2"
                   else math.log(5 / nc / (640 / STRIDES[level]) ** 2))
            branch[2].bias.fill_(val)
    return net


def _bn_affine(bn: nn.BatchNorm2d, conv_bias):
    """(mul, beta + (conv_bias - mean) * mul) of one BatchNorm, float32,
    on the BatchNorm's device. Computed on the host, as the JAX fold
    computes it in numpy: PyTorch's CUDA sqrt is not correctly rounded
    (0.7% of float32 inputs an ulp off on an H100), so a fold on the card
    would quantise other int8 weights than the CPU's."""
    cpu = {k: t.detach().float().cpu() for k, t in (
        ("gamma", bn.weight), ("beta", bn.bias), ("mean", bn.running_mean),
        ("var", bn.running_var))}
    mul = cpu["gamma"] / torch.sqrt(cpu["var"] + bn.eps)
    b = cpu["beta"] - cpu["mean"] * mul
    if conv_bias is not None:
        b = b + conv_bias.detach().float().cpu() * mul
    dev = bn.weight.device
    return mul.to(dev), b.to(dev)


def stat_key(name: str) -> str:
    """The JAX "quant_stats" key of the ConvBN at module path `name`: its
    flax path (a YoloNet's module names without the leading "model.") +
    ".absmax"."""
    name = name.removeprefix("model.")
    return f"{name}.absmax" if name else "absmax"


def _eligible(net: nn.Module):
    return ((name, m) for name, m in net.named_modules()
            if isinstance(m, ConvBN) and m.int8_eligible)


def start_calibration(net: nn.Module) -> nn.Module:
    """Flag every int8-eligible ConvBN of an unfolded net to record the
    running max |x| of its input once folded (call before fold_bn, which
    then leaves the C2f blocks unpacked); returns net."""
    for _, m in _eligible(net):
        m.calibrating, m.absmax = True, None
    return net


def calibration_stats(net: nn.Module) -> Dict[str, np.ndarray]:
    """{stat key: float32 absmax} of the flagged ConvBNs that ran."""
    return {stat_key(name): np.float32(m.absmax.item())
            for name, m in _eligible(net)
            if m.calibrating and m.absmax is not None}


@torch.no_grad()
def fold_bn(net: nn.Module,
            quant_stats: Optional[Dict[str, np.ndarray]] = None
            ) -> nn.Module:
    """Fold every ConvBN's (and ConvTranspose's) BatchNorm statistics into
    its conv (inference only), in place; returns net. Its ConvBNs, C2fs and
    ConvTransposes then run folded; with `quant_stats`, every int8-eligible
    ConvBN that has a stat runs as int8."""
    for m in net.modules():
        if isinstance(m, ConvBN):
            mul, b = _bn_affine(m.bn, m.conv.bias)
            m.set_folded(m.unfolded_weight().float()
                         * mul[:, None, None, None], b)
        elif isinstance(m, ConvTranspose) and m.bn is not None:
            mul, b = _bn_affine(m.bn, None)
            m.w_fold = (m.conv_transpose.weight.float()
                        * mul[None, :, None, None]).contiguous()
            m.b_fold = b
    for name, m in _eligible(net) if quant_stats else ():
        absmax = quant_stats.get(stat_key(name))
        if absmax is not None:
            m.set_int8(torch.as_tensor(np.float32(absmax)))
    for m in net.modules():
        if isinstance(m, C2f):
            m.pack_folded()
    return net
