"""Detection-head bias priors and inference Conv+BN folding, for torch
modules (counterpart of yolosharp_tpu/ckpt/fuse.py).

bias_init: the Ultralytics prior the reference intends (Head.cs:129-150):
box-tower final bias 1.0, class-tower final bias log(5/nc/(640/stride)^2)
per level, one2one towers included.

fold_bn: kernel' = kernel * mul, bias' = beta + (conv_bias - mean) * mul
with mul = gamma/sqrt(var+eps) (conv_bias 0 for a conv without one),
computed once in float32 and stored on the modules in the layout their
route reads (HWIO for the 3x3 kernel, the packed C2f kernel weights); the
checkpointed parameters are left as they are. The JAX package's fold_bn
leaves a conv bias unscaled (beta - mean * mul + conv_bias), which differs
from the eval-BN forward wherever mul != 1; this one equals it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.common import C2f, ConvBN
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


@torch.no_grad()
def fold_bn(net: nn.Module) -> nn.Module:
    """Fold every ConvBN's BatchNorm statistics into its conv (inference
    only), in place; returns net. Its ConvBNs and C2fs then run folded."""
    for m in net.modules():
        if isinstance(m, ConvBN):
            bn = m.bn
            mul = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
            w = m.conv.weight.float() * mul[:, None, None, None]
            b = bn.bias.float() - bn.running_mean.float() * mul
            if m.conv.bias is not None:
                b = b + m.conv.bias.float() * mul
            m.set_folded(w, b)
    for m in net.modules():
        if isinstance(m, C2f):
            m.pack_folded()
    return net
