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
"""

from __future__ import annotations

import math

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
    """(mul, beta + (conv_bias - mean) * mul) of one BatchNorm, float32."""
    mul = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * mul
    if conv_bias is not None:
        b = b + conv_bias.float() * mul
    return mul, b


@torch.no_grad()
def fold_bn(net: nn.Module) -> nn.Module:
    """Fold every ConvBN's (and ConvTranspose's) BatchNorm statistics into
    its conv (inference only), in place; returns net. Its ConvBNs, C2fs and
    ConvTransposes then run folded."""
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
    for m in net.modules():
        if isinstance(m, C2f):
            m.pack_folded()
    return net
