"""Conv / CSP building blocks of the v5u, v8, v11 and v12 detectors, the
segment head's Proto, and the rest of the library's blocks that no zoo
model builds (Conv2 ... AGLU, at the end), as torch modules (counterpart of
yolosharp_tpu/nn/common.py, plain branches only).

Modules run NCHW tensors in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is a free NHWC view for the kernels. Submodule
names follow the Ultralytics state dict (``conv``, ``bn``, ``cv1``, ``m.0``
...), so checkpoints load with ``load_state_dict(strict=True)``.

Two forward modes, as in the JAX package:
- plain: ``Conv2d`` + BatchNorm (eps 1e-3, momentum 0.03) + activation, in
  train or eval BN mode, with the JAX package's numerics (``FastBN``): the
  train-mode running variance is the *biased* batch variance, and both
  modes keep the statistics in float32 and apply them in the activations'
  type. Convs cast their float32 weights to the input's type, so a float32
  master network runs a bfloat16 forward;
- folded (after ``ckpt.fuse.fold_bn``): BN is folded into the conv weights
  and becomes a bias. Then every 3x3 ConvBN the conv kernel takes, and every
  C2f the fused C2f kernel takes, runs through those kernels; on CPU tensors
  the kernels' wrappers run their plain versions. Only the predict copy is
  folded: training never routes a conv through the kernels.

int8 post-training quantisation (the JAX package's quant_calibrate /
quant_int8 / int8_conv, yolosharp_tpu/nn/common.py:590-652 and :844-876):
a folded ConvBN that the JAX ConvBN would quantise (``int8_eligible``: no
conv bias, no groups, no dilation, and not a DWConv or Conv2, whose JAX
classes do not take that branch) records the running max of |x| of its
input while ``calibrating``, and once ``ckpt.fuse.fold_bn`` has given it a
calibrated absmax it runs as int8 (``kernels.int8_conv``; a stem, whose
input has at most 7 channels, quantises in its conv's own launch,
``int8_conv_stem``), ahead of the 3x3 conv kernel; a C2f whose ConvBNs are
int8 or recording runs them one by one instead of the fused C2f kernel, as
JAX does on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import c2f as c2f_kernel
from ..kernels import conv3x3
from ..kernels.int8_conv import (activation_scale, int8_conv, int8_conv_stem,
                                 int8_route, quantize_int8, quantize_weight)
from ..parallel import dist

ACTS = {"silu": F.silu, "relu": F.relu, "identity": lambda x: x}


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC view of an NCHW tensor, made contiguous when it is a channel
    slice (the C2f split) or not channels-last."""
    return x.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its input's type: float32 master weights (and bias) are
    cast to the input's type, as the JAX Conv2d casts its kernel
    (yolosharp_tpu/nn/common.py:673)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d in its input's type, as Conv2d (the JAX package's
    ConvTranspose2dRaw: a dilated conv with the flipped kernel, which is
    the same function; its HWIO kernel crosses over as (Cin, Cout, k, k))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm with the JAX package's statistics
    (yolosharp_tpu/nn/common.py:185-200): y normalised by its batch mean and
    biased variance, gradients through both (F.batch_norm), and the running
    statistics moved ``bn.momentum`` (0.03) of the way to the batch mean and
    the *biased* batch variance in float32. nn.BatchNorm2d would use the
    unbiased one.

    Under an active process group (parallel.dist) the statistics are the
    global batch's, as the JAX package's over a data mesh: float32 sums of x
    and x * x over the ranks through the differentiable all-reduce (one a
    direction), so gradients flow through the global statistics;
    nn.SyncBatchNorm would refuse CPU tensors and move running_var by the
    unbiased variance."""
    ctx = dist.active()
    if ctx is not None and ctx.world > 1:
        return _batch_norm_global(y, bn)
    c = y.shape[1]
    dtype = torch.promote_types(y.dtype, torch.float32)
    mean = torch.zeros(c, dtype=dtype, device=y.device)
    var = torch.ones(c, dtype=dtype, device=y.device)
    # momentum 1: the buffers take the batch mean and unbiased variance
    out = F.batch_norm(y, mean, var, bn.weight, bn.bias, True, 1.0, bn.eps)
    n = y.numel() // c
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var * ((n - 1) / n), alpha=m)
    return out


def _batch_norm_global(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """batch_norm_train's rule over the ranks' rows together, in float32,
    as the JAX FastBN takes it: one all-reduce a direction of the sums of
    x and x * x and the count, the variance E[x^2] - mean^2 (at least 0),
    and y = x * k + (beta - mean * k), which keeps no centred copy of x
    for the backward."""
    x = y.float()
    c = x.shape[1]
    dims = (0, 2, 3)
    count = x.new_full((1,), x.numel() // c)
    total = dist.allsum(torch.cat([x.sum(dims), (x * x).sum(dims), count]))
    n = total[-1].detach()
    mean = total[:c] / n
    var = (total[c:2 * c] / n - mean * mean).clamp(min=0.0)
    k = bn.weight.float() * torch.rsqrt(var + bn.eps)
    b = bn.bias.float() - mean * k
    out = x * k.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
    return out.to(y.dtype)


def batch_norm_eval(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm as the JAX FastBN applies it: k = gamma /
    sqrt(var + eps) and b = beta - mean * k in float32, then y * k + b in
    y's type."""
    k = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * k
    shape = (1, -1, 1, 1)
    return y * k.to(y.dtype).view(shape) + b.to(y.dtype).view(shape)


class ConvBN(nn.Module):
    """Conv + BatchNorm + activation (the reference's Convs.Conv)."""

    # whether the JAX class of this module takes the ConvBN int8 branch
    int8_class = True
    # the int8 buffers, float32 whatever type the net is cast to (_apply)
    _INT8_F32 = ("i8_scale", "i8_ascale")

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, g: int = 1, d: int = 1,
                 use_bias: bool = False, act: str = "silu"):
        super().__init__()
        self.k, self.s, self.p, self.g, self.d = k, s, autopad(k, p, d), g, d
        self.act = act
        self.conv = Conv2d(c1, c2, k, s, self.p, dilation=d, groups=g,
                           bias=use_bias)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        # folded weight (HWIO when the 3x3 kernel takes this conv, OIHW
        # otherwise) and bias, set by ckpt.fuse.fold_bn; not checkpointed
        self.register_buffer("w_fold", None, persistent=False)
        self.register_buffer("b_fold", None, persistent=False)
        # int8 (set_int8): the (Co, k, k, Cp) int8 weights, a_scale *
        # w_scale (Co,) and a_scale, float32; not checkpointed
        self.register_buffer("i8_w", None, persistent=False)
        self.register_buffer("i8_scale", None, persistent=False)
        self.register_buffer("i8_ascale", None, persistent=False)
        # calibration: while `calibrating`, the running max |x| of the input
        self.calibrating = False
        self.absmax: Optional[torch.Tensor] = None

    @property
    def kernel_route(self) -> bool:
        return conv3x3.supported(self.k, self.s, self.p, self.d, self.g)

    @property
    def int8_eligible(self) -> bool:
        """The JAX ConvBN's quant_ok: no conv bias, no groups, no dilation
        (and a JAX class that reaches it)."""
        return (self.int8_class and self.conv.bias is None and self.g == 1
                and self.d == 1)

    @property
    def int8_route(self) -> Optional[str]:
        """The route of this ConvBN's int8 conv (kernels/int8_conv.py
        int8_route): "stem" quantises its input in the conv's own launch;
        None while it is not int8."""
        if self.i8_w is None:
            return None
        return int8_route(self.k, self.s, self.p, self.i8_w.shape[-1],
                          self.i8_w.shape[0], self.conv.in_channels)

    def set_int8(self, absmax: torch.Tensor) -> None:
        """Quantise the float32 folded weight (per output channel) and keep
        the scales of a calibrated input absmax: the int8 route."""
        w = self.w_fold.float()
        if self.kernel_route:
            w = w.permute(3, 2, 0, 1)
        wq, w_scale = quantize_weight(w)
        a_scale = activation_scale(absmax.to(w.device))
        self.i8_w, self.i8_ascale = wq, a_scale
        self.i8_scale = (a_scale * w_scale).contiguous()

    def _apply(self, fn, recurse=True):
        keep = {n: self._buffers[n] for n in self._INT8_F32
                if self._buffers.get(n) is not None}
        super()._apply(fn, recurse)
        for n, t in keep.items():   # moved with the net, never cast
            self._buffers[n] = t.to(self._buffers[n].device)
        return self

    def unfolded_weight(self) -> torch.Tensor:
        """The OIHW weight of the conv the BatchNorm follows, which
        ckpt.fuse.fold_bn scales."""
        return self.conv.weight

    def set_folded(self, w_oihw: torch.Tensor, bias: torch.Tensor) -> None:
        """Store folded weights in the layout this conv's route reads."""
        self.w_fold = (w_oihw.permute(2, 3, 1, 0).contiguous()
                       if self.kernel_route else w_oihw.contiguous())
        self.b_fold = bias.contiguous()

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.b_fold is None:
            bn = batch_norm_train if self.training else batch_norm_eval
            return ACTS[self.act](bn(self._conv(x), self.bn))
        if self.calibrating:
            a = x.abs().amax().float()
            self.absmax = a if self.absmax is None else torch.maximum(
                self.absmax, a)
        if self.i8_w is not None:
            if self.int8_route == "stem":
                return int8_conv_stem(_nhwc(x), self.i8_ascale, self.i8_w,
                                      self.i8_scale, self.b_fold, self.s,
                                      self.p, self.act).permute(0, 3, 1, 2)
            xq = quantize_int8(_nhwc(x), self.i8_ascale, self.i8_w.shape[-1])
            return int8_conv(xq, self.i8_w, self.i8_scale, self.b_fold,
                             self.s, self.p, self.act).permute(0, 3, 1, 2)
        if self.kernel_route:
            fn = conv3x3.conv3x3_silu if self.s == 1 else conv3x3.conv3x3s2_silu
            return fn(_nhwc(x), self.w_fold, self.b_fold,
                      self.act).permute(0, 3, 1, 2)
        y = F.conv2d(x, self.w_fold, self.b_fold, self.s, self.p, self.d,
                     self.g)
        return ACTS[self.act](y)


class DWConv(ConvBN):
    """Depthwise conv: groups = gcd(c1, c2). Its groups keep it off the 3x3
    kernel, so folded it runs F.conv2d. Never int8, even where the gcd is
    1: the JAX DWConv overrides the ConvBN call that holds the int8 branch."""

    int8_class = False

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 d: int = 1, use_bias: bool = False, act: str = "silu"):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d,
                         use_bias=use_bias, act=act)


class Bottleneck(nn.Module):
    """Standard bottleneck (Block.cs:572-608)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0], 1)
        self.cv2 = ConvBN(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Fast CSP bottleneck with n cascaded splits (Block.cs:371-399)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1)
        # e=1.0 matches the reference's C# argument-order quirk
        # (Block.cs:383 `e = 1.0f` inside the ctor call)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, (3, 3), 1.0)
            for _ in range(n))
        self.kernel_route = c2f_kernel.c2f_supported(n, shortcut, g, c1,
                                                     self.c, c2)
        # kernel-layout weights packed by ckpt.fuse.fold_bn: w1 (Cin, 2c),
        # wm1 / wm2 (3, 3, c, c), w2 (3c, C2) and their biases
        self.fused_weights: Tuple[str, ...] = ()

    def pack_folded(self) -> None:
        """After the child ConvBNs are folded: pack the kernel's weights,
        unless a child is int8 or recording its calibration (then the
        children run one by one)."""
        if not self.kernel_route or any(
                m.i8_w is not None or m.calibrating for m in self.modules()
                if isinstance(m, ConvBN)):
            return
        cv1, cv2, m = self.cv1, self.cv2, self.m[0]
        packed = {
            "w1": cv1.w_fold.flatten(1).t(), "b1": cv1.b_fold,
            "wm1": m.cv1.w_fold, "bm1": m.cv1.b_fold,
            "wm2": m.cv2.w_fold, "bm2": m.cv2.b_fold,
            "w2": cv2.w_fold.flatten(1).t(), "b2": cv2.b_fold,
        }
        for name, t in packed.items():
            self.register_buffer(f"k_{name}", t.contiguous(), persistent=False)
        self.fused_weights = tuple(f"k_{n}" for n in packed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_weights:
            args = [getattr(self, n) for n in self.fused_weights]
            return c2f_kernel.c2f_fused(_nhwc(x), *args).permute(0, 3, 1, 2)
        y = list(self.cv1(x).split(self.c, dim=1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class C3(nn.Module):
    """CSP bottleneck, 3 convs (Block.cs:404-442); bottlenecks with e=1.0."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, k: Tuple[int, int] = (1, 3)):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k, 1.0)
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    """C3 with (3, 3) bottleneck kernels (Block.cs:611-620)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, (3, 3))


class C3k2(nn.Module):
    """C2f whose inner blocks are C3k or Bottleneck(e=0.5) (Block.cs:623-662).
    Its bottlenecks are not the fused C2f kernel's (e=1.0), so its 3x3s run
    one by one through the conv kernel."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, g: int = 1, shortcut: bool = True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k
            else Bottleneck(self.c, self.c, shortcut, g, (3, 3), 0.5)
            for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).split(self.c, dim=1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class Proto(nn.Module):
    """The segment head's mask prototypes (Block.cs:51-84): cv1 3x3 ->
    upsample (ConvTranspose k2 s2 with a bias) -> cv2 3x3 -> cv3 1x1 to c2
    channels, at twice the input's resolution. Folded, cv1 and cv2 run
    through the conv kernel."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = ConvBN(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = ConvBN(c_, c_, 3)
        self.cv3 = ConvBN(c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def max_pool_same(x: torch.Tensor, k: int, s: int = 1) -> torch.Tensor:
    """MaxPool with torch 'pad k//2' semantics (pads with -inf)."""
    return F.max_pool2d(x, k, s, k // 2)


class SPPF(nn.Module):
    """SPP-Fast: chained max pools (Block.cs:236-285). The reference's cv1
    has identity activation (Block.cs:257), kept for output parity."""

    def __init__(self, c1: int, c2: int, k: int = 5, n: int = 3):
        super().__init__()
        c_ = c1 // 2
        self.k, self.n = k, n
        self.cv1 = ConvBN(c1, c_, 1, 1, act="identity")
        self.cv2 = ConvBN(c_ * (n + 1), c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(self.n):
            y.append(max_pool_same(y[-1], self.k))
        return self.cv2(torch.cat(y, 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (exact torch Upsample nearest)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """Parameter-free layer placeholder for upsample2x."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x(x)


class Concat(nn.Module):
    """Parameter-free layer placeholder: channel concat with a skip."""

    def forward(self, xs) -> torch.Tensor:
        return torch.cat(xs, 1)


# ------------------------------------------------------------------------
# The rest of the library's blocks (yolosharp_tpu/nn/common.py:884-1716).
# No v5u / v8 / v11 / v12 model builds them; each is a module of the
# library, with the JAX package's math and Ultralytics' state-dict names.


class Conv2(ConvBN):
    """Simplified RepConv (Convs.cs:67-103): a k x k conv and a 1x1 conv
    (``cv2``) that share one BatchNorm, both run in train and eval-BN
    mode, as in the JAX package. Folded, the 1x1 kernel joins the centre
    tap of the k x k one (the reference's lazy fuse; both scale by the
    shared gamma / sqrt(var + eps)), so a 3x3 Conv2 takes the conv kernel.
    Never int8: the JAX Conv2 is not a ConvBN."""

    int8_class = False

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 p: Optional[int] = None, g: int = 1, d: int = 1,
                 act: str = "silu"):
        super().__init__(c1, c2, k, s, p, g, d, act=act)
        self.cv2 = Conv2d(c1, c2, 1, s, 0, dilation=d, groups=g, bias=False)

    def unfolded_weight(self) -> torch.Tensor:
        w = self.conv.weight.clone()
        c = self.k // 2
        w[:, :, c, c] += self.cv2.weight[:, :, 0, 0]
        return w

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.cv2(x)


class LightConv(nn.Module):
    """A 1x1 ConvBN without activation, then a depthwise k x k one
    (Convs.cs:119-134)."""

    def __init__(self, c1: int, c2: int, k: int = 1, act: str = "relu"):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, 1, act="identity")
        self.conv2 = DWConv(c2, c2, k, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class DWConvTranspose2d(ConvTranspose2d):
    """Depthwise transpose conv, groups = gcd(c1, c2), with a bias
    (Convs.cs:139-152). The weight is torch's (c1, c2 / g, k, k); the JAX
    kernel (k, k, c1 / g, c2) crosses over by ``state_dict_from_jax``'s
    ``transposed_groups``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 p1: int = 0):
        super().__init__(c1, c2, k, s, p1, groups=math.gcd(c1, c2))


class Index(nn.Module):
    """Select one tensor of a list (Convs.cs:453-466)."""

    def __init__(self, index: int = 0):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[self.index]


class ConvTranspose(nn.Module):
    """ConvTranspose2d + optional BatchNorm + activation (Convs.cs:157-182;
    with bn=False the transposed conv has a bias). ckpt.fuse.fold_bn folds
    the BatchNorm into the transposed kernel's output channels."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0,
                 bn: bool = True, act: str = "silu"):
        super().__init__()
        self.act = act
        self.conv_transpose = ConvTranspose2d(c1, c2, k, s, p, bias=not bn)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03) if bn else None
        self.register_buffer("w_fold", None, persistent=False)
        self.register_buffer("b_fold", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.b_fold is not None:
            ct = self.conv_transpose
            y = F.conv_transpose2d(x, self.w_fold, self.b_fold, ct.stride,
                                   ct.padding)
        else:
            y = self.conv_transpose(x)
            if self.bn is not None:
                bn = batch_norm_train if self.training else batch_norm_eval
                y = bn(y, self.bn)
        return ACTS[self.act](y)


class Focus(nn.Module):
    """Space-to-channel stem: the four 2x2 pixel phases stacked on the
    channels, then a ConvBN (Convs.cs:187-206)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = ConvBN(4 * c1, c2, k, s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                   1))


class GhostConv(nn.Module):
    """Ghost convolution: half the channels from a k x k ConvBN, half from
    a cheap depthwise 5x5 one over them (Convs.cs:211-228)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: str = "silu"):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, k, s, act=act)
        self.cv2 = ConvBN(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class RepConv(nn.Module):
    """Training-mode RepVGG conv: 3x3 and 1x1 ConvBNs without activation,
    plus an identity BatchNorm (``bn``, with the FastBN statistics rule)
    when asked for and c1 == c2 at stride 1 (Convs.cs:233-359). The branch
    ConvBNs fold like any other; the identity BN stays a real BN."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 bn: bool = False, act: str = "silu"):
        super().__init__()
        self.act = act
        self.conv1 = ConvBN(c1, c2, 3, s, 1, g, act="identity")
        self.conv2 = ConvBN(c1, c2, 1, s, 0, g, act="identity")
        self.bn = (nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
                   if bn and c1 == c2 and s == 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x) + self.conv2(x)
        if self.bn is not None:
            bn = batch_norm_train if self.training else batch_norm_eval
            y = y + bn(x, self.bn)
        return ACTS[self.act](y)


class ChannelAttention(nn.Module):
    """Squeeze-excite channel gate: a biased 1x1 conv over the spatial
    mean, sigmoid (Convs.cs:365-382)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """Spatial gate: a k x k conv over the channel mean and max, sigmoid
    (Convs.cs:387-410)."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.cv1 = Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                          bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = torch.cat([x.mean(1, keepdim=True),
                           x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.cv1(stats))


class CBAM(nn.Module):
    """Convolutional Block Attention Module: the channel gate, then the
    spatial gate (Convs.cs:415-430)."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial_attention(self.channel_attention(x))


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (Block.cs:540-567): GhostConv, a depthwise k x k
    stride-2 ConvBN at s = 2, GhostConv without activation; the shortcut
    is the input, or at s = 2 a depthwise and a 1x1 ConvBN."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act="identity") if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act="identity"))
        self.shortcut = (nn.Sequential(
            DWConv(c1, c1, k, s, act="identity"),
            ConvBN(c1, c2, 1, 1, act="identity")) if s == 2
            else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.shortcut(x)


class SPP(nn.Module):
    """Spatial pyramid pooling: cv1, then max pools of each size beside it,
    concatenated, then cv2 (Block.cs:195-231)."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [max_pool_same(y, k)
                                         for k in self.k], 1))


class C1(nn.Module):
    """CSP bottleneck with one conv (Block.cs:290-320): cv1, then a 3x3
    ConvBN with a residual. The reference builds exactly one inner conv
    whatever n is (Block.cs:306), as the JAX package does."""

    def __init__(self, c1: int, c2: int, n: int = 1):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.m = nn.Sequential(ConvBN(c2, c2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.m(y) + y


class C2(nn.Module):
    """CSP bottleneck with two convs (Block.cs:325-366): cv1 split in two
    halves, the first through n bottlenecks (e = 1.0), concatenated with the
    second, cv2."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBN(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(self.c, self.c, shortcut, g,
                                            (3, 3), 1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split(self.c, dim=1)
        return self.cv2(torch.cat([self.m(a), b], 1))


class C3x(C3):
    """C3 with its (1, 3) bottleneck stack: the reference's override
    (Block.cs:444-454) registers the same bottlenecks as C3."""


class RepC3(nn.Module):
    """Rep-style C3 (Block.cs:459-494): n RepConvs over cv1, plus cv2; cv3
    only where c_ = c2 e differs from c2."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.m = nn.Sequential(*(RepConv(c_, c_) for _ in range(n)))
        self.cv3 = ConvBN(c_, c2, 1, 1) if c_ != c2 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.m(self.cv1(x)) + self.cv2(x)
        return y if self.cv3 is None else self.cv3(y)


class C3Ghost(C3):
    """C3 with a GhostBottleneck stack (Block.cs:525-535)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


class SCDown(nn.Module):
    """Separable downsample of v10 (Block.cs:812-827): a 1x1 ConvBN, then a
    depthwise k x k stride-s one (SiLU on both, as the JAX package)."""

    def __init__(self, c1: int, c2: int, k: int, s: int):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.cv2 = ConvBN(c2, c2, k, s, g=c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """Depthwise 7x7 and 3x3 ConvBNs side by side, summed, SiLU
    (Block.cs:1120-1139)."""

    def __init__(self, ed: int, act: str = "silu"):
        super().__init__()
        self.conv = ConvBN(ed, ed, 7, 1, 3, g=ed, act=act)
        self.conv1 = ConvBN(ed, ed, 3, 1, 1, g=ed, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Conditional identity block of v10 (Block.cs:861-883): depthwise 3x3,
    1x1 to 2c, RepVGGDW (lk) or a depthwise 3x3, 1x1 to c2, depthwise 3x3;
    residual where c1 == c2 and shortcut."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            ConvBN(c1, c1, 3, g=c1), ConvBN(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else ConvBN(2 * c_, 2 * c_, 3, g=2 * c_),
            ConvBN(2 * c_, c2, 1), ConvBN(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C3k2):
    """C2f with CIB blocks (Block.cs:829-859). It takes C3k2's
    split-and-concat forward and is not a C2f, so the fused C2f kernel never
    takes it."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 lk: bool = False, e: float = 0.5):
        super().__init__(c1, c2, n, e=e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, 1.0, lk)
                               for _ in range(n))


class HGStem(nn.Module):
    """PPHGNetV2 stem (Block.cs:90-137), ReLU throughout: stem1 3x3 / 2;
    zero pad right and bottom; stem2a, pad, stem2b (2x2 VALID convs) beside
    a 2x2 stride-1 VALID max pool; concat; stem3 3x3 / 2; stem4 1x1."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = ConvBN(c1, cm, 3, 2, act="relu")
        self.stem2a = ConvBN(cm, cm // 2, 2, 1, 0, act="relu")
        self.stem2b = ConvBN(cm // 2, cm, 2, 1, 0, act="relu")
        self.stem3 = ConvBN(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = ConvBN(cm, c2, 1, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        x = torch.cat([F.max_pool2d(x, 2, 1), x2], 1)
        return self.stem4(self.stem3(x))


class HGBlock(nn.Module):
    """PPHGNetV2 block (Block.cs:143-189): n k x k ConvBNs (or LightConvs)
    in a chain, the input and every output concatenated, squeezed by sc to
    c2 / 2 and excited by ec to c2; residual where shortcut and c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False,
                 act: str = "relu"):
        super().__init__()
        self.m = nn.ModuleList(
            LightConv(c1 if i == 0 else cm, cm, k, act) if lightconv
            else ConvBN(c1 if i == 0 else cm, cm, k, act=act)
            for i in range(n))
        self.sc = ConvBN(c1 + n * cm, c2 // 2, 1, 1, act=act)
        self.ec = ConvBN(c2 // 2, c2, 1, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [x]
        for m in self.m:
            y.append(m(y[-1]))
        out = self.ec(self.sc(torch.cat(y, 1)))
        return out + x if self.add else out


class AGLU(nn.Module):
    """Adaptive gated linear unit (Activation.cs:15-38):
    exp(softplus_{beta=-1}(kappa x - log lambda) / lambda) with lambda
    clipped at 1e-4, the softplus as the JAX package writes it,
    -log1p(exp(-(kappa x - log lambda))) (torch's Softplus(beta=-1) takes
    another branch past its threshold)."""

    def __init__(self):
        super().__init__()
        self.lambd = nn.Parameter(torch.rand(1))
        self.kappa = nn.Parameter(torch.rand(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lam = self.lambd.clamp(min=1e-4)
        gate = -torch.log1p(torch.exp(-(self.kappa * x - torch.log(lam))))
        return torch.exp(gate / lam)
