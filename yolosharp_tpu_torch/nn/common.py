"""Conv / CSP building blocks of the v5u, v8, v11 and v12 detectors and the
segment head's Proto as torch modules (counterpart of
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
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import c2f as c2f_kernel
from ..kernels import conv3x3

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
                                  self.stride, self.padding)


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm with the JAX package's statistics
    (yolosharp_tpu/nn/common.py:185-200): y normalised by its batch mean and
    biased variance, gradients through both (F.batch_norm), and the running
    statistics moved ``bn.momentum`` (0.03) of the way to the batch mean and
    the *biased* batch variance in float32. nn.BatchNorm2d would use the
    unbiased one."""
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

    @property
    def kernel_route(self) -> bool:
        return conv3x3.supported(self.k, self.s, self.p, self.d, self.g)

    def set_folded(self, w_oihw: torch.Tensor, bias: torch.Tensor) -> None:
        """Store folded weights in the layout this conv's route reads."""
        self.w_fold = (w_oihw.permute(2, 3, 1, 0).contiguous()
                       if self.kernel_route else w_oihw.contiguous())
        self.b_fold = bias.contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.b_fold is None:
            bn = batch_norm_train if self.training else batch_norm_eval
            return ACTS[self.act](bn(self.conv(x), self.bn))
        if self.kernel_route:
            fn = conv3x3.conv3x3_silu if self.s == 1 else conv3x3.conv3x3s2_silu
            return fn(_nhwc(x), self.w_fold, self.b_fold,
                      self.act).permute(0, 3, 1, 2)
        y = F.conv2d(x, self.w_fold, self.b_fold, self.s, self.p, self.d,
                     self.g)
        return ACTS[self.act](y)


class DWConv(ConvBN):
    """Depthwise conv: groups = gcd(c1, c2). Its groups keep it off the 3x3
    kernel, so folded it runs F.conv2d."""

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
        """After the child ConvBNs are folded: pack the kernel's weights."""
        if not self.kernel_route:
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
