"""Attention blocks: PSA of the v11 detector, area attention of the v12
detector and the transformer blocks no zoo model builds (counterpart of
yolosharp_tpu/nn/attention.py: AttentionPSA, PSABlock, C2PSA, AAttn, ABlock,
A2C2f, TransformerLayer, TransformerBlock, C3TR).

The area attention runs ``kernels.attention_bihd``: the hand-written CUDA
kernel on CUDA tensors, its plain version on CPU tensors. PSA's keys are
half as wide as its values (C2PSA's attn_ratio 0.5: kd = hd / 2), so, as in
the JAX package, it takes the einsum path: plain torch, the softmax in
float32 cast back to the activations' type. As in
the JAX package, qkv / proj / pe are the reference's Conv blocks with SiLU
(a deliberate deviation from Ultralytics, docs/IMPLEMENTATION_STATUS.md);
PSA's ``pe`` is a 3x3 depthwise conv, AAttn's a 7x7 one with a conv bias.
C3TR's TransformerLayer is einsum code in the JAX package too, so it is
plain torch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import attention_bihd
from .common import C3, C3k, ConvBN


class AttentionPSA(nn.Module):
    """Multi-head self-attention over the whole map plus a positional conv
    (Block.cs:721-810). The qkv channels are per head [q | k | v] with q
    and k kd = head_dim / 2 wide."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = self.head_dim // 2
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBN(dim, dim + 2 * self.key_dim * num_heads, 1)
        self.proj = ConvBN(dim, dim, 1)
        self.pe = ConvBN(dim, dim, 3, g=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, nh,
                                                      2 * kd + hd)
        q, k, v = qkv.split([kd, kd, hd], dim=-1)
        attn = torch.einsum("bihd,bjhd->bhij", q * self.scale, k)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhij,bjhd->bihd", attn, v)
        nchw = (0, 3, 1, 2)
        out = out.reshape(b, h, w, c).permute(nchw)
        v_map = v.reshape(b, h, w, c).permute(nchw)
        return self.proj(out + self.pe(v_map))


class PSABlock(nn.Module):
    """Attention and a conv FFN (``ffn.0`` / ``ffn.1``, both with SiLU),
    each residual (Block.cs:699-719)."""

    def __init__(self, c: int, num_heads: int = 8):
        super().__init__()
        self.attn = AttentionPSA(c, num_heads)
        self.ffn = nn.Sequential(ConvBN(c, 2 * c, 1), ConvBN(2 * c, c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """CSP wrapper around n PSABlocks of c = c1 * e channels and c // 64
    heads (Block.cs:664-697)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBN(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, self.c // 64)
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split(self.c, dim=1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


class AAttn(nn.Module):
    """Area attention (Block.cs:1029-1118): full attention within `area`
    chunks of the flattened H*W sequence. The chunks are contiguous runs of
    the row-major sequence, not spatial tiles; area=1 is global attention.
    The qkv channels are per head [q | k | v] (channel = head*3hd + slot)."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.area, self.num_heads = area, num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        all_dim = self.head_dim * num_heads
        self.qkv = ConvBN(dim, all_dim * 3, 1)
        self.proj = ConvBN(all_dim, dim, 1)
        self.pe = ConvBN(all_dim, dim, 7, 1, 3, g=dim, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        if n % self.area:
            raise ValueError(
                f"AAttn: {h}x{w} = {n} positions do not split into "
                f"{self.area} areas (an input canvas that is a multiple of "
                f"32 always does)")
        nh, hd = self.num_heads, self.head_dim
        # NHWC view of the channels-last qkv map, cut into area chunks
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(
            b * self.area, n // self.area, nh, 3 * hd)
        q, k, v = qkv.split(hd, dim=-1)
        out = attention_bihd(q, k, v, self.scale).reshape(b, h, w, c)
        v_map = v.reshape(b, h, w, c)      # a copy: v is a strided slice
        nchw = (0, 3, 1, 2)
        out = out.permute(nchw) + self.pe(v_map.permute(nchw))
        return self.proj(out)


class ABlock(nn.Module):
    """Area-attention block (Block.cs:991-1020): AAttn and a conv MLP,
    both residual; both MLP convs have SiLU."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2,
                 area: int = 1):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, num_heads, area)
        self.mlp = nn.Sequential(ConvBN(dim, hidden, 1), ConvBN(hidden, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """Area-attention C2f (Block.cs:891-983): n pairs of ABlocks
    (``m.{i}.0`` / ``m.{i}.1``), or n C3k blocks when a2 is False; with
    a2 and residual, the output is x + gamma * out (gamma starts at 0.01)."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True,
                 area: int = 1, residual: bool = False,
                 mlp_ratio: float = 2.0, e: float = 0.5, g: int = 1,
                 shortcut: bool = True):
        super().__init__()
        c_ = int(c2 * e)
        assert c_ % 32 == 0, "A2C2f hidden dim must be a multiple of 32"
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN((1 + n) * c_, c2, 1)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area)
                            for _ in range(2))) if a2
            else C3k(c_, c_, 2, shortcut, g) for _ in range(n))
        self.gamma = (nn.Parameter(torch.full((c2,), 0.01))
                      if a2 and residual else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for m in self.m:
            y.append(m(y[-1]))
        out = self.cv2(torch.cat(y, 1))
        if self.gamma is None:
            return out
        return x + self.gamma.to(out.dtype).view(1, -1, 1, 1) * out


def _linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Linear in its input's type (float32 master weights cast, as the
    port's Conv2d casts)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class TransformerLayer(nn.Module):
    """ViT-style layer without LayerNorm (Transformer.cs:53-91), on (B, N,
    C): q / k / v Linears, then the in-projection, attention and out_proj of
    ``ma`` (a torch nn.MultiheadAttention, so its state dict loads as
    torch's: in_proj_weight (3c, c)), the softmax in float32 cast back, a
    residual, then fc1 -> fc2 and a residual. The math is the JAX
    package's; the weights run in the input's type."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = nn.MultiheadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def attention(self, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
        """``ma``'s multi-head attention of (B, N, C) q, k, v."""
        b, n, c = q.shape
        nh = self.num_heads
        hd = c // nh
        w = self.ma.in_proj_weight.to(q.dtype)
        bias = self.ma.in_proj_bias.to(q.dtype)
        q, k, v = (F.linear(t, w[i * c:(i + 1) * c], bias[i * c:(i + 1) * c])
                   .reshape(b, n, nh, hd) for i, t in enumerate((q, k, v)))
        attn = torch.einsum("bihd,bjhd->bhij", q * hd ** -0.5, k)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, n, c)
        return _linear(self.ma.out_proj, o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attention(_linear(self.q, x), _linear(self.k, x),
                           _linear(self.v, x)) + x
        return _linear(self.fc2, _linear(self.fc1, x)) + x


class TransformerBlock(nn.Module):
    """A ConvBN where c1 != c2, a learned position embedding (``linear``:
    p + linear(p)) and num_layers TransformerLayers over the H*W sequence
    (Transformer.cs:8-48)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int):
        super().__init__()
        self.c2 = c2
        self.conv = ConvBN(c1, c2) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads)
                                  for _ in range(num_layers)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        p = self.tr(p + _linear(self.linear, p))
        return p.reshape(b, h, w, c).permute(0, 3, 1, 2)


class C3TR(C3):
    """C3 whose inner stack is a TransformerBlock of 4 heads and n layers
    (Block.cs:499-520)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, e=e)
        c_ = int(c2 * e)
        self.m = TransformerBlock(c_, c_, 4, n)
