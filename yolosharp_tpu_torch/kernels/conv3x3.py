"""3x3 convolution + bias + activation: ``conv3x3_silu`` (stride 1) and
``conv3x3s2_silu`` (stride 2), zero padding 1.

Replaces the Pallas kernels ``yolosharp_tpu/kernels/conv3x3.py``
``conv3x3_silu`` (``_kernel_s1``) and ``conv3x3s2_silu`` (``_kernel_s2``)
with one hand-written CUDA kernel, ``csrc/conv3x3.cu``. The public
functions keep the JAX signatures: NHWC ``x``, HWIO ``w``, ``(Co,)`` bias
(the folded BatchNorm), activation ``silu`` / ``relu`` / ``identity``.

What bounds it on the card: a YOLO 3x3 conv does 9*Ci multiply-adds per
output value, so the limit is how fast the operands reach the multipliers.
The route goes by dtype, statically, with no fallback:

- bfloat16 and float16 (one template on the element type): a flat-M
  implicit GEMM on Hopper's warpgroup MMA (``wgmma.m64nBNk16``, float32
  sums). M runs over the flat output pixels
  of the batch, N over Co, K over (tap, 32 channels). A block owns 128
  pixels x BN channels, BN = 128 where that grid still covers every SM,
  else 64 (``n_tile``). Each k step's A rows (the pixel each output pixel
  reads at that tap, zero-filled outside the image) and weight rows are
  copied with 16-byte ``cp.async`` into a 5-slot shared-memory ring three
  steps ahead, stored in the swizzled layouts that wgmma reads through
  shared-memory descriptors: no ldmatrix, no im2col, and stride 2 only
  changes the addresses. Bound by the L2 -> shared copies: 64 flop per
  copied byte at BN = 128, A copied once per tap. The stem (Ci <= 7)
  packs its 9 taps x Ci channels into one K <= 64 on ``mma.sync``.
- float32: the CUDA-core kernel (TF32 would break the float32 contract). A
  block owns 8x16 output pixels x 64 channels, stages the halo tile and the
  weight slice 16 channels at a time, and each thread keeps a 4-pixel x
  8-channel micro-tile (32 multiply-adds per 6 shared loads).

Neither needs the TPU kernel's layout tricks (flat-row im2col, junk
columns, parity planes for stride 2, H % R == 0): edges are masked.

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

ACT_CODES = {"identity": 0, "silu": 1, "relu": 2}
_ACTS = {"identity": lambda y: y, "silu": F.silu, "relu": F.relu}


def supported(k: int, s: int, p: int, d: int, g: int) -> bool:
    """Which convolutions the kernel computes: 3x3, stride 1 or 2, padding
    1, no dilation, no groups. Every such ConvBN on CUDA takes it."""
    return k == 3 and s in (1, 2) and p == 1 and d == 1 and g == 1


def n_tile(B: int, H: int, W: int, Ci: int, Co: int, stride: int,
           sms: int) -> int:
    """Output channels of one block of the 16-bit kernel: 0 for the stem
    (Ci <= 7, its own kernel), 128 where the grid of 128-pixel x 128-channel
    blocks still covers the card's sms SMs, else 64."""
    if Ci <= 7:
        return 0
    m = B * ((H - 1) // stride + 1) * ((W - 1) // stride + 1)
    if Co > 64 and -(-m // 128) * -(-Co // 128) >= sms:
        return 128
    return 64


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  act: str = "silu", stride: int = 1) -> torch.Tensor:
    """The plain PyTorch version: NHWC in, NHWC out (a view of a
    channels-last NCHW result)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                 stride=stride, padding=1)
    return _ACTS[act](y).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("conv3x3")
    fn = lib.ys_conv3x3
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return lib


def _launch(name: str, x, w, b, act: str, stride: int) -> torch.Tensor:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, Ci) and w (3, 3, Ci, "
                         f"Co), got {tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Ci = x.shape
    Co = w.shape[-1]
    if tuple(w.shape) != (3, 3, Ci, Co) or tuple(b.shape) != (Co,):
        raise ValueError(f"{name}: w must be (3, 3, {Ci}, Co) and b (Co,), "
                         f"got {tuple(w.shape)} and {tuple(b.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"{name}: unknown activation {act!r}")
    code, stream = build.launch_args(name, x, w, b)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    bn = (n_tile(B, H, W, Ci, Co, stride, build.sm_count(x.device.index))
          if x.dtype in build.HALF_DTYPES else 0)
    y = torch.empty((B, Ho, Wo, Co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _lib().ys_conv3x3(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, H, W,
            Ci, Co, stride, ACT_CODES[act], code, bn, stream)
    build.check_status(name, status)
    return y


def conv3x3_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 act: str = "silu") -> torch.Tensor:
    """Fused 3x3/s1/SAME conv + bias + activation. x: (B, H, W, Ci) NHWC,
    w: (3, 3, Ci, Co) HWIO, b: (Co,). Returns (B, H, W, Co)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, act, 1)
    y = _launch("conv3x3_silu", x, w, b, act, 1)
    build.count_launch(conv3x3_silu, x.device)
    return y


def conv3x3s2_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   act: str = "silu") -> torch.Tensor:
    """Fused 3x3/s2/pad-1 conv + bias + activation. x: (B, H, W, Ci),
    w: (3, 3, Ci, Co), b: (Co,). Returns (B, ceil(H/2), ceil(W/2), Co)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, act, 2)
    y = _launch("conv3x3s2_silu", x, w, b, act, 2)
    build.count_launch(conv3x3s2_silu, x.device)
    return y


conv3x3_silu.launches = 0
conv3x3s2_silu.launches = 0
conv3x3_silu.launches_by_device = {}
conv3x3s2_silu.launches_by_device = {}
