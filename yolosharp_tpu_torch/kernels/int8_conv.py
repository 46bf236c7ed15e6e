"""int8 post-training quantisation of a folded ConvBN: the quantise pass
``quantize_int8`` and the int8 conv ``int8_conv`` (with folded-BN bias and
activation), and their plain PyTorch versions.

The JAX package's int8_conv (yolosharp_tpu/nn/common.py:635-652) with the
ConvBN int8 branch around it (:844-876), as ``ConvBN`` calls it:

- ``activation_scale``: a_scale = max(absmax, 1e-6) / 127 in float32, from
  the calibrated max |x| of the conv's input;
- ``quantize_weight``: w_scale[co] = max(max |w[co]|, 1e-12) / 127 and
  wq = clip(round(w / w_scale), -127, 127), from the float32 folded kernel;
- ``quantize_int8``: xq = clip(round(x_f32 / a_scale), -127, 127), an IEEE
  division and round half to even;
- ``int8_conv``: the int8 x int8 -> int32 sums, times (a_scale * w_scale)
  in float32 (``scale``, formed first), cast to the working type, plus the
  folded bias in that type, then the activation.

Neither kernel replaces a Pallas kernel: JAX leaves the int8 conv to
lax.conv_general_dilated with preferred_element_type=int32, and PyTorch has
no int8 convolution on CUDA. Both are hand-written in ``csrc/int8_conv.cu``
(its note says what bounds them and how it is built); this module holds
their layouts, checks and plain versions.

Layouts: xq is NHWC int8 with the channels padded with zeros to Cp, a
multiple of 16 (16-byte rows for the conv's cp.async copies); wq is
(Co, k, k, Cp) int8, the conv's K contiguous for each output channel.

On a CPU tensor the wrappers run the plain versions (the int32 sums exact:
F.conv2d in float64 on the int8 values, every partial sum far below 2**53);
on a CUDA tensor they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.numerics import divide_by_constant
from . import build
from .conv3x3 import ACT_CODES

ACTS = {"identity": lambda y: y, "silu": F.silu, "relu": F.relu}


def padded_channels(ci: int) -> int:
    """Cp: Ci rounded up to a multiple of 16."""
    return -(-ci // 16) * 16


def activation_scale(absmax: torch.Tensor) -> torch.Tensor:
    """a_scale = max(absmax, 1e-6) / 127, a 0-d float32 tensor, rounded as
    the jitted JAX reference rounds it (divide_by_constant)."""
    return divide_by_constant(torch.clamp(absmax.float().reshape(()),
                                          min=1e-6), 127.0)


@torch.no_grad()
def quantize_weight(w: torch.Tensor):
    """(wq (Co, k, k, Cp) int8, w_scale (Co,) float32) of a float32 OIHW
    kernel, per output channel."""
    w = w.float()
    w_scale = divide_by_constant(
        torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12), 127.0)
    wq = torch.clamp(torch.round(w / w_scale.view(-1, 1, 1, 1)), -127, 127)
    wq = wq.permute(0, 2, 3, 1).to(torch.int8)
    cp = padded_channels(w.shape[1])
    return F.pad(wq, (0, cp - w.shape[1])).contiguous(), w_scale


def quantize_plain(x: torch.Tensor, a_scale: torch.Tensor,
                   cp: int) -> torch.Tensor:
    """The plain quantise pass: x (B, H, W, Ci) -> (B, H, W, cp) int8."""
    xq = torch.clamp(torch.round(x.float() / a_scale), -127, 127)
    return F.pad(xq.to(torch.int8), (0, cp - x.shape[-1]))


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    b: torch.Tensor, stride: int, pad: int,
                    act: str = "identity") -> torch.Tensor:
    """The plain int8 conv: NHWC int8 in, NHWC out in b's type; the sums
    in float64 (exact), scaled in float32, then rounded to b's type at the
    points the JAX ConvBN rounds (after the scale, after the bias)."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   wq.permute(0, 3, 1, 2).double(), stride=stride,
                   padding=pad)
    y = (acc.float() * scale.view(1, -1, 1, 1)).to(b.dtype)
    y = y + b.view(1, -1, 1, 1)
    return ACTS[act](y).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("int8_conv")
    lib.ys_quantize_int8.restype = ctypes.c_int
    lib.ys_quantize_int8.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.ys_int8_conv.restype = ctypes.c_int
    lib.ys_int8_conv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                                 + [ctypes.c_void_p])
    return lib


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: needs CUDA tensors on one device, got "
                             f"{[str(u.device) for u in tensors]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             f"16-byte aligned (shape {tuple(t.shape)}, "
                             f"strides {t.stride()})")


def quantize_int8(x: torch.Tensor, a_scale: torch.Tensor,
                  cp: int) -> torch.Tensor:
    """The quantise pass: x (B, H, W, Ci) float32 / bfloat16 / float16 NHWC,
    a_scale a 0-d float32 tensor -> (B, H, W, cp) int8, channels past Ci 0."""
    if x.device.type == "cpu":
        return quantize_plain(x, a_scale, cp)
    ci = x.shape[-1]
    if x.dim() != 4 or cp % 16 or cp < ci:
        raise ValueError(f"quantize_int8: x must be (B, H, W, Ci) and cp a "
                         f"multiple of 16 >= Ci, got {tuple(x.shape)}, {cp}")
    code = build.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"quantize_int8: takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if a_scale.dtype != torch.float32 or a_scale.numel() != 1:
        raise ValueError("quantize_int8: a_scale must be one float32 value")
    x = x.contiguous()
    _check_cuda("quantize_int8", x, a_scale)
    xq = torch.empty((*x.shape[:3], cp), dtype=torch.int8, device=x.device)
    vec = int(ci * x.element_size() % 16 == 0)
    with torch.cuda.device(x.device):
        status = _lib().ys_quantize_int8(
            x.data_ptr(), a_scale.data_ptr(), xq.data_ptr(),
            x.numel() // max(ci, 1), ci, cp, vec, code,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status("quantize_int8", status)
    build.count_launch(quantize_int8, x.device)
    return xq


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              b: torch.Tensor, stride: int, pad: int,
              act: str = "silu") -> torch.Tensor:
    """The int8 conv + dequantise + bias + activation: xq (B, H, W, Cp) int8,
    wq (Co, k, k, Cp) int8, scale (Co,) float32 = a_scale * w_scale, b (Co,)
    in the output's type. Returns (B, Ho, Wo, Co) NHWC in b's type."""
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, scale, b, stride, pad, act)
    if xq.dim() != 4 or wq.dim() != 4 or wq.shape[1] != wq.shape[2]:
        raise ValueError(f"int8_conv: xq must be (B, H, W, Cp) and wq (Co, "
                         f"k, k, Cp), got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    B, H, W, cp = xq.shape
    co, k = wq.shape[0], wq.shape[1]
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8 or cp % 16
            or wq.shape[3] != cp):
        raise ValueError(f"int8_conv: int8 xq and wq with the same Cp, a "
                         f"multiple of 16; got {xq.dtype} {tuple(xq.shape)} "
                         f"and {wq.dtype} {tuple(wq.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (co,) \
            or tuple(b.shape) != (co,):
        raise ValueError(f"int8_conv: scale must be ({co},) float32 and b "
                         f"({co},), got {scale.dtype} {tuple(scale.shape)} "
                         f"and {tuple(b.shape)}")
    code = build.DTYPE_CODES.get(b.dtype)
    if code is None:
        raise TypeError(f"int8_conv: outputs float32, bfloat16 or float16, "
                        f"got {b.dtype}")
    if act not in ACT_CODES:
        raise ValueError(f"int8_conv: unknown activation {act!r}")
    _check_cuda("int8_conv", xq, wq, scale, b)
    ho, wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    y = torch.empty((B, ho, wo, co), dtype=b.dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        status = _lib().ys_int8_conv(
            xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
            y.data_ptr(), B, H, W, cp, co, k, stride, pad, ACT_CODES[act],
            code, torch.cuda.current_stream(xq.device).cuda_stream)
    build.check_status("int8_conv", status)
    build.count_launch(int8_conv, xq.device)
    return y


quantize_int8.launches = 0
int8_conv.launches = 0
quantize_int8.launches_by_device = {}
int8_conv.launches_by_device = {}
