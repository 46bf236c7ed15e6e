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
(its note says how each route is built and what bounds it); this module
holds their layouts, routes, plans, checks and plain versions.

The conv's route is static, a function of the shape alone (``int8_route``):

- ``"gemm"``, 1x1 stride 1: a GEMM, M = B*H*W rows of xq viewed as (M, Cp)
  against wq viewed as (Co, Cp), on Hopper's ``wgmma`` s8;
- ``"flat"``, 3x3 padding 1 stride 1 or 2 with Cp >= 32: the 16-bit conv's
  flat-row tile (the input tile loaded by TMA once a channel chunk for all
  nine taps, four parity planes at stride 2), on ``wgmma`` s8;
- ``"mma"``, everything else (the 3-channel stems padded to Cp = 16, v5u's
  6x6/2 stem, any other k): the ``mma.sync`` implicit GEMM.

The two ``wgmma`` routes are one persistent warp-specialised kernel (a TMA
producer thread, two consumer warpgroups, one block an SM); ``int8_plan``
picks its tile (channel chunk, N tile, the flat-row tile's output rows and
columns) from the shape, the batch and the card's SM count. Its bound at
the models' shapes is the bytes it moves (1.14 ms over phase 17a's 76
shapes at bf16 b32), but what holds it on an H100 80GB HBM3 (700 W) is
its epilogue, ~20-40 instructions an output element (dequantise, two
roundings, the SiLU) not overlapped with the next tile's products: the
76 shapes take 7.5 ms, the 1x1 ones 1.7x ``torch._int_mm``'s time
(chip_smoke phase 17a). So the activation is a template argument and the
SiLU branch-free (a branch per element serialised them), each warp stages
its rows and stores whole 16-byte units, and the tiles leave the epilogue
registers (128-row GEMM tiles, a 64-channel N tile on the flat route).

Layouts: xq is NHWC int8 with the channels padded with zeros to Cp, a
multiple of 16 (16-byte rows for the copies and TMA's strides); wq is
(Co, k, k, Cp) int8, the conv's K contiguous for each output channel (the
K-major B operand that 8-bit ``wgmma`` needs).

On a CPU tensor the wrappers run the plain versions (the int32 sums exact:
F.conv2d in float64 on the int8 values, every partial sum far below 2**53);
on a CUDA tensor they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils.numerics import divide_by_constant
from . import build
from .conv3x3 import (ACT_CODES, COST_LAUNCH, COST_MMA, COST_OUT,
                      COST_ROUND, COST_STEP, COST_TILE_KB)

ACTS = {"identity": lambda y: y, "silu": F.silu, "relu": F.relu}


def padded_channels(ci: int) -> int:
    """Cp: Ci rounded up to a multiple of 16."""
    return -(-ci // 16) * 16


ROUTES = ("mma", "gemm", "flat")   # their codes in csrc/int8_conv.cu
TC_ROWS = 256        # flat rows of a 3x3 wgmma block: two warpgroups x 128
GEMM_ROWS = 128      # rows of a GEMM block: two warpgroups x 64
TC_CONSUMER_WARPS = 8
TC_MIN_BSTAGES, TC_MAX_BSTAGES = 4, 8


def int8_route(k: int, s: int, p: int, cp: int, co: int) -> str:
    """The conv's route for a k x k / stride s / padding p conv of Cp
    (padded) input and Co output channels: "gemm", "flat" or "mma"."""
    if k == 1 and s == 1 and p == 0:
        return "gemm"
    if k == 3 and p == 1 and s in (1, 2) and cp >= 32:
        return "flat"
    return "mma"


class I8Plan(NamedTuple):
    """What one wgmma launch runs: ``bk`` bytes of K a chunk (128 or 64),
    ``bn`` output channels a block (64 or 128 on the GEMM, 64 on the flat
    route), and on the flat route the
    block's ``rows`` output rows x ``wt`` output columns (0 on the GEMM,
    whose blocks are GEMM_ROWS rows of M). All 0 on the mma.sync route."""
    bk: int = 0
    bn: int = 0
    rows: int = 0
    wt: int = 0


def int8_smem(route: str, stride: int, plan: I8Plan, out_size: int) -> int:
    """Dynamic shared memory of one wgmma block (its i8_geometry) with the
    least weight ring: two A slots, four weight slots, the epilogue's
    staging (8 warps x 16 rows x 64 columns of the out_size-byte output),
    the barriers; the kernel takes up to 8 weight slots where the card's
    shared memory holds them."""
    bk, bn, rows, wt = plan
    if route == "gemm":
        tile = GEMM_ROWS
    else:
        p = wt + 3 - stride
        reach = 128 * -(-rows * p // 128)
        if stride == 1:
            tile = reach + 2 * p + 2
        else:
            plane = -(-(rows + 1) * p // 16) * 16
            tile = 3 * plane + reach + p + 1
    slot = -(-tile * bk // 1024) * 1024
    stage = TC_CONSUMER_WARPS * 16 * (64 * out_size + 16)
    return (1024 + 2 * slot + stage + 8 * (4 + 2 * TC_MAX_BSTAGES)
            + TC_MIN_BSTAGES * bk * bn)


def plan_features(B: int, H: int, W: int, cp: int, co: int, stride: int,
                  sms: int, plan: I8Plan) -> tuple:
    """A flat-route plan's (tile rounds of the persistent grid, then per
    tile: wgmma.m64n64k32 issued, k steps, KB of A tile copied, output
    elements)."""
    bk, bn, rows, wt = plan
    chunks = -(-cp // bk)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    p = wt + 3 - stride
    tiles = B * -(-ho // rows) * -(-wo // wt) * -(-co // bn)
    subtiles = 2 * -(-rows * p // 128)
    tile_kb = (chunks * (rows + 3 - stride) * p * bk
               * (1 if stride == 1 else 4) / 1e3)
    return (-(-tiles // sms), chunks * bk // 32 * 9 * subtiles * (bn // 64),
            chunks * 9, tile_kb, rows * wt * bn)


def plan_cost(B: int, H: int, W: int, cp: int, co: int, stride: int,
              sms: int, plan: I8Plan) -> float:
    """A model of a flat-route launch's time in SM clocks, on the 16-bit
    conv's fitted clocks (kernels/conv3x3.py COST_*: a wgmma.m64n64k32 s8
    moves the bytes of a wgmma.m64n64k16 in bf16 through the same pipe)."""
    rounds, mma, steps, tile_kb, out = plan_features(
        B, H, W, cp, co, stride, sms, plan)
    return (rounds * (COST_MMA * mma + COST_STEP * steps
                      + COST_TILE_KB * tile_kb + COST_OUT * out + COST_ROUND)
            + COST_LAUNCH)


@functools.lru_cache(maxsize=None)
def int8_plan(route: str, B: int, H: int, W: int, cp: int, co: int,
              stride: int, sms: int, out_size: int = 2) -> I8Plan:
    """The wgmma kernel's tile for one call on a card of sms SMs: on the
    GEMM, BK 128 and the N tile 128 where Co > 64 (else 64); on the flat
    route, BK 128 (64 at stride 2 and for Cp <= 64), the N tile 64 (its two
    m64 subtiles a warpgroup leave the epilogue the registers only there)
    and the band's rows and the W chunk (R P
    <= 256 flat rows, the shared memory within the card's) that plan_cost
    rates fastest; I8Plan() on the mma.sync route."""
    if route == "mma":
        return I8Plan()
    if route == "gemm":
        return I8Plan(128, 128 if co > 64 else 64)
    bk = 64 if stride == 2 or cp <= 64 else 128
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    best = None
    for splits in range(1, min(wo, 16) + 1):
        wt = -(-wo // splits)
        p = wt + 3 - stride
        if p > TC_ROWS or (splits > 1 and wt == -(-wo // (splits - 1))):
            continue
        for rows in sorted({-(-ho // n) for n in range(1, ho + 1)}):
            plan = I8Plan(bk, 64, rows, wt)
            if rows * p > TC_ROWS or int8_smem(
                    route, stride, plan, out_size) > build.SMEM_LIMIT:
                continue
            key = (plan_cost(B, H, W, cp, co, stride, sms, plan), -rows * wt)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


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
    lib.ys_int8_conv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 15
                                 + [ctypes.c_void_p])
    lib.ys_int8_silu_check.restype = ctypes.c_int
    lib.ys_int8_silu_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ys_int8_desc_probe.restype = ctypes.c_int
    lib.ys_int8_desc_probe.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 2
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
              act: str = "silu", plan: I8Plan = None) -> torch.Tensor:
    """The int8 conv + dequantise + bias + activation: xq (B, H, W, Cp) int8,
    wq (Co, k, k, Cp) int8, scale (Co,) float32 = a_scale * w_scale, b (Co,)
    in the output's type. Returns (B, Ho, Wo, Co) NHWC in b's type. On the
    card the route is int8_route's and the tile int8_plan's, or ``plan``
    where one is given (tests hold other tiles to the plain version)."""
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
    route = int8_route(k, stride, pad, cp, co)
    plan = plan or int8_plan(route, B, H, W, cp, co, stride,
                             build.sm_count(xq.device.index),
                             b.element_size())
    with torch.cuda.device(xq.device):
        status = _lib().ys_int8_conv(
            xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
            y.data_ptr(), B, H, W, cp, co, k, stride, pad, ACT_CODES[act],
            code, ROUTES.index(route), *plan,
            torch.cuda.current_stream(xq.device).cuda_stream)
    build.check_status("int8_conv", status)
    build.count_launch(int8_conv, xq.device)
    return y


def desc_probe(a: torch.Tensor, b: torch.Tensor, nr0: int) -> torch.Tensor:
    """The wgmma kernel's 8-bit descriptors at every row start: (nr0, 64,
    64) int32 A[r0 : r0 + 64] @ b.T for r0 < nr0, with a (128, bk) and b
    (64, bk) int8 (bk 64 or 128 bytes of K) loaded as the kernel loads its
    A tile and its weights (TMA under the 64- or 128-byte swizzle) and a
    read from row r0 as a tap reads its rows."""
    bk = a.shape[-1]
    if a.dtype != torch.int8 or b.dtype != torch.int8 or bk not in (64, 128) \
            or tuple(a.shape) != (128, bk) or tuple(b.shape) != (64, bk):
        raise ValueError("desc_probe: a (128, bk) and b (64, bk) int8, bk "
                         "64 or 128")
    _check_cuda("int8 desc_probe", a, b)
    out = torch.empty((nr0, 64, 64), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        status = _lib().ys_int8_desc_probe(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), nr0, bk,
            torch.cuda.current_stream(a.device).cuda_stream)
    build.check_status("int8 desc_probe", status)
    return out


def silu_check(device) -> int:
    """How many of the 2^32 float32 inputs the epilogue's branch-free SiLU
    (csrc/int8_conv.cu silu_rn) gives other bits than v / (1 + expf(-v))
    with the IEEE division, on the CUDA ``device``: 0 when the int8 conv's
    SiLU is the plain version's."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(bad.device):
        status = _lib().ys_int8_silu_check(
            bad.data_ptr(), torch.cuda.current_stream(bad.device).cuda_stream)
    build.check_status("int8 silu_check", status)
    return int(bad.item())


quantize_int8.launches = 0
int8_conv.launches = 0
quantize_int8.launches_by_device = {}
int8_conv.launches_by_device = {}
