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

- bfloat16 and float16 (one template on the element type), Ci >= 8: an
  implicit GEMM on Hopper's warpgroup MMA (``wgmma``, float32 sums) whose
  input tile is loaded once per channel chunk for all nine taps, the TPU
  kernel's flat-row trick: a block's R output rows x Wt columns of one
  image are stored as rows of P pixels (the padded band at stride 1, four
  parity planes at stride 2), so every tap's operand is one run of rows
  read through a shifted shared-memory descriptor, and the junk columns
  (P - Wt a row) are never stored. A producer thread feeds it with TMA
  (the zero padding is TMA's out-of-bounds fill) against mbarriers; two
  consumer warpgroups only run wgmma; one block an SM walks the tiles.
  ``conv_plan`` picks R, Wt and the N tile per call from the shape and the
  card's SM count, by a cost model fitted to the kernel's times on the
  card (``chip_conv_plans.py``); Ci or Co not a multiple of 8 is
  zero-padded here (TMA needs 16-byte strides). With the tile copied once
  and not nine times, what bounds it is its epilogue, not overlapped with
  the next tile's products, and each k step's barrier round trip (the
  source note of ``csrc/conv3x3.cu``). The stem (Ci <= 7) packs its 9
  taps x Ci channels into one K <= 64 on ``mma.sync``.
- float32: the CUDA-core kernel (TF32 would break the float32 contract). A
  block owns 8x16 output pixels x 64 channels, stages the halo tile and the
  weight slice 16 channels at a time, and each thread keeps a 4-pixel x
  8-channel micro-tile (32 multiply-adds per 6 shared loads).

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build

ACT_CODES = {"identity": 0, "silu": 1, "relu": 2}
_ACTS = {"identity": lambda y: y, "silu": F.silu, "relu": F.relu}


def supported(k: int, s: int, p: int, d: int, g: int) -> bool:
    """Which convolutions the kernel computes: 3x3, stride 1 or 2, padding
    1, no dilation, no groups. Every such ConvBN on CUDA takes it."""
    return k == 3 and s in (1, 2) and p == 1 and d == 1 and g == 1


# the 16-bit kernel's constants (csrc/conv3x3.cu)
TC_ROWS = 256          # flat rows of a block: two consumer warpgroups x 128
TC_BSTAGES = 4         # slots of the weight ring at least (up to 8 where
                       # the shared memory holds them)


class ConvPlan(NamedTuple):
    """What one 16-bit launch runs: ``bn`` output channels a block (0: the
    stem kernel, Ci <= 7), ``rows`` output rows and ``wt`` output columns a
    block."""
    bn: int
    rows: int = 0
    wt: int = 0


def chunk(stride: int) -> int:
    """Input channels a k step of the 16-bit kernel reads (its BK)."""
    return 64 if stride == 1 else 32


def subtiles(flat: int) -> int:
    """The m64 subtiles of flat rows the 16-bit kernel computes for a block
    of ``flat`` rows: one a consumer warpgroup up to 128 rows, else two a
    warpgroup on both."""
    return -(-flat // 64) if flat <= 128 else 4


def tc_smem(stride: int, rows: int, wt: int, bn: int) -> int:
    """Dynamic shared memory of one block of the 16-bit kernel (its
    tc_geometry) with the least weight ring: two input-tile slots, four
    weight slots, the barriers; the kernel takes more weight slots, up to 8,
    where the card's shared memory holds them."""
    bk = chunk(stride)
    p = wt + 3 - stride
    reach = 64 * subtiles(rows * p)
    if stride == 1:
        tile = reach + 2 * p + 2
    else:
        plane = -(-(rows + 1) * p // 16) * 16
        tile = 3 * plane + reach + p + 1
    slot = -(-tile * bk * 2 // 1024) * 1024
    return 1024 + 2 * slot + TC_BSTAGES * bk * bn * 2 + 8 * (4 + 2 * 8)


# plan_cost's clocks, fitted (non-negative least squares on the relative
# error) to the bf16 times of candidate plans at every 16-bit shape of
# every path at B=32 and B=2 on an H100 (chip_conv_plans.py):
# a wgmma.m64n64k16, a k step's barrier round trip, a KB of input tile, an
# output element's epilogue, a tile round and the launch
COST_MMA, COST_STEP, COST_TILE_KB, COST_OUT, COST_ROUND, COST_LAUNCH = (
    24.28, 281.8, 5.519, 0.5042, 1958.0, 11470.0)


def plan_features(B: int, Ho: int, Wo: int, Ci: int, Co: int, stride: int,
                  sms: int, plan: ConvPlan) -> tuple:
    """(tile rounds of the persistent grid, then per tile: wgmma.m64n64k16
    issued, k steps, KB of input tile copied, output elements)."""
    bn, rows, wt = plan
    bk = chunk(stride)
    p = wt + 3 - stride
    tiles = B * -(-Ho // rows) * -(-Wo // wt) * -(-Co // bn)
    chunks = -(-Ci // bk)
    mma = chunks * bk // 16 * 9 * subtiles(rows * p) * (bn // 64)
    tile_kb = (chunks * (rows + 3 - stride) * p * bk * 2
               * (1 if stride == 1 else 4) / 1e3)
    return -(-tiles // sms), mma, chunks * 9, tile_kb, rows * wt * bn


def plan_cost(B: int, Ho: int, Wo: int, Ci: int, Co: int, stride: int,
              sms: int, plan: ConvPlan) -> float:
    """A model of the launch's time in SM clocks: the persistent grid's
    rounds of tiles, each tile as long as its wgmma, k steps, input-tile
    copy and epilogue take (COST_*), plus the launch."""
    rounds, mma, steps, tile_kb, out = plan_features(B, Ho, Wo, Ci, Co,
                                                     stride, sms, plan)
    return (rounds * (COST_MMA * mma + COST_STEP * steps
                      + COST_TILE_KB * tile_kb + COST_OUT * out + COST_ROUND)
            + COST_LAUNCH)


@functools.lru_cache(maxsize=None)
def conv_plan(B: int, H: int, W: int, Ci: int, Co: int, stride: int,
              sms: int) -> ConvPlan:
    """The 16-bit kernel's tile for one call on a card of sms SMs: the stem
    where Ci <= 7, else the N tile (128 only where Co > 64), the W chunk
    (Wt + 2 or + 1 pixels a tile row, at most 256) and the band's rows
    (R P <= 256 flat rows, the shared memory within the card's) that
    plan_cost rates fastest. Ci and Co are the padded widths the kernel
    takes."""
    if Ci <= 7:
        return ConvPlan(0)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    best = None
    for bn in ((64, 128) if Co > 64 else (64,)):
        for splits in range(1, min(Wo, 16) + 1):
            wt = -(-Wo // splits)
            p = wt + 3 - stride
            if p > TC_ROWS or (splits > 1 and wt == -(-Wo // (splits - 1))):
                continue
            for rows in sorted({-(-Ho // n) for n in range(1, Ho + 1)}):
                if rows * p > TC_ROWS or \
                        tc_smem(stride, rows, wt, bn) > build.SMEM_LIMIT:
                    continue
                plan = ConvPlan(bn, rows, wt)
                key = (plan_cost(B, Ho, Wo, Ci, Co, stride, sms, plan),
                       -rows * wt, -bn)
                if best is None or key < best[0]:
                    best = (key, plan)
    return best[1]


def padded(c: int) -> int:
    """A channel count rounded up to the 16-bit kernel's multiple of 8."""
    return -(-c // 8) * 8


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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    probe = lib.ys_conv3x3_desc_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    return lib


def _launch(name: str, x, w, b, act: str, stride: int,
            plan: ConvPlan = None) -> torch.Tensor:
    """The kernel's launch; the 16-bit route runs ``plan`` where one is
    given (tests hold other tiles than conv_plan's to the plain version),
    else conv_plan's."""
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
    y = torch.empty((B, Ho, Wo, Co), dtype=x.dtype, device=x.device)
    cop = Co
    if x.dtype not in build.HALF_DTYPES:
        plan = ConvPlan(0)   # the float32 kernel has one tile
    else:
        cip, cop = (Ci, Co) if Ci <= 7 else (padded(Ci), padded(Co))
        if (cip, cop) != (Ci, Co):   # TMA needs 16-byte strides
            x = F.pad(x, (0, cip - Ci))
            w = F.pad(w, (0, cop - Co, 0, cip - Ci))
        plan = plan or conv_plan(B, H, W, cip, cop, stride,
                                 build.sm_count(x.device.index))
        Ci = cip
    with torch.cuda.device(x.device):
        status = _lib().ys_conv3x3(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, H, W,
            Ci, Co, cop, stride, ACT_CODES[act], code, *plan, stream)
    build.check_status(name, status)
    return y


def desc_probe(a: torch.Tensor, b: torch.Tensor, nr0: int) -> torch.Tensor:
    """The kernel's A descriptor at every row start: (nr0, 64, 64) float32
    A[r0 : r0 + 64] @ b for r0 < nr0, with a (128, 64) bfloat16 loaded as the
    kernel loads its input tile (TMA, 128-byte swizzle) and read from row r0
    as a tap reads its rows, b (64, 64) bfloat16."""
    build.launch_args("conv3x3 desc_probe", a, b)
    if a.dtype != torch.bfloat16 or tuple(a.shape) != (128, 64) \
            or tuple(b.shape) != (64, 64):
        raise ValueError("desc_probe: a (128, 64) and b (64, 64) bfloat16")
    out = torch.empty((nr0, 64, 64), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        status = _lib().ys_conv3x3_desc_probe(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), nr0,
            torch.cuda.current_stream(a.device).cuda_stream)
    build.check_status("conv3x3 desc_probe", status)
    return out


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
