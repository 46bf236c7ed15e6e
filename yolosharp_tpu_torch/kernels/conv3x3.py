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
  source note of ``csrc/conv3x3.cu``). The stem (Ci <= 7) takes the
  streaming kernel of ``csrc/stem.cuh`` instead, which it shares with the
  int8 stem: bound by the bytes it moves (3 channels read, 32-96 written a
  pixel), it keeps persistent blocks fed a ring of input bands by TMA,
  packs its 9 taps x Ci channels into one K on ``mma.sync``, computes every
  output channel of a pixel in one block and writes whole 16-byte output
  lines; ``stem_plan`` picks its tile, ring and blocks an SM.
- float32: the CUDA-core kernel, float32 FMAs in every form (TF32 would
  break the float32 contract; the bound is the 67 TFLOP/s float32 pipe,
  which every path's shapes at B=2 reach ~0.4 of on an H100 80GB HBM3 at
  700 W, below cuDNN's full-float32 ``F.conv2d``, PERF.md §6). A
  block of 256 threads owns TH x TW output pixels x TN channels, each
  thread an 8-pixel x 8-channel register tile read as float4 from both
  operands (the input staged as float4 units of 4 channels a pixel, the
  columns split by parity at stride 2, so a thread's pixels are
  consecutive units); the input channels go 8 at a time through a
  two-stage ring of 16-byte ``cp.async`` copies, so the next chunk's copy
  overlaps this one's products. ``f32_plan`` picks the tile and a split of
  the Ci sum over blocks (added in a fixed order by a second pass: the same
  bits from run to run) per call, so that the grid fills the card at B=1
  and B=2 too. The stem (Ci <= 4) runs one chunk of 4 channels, and Ci or
  Co not a multiple of 4 one tile, with plain loads.

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
    """What one 16-bit launch of the tensor-core kernel (Ci >= 8) runs:
    ``bn`` output channels a block, ``rows`` output rows and ``wt`` output
    columns a block."""
    bn: int
    rows: int = 0
    wt: int = 0


class StemPlan(NamedTuple):
    """What one launch of the stem kernel (csrc/stem.cuh; the 16-bit conv
    at Ci <= 7 and the int8 stem route) runs: a tile of ``rows`` output rows
    x ``strips`` strips of 32 output columns, ``ring`` input-band slots in
    flight, ``blocks`` blocks an SM, and the output channels ``cg`` an
    epilogue chunk (the whole Co wherever it fits)."""
    rows: int
    strips: int
    ring: int
    blocks: int
    cg: int


# the stem kernel's constants (csrc/stem.cuh): consumer warps, output
# columns a strip, band slots at most; its tiles (rows, strips); a Hopper
# SM's shared memory (two blocks take 1 KB of it each besides their own)
STEM_WARPS, STEM_STRIP, STEM_MAX_RING = 8, 32, 4
STEM_TILES = ((16, 1), (8, 1), (4, 2), (2, 4), (1, 8))
SM_SMEM = 233472


def stem_ksteps(k: int, ci: int, int8: bool) -> int:
    """The k steps of the stem kernel's packed K = k k Ci: k16 steps in 16
    bits (2 to K = 32, else 4), k32 steps in int8 (1 to K = 32, else 4)."""
    if int8:
        return 1 if k * k * ci <= 32 else 4
    return 2 if k * k * ci <= 32 else 4


def stem_band(k: int, stride: int, pad: int, ci: int, rows: int, isz: int):
    """(rows, elements a row) of one strip's input band: (rows - 1) s + k
    rows of the strip's (31 s + k) Ci elements from the 16-byte unit its
    first element (column 32 j s - pad) lies in, rounded up to 16 bytes."""
    unit = 16 // isz
    shift = (-pad * ci) % unit
    iw = shift + ((STEM_STRIP - 1) * stride + k) * ci
    return (rows - 1) * stride + k, -(-iw // unit) * unit


def stem_smem(k: int, stride: int, pad: int, ci: int, co: int,
              plan: StemPlan, isz: int = 2, osz: int = 2,
              int8: bool = False) -> int:
    """Dynamic shared memory of one stem block (its stem_geometry): the ring
    of band slots, the int8 route's two quantised copies, the weights as B
    fragments, bias and scale, the warps' staging rows, the barriers."""
    ih, iwb = stem_band(k, stride, pad, ci, plan.rows, isz)
    sub = -(-ih * iwb * isz // 128) * 128     # a strip's band, 128-aligned
    slot = plan.strips * sub
    q = -(-plan.strips * sub // isz // 128) * 128 if int8 else 0
    wfrag = stem_ksteps(k, ci, int8) * -(-co // 8) * 32 * 8
    cop32 = -(-co // 32) * 32
    stage = STEM_WARPS * STEM_STRIP * (plan.cg * osz + 16)
    return (128 + plan.ring * slot + 2 * q + wfrag + 8 * cop32 + stage
            + 16 * STEM_MAX_RING)


@functools.lru_cache(maxsize=None)
def stem_plan(B: int, H: int, W: int, Ci: int, Co: int, stride: int,
              sms: int, k: int = 3, pad: int = 1, isz: int = 2, osz: int = 2,
              int8: bool = False) -> StemPlan:
    """The stem kernel's plan for one call on a card of sms SMs: channel
    chunks of the whole Co up to 128 (64 for a float32 output), the ring's
    four slots (fewer where the shared memory runs out), two blocks an SM
    where two fit, and of STEM_TILES the tile whose persistent grid gives
    its busiest warp the fewest strips (its rounds of tiles times the
    strips a warp takes a tile), then the one that reads the fewest input
    rows an output row (the band's halo), then the larger tile."""
    ho = (H + 2 * pad - k) // stride + 1
    wo = (W + 2 * pad - k) // stride + 1
    cg = min(-(-Co // 32) * 32, 128 if osz == 2 else 64)
    best = None
    for rows, strips in STEM_TILES:
        for ring in range(STEM_MAX_RING, 1, -1):
            plan = StemPlan(rows, strips, ring, 1, cg)
            smem = stem_smem(k, stride, pad, Ci, Co, plan, isz, osz, int8)
            if smem <= build.SMEM_LIMIT:
                break
        else:
            continue
        blocks = 2 if 2 * (smem + 1024) <= SM_SMEM else 1
        tiles = B * -(-ho // rows) * -(-wo // (STEM_STRIP * strips))
        rounds = -(-tiles // (sms * blocks))
        key = (rounds * -(-rows * strips // STEM_WARPS),
               ((rows - 1) * stride + k) / rows, -rows * strips)
        if best is None or key < best[0]:
            best = (key, plan._replace(blocks=blocks))
    return best[1]


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
    kernel's stem_plan where Ci <= 7, else the N tile (128 only where Co >
    64), the W chunk (Wt + 2 or + 1 pixels a tile row, at most 256) and the
    band's rows (R P <= 256 flat rows, the shared memory within the card's)
    that plan_cost rates fastest. Ci and Co are the padded widths the
    kernel takes (the stem's unpadded)."""
    if Ci <= 7:
        return stem_plan(B, H, W, Ci, Co, stride, sms)
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


class F32Plan(NamedTuple):
    """What one float32 launch runs: ``tn`` output channels a block, ``sw``
    strips of 8 output columns a tile row (the tile is 256 / (tn / 8) / sw
    rows x 8 sw columns), and the Ci sum split over ``splits`` blocks."""
    tn: int
    sw: int
    splits: int = 1


# the float32 kernel's constants (csrc/conv3x3.cu conv_f32_kernel): its
# tiles (tn, sw), input channels a chunk (the stem, Ci <= 4: one chunk of
# 4, plain loads)
F32_THREADS, F32_CK, F32_STEM_CK = 256, 8, 4
F32_TILES = ((32, 4), (64, 1), (64, 2), (128, 1), (256, 1))
F32_ODD_TILE = (64, 2)        # Ci or Co not a multiple of 4: plain loads
F32_STEM_TILES = ((32, 4), (64, 2))
# f32_plan's clocks (SM clocks of an H100): a chunk's barrier and copy
# latency not hidden, the second pass's launch, and the card's bytes a
# clock (3.35 TB/s at ~1.75 GHz) for the split sums' workspace traffic
F32_COST_CHUNK, F32_COST_LAUNCH, F32_BYTES_PER_CLOCK = 300.0, 5000.0, 1900.0
F32_COST_SLACK = 0.05


def f32_tile(tn: int, sw: int):
    """(output rows, output columns) of a float32 block."""
    return F32_THREADS // (tn // 8) // sw, 8 * sw


def f32_smem(stride: int, tn: int, sw: int, ck: int = F32_CK) -> int:
    """Dynamic shared memory of a float32 block: two stages of the input
    tile (float4 units) and the weights of ck channels x 9 taps x tn."""
    th, tw = f32_tile(tn, sw)
    ih, iw = (th - 1) * stride + 3, (tw - 1) * stride + 3
    return 2 * 16 * (ck // 4 * ih * iw + ck * 9 * tn // 4)


def f32_cost(B: int, H: int, W: int, Ci: int, Co: int, stride: int,
             sms: int, plan: F32Plan) -> float:
    """A model of a float32 launch's time in SM clocks: the grid's rounds
    (one block an SM: the 8 x 8 register tile and its operands take more
    than the 128 registers a thread that two blocks of 256 threads would
    leave), each as long as its chunks' FMAs at 128 a clock an SM take plus
    a chunk's unhidden latency, plus the split sums' second pass."""
    tn, sw, splits = plan
    ck = F32_STEM_CK if Ci <= F32_STEM_CK else F32_CK
    th, tw = f32_tile(tn, sw)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    blocks = B * -(-ho // th) * -(-wo // tw) * -(-Co // tn) * splits
    chunks = -(-(-(-Ci // ck)) // splits)
    fma = th * tw * tn * 9 * ck
    cost = -(-blocks // sms) * chunks * (fma / 128 + F32_COST_CHUNK)
    if splits > 1:
        cost += F32_COST_LAUNCH + (2 * splits * B * ho * wo * Co * 4
                                   / F32_BYTES_PER_CLOCK)
    return cost


@functools.lru_cache(maxsize=None)
def f32_plan(B: int, H: int, W: int, Ci: int, Co: int, stride: int,
             sms: int) -> F32Plan:
    """The float32 kernel's plan for one call on a card of sms SMs: the
    tile and the split of the Ci sum that f32_cost rates fastest (the stem,
    Ci <= 4, takes one chunk and one of F32_STEM_TILES; Ci or Co not a
    multiple of 4 the one tile with plain loads)."""
    if Ci <= F32_STEM_CK:
        tiles = F32_STEM_TILES
    elif Ci % 4 == 0 and Co % 4 == 0:
        tiles = F32_TILES
    else:
        tiles = (F32_ODD_TILE,)
    ck = F32_STEM_CK if Ci <= F32_STEM_CK else F32_CK
    nck = -(-Ci // ck)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    rated = []
    for tn, sw in tiles:
        if f32_smem(stride, tn, sw, ck) > build.SMEM_LIMIT:
            continue
        th, tw = f32_tile(tn, sw)
        for splits in range(1, min(nck, 16) + 1):
            if splits > 1 and -(-nck // splits) == -(-nck // (splits - 1)):
                continue
            plan = F32Plan(tn, sw, splits)
            blocks = B * -(-ho // th) * -(-wo // tw) * -(-Co // tn) * splits
            rated.append((f32_cost(B, H, W, Ci, Co, stride, sms, plan),
                          min(blocks, sms), plan))
    # of the plans within F32_COST_SLACK of the fastest, the one that
    # gives the most SMs a block (the model's rounds are whole, so a part
    # of the card it leaves idle costs nothing there), then the fewest
    # splits and the widest tile
    least = min(r[0] for r in rated)
    return min((r for r in rated if r[0] <= least * (1 + F32_COST_SLACK)),
               key=lambda r: (-r[1], r[2].splits, -r[2].tn, r[0]))[2]


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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    stem = lib.ys_conv3x3_stem
    stem.restype = ctypes.c_int
    stem.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                     + [ctypes.c_void_p])
    probe = lib.ys_conv3x3_desc_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    return lib


def _launch(name: str, x, w, b, act: str, stride: int,
            plan=None) -> torch.Tensor:
    """The kernel's launch; it runs ``plan`` where one is given (a ConvPlan
    on the 16-bit route, a StemPlan on its stem, an F32Plan on the float32
    route: tests hold other tiles than the planner's to the plain
    version), else conv_plan's or f32_plan's."""
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
    cop, part = Co, None
    sms = build.sm_count(x.device.index)
    if x.dtype not in build.HALF_DTYPES:
        plan = plan or f32_plan(B, H, W, Ci, Co, stride, sms)
        if plan.splits > 1:   # the splits' partial sums
            part = torch.empty((plan.splits, B, Ho, Wo, Co),
                               dtype=torch.float32, device=x.device)
    elif Ci <= 7:
        plan = plan or conv_plan(B, H, W, Ci, Co, stride, sms)
        with torch.cuda.device(x.device):
            status = _lib().ys_conv3x3_stem(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, H,
                W, Ci, Co, stride, ACT_CODES[act], code, *plan, stream)
        build.check_status(name, status)
        return y
    else:
        cip, cop = padded(Ci), padded(Co)
        if (cip, cop) != (Ci, Co):   # TMA needs 16-byte strides
            x = F.pad(x, (0, cip - Ci))
            w = F.pad(w, (0, cop - Co, 0, cip - Ci))
        plan = plan or conv_plan(B, H, W, cip, cop, stride, sms)
        Ci = cip
    with torch.cuda.device(x.device):
        status = _lib().ys_conv3x3(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            0 if part is None else part.data_ptr(), B, H, W, Ci, Co, cop,
            stride, ACT_CODES[act], code, *plan, stream)
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
