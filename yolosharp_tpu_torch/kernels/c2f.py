"""One fused inference C2f block (n=1, shortcut): ``c2f_fused``.

Replaces the Pallas kernel ``yolosharp_tpu/kernels/c2f.py`` ``c2f_fused``
(``_kernel``) with the hand-written CUDA kernel ``csrc/c2f.cu``. Same
signature: x (B, H, W, Cin), w1 (Cin, 2c), wm1 / wm2 (3, 3, c, c), w2
(3c, C2), folded-BN biases; returns (B, H, W, C2).

What bounds it on the card: run as separate layers, the block launches
about ten kernels and writes and re-reads its intermediates through device
memory. Its two shape classes are bound differently: v8s layer 2 (160x160,
c = 32, ``plan_class`` 'narrow') by bytes, layer 8 (20x20, c = 256, 'deep')
by products on 3.7 MB of weights that a tile of one SM cannot amortise.

- bfloat16 and float16 (one template on the element type): the four GEMMs
  (cv1, the two 3x3s, cv2 over ``[y1 | z]``) run in one persistent,
  cooperative launch on Hopper's warpgroup MMA, one after the other over
  the whole batch with a grid barrier between them. Each is tiled as the
  conv kernel (``kernels/conv3x3.py``) is: TMA loads of the A tiles and of
  each tap's weights against mbarriers, a producer thread and two ``wgmma``
  warpgroups, one block an SM; the 3x3s take the flat-row layout (a band of
  R + 2 rows of Wt + 2 pixels, each tap a shifted descriptor) and read their
  zero padding from TMA's out-of-bounds fill; the epilogue stages each tile
  in shared memory and writes it by TMA. The intermediates (cv1's output,
  t, z: B H W 4c elements) go to a scratch buffer this wrapper allocates,
  which the L2 holds at the deep shapes: no tile recomputes a halo, and
  each weight tile serves up to 256 pixel rows. The narrow class pays for
  that in traffic (about 3.5x the block's own bytes).
- float32: the CUDA-core kernel; a block owns an 8x8 tile (4x4 above c =
  64) with a 2-pixel halo and keeps the float32 intermediates in shared
  memory.

``c2f_plan`` owns the 16-bit choice, per shape and batch: the K chunk
(32 channels up to c = 32, else 64), the N tile (128 only in the deep
class, where N exceeds 64), the m64 subtiles a warpgroup and the 3x3 tile,
by a cost model whose clocks ``chip_c2f_plans.py`` fits on the card. On a
132-SM card it gives (bk, bn, ms, rows, wt):

- 160x160 64/32/64 (v8s layer 2): B = 1 and 2 (32, 64, 2, 10, 20), B = 32
  (32, 64, 2, 6, 40);
- 56x56 64/32/64 (v8s-cls): B = 1 (32, 64, 1, 4, 7), B = 2 (32, 64, 1, 7, 7),
  B = 32 (32, 64, 2, 14, 14);
- 20x20 512/256/512 (v8s layer 8): B = 1 (64, 64, 1, 2, 7), B = 2
  (64, 64, 1, 5, 5), B = 32 (64, 128, 1, 10, 10);
- 7x7 512/256/512 (v8s-cls): B = 1 (64, 64, 1, 1, 2), B = 2
  (64, 64, 1, 2, 2), B = 32 (64, 64, 1, 7, 7).

The kernel takes every shape the module routes to it at every batch: on
the card it beats the plain chain at each of these at B = 2 and 32
(PERF.md), so no shape is left to the plain chain.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .build import SMEM_LIMIT
from .conv3x3 import conv3x3_plain

_CHUNK = 32           # input channels the float32 kernel stages a chunk


def tile_for(c: int) -> int:
    """The float32 kernel's output tile edge for hidden width c: 8 for
    c <= 64, 4 above."""
    return 8 if c <= 64 else 4


def smem_bytes(tile: int, c: int) -> int:
    """Shared memory of one block of the float32 kernel (Geom::floats)."""
    r2, r1, r0 = (tile + 4) ** 2, (tile + 2) ** 2, tile ** 2
    return 4 * (r2 * _CHUNK + c * (r2 + r1 + 2 * r0))


# the 16-bit kernel's constants (csrc/c2f.cu)
TC_CONSUMERS = 2      # warpgroups that issue wgmma
TC_BSTAGES = (4, 8)   # slots of the weight ring: at least, at most
TC_ASTAGES = 6        # slots of A tiles at most
# plan_cost's clocks: a wgmma.m64n64k16, a k step, a KB of A tile, an output
# element's epilogue, a tile round, and the launch with its grid barriers;
# fitted (non-negative least squares on the relative error) to the bf16 times
# of candidate plans at every C2f shape of every path at B=32, 2 and 1 on an
# H100 (chip_c2f_plans.py)
COST = (21.6, 433.1, 8.336, 0.2112, 1171.0, 25360.0)


class C2fPlan(NamedTuple):
    """What one 16-bit launch runs: ``bk`` input channels a K chunk (32 for
    c <= 32, else 64), ``bn`` output channels a tile (64 or 128), ``ms`` m64
    subtiles a consumer warpgroup (1 or 2), and the 3x3 GEMMs' tile of
    ``rows`` output rows x ``wt`` columns of one image."""
    bk: int
    bn: int
    ms: int
    rows: int
    wt: int


class Gemm(NamedTuple):
    """One of the launch's four GEMMs as the kernel tiles it
    (csrc/c2f.cu GemmGeo): 3x3 or 1x1, tiles, K chunks, flat rows a tile
    and the warpgroups that hold them, output pixels a tile, bytes of one A
    load."""
    spatial: bool
    tiles: int
    chunks: int
    rows: int
    wgs: int
    pixels: int
    a_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemms(B: int, H: int, W: int, cin: int, c: int, c2: int,
          plan: C2fPlan) -> tuple:
    """The four GEMMs (cv1, t, z, cv2) of one launch (tc_geometry)."""
    bk, bn, ms, rows, wt = plan
    npix = B * H * W
    wgs1 = 2 if npix > 64 * ms else 1
    rows1 = 64 * ms * wgs1
    p = wt + 2

    def one(n, chunks):
        return Gemm(False, _cdiv(npix, rows1) * _cdiv(n, bn), chunks, rows1,
                    wgs1, rows1, rows1 * bk * 2)

    three = Gemm(True, B * _cdiv(H, rows) * _cdiv(W, wt) * _cdiv(c, bn),
                 _cdiv(c, bk), rows * p, _cdiv(rows * p, 64 * ms), rows * wt,
                 (rows + 2) * p * bk * 2)
    return (one(2 * c, _cdiv(cin, bk)), three, three,
            one(c2, _cdiv(2 * c, bk) + _cdiv(c, bk)))


def tc_smem(B: int, H: int, W: int, plan: C2fPlan) -> int:
    """Dynamic shared memory of one block of the 16-bit kernel
    (tc_geometry): the output tile's staging buffer (128 ms rows of 128
    bytes a 64 channels), the barriers, up to 6 A slots (as many as leave
    room for 4 weight slots) and the weight ring (up to 8 slots in what is
    left); 0 where the plan does not fit."""
    bk, bn, ms, rows, wt = plan
    p = wt + 2
    if rows < 1 or wt < 1 or p > 256 or rows + 2 > 256 \
            or rows * p > 64 * ms * TC_CONSUMERS:
        return 0
    reach1 = 64 * ms * (2 if B * H * W > 64 * ms else 1)
    reach3 = 64 * ms * _cdiv(rows * p, 64 * ms) + 2 * p + 2
    slot = _cdiv(max(reach1, reach3) * bk * 2, 1024) * 1024
    bslot = bk * bn * 2
    fixed = 1024 + bn // 64 * 128 * ms * 128 + 16 * (TC_ASTAGES + TC_BSTAGES[1])
    a_slots = min(TC_ASTAGES, (SMEM_LIMIT - fixed - TC_BSTAGES[0] * bslot)
                  // slot)
    b_slots = min(TC_BSTAGES[1], (SMEM_LIMIT - fixed - a_slots * slot)
                  // bslot)
    if a_slots < 2 or b_slots < TC_BSTAGES[0]:
        return 0
    return fixed + a_slots * slot + b_slots * bslot


def plan_features(B: int, H: int, W: int, cin: int, c: int, c2: int,
                  sms: int, plan: C2fPlan) -> tuple:
    """Summed over the launch's GEMMs, each times its rounds of tiles over
    the persistent grid: wgmma.m64n64k16 issued a tile, k steps a tile, KB
    of A tiles a tile, output elements a tile, and the rounds themselves."""
    gs = gemms(B, H, W, cin, c, c2, plan)
    grid = min(sms, max(g.tiles for g in gs))
    mma = steps = kb = out = rounds = 0
    for g in gs:
        r = _cdiv(g.tiles, grid)
        taps = 9 if g.spatial else 1
        mma += r * g.chunks * plan.bk // 16 * taps * plan.ms * g.wgs \
            * plan.bn // 64
        steps += r * g.chunks * taps
        kb += r * g.chunks * g.a_bytes / 1e3
        out += r * g.pixels * plan.bn
        rounds += r
    return mma, steps, kb, out, rounds


def plan_cost(B: int, H: int, W: int, cin: int, c: int, c2: int, sms: int,
              plan: C2fPlan) -> float:
    """A model of the launch's time in SM clocks (COST_*): its GEMMs' wgmma,
    k steps, A-tile copies, epilogues and tile rounds, plus the launch and
    its grid barriers."""
    feats = plan_features(B, H, W, cin, c, c2, sms, plan)
    return sum(k * f for k, f in zip(COST, feats)) + COST[-1]


def plan_space(B: int, H: int, W: int, c: int, c2: int) -> list:
    """Every plan the kernel is built for that fits the shape: the K chunk
    from c (32 channels up to c = 32, else 64), the N tile (128 only with
    64-channel chunks and an N above 64, and then one m64 subtile a
    warpgroup: two would hold 128 accumulators a thread, which spill), the
    subtiles and the 3x3 tile (R rows x Wt columns within the two
    warpgroups' reach)."""
    bk = 32 if c <= 32 else 64
    wide = bk == 64 and max(2 * c, c2) > 64
    plans = []
    for bn in ((64, 128) if wide else (64,)):
        for ms in ((1,) if bn == 128 else (1, 2)):
            for splits in range(1, min(W, 16) + 1):
                wt = _cdiv(W, splits)
                if splits > 1 and wt == _cdiv(W, splits - 1):
                    continue
                for rows in sorted({_cdiv(H, n) for n in range(1, H + 1)}):
                    plan = C2fPlan(bk, bn, ms, rows, wt)
                    if tc_smem(B, H, W, plan):
                        plans.append(plan)
    return plans


@functools.lru_cache(maxsize=None)
def c2f_plan(B: int, H: int, W: int, cin: int, c: int, c2: int,
             sms: int) -> C2fPlan:
    """The 16-bit launch's plan for one call on a card of sms SMs: of
    plan_space, the one plan_cost rates fastest (ties: the larger tile)."""
    return min(plan_space(B, H, W, c, c2),
               key=lambda p: (plan_cost(B, H, W, cin, c, c2, sms, p),
                              -p.rows * p.wt, -p.bn, -p.ms))


def plan_class(c: int) -> str:
    """The shape class a hidden width falls in: 'narrow' (c <= 64, bound by
    bytes at the model's shapes) or 'deep' (bound by products)."""
    return "narrow" if c <= 64 else "deep"


def c2f_supported(n: int, shortcut: bool, g: int, cin: int, c: int,
                  c2: int) -> bool:
    """Static statement of what the kernel takes, in both types: a C2f with
    one shortcut bottleneck, no groups, c % 16 == 0, C2 and Cin multiples of
    8 (16-byte rows for TMA), and a float32 tile that fits shared memory
    (c <= 424; the 16-bit kernel streams its K and takes any c). Covers the
    v8n and v8s layers 2 and 8 (c = 16, 32, 128, 256)."""
    if not (n == 1 and shortcut and g == 1 and cin > 0 and c > 0
            and c % 16 == 0 and c2 % 8 == 0 and cin % 8 == 0):
        return False
    return smem_bytes(tile_for(c), c) <= SMEM_LIMIT


def c2f_plain(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2) -> torch.Tensor:
    """The plain PyTorch version: the C2f module's math on NHWC tensors."""
    c = wm1.shape[-1]
    a, bh = F.silu(x @ w1 + b1).split(c, dim=-1)
    t = conv3x3_plain(bh, wm1, bm1)
    z = bh + conv3x3_plain(t, wm2, bm2)
    return F.silu(torch.cat([a, bh, z], -1) @ w2 + b2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("c2f")
    fn = lib.ys_c2f
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 13
                   + [ctypes.c_void_p])
    return lib


# the grid barrier of the 16-bit kernel a card: two counters the kernel
# leaves at (0, generation); one launch at a time uses it, as the port
# launches on one stream a card
_barriers = {}


def _barrier(device: torch.device) -> torch.Tensor:
    bar = _barriers.get(device.index)
    if bar is None:
        bar = _barriers[device.index] = torch.zeros(2, dtype=torch.int32,
                                                    device=device)
    return bar


def c2f_fused(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2,
              plan: C2fPlan = None) -> torch.Tensor:
    """Fused C2f(n=1, shortcut=True) forward (inference, folded BN). The
    16-bit route runs ``plan`` where one is given (tests hold other plans
    than c2f_plan's to the plain version), else c2f_plan's."""
    if x.device.type == "cpu":
        return c2f_plain(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2)
    if x.dim() != 4:
        raise ValueError(f"c2f_fused: x must be (B, H, W, Cin), got "
                         f"{tuple(x.shape)}")
    B, H, W, cin = x.shape
    c = wm1.shape[-1]
    C2 = w2.shape[-1]
    shapes = {"w1": (w1, (cin, 2 * c)), "b1": (b1, (2 * c,)),
              "wm1": (wm1, (3, 3, c, c)), "bm1": (bm1, (c,)),
              "wm2": (wm2, (3, 3, c, c)), "bm2": (bm2, (c,)),
              "w2": (w2, (3 * c, C2)), "b2": (b2, (C2,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"c2f_fused: {name} must be {want}, got "
                             f"{tuple(t.shape)}")
    code, stream = build.launch_args("c2f_fused", x, w1, b1, wm1, bm1, wm2,
                                     bm2, w2, b2)
    if not c2f_supported(1, True, 1, cin, c, C2):
        raise ValueError(f"c2f_fused: the kernel does not take Cin={cin}, "
                         f"c={c}, C2={C2}")
    y = torch.empty((B, H, W, C2), dtype=x.dtype, device=x.device)
    scratch = bar = None
    if x.dtype in build.HALF_DTYPES:
        plan = plan or c2f_plan(B, H, W, cin, c, C2,
                                build.sm_count(x.device.index))
        scratch = torch.empty(B * H * W * 4 * c, dtype=x.dtype,
                              device=x.device)
        bar = _barrier(x.device)
        tile = 0
    else:
        plan = C2fPlan(0, 0, 0, 0, 0)
        tile = tile_for(c)
    ptrs = [t.data_ptr() for t in (x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, y)]
    ptrs += [None if t is None else t.data_ptr() for t in (scratch, bar)]
    with torch.cuda.device(x.device):
        status = _lib().ys_c2f(*ptrs, B, H, W, cin, c, C2, code, tile, *plan,
                               stream)
    build.check_status("c2f_fused", status)
    build.count_launch(c2f_fused, x.device)
    return y


c2f_fused.launches = 0
c2f_fused.launches_by_device = {}
