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
- float32: the same four GEMMs in one cooperative launch on the CUDA
  cores (float32 FMAs; TF32 would break the float32 contract), each tiled
  as the float32 conv (``csrc/f32_tile.cuh``: an 8-row x 8-channel register
  tile a thread, float4 operands, a two-stage ``cp.async`` ring whose
  copies are issued between the products), the 3x3s on the same flat-row
  bands, the intermediates in the same scratch buffer, which also holds
  the split sums: where a GEMM's tiles alone leave SMs idle its K sum is
  split over blocks and the splits are added in a fixed order after a grid
  barrier. ``f32_c2f_plan`` picks each GEMM's tile width and split and the
  3x3 tile by a cost model (``F32_COST``, fitted by ``chip_c2f_plans.py
  --f32``); the two 1x1s share their width, a template argument of the
  kernel. On a 132-SM card it gives (C2fF32Plan.ints: cv1 tn, split; 3x3
  tn, rows, wt, split; cv2 tn, split) (64, 1, 32, 27, 15, 1, 64, 1) at
  v8s layer 2, B = 2, and (256, 4, 32, 20, 20, 8, 256, 5) at layer 8.

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

The kernel takes every shape the module routes to it at every batch, in
both types and at any c (neither route's shared memory grows with c): no
shape is left to the plain chain.

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


# the float32 kernel's constants (csrc/c2f.cu c2f_f32_kernel): a tile is
# F32_ROWS / tn flat rows x tn channels (256 threads, 8 x 8 sums each); K
# chunks of 32 channels (1x1) or 8 channels x 9 taps (3x3); the tiles'
# widths; the most blocks a K sum is split over
F32_ROWS = 16384
F32_CK1, F32_CK3 = 32, 8
F32_TN1 = (64, 128, 256)
F32_TN3 = (32, 64, 128, 256)
F32_MAX_SPLITS = 32
# the float32 cost model's clocks a feature (f32_gemm_features; SM clocks
# of an H100): an FMA of a tile (1 / the FMAs an SM's register tiles sustain a
# clock), a byte staged, a chunk's barriers, an item's epilogue, a GEMM's
# first copy, a split's grid barrier, a byte of the split sums, and the
# launch; fitted to the kernel's times on the card (non-negative least
# squares on the relative error) by ``chip_c2f_plans.py --f32``
F32_COST = (0.01416, 0.0, 0.0, 3538.0, 9022.0, 148.5, 0.0008021, 0.0)
F32_COST_SLACK = 0.05


class F32Gemm(NamedTuple):
    """One GEMM of the float32 launch: ``tn`` output channels a tile (the
    tile is F32_ROWS / tn flat rows), its K sum split over ``splits``
    blocks, and (3x3) a tile of ``rows`` output rows x ``wt`` columns."""
    tn: int
    splits: int = 1
    rows: int = 0
    wt: int = 0


class C2fF32Plan(NamedTuple):
    """What one float32 launch runs: cv1's GEMM, the two 3x3s' (t and z
    take the same tile) and cv2's (the 1x1s share their tile width: the
    kernel is built for one a launch)."""
    cv1: F32Gemm
    m: F32Gemm
    cv2: F32Gemm

    def ints(self) -> tuple:
        """The eight ints ys_c2f takes."""
        return (self.cv1.tn, self.cv1.splits, self.m.tn, self.m.rows,
                self.m.wt, self.m.splits, self.cv2.tn, self.cv2.splits)


def f32_rows(tn: int) -> int:
    """Flat rows of a float32 tile of tn channels."""
    return F32_ROWS // tn


def f32_a_units(spatial: bool, tm: int, wt: int = 0) -> int:
    """16-byte units of one group of 4 channels of a stage's A tile
    (f32_a_units): the tile's pixels and a pad unit; for the 3x3 the padded
    band of rows of wt + 2 pixels (a pad unit after every 8), rounded to 4
    units past a multiple of 8."""
    if not spatial:
        return tm + 1
    n = tm + 2 * (wt + 2) + 2
    return ((n + n // 8 + 1 + 7) & ~7) + 4


def f32_stage_bytes(spatial: bool, tn: int, wt: int = 0) -> int:
    """One stage of a float32 GEMM's ring (f32_stage_units): the A units
    of a chunk and its weights."""
    ck, taps = (F32_CK3, 9) if spatial else (F32_CK1, 1)
    return 16 * (ck // 4 * f32_a_units(spatial, f32_rows(tn), wt)
                 + ck * taps * tn // 4)


def f32_smem(plan: C2fF32Plan) -> int:
    """Dynamic shared memory of the float32 launch: two stages of its
    largest GEMM."""
    return 2 * max(f32_stage_bytes(False, plan.cv1.tn),
                   f32_stage_bytes(True, plan.m.tn, plan.m.wt),
                   f32_stage_bytes(False, plan.cv2.tn))


def f32_gemms(B: int, H: int, W: int, cin: int, c: int, c2: int,
              plan: C2fF32Plan) -> tuple:
    """(tiles, splits, K chunks, N, spatial) of cv1, t, z and cv2."""
    npix = B * H * W

    def one(g, n, k):
        return (_cdiv(npix, f32_rows(g.tn)) * _cdiv(n, g.tn), g.splits,
                _cdiv(k, F32_CK1), n, False)

    m = plan.m
    three = (B * _cdiv(H, m.rows) * _cdiv(W, m.wt) * _cdiv(c, m.tn),
             m.splits, c // F32_CK3, c, True)
    return (one(plan.cv1, 2 * c, cin), three, three, one(plan.cv2, c2, 3 * c))


def f32_scratch(B: int, H: int, W: int, cin: int, c: int, c2: int,
                plan: C2fF32Plan) -> int:
    """Floats of the float32 launch's scratch buffer: y1, t and z (B H W
    4c), then the largest GEMM's split sums."""
    npix = B * H * W
    part = max(s * npix * n if s > 1 else 0
               for _, s, _, n, _ in f32_gemms(B, H, W, cin, c, c2, plan))
    return npix * 4 * c + part


def f32_chunk_bytes(spatial: bool, tn: int, wt: int = 0) -> int:
    """Bytes one K chunk of a float32 tile stages: its A tile (for the 3x3
    the band) and its weights."""
    tm = f32_rows(tn)
    if not spatial:
        return 4 * F32_CK1 * (tm + tn)
    return 4 * F32_CK3 * (tm + 2 * (wt + 2) + 2 + 9 * tn)


def f32_gemm_features(npix: int, tiles: int, splits: int, chunks: int,
                      n: int, tn: int, spatial: bool, sms: int,
                      wt: int = 0) -> tuple:
    """One float32 GEMM's terms of F32_COST: over its rounds of (tile,
    split) items on one block an SM, the FMAs and bytes its chunks take
    (the register tile's FMAs, the staged A tile and weights), the chunks
    and the items; the GEMM itself; a split's grid barrier and the bytes
    its sums write and read; no launch."""
    ck, taps = (F32_CK3, 9) if spatial else (F32_CK1, 1)
    rounds = _cdiv(tiles * splits, sms)
    steps = rounds * _cdiv(chunks, splits)
    split = splits > 1
    return (steps * f32_rows(tn) * tn * ck * taps,
            steps * f32_chunk_bytes(spatial, tn, wt), steps, rounds, 1,
            int(split), (splits + 1) * npix * n * 4 if split else 0, 0)


def f32_gemm_cost(*args, **kw) -> float:
    """One float32 GEMM's time in SM clocks by the model (F32_COST)."""
    return sum(k * f for k, f in zip(F32_COST, f32_gemm_features(*args,
                                                                 **kw)))


def f32_plan_features(B: int, H: int, W: int, cin: int, c: int, c2: int,
                      sms: int, plan: C2fF32Plan) -> tuple:
    """The launch's terms of F32_COST: its four GEMMs' and the launch."""
    npix = B * H * W
    gs = f32_gemms(B, H, W, cin, c, c2, plan)
    feats = [f32_gemm_features(npix, tiles, s, chunks, n, g.tn, spatial,
                               sms, g.wt)
             for g, (tiles, s, chunks, n, spatial)
             in zip((plan.cv1, plan.m, plan.m, plan.cv2), gs)]
    total = [sum(f[i] for f in feats) for i in range(len(F32_COST))]
    total[-1] = 1
    return tuple(total)


def _f32_rank(options):
    """(cost, blocks, staged bytes, gemm) options from the fastest: within
    F32_COST_SLACK of the cheapest, the fewest splits, then the most blocks
    (more SMs pull the operands in sooner), then the fewest bytes staged,
    then the rest by cost."""
    least = min(o[0] for o in options)
    near = [o for o in options if o[0] <= least * (1 + F32_COST_SLACK)]
    far = [o for o in options if o[0] > least * (1 + F32_COST_SLACK)]
    return ([o[3] for o in sorted(near, key=lambda o: (o[3].splits, -o[1],
                                                       o[2], o[0]))]
            + [o[3] for o in sorted(far, key=lambda o: o[0])])


def _f32_splits(chunks: int):
    """The splits of a sum of `chunks` K chunks that leave no split empty
    and change the chunks a split takes."""
    for s in range(1, min(chunks, F32_MAX_SPLITS) + 1):
        if s == 1 or _cdiv(chunks, s) != _cdiv(chunks, s - 1):
            yield s


def _f32_1x1_cost(npix: int, n: int, k: int, g: F32Gemm, sms: int) -> float:
    """A 1x1 GEMM's time by the model: N = n, K = k, tile and split g."""
    return f32_gemm_cost(npix, _cdiv(npix, f32_rows(g.tn)) * _cdiv(n, g.tn),
                         g.splits, _cdiv(k, F32_CK1), n, g.tn, False, sms)


def f32_options(kind: str, B: int, H: int, W: int, cin: int, c: int,
                c2: int, sms: int) -> list:
    """The F32Gemm choices of one GEMM kind ('cv1', 'm' for both 3x3s,
    'cv2') whose two ring stages fit the shared memory, from the one the
    model rates fastest (_f32_rank)."""
    npix = B * H * W
    options = []
    if kind in ("cv1", "cv2"):
        n, k = (2 * c, cin) if kind == "cv1" else (c2, 3 * c)
        chunks = _cdiv(k, F32_CK1)
        for tn in F32_TN1:
            if 2 * f32_stage_bytes(False, tn) > SMEM_LIMIT:
                continue
            tiles = _cdiv(npix, f32_rows(tn)) * _cdiv(n, tn)
            for s in _f32_splits(chunks):
                g = F32Gemm(tn, s)
                options.append((_f32_1x1_cost(npix, n, k, g, sms),
                                min(tiles * s, sms),
                                tiles * chunks * f32_chunk_bytes(False, tn),
                                g))
        return _f32_rank(options)
    chunks = c // F32_CK3
    for tn in F32_TN3:
        tm = f32_rows(tn)
        for nw in range(1, W + 1):
            wt = _cdiv(W, nw)
            if (nw > 1 and wt == _cdiv(W, nw - 1)) or wt + 2 > tm \
                    or 2 * f32_stage_bytes(True, tn, wt) > SMEM_LIMIT:
                continue
            rmax = min(H, tm // (wt + 2))
            rows = _cdiv(H, _cdiv(H, rmax))     # the bands evened out
            tiles = B * _cdiv(H, rows) * nw * _cdiv(c, tn)
            for s in _f32_splits(chunks):
                options.append((f32_gemm_cost(npix, tiles, s, chunks, c, tn,
                                              True, sms, wt),
                                min(tiles * s, sms),
                                tiles * chunks * f32_chunk_bytes(True, tn, wt),
                                F32Gemm(tn, s, rows, wt)))
    if not options:
        raise ValueError(f"c2f_fused: no float32 3x3 tile fits a {W}-wide "
                         f"map")
    return _f32_rank(options)


@functools.lru_cache(maxsize=None)
def f32_c2f_plan(B: int, H: int, W: int, cin: int, c: int, c2: int,
                 sms: int) -> C2fF32Plan:
    """The float32 launch's plan for one call on a card of sms SMs: the
    3x3s' first f32_options, and the 1x1 tile width whose first cv1 and
    cv2 options the model rates fastest together, with those (the GEMMs run
    one after another, so each is chosen on its own but for the shared
    width)."""
    npix = B * H * W
    cv1 = f32_options("cv1", B, H, W, cin, c, c2, sms)
    cv2 = f32_options("cv2", B, H, W, cin, c, c2, sms)
    pairs = []
    for tn in F32_TN1:
        a = next(g for g in cv1 if g.tn == tn)
        b = next(g for g in cv2 if g.tn == tn)
        pairs.append((_f32_1x1_cost(npix, 2 * c, cin, a, sms)
                      + _f32_1x1_cost(npix, c2, 3 * c, b, sms),
                      cv1.index(a) + cv2.index(b), a, b))
    _, _, a, b = min(pairs, key=lambda p: (p[0], p[1]))
    return C2fF32Plan(a, f32_options("m", B, H, W, cin, c, c2, sms)[0], b)


def plan_class(c: int) -> str:
    """The shape class a hidden width falls in: 'narrow' (c <= 64, bound by
    bytes at the model's shapes) or 'deep' (bound by products)."""
    return "narrow" if c <= 64 else "deep"


def c2f_supported(n: int, shortcut: bool, g: int, cin: int, c: int,
                  c2: int) -> bool:
    """Static statement of what the kernel takes, in both types: a C2f with
    one shortcut bottleneck, no groups, c % 16 == 0, C2 and Cin multiples of
    8 (16-byte rows for TMA); any c (both routes stream their K). Covers
    the v8n and v8s layers 2 and 8 (c = 16, 32, 128, 256)."""
    return (n == 1 and shortcut and g == 1 and cin > 0 and c > 0
            and c % 16 == 0 and c2 % 8 == 0 and cin % 8 == 0)


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
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    return lib


# the grid barrier of the kernel a card (both routes): two counters the
# kernel leaves at (0, generation); one launch at a time uses it, as the
# port launches on one stream a card
_barriers = {}


def _barrier(device: torch.device) -> torch.Tensor:
    bar = _barriers.get(device.index)
    if bar is None:
        bar = _barriers[device.index] = torch.zeros(2, dtype=torch.int32,
                                                    device=device)
    return bar


def c2f_fused(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2,
              plan: C2fPlan = None) -> torch.Tensor:
    """Fused C2f(n=1, shortcut=True) forward (inference, folded BN). It
    runs ``plan`` where one is given (a C2fPlan on the 16-bit route, a
    C2fF32Plan on the float32 one: tests hold other plans than the
    planner's to the plain version), else c2f_plan's or f32_c2f_plan's."""
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
    sms = build.sm_count(x.device.index)
    if x.dtype in build.HALF_DTYPES:
        plan = plan or c2f_plan(B, H, W, cin, c, C2, sms)
        ints, size = tuple(plan), B * H * W * 4 * c
    else:
        plan = plan or f32_c2f_plan(B, H, W, cin, c, C2, sms)
        ints, size = plan.ints(), f32_scratch(B, H, W, cin, c, C2, plan)
    scratch = torch.empty(size, dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, y,
                                   scratch, _barrier(x.device))]
    with torch.cuda.device(x.device):
        status = _lib().ys_c2f(*ptrs, B, H, W, cin, c, C2, code,
                               (ctypes.c_int * 8)(*ints, *[0] * (8 - len(ints))),
                               size, stream)
    build.check_status("c2f_fused", status)
    build.count_launch(c2f_fused, x.device)
    return y


c2f_fused.launches = 0
c2f_fused.launches_by_device = {}
