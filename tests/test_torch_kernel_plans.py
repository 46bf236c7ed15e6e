"""The routes and plans of the int8 conv and of the float32 conv3x3 (pure
Python, chosen on the host from the shape, the batch and the card's SM
count): the int8 route is a function of the shape alone, every plan fits
the card's shared memory and covers ragged maps, channels and K, and the
float32 plan's split of the Ci sum fills a 132-SM card at B=2."""

import pytest

from test_torch_kernels import PLAN_BATCHES, S1_SHAPES, S2_SHAPES
from yolosharp_tpu_torch.kernels import build
from yolosharp_tpu_torch.kernels.conv3x3 import (F32_CK, F32_ODD_TILE,
                                                 F32_STEM_CK, F32_STEM_TILES,
                                                 F32_TILES, f32_plan,
                                                 f32_smem, f32_tile)
from yolosharp_tpu_torch.kernels.int8_conv import (GEMM_ROWS, TC_ROWS,
                                                   I8Plan, int8_plan,
                                                   int8_route, int8_smem,
                                                   padded_channels)

SMS = 132
# every int8-eligible conv of chip_smoke phase 17a's five groups (v8s-640,
# v12s-640, v5us's stem, v11s-pose's 51-wide towers, v8s-cls-224), as
# (H, W, Ci, Co, k, s, p): 75 shapes (76 with v8s's identity 1x1, which
# shares its shape with v12s's SiLU one)
INT8_SHAPES = [
    (640, 640, 3, 32, 3, 2, 1), (640, 640, 3, 32, 6, 2, 2),
    (320, 320, 32, 64, 3, 2, 1), (224, 224, 3, 32, 3, 2, 1),
    (160, 160, 16, 32, 3, 1, 1), (160, 160, 32, 16, 3, 1, 1),
    (160, 160, 64, 64, 1, 1, 0), (160, 160, 64, 128, 3, 2, 1),
    (160, 160, 96, 128, 1, 1, 0), (160, 160, 128, 128, 3, 2, 1),
    (112, 112, 32, 64, 3, 2, 1), (80, 80, 32, 32, 3, 1, 1),
    (80, 80, 32, 64, 3, 1, 1), (80, 80, 51, 51, 3, 1, 1),
    (80, 80, 64, 32, 1, 1, 0), (80, 80, 64, 32, 3, 1, 1),
    (80, 80, 64, 64, 1, 1, 0), (80, 80, 64, 64, 3, 1, 1),
    (80, 80, 128, 51, 3, 1, 1), (80, 80, 128, 64, 3, 1, 1),
    (80, 80, 128, 128, 1, 1, 0), (80, 80, 128, 128, 3, 1, 1),
    (80, 80, 128, 128, 3, 2, 1), (80, 80, 128, 256, 3, 2, 1),
    (80, 80, 192, 128, 1, 1, 0), (80, 80, 192, 256, 1, 1, 0),
    (80, 80, 256, 128, 1, 1, 0), (80, 80, 256, 256, 3, 2, 1),
    (80, 80, 384, 128, 1, 1, 0), (80, 80, 512, 64, 1, 1, 0),
    (56, 56, 64, 128, 3, 2, 1), (40, 40, 51, 51, 3, 1, 1),
    (40, 40, 64, 64, 3, 1, 1), (40, 40, 128, 64, 1, 1, 0),
    (40, 40, 128, 128, 1, 1, 0), (40, 40, 128, 128, 3, 1, 1),
    (40, 40, 128, 256, 1, 1, 0), (40, 40, 128, 384, 1, 1, 0),
    (40, 40, 256, 51, 3, 1, 1), (40, 40, 256, 64, 3, 1, 1),
    (40, 40, 256, 128, 1, 1, 0), (40, 40, 256, 128, 3, 1, 1),
    (40, 40, 256, 256, 1, 1, 0), (40, 40, 256, 256, 3, 2, 1),
    (40, 40, 256, 512, 3, 2, 1), (40, 40, 384, 128, 1, 1, 0),
    (40, 40, 384, 256, 1, 1, 0), (40, 40, 512, 256, 1, 1, 0),
    (40, 40, 768, 128, 1, 1, 0), (40, 40, 768, 256, 1, 1, 0),
    (28, 28, 64, 64, 3, 1, 1), (28, 28, 128, 128, 1, 1, 0),
    (28, 28, 128, 256, 3, 2, 1), (28, 28, 256, 128, 1, 1, 0),
    (20, 20, 51, 51, 3, 1, 1), (20, 20, 64, 64, 3, 1, 1),
    (20, 20, 128, 128, 1, 1, 0), (20, 20, 128, 128, 3, 1, 1),
    (20, 20, 256, 128, 1, 1, 0), (20, 20, 256, 256, 1, 1, 0),
    (20, 20, 256, 256, 3, 1, 1), (20, 20, 256, 512, 1, 1, 0),
    (20, 20, 256, 768, 1, 1, 0), (20, 20, 512, 51, 3, 1, 1),
    (20, 20, 512, 64, 3, 1, 1), (20, 20, 512, 128, 1, 1, 0),
    (20, 20, 512, 128, 3, 1, 1), (20, 20, 512, 256, 1, 1, 0),
    (20, 20, 768, 512, 1, 1, 0), (20, 20, 1024, 512, 1, 1, 0),
    (14, 14, 128, 128, 3, 1, 1), (14, 14, 256, 256, 1, 1, 0),
    (14, 14, 256, 512, 3, 2, 1), (14, 14, 512, 256, 1, 1, 0),
    (7, 7, 512, 1280, 1, 1, 0)]
# ragged shapes of the card tests: maps neither 16 nor 32 divides, odd
# and 51-wide channels, a Cp of 112
RAGGED_INT8 = [(9, 33, 51, 51, 3, 1, 1), (17, 23, 128, 96, 3, 2, 1),
               (20, 20, 64, 51, 1, 1, 0), (9, 33, 51, 80, 1, 1, 0),
               (9, 33, 112, 130, 1, 1, 0), (3, 5, 32, 7, 3, 2, 1),
               (1, 1, 48, 24, 3, 1, 1), (1, 3, 64, 64, 3, 2, 1)]


def test_int8_route_of_every_phase17_shape():
    """35 1x1 stride-1 shapes (36 convs: v8s's identity 1x1 shares one)
    take the GEMM, 36 3x3 shapes with Cp >= 32 the flat-row tile, and 4 the
    mma.sync kernel: the two 3-channel stems, the 16-channel 3x3 (Cp 16)
    and v5u's 6x6/2 stem."""
    routes = {}
    for h, w, ci, co, k, s, p in INT8_SHAPES:
        routes.setdefault(int8_route(k, s, p, padded_channels(ci), co),
                          []).append((h, w, ci, co, k, s, p))
    assert {r: len(v) for r, v in routes.items()} == {
        "gemm": 35, "flat": 36, "mma": 4}
    assert all(sh[4:] == (1, 1, 0) for sh in routes["gemm"])
    assert all(sh[4] == 3 and sh[6] == 1 and padded_channels(sh[2]) >= 32
               for sh in routes["flat"])
    assert sorted(routes["mma"]) == [
        (160, 160, 16, 32, 3, 1, 1), (224, 224, 3, 32, 3, 2, 1),
        (640, 640, 3, 32, 3, 2, 1), (640, 640, 3, 32, 6, 2, 2)]
    # the route reads the shape only: any other k, s or p leaves the
    # wgmma routes, and so does a Cp of 16
    assert int8_route(1, 2, 0, 64, 64) == "mma"
    assert int8_route(1, 1, 1, 64, 64) == "mma"
    assert int8_route(5, 1, 2, 64, 64) == "mma"
    assert int8_route(3, 1, 1, 16, 64) == "mma"
    assert int8_route(3, 3, 1, 64, 64) == "mma"


def _check_int8_plan(B, h, w, ci, co, k, s, p, out_size, sms=SMS):
    """The plan the wrapper passes, checked as the kernel's launch checks
    it: BK 128 (64 at stride 2 and for Cp <= 64 on the flat route), an N
    tile of 128 on the GEMM where Co > 64, else 64, TMA boxes within 256, at
    most 256 flat rows, the shared memory within the card's, and tiles
    that cover M (or the map), Co and K with none empty."""
    cp = padded_channels(ci)
    route = int8_route(k, s, p, cp, co)
    plan = int8_plan(route, B, h, w, cp, co, s, sms, out_size)
    if route == "mma":
        assert plan == I8Plan()
        return route, plan, 0
    bk, bn, rows, wt = plan
    assert bn == (128 if route == "gemm" and co > 64 else 64)
    assert bk == (128 if route == "gemm" or (s == 1 and cp > 64) else 64)
    assert int8_smem(route, s, plan, out_size) <= build.SMEM_LIMIT
    nk, nco = -(-cp // bk), -(-co // bn)
    assert (nk - 1) * bk < cp <= nk * bk and (nco - 1) * bn < co <= nco * bn
    if route == "gemm":
        m = B * h * w
        return route, plan, -(-m // GEMM_ROWS) * nco
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    pp = wt + 3 - s
    assert 1 <= rows <= ho and 1 <= wt <= wo
    assert rows * pp <= TC_ROWS and pp <= 256 and rows + 3 - s <= 256
    bands, chunks = -(-ho // rows), -(-wo // wt)
    assert (bands - 1) * rows < ho <= bands * rows
    assert (chunks - 1) * wt < wo <= chunks * wt
    return route, plan, B * bands * chunks * nco


@pytest.mark.parametrize("out_size", [4, 2], ids=["float32", "16-bit"])
def test_int8_plan_fits_and_covers_every_shape(out_size):
    """Every phase 17a shape and the ragged ones at B = 1, 2 and 32, with a
    float32 and a 16-bit output (the epilogue's staging differs)."""
    for B in (1, 2, 32):
        for shape in INT8_SHAPES + RAGGED_INT8:
            _check_int8_plan(B, *shape, out_size)


def test_int8_plan_spreads_the_b2_deep_shapes():
    """At B=2 the deep maps (20 x 20 and 40 x 40) hold too few tiles to give
    each of 132 SMs one (a 20 x 20 GEMM is 7 tiles of 128 rows an N tile),
    so no plan there makes an SM run two tiles while others idle: every
    plan runs its tiles in one round of the persistent grid."""
    for shape in INT8_SHAPES:
        if shape[0] not in (20, 40):
            continue
        route, plan, tiles = _check_int8_plan(2, *shape, 2)
        assert tiles <= SMS, (shape, plan, tiles)


def _check_f32_plan(B, H, W, ci, co, stride, sms=SMS):
    """A float32 plan as the launch checks it: a stem tile and one chunk of
    4 channels for Ci <= 4; else a tile of F32_TILES (the odd tile where Ci
    or Co is not a multiple of 4); the shared memory within the card's, and
    a split of the Ci chunks whose every part holds at least one chunk.
    Returns the blocks it launches."""
    tn, sw, splits = f32_plan(B, H, W, ci, co, stride, sms)
    ck = F32_CK
    if ci <= F32_STEM_CK:
        assert (tn, sw) in F32_STEM_TILES and splits == 1
        ck = F32_STEM_CK
    elif ci % 4 or co % 4:
        assert (tn, sw) == F32_ODD_TILE
    else:
        assert (tn, sw) in F32_TILES
    assert f32_smem(stride, tn, sw, ck) <= build.SMEM_LIMIT
    nck = -(-ci // ck)
    per = -(-nck // splits)
    assert 1 <= splits <= nck and (splits - 1) * per < nck <= splits * per
    th, tw = f32_tile(tn, sw)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    return B * -(-ho // th) * -(-wo // tw) * -(-co // tn) * splits


@pytest.mark.parametrize("stride,shapes", [(1, S1_SHAPES), (2, S2_SHAPES)],
                         ids=["s1", "s2"])
def test_f32_plan_fits_every_path_shape(stride, shapes):
    """The float32 plan at every shape of every path, each batch the paths
    run, and ragged maps and channels, on a 132-SM card."""
    ragged = [(9, 33, 51, 51), (17, 23, 64, 52), (33, 9, 12, 20),
              (20, 20, 96, 40), (3, 5, 3, 16), (1, 1, 8, 8)]
    for B in PLAN_BATCHES:
        for shape in list(shapes) + ragged:
            _check_f32_plan(B, *shape, stride)


def _most_blocks(B, H, W, ci, co, stride):
    """The most blocks any tile and split of the plan space launches."""
    nck = -(-ci // F32_CK)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    tiles = F32_TILES if ci % 4 == 0 and co % 4 == 0 else (F32_ODD_TILE,)
    return max(B * -(-ho // th) * -(-wo // tw) * -(-co // tn) * min(nck, 16)
               for tn, sw in tiles for th, tw in [f32_tile(tn, sw)])


@pytest.mark.parametrize("stride,shapes", [(1, S1_SHAPES), (2, S2_SHAPES)],
                         ids=["s1", "s2"])
def test_f32_plan_fills_the_card_at_b2(stride, shapes):
    """At B=2 the deep layers (output maps of 40 x 40 and less) give most
    of a 132-SM card a block: the split of the Ci sum makes up for the few
    tiles (a 20 x 20 x 128 map is 6 tiles of 128 channels an image). The
    plan's whole chunks of 8 channels leave some SMs idle where that costs
    no time (120 blocks of 2 chunks end with 240 of 1), so the bound is
    0.7 of the card, or every block the shape can give at all."""
    for shape in shapes:
        if shape[0] * shape[1] // stride ** 2 <= 40 * 40 and shape[2] >= 64:
            blocks = _check_f32_plan(2, *shape, stride)
            assert blocks >= min(0.7 * SMS, _most_blocks(2, *shape, stride)
                                 ), (shape, blocks)
