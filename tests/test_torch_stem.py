"""The stem kernel of the port on the CPU (csrc/stem.cuh: the 16-bit conv
at Ci <= 7 and the int8 stem route, which quantises in the conv's own
launch): its plan (pure Python, chosen on the host from the shape, the
batch and the card's SM count), the int8 routes that reach it, its plain
version, and an int8 stem ConvBN against the JAX package's int8 ConvBN.
The kernel itself runs in tests/test_torch_cuda.py on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolosharp_tpu.nn.common import ConvBN as JaxConvBN
from yolosharp_tpu.nn.common import fused_inference, quant_int8
from yolosharp_tpu_torch.ckpt import fold_bn
from yolosharp_tpu_torch.kernels import build
from yolosharp_tpu_torch.kernels.conv3x3 import (SM_SMEM, STEM_STRIP,
                                                 STEM_TILES, StemPlan,
                                                 conv_plan, stem_band,
                                                 stem_plan, stem_smem)
from yolosharp_tpu_torch.kernels.int8_conv import (activation_scale,
                                                   int8_conv_plain,
                                                   int8_conv_stem,
                                                   int8_route,
                                                   int8_stem_plain,
                                                   padded_channels,
                                                   quantize_plain,
                                                   quantize_weight)
from yolosharp_tpu_torch.nn import ConvBN

SMS = 132
# the zoo's 16-bit stems, (H, W, Ci, Co, stride): the 3x3/2 stem at 640 of
# the s models (Co 32), v11m-seg / v11m-pose (64) and v12x-obb (96), and of
# the classify models at 224
ZOO_STEMS = [(640, 640, 3, 32, 2), (640, 640, 3, 64, 2),
             (640, 640, 3, 96, 2), (224, 224, 3, 32, 2)]
# the int8 stems of chip_smoke phase 17a, (H, W, Ci, Co, k, s, p): the 3x3/2
# stems at 640 and 224, v5u's 6x6/2
INT8_STEMS = [(640, 640, 3, 32, 3, 2, 1), (640, 640, 3, 32, 6, 2, 2),
              (224, 224, 3, 32, 3, 2, 1)]
# ragged stems: maps neither 16 nor 32 divides, odd Co, Ci up to 7, a Co
# wider than a channel chunk, other k, s and p
RAGGED = [(17, 23, 3, 16, 3, 1, 1), (9, 33, 3, 70, 3, 2, 1),
          (9, 33, 7, 70, 3, 2, 1), (40, 48, 5, 40, 3, 1, 1),
          (13, 17, 3, 16, 6, 2, 2), (20, 24, 5, 24, 5, 1, 2),
          (64, 96, 3, 200, 3, 2, 1), (1, 1, 3, 8, 3, 2, 1),
          (2, 3, 1, 9, 3, 1, 1)]
BATCHES = (1, 2, 8, 16, 32)


def _check_stem_plan(B, H, W, ci, co, k, s, p, isz, osz, int8):
    """The plan the wrappers pass, checked as the kernel's launch checks it
    (stem_geometry): a tile of STEM_TILES, 2-4 ring slots, 1 or 2 blocks an
    SM (two only where two fit the SM's shared memory), channel chunks of
    32 that cover Co, the shared memory within a block's, bands and strips
    that cover the output with none empty. Returns the plan."""
    plan = stem_plan(B, H, W, ci, co, s, SMS, k, p, isz, osz, int8)
    rows, strips, ring, blocks, cg = plan
    assert (rows, strips) in STEM_TILES
    assert 2 <= ring <= 4 and blocks in (1, 2)
    assert cg % 32 == 0 and cg == min(-(-co // 32) * 32,
                                      128 if osz == 2 else 64)
    smem = stem_smem(k, s, p, ci, co, plan, isz, osz, int8)
    assert smem <= build.SMEM_LIMIT
    assert blocks == 1 or 2 * (smem + 1024) <= SM_SMEM
    ho, wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    bands, cols = -(-ho // rows), -(-wo // (STEM_STRIP * strips))
    assert (bands - 1) * rows < ho <= bands * rows
    assert (cols - 1) * STEM_STRIP * strips < wo <= cols * STEM_STRIP * strips
    ih, iwb = stem_band(k, s, p, ci, rows, isz)
    assert ih == (rows - 1) * s + k and iwb * isz % 16 == 0
    # the band row holds the strip's window from the 16-byte unit its first
    # element lies in
    assert iwb >= (-p * ci) % (16 // isz) + ((STEM_STRIP - 1) * s + k) * ci
    return plan


@pytest.mark.parametrize("shape", ZOO_STEMS + [(*r[:4], r[5]) for r in RAGGED
                                               if r[4:6] == (3, 1) or
                                               r[4:6] == (3, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_stem_plan_fits_and_covers_the_16bit_stems(shape):
    """The 16-bit stem's plan (conv_plan at Ci <= 7) at each batch the
    paths run, bfloat16 / float16 in and out."""
    H, W, ci, co, s = shape
    for B in BATCHES:
        plan = _check_stem_plan(B, H, W, ci, co, 3, s, 1, 2, 2, False)
        assert conv_plan(B, H, W, ci, co, s, SMS) == plan


@pytest.mark.parametrize("size", [4, 2], ids=["float32", "16-bit"])
@pytest.mark.parametrize("shape", INT8_STEMS + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_stem_plan_fits_and_covers_the_int8_stems(shape, size):
    """The int8 stem route's plan with a float32 and a 16-bit input and
    output (the staging and the band differ), at each batch."""
    for B in BATCHES:
        _check_stem_plan(B, *shape, size, size, True)


@pytest.mark.parametrize("shape,batch,want", [
    ((640, 640, 3, 32, 2), 32, StemPlan(8, 1, 4, 2, 32)),
    ((640, 640, 3, 64, 2), 32, StemPlan(8, 1, 4, 2, 64)),
    ((640, 640, 3, 96, 2), 32, StemPlan(8, 1, 4, 2, 96)),
    ((224, 224, 3, 32, 2), 32, StemPlan(8, 1, 4, 2, 32)),
    ((640, 640, 3, 32, 2), 2, StemPlan(16, 1, 4, 2, 32)),
    ((640, 640, 3, 96, 2), 2, StemPlan(16, 1, 4, 2, 96)),
    ((224, 224, 3, 32, 2), 2, StemPlan(8, 1, 4, 2, 32)),
], ids=["640-32-b32", "640-64-b32", "640-96-b32", "224-32-b32", "640-32-b2",
        "640-96-b2", "224-32-b2"])
def test_stem_plan_of_the_zoo_stems(shape, batch, want):
    """One plan per zoo stem shape: every output channel in one chunk, the
    four-slot ring, two blocks an SM; 8-row tiles at b32 (a tile a warp
    strip: the most tiles a round), 16-row ones at B=2 640 (the same
    rounds of strips, a smaller halo). Every such band is a TMA box: the
    row W Ci of 2-byte elements a 16-byte multiple, a strip's row at most
    256 elements."""
    H, W, ci, co, s = shape
    plan = stem_plan(batch, H, W, ci, co, s, SMS)
    assert plan == want
    ih, iwb = stem_band(3, s, 1, ci, plan.rows, 2)
    assert W * ci * 2 % 16 == 0 and iwb <= 256 and ih <= 256


def test_int8_route_takes_the_stems():
    """The three int8 stems of phase 17a go to "stem" when the ConvBN's Ci
    is given, and to "mma" as an int8 input of Cp = 16 channels; a Cp of 16
    from 16 channels, Ci = 8, and k k Ci past 128 stay off it; any k, s and
    p with Ci <= 7 and k k Ci <= 128 take it."""
    for h, w, ci, co, k, s, p in INT8_STEMS:
        cp = padded_channels(ci)
        assert int8_route(k, s, p, cp, co, ci) == "stem"
        assert int8_route(k, s, p, cp, co) == "mma"
    assert int8_route(3, 1, 1, 16, 32, 16) == "mma"
    assert int8_route(3, 2, 1, 16, 32, 8) == "mma"
    assert int8_route(7, 2, 3, 16, 32, 3) == "mma"      # 147 > 128
    assert int8_route(4, 4, 0, 16, 64, 7) == "stem"     # 112
    assert int8_route(1, 1, 0, 16, 64, 3) == "stem"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", INT8_STEMS[1:2] + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_stem_plain_is_quantise_then_conv(shape, dtype):
    """The stem route's plain version (int8_conv_stem on a CPU tensor)
    equals the plain quantise pass followed by the plain int8 conv, bit for
    bit, with the identity and SiLU: the kernel is held to it on the card."""
    h, w, ci, co, k, s, p = shape
    h, w = min(h, 40), min(w, 48)
    rng = np.random.default_rng(h * w + ci + co + k)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(0, 2, (2, h, w, ci)).astype(np.float32)
                         ).to(dt)
    wq, w_scale = quantize_weight(torch.from_numpy(
        rng.normal(0, 0.2, (co, ci, k, k)).astype(np.float32)))
    b = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32)).to(dt)
    a = activation_scale(x.float().abs().amax() * 0.8)   # some past 127
    scale = a * w_scale
    for act in ("identity", "silu"):
        want = int8_conv_plain(quantize_plain(x, a, padded_channels(ci)),
                               wq, scale, b, s, p, act)
        got = int8_conv_stem(x, a, wq, scale, b, s, p, act)
        assert torch.equal(got, want)
        assert torch.equal(int8_stem_plain(x, a, wq, scale, b, s, p, act),
                           want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["identity", "silu"])
@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (6, 2, 2)],
                         ids=["3x3s2", "6x6s2"])
def test_int8_stem_convbn_matches_jax(k, s, p, act, dtype):
    """A folded stem ConvBN (Ci = 3: the 3x3/2 stem and v5u's 6x6/2) given
    one absmax: its int8 route is "stem" and its output the JAX ConvBN's
    quant_int8 output on the port's fold and the same absmax, in float32
    and (the module cast, the input rounded) bfloat16: to the bit with the
    identity, the activation's ulps apart otherwise (as
    tests/test_torch_int8.py holds the other convs). The scales are powers
    of two, the same in eager JAX (which divides by 127) and in the port
    (which multiplies by its float32 reciprocal, as jitted JAX does): an
    absmax of 127 / 16 and each channel's largest weight 127 / 64; the
    BatchNorm folds with a factor of 1 (its variance + eps is 1), its bias
    drawn."""
    rng = np.random.default_rng(k * 10 + s)
    m = ConvBN(3, 16, k, s, p, act=act)
    with torch.no_grad():
        w = np.clip(rng.normal(0, 0.6, (16, 3, k, k)), -1.9, 1.9)
        w[:, 0, 0, 0] = 127 / 64
        m.conv.weight.copy_(torch.from_numpy(w.astype(np.float32)))
        m.bn.running_mean.zero_()
        m.bn.running_var.fill_(1.0 - m.bn.eps)
        m.bn.bias.copy_(torch.from_numpy(rng.normal(0, .1, 16)))
    m.eval()
    x = torch.from_numpy(rng.uniform(-8, 8, (2, 19, 23, 3))
                         .astype(np.float32)).to(getattr(torch, dtype))
    absmax = np.float32(127 / 16)       # a_scale 2**-4: some x past 127
    # the JAX module on the port's float32 fold (both quantise it alike)
    net = fold_bn(m, {"absmax": absmax})
    assert torch.equal(net.w_fold if not net.kernel_route else
                       net.w_fold.permute(3, 2, 0, 1), m.conv.weight)
    w = net.w_fold if net.kernel_route else net.w_fold.permute(2, 3, 1, 0)
    variables = {"params": {"conv": {"kernel": w.numpy()},
                            "bn": {"bias": net.b_fold.numpy()}},
                 "quant_stats": {"absmax": jnp.asarray(absmax)}}
    net = net.to(x.dtype)
    assert net.int8_route == "stem" and net.i8_w.shape == (16, k, k, 16)
    assert float(net.i8_ascale) == 2.0 ** -4
    with torch.no_grad():
        got = net(x.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1).numpy()
    jm = JaxConvBN(16, k, s, p, act=act)
    with fused_inference(), quant_int8():
        want = jm.apply(variables, jnp.asarray(x.float().numpy(), dtype),
                        False)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    if act == "identity":
        np.testing.assert_array_equal(got, want)
    else:
        # XLA's bfloat16 SiLU rounds its sigmoid before the product, torch's
        # does not: up to two bfloat16 steps apart (2 x 2**-8)
        tol = 1e-6 if dtype == "float32" else 2.0 ** -6
        np.testing.assert_allclose(got, want, rtol=tol, atol=1e-6)
