"""The port's CUDA kernels (float32, bfloat16 and float16), its predict
and its train steps on a CUDA card. Every test here
needs the card: it skips without one. The file imports no JAX (the GPU
machine has none), so it runs there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask, YoloType)
from yolosharp_tpu_torch.kernels import (attention_bihd, attention_bwd_plain,
                                         attention_grads_plain, attention_plain,
                                         attention_stats_plain, c2f_fused,
                                         c2f_plain, conv3x3_plain,
                                         conv3x3_silu, conv3x3s2_silu,
                                         fused_attention, fused_attention_bwd,
                                         launch_counts, reset_launch_counts)
from yolosharp_tpu_torch.kernels import attention as attn_module
from yolosharp_tpu_torch.kernels.attention import (attention_plan,
                                                   f32_geometry,
                                                   launch_geometry)
from yolosharp_tpu_torch.kernels.c2f import (C2fF32Plan, C2fPlan, F32Gemm,
                                             c2f_plan, f32_c2f_plan)
from yolosharp_tpu_torch.kernels import conv3x3 as conv_module
from yolosharp_tpu_torch.kernels.conv3x3 import ConvPlan, conv_plan, padded
from yolosharp_tpu_torch.loss import flatten_levels
from yolosharp_tpu_torch.nn import ConvBN
from yolosharp_tpu_torch.predict import pad_to_multiple

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


# float32: another summation order; bf16 / f16: one rounding vs the plain
# version's per-op roundings (max error relative to the largest value)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": 1e-2,
       "float16": 1e-2}
DTYPES = ["float32", "bfloat16", "float16"]


def _check(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, **TOL[dtype])
    else:
        rel = (got - want).abs().max() / want.abs().max()
        assert rel < TOL[dtype], float(rel)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 17, 23, 3, 16), (1, 40, 40, 64, 96),
                                   (3, 9, 33, 20, 70)])
def test_conv_kernels_match_plain_on_ragged_shapes(cuda, dtype, shape):
    B, H, W, ci, co = shape
    rng = np.random.default_rng(sum(shape))
    dt = getattr(torch, dtype)
    x = _rand(rng, B, H, W, ci).to(cuda, dt)
    w = _rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(cuda, dt)
    b = _rand(rng, co, scale=0.1).to(cuda, dt)
    for act in ("silu", "relu", "identity"):
        _check(conv3x3_silu(x, w, b, act), conv3x3_plain(x, w, b, act, 1),
               dtype)
        _check(conv3x3s2_silu(x, w, b, act), conv3x3_plain(x, w, b, act, 2),
               dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 21, 19, 48, 32, 40),
                                   (1, 13, 11, 200, 128, 96)])
def test_c2f_kernel_matches_plain_on_ragged_shapes(cuda, dtype, shape):
    B, H, W, cin, c, c2 = shape
    rng = np.random.default_rng(sum(shape))
    args = [_rand(rng, B, H, W, cin), _rand(rng, cin, 2 * c, scale=cin ** -0.5),
            _rand(rng, 2 * c, scale=0.1),
            _rand(rng, 3, 3, c, c, scale=(9 * c) ** -0.5),
            _rand(rng, c, scale=0.1),
            _rand(rng, 3, 3, c, c, scale=(9 * c) ** -0.5),
            _rand(rng, c, scale=0.1), _rand(rng, 3 * c, c2, scale=(3 * c) ** -0.5),
            _rand(rng, c2, scale=0.1)]
    args = [a.to(cuda, getattr(torch, dtype)) for a in args]
    got = c2f_fused(*args)
    want = c2f_plain(*args)
    if dtype == "float32":
        _check(got, want, dtype)
    else:   # four layers round to 16 bits at different points
        assert (got.float() - want.float()).abs().max() \
            / want.float().abs().max() < 2e-2


def _check_conv(cuda, dtype, B, H, W, ci, co, acts=("silu", "identity")):
    """Both strides of the conv kernel against the plain version."""
    rng = np.random.default_rng(B * H * W + ci + co)
    dt = getattr(torch, dtype)
    x = _rand(rng, B, H, W, ci).to(cuda, dt)
    w = _rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(cuda, dt)
    b = _rand(rng, co, scale=0.1).to(cuda, dt)
    for act in acts:
        _check(conv3x3_silu(x, w, b, act), conv3x3_plain(x, w, b, act, 1),
               dtype)
        _check(conv3x3s2_silu(x, w, b, act), conv3x3_plain(x, w, b, act, 2),
               dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw", [(9, 33), (17, 23)])
@pytest.mark.parametrize("ci", [3, 20, 24])
def test_conv_kernels_on_chunk_and_tile_edges(cuda, dtype, hw, ci):
    """Ci not a multiple of the 32-channel chunk (3 and 20 not even of 8:
    the scalar zero-padded fill), Co = 70 not a multiple of the N tile,
    ragged H and W, B=3; stride 1 and 2."""
    _check_conv(cuda, dtype, 3, *hw, ci, 70)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 150, 142, 40, 200),
                                   (2, 200, 200, 64, 130)])
def test_conv_kernels_on_the_128_channel_tile(cuda, dtype, shape):
    """Grids large enough for the 16-bit kernel's 128-channel tile at both
    strides, under conv_plan's tile and under the 128-channel tile of the
    same band (16-bit: within 1.25 u of float64): Ci = 40 ends in a chunk
    of 8 channels, Co = 200 leaves a ragged second tile, Co = 130 is not a
    multiple of 8 (zero-padded to 136 for the kernel)."""
    B, H, W, ci, co = shape
    _check_conv(cuda, dtype, *shape)
    if dtype == "float32":
        return
    rng = np.random.default_rng(B + H + ci + co)
    dt = getattr(torch, dtype)
    x = _rand(rng, B, H, W, ci).to(cuda, dt)
    w = _rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(cuda, dt)
    b = _rand(rng, co, scale=0.1).to(cuda, dt)
    for s in (1, 2):
        plan = conv_plan(B, H, W, padded(ci), padded(co), s, _sms(cuda))
        for bn in {plan.bn, 128}:
            assert _conv_to_float64(x, w, b, "silu", s,
                                    plan._replace(bn=bn)) <= 1.25, (s, bn)


def _conv_to_float64(x, w, b, act, stride, plan=None):
    """The 16-bit kernel (with ``plan`` where given, else conv_plan's)
    against a float64 evaluation of the plain version on the same inputs:
    max|k - ref| / max|ref| in units of the type's u (chip_smoke phase 2's
    rule: at most 1.25 u, the kernel rounds its float32 sums once)."""
    name = "conv3x3_silu" if stride == 1 else "conv3x3s2_silu"
    got = conv_module._launch(name, x, w, b, act, stride, plan)
    ref = conv3x3_plain(x.double(), w.double(), b.double(), act, stride)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    u = UNIT[str(x.dtype)[6:]]
    return float((got.double() - ref).abs().max() / ref.abs().max()) / u


# shapes (B, H, W, Ci, Co) that stress the tensor-core kernel's tile: W + 2
# and W + 1 not multiples of 8, bands that end at an image's last row of the
# flat batch, W wider than a TMA box (320 at stride 1, 640 at stride 2),
# H = W = 1, odd H and W at stride 2, Ci = 12, 51 and 768, Co % 8 != 0
TC_STRESS = {"w23": (2, 17, 23, 64, 64), "bands": (3, 12, 20, 64, 136),
             "w320": (1, 320, 320, 32, 32), "w640": (1, 640, 640, 16, 32),
             "1x1": (2, 1, 1, 64, 64), "1x5": (2, 1, 5, 16, 24),
             "5x1": (2, 5, 1, 16, 24), "odd": (2, 7, 9, 32, 48),
             "ci12": (2, 20, 20, 12, 32), "ci51": (2, 40, 40, 51, 51),
             "ci768": (2, 20, 20, 768, 96), "co70": (3, 9, 33, 20, 70)}


@pytest.mark.parametrize("act", ["silu", "relu", "identity"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", list(TC_STRESS))
def test_tensor_core_conv_on_its_tile_edges(cuda, name, dtype, act):
    """Both strides of the 16-bit kernel at TC_STRESS's shapes within
    1.25 u of float64 (w640 at stride 2 only: 640 + 2 is past a box)."""
    B, H, W, ci, co = TC_STRESS[name]
    rng = np.random.default_rng(B * H * W + ci + co)
    dt = getattr(torch, dtype)
    x = _rand(rng, B, H, W, ci).to(cuda, dt)
    w = _rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(cuda, dt)
    b = _rand(rng, co, scale=0.1).to(cuda, dt)
    for stride in ((2,) if name == "w640" else (1, 2)):
        assert _conv_to_float64(x, w, b, act, stride) <= 1.25, stride


# other tiles than conv_plan's at one shape: 1- to 11-row bands, W chunks of
# 5, 7 and 20 columns (one consumer warpgroup of one or two m64 subtiles,
# or both warpgroups on a tile of over 128 flat rows), both N tiles
FORCED_PLANS = [ConvPlan(64, 1, 5), ConvPlan(128, 2, 7), ConvPlan(64, 3, 20),
                ConvPlan(128, 1, 20), ConvPlan(64, 5, 20), ConvPlan(64, 11, 20),
                ConvPlan(128, 6, 20)]


@pytest.mark.parametrize("plan", FORCED_PLANS,
                         ids=lambda p: f"bn{p.bn}-rows{p.rows}-wt{p.wt}")
@pytest.mark.parametrize("stride", [1, 2])
def test_tensor_core_conv_on_forced_tiles(cuda, stride, plan):
    """bfloat16 20x20 (stride 1) or 40x40 (stride 2) 96 -> 136 under tiles
    the plan would not take, within 1.25 u of float64."""
    H = 20 * stride
    rng = np.random.default_rng(stride + plan.rows)
    x = _rand(rng, 2, H, H, 96).to(cuda, torch.bfloat16)
    w = _rand(rng, 3, 3, 96, 136, scale=(9 * 96) ** -0.5).to(
        cuda, torch.bfloat16)
    b = _rand(rng, 136, scale=0.1).to(cuda, torch.bfloat16)
    assert _conv_to_float64(x, w, b, "silu", stride, plan) <= 1.25


def test_conv_descriptor_starts_at_any_row(cuda):
    """The descriptor probe: a 128 x 64 bfloat16 tile loaded by TMA under
    the 128-byte swizzle and read by wgmma from every row r0 < 64 through
    the kernel's A descriptor (base offset 0: the swizzle follows the
    absolute address) gives A[r0 : r0 + 64] @ B, as a tap's shifted rows
    need."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(128, 64, generator=g, device=cuda).bfloat16()
    b = torch.randn(64, 64, generator=g, device=cuda).bfloat16()
    out = conv_module.desc_probe(a, b, 64).double()
    ref = a.double() @ b.double()
    for r0 in range(64):
        torch.testing.assert_close(out[r0], ref[r0:r0 + 64], atol=1e-3,
                                   rtol=1e-5, msg=f"row start {r0}")


def _c2f_args(rng, B, H, W, cin, c, c2, bias=0.1):
    return [_rand(rng, B, H, W, cin), _rand(rng, cin, 2 * c, scale=cin ** -0.5),
            _rand(rng, 2 * c, scale=bias),
            _rand(rng, 3, 3, c, c, scale=(9 * c) ** -0.5),
            _rand(rng, c, scale=bias),
            _rand(rng, 3, 3, c, c, scale=(9 * c) ** -0.5),
            _rand(rng, c, scale=bias), _rand(rng, 3 * c, c2, scale=(3 * c) ** -0.5),
            _rand(rng, c2, scale=bias)]


def _check_c2f_out(got, want, dtype):
    if dtype == "float32":
        _check(got, want, dtype)
    else:   # four layers round to 16 bits at different points
        assert (got.float() - want.float()).abs().max() \
            / want.float().abs().max() < 2e-2


def _check_c2f(cuda, dtype, shape, plan=None, bias=0.1):
    rng = np.random.default_rng(sum(shape))
    args = [a.to(cuda, getattr(torch, dtype))
            for a in _c2f_args(rng, *shape, bias=bias)]
    got = c2f_fused(*args, plan=plan)
    _check_c2f_out(got, c2f_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 80, 80, 32, 16, 32),      # v8n layer 2
                                   (2, 20, 20, 512, 256, 512),   # v8s layer 8
                                   (2, 13, 11, 200, 128, 96)])
def test_c2f_kernel_on_model_widths(cuda, dtype, shape):
    _check_c2f(cuda, dtype, shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(32, 20, 20, 512, 256, 512),  # v8s layer 8
                                   (32, 20, 20, 256, 128, 256),  # v8n layer 8
                                   (1, 160, 160, 64, 32, 64)])   # v8s layer 2
def test_c2f_kernel_on_the_served_tiles(cuda, dtype, shape):
    """The 16-bit plans that the served batch of 32 (c = 256, 128: 128-wide
    N tiles, one m64 subtile a warpgroup) and a single 640x640 request
    (c = 32: 32-channel chunks, 64-wide N tiles) take."""
    B, H, W, cin, c, c2 = shape
    if dtype != "float32":
        plan = c2f_plan(B, H, W, cin, c, c2, _sms(cuda))
        assert plan.bk == (32 if c <= 32 else 64)
        assert (plan.bn, plan.ms) == ((64, 2) if c <= 32 else (128, 1))
    _check_c2f(cuda, dtype, shape)


# every (K chunk, N tile, subtiles) the kernel is built for, each with a 3x3
# tile that leaves ragged bands and columns, and a hidden width c: within the
# plan's N tile and K chunk, or above them
PLANS = [(C2fPlan(32, 64, 1, 3, 5), 32), (C2fPlan(32, 64, 2, 5, 17), 32),
         (C2fPlan(64, 64, 1, 4, 6), 128), (C2fPlan(64, 64, 2, 9, 9), 128),
         (C2fPlan(64, 128, 1, 2, 13), 128), (C2fPlan(64, 128, 1, 4, 16), 128),
         (C2fPlan(64, 64, 1, 3, 10), 32), (C2fPlan(64, 128, 1, 3, 11), 64)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("plan,c", PLANS,
                         ids=lambda p: "-".join(map(str, p)) if isinstance(
                             p, tuple) else f"c{p}")
def test_c2f_kernel_at_every_plan(cuda, dtype, plan, c):
    """Each plan the planner can return, held to the plain version on a map
    its tiles do not divide."""
    _check_c2f(cuda, dtype, (3, 19, 23, 96, c, 2 * c), plan=plan)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", [
    (1, 13, 7, 48, 16, 40),       # W = 7, c = 16, Cin != 2c
    (33, 9, 1, 64, 32, 64),       # W = 1, B = 33
    (1, 1, 9, 256, 64, 128),      # H = 1
    (33, 7, 7, 512, 256, 512),    # v8s-cls's 7x7 at B = 33
    (2, 17, 29, 120, 128, 200),   # c = 128, Cin and C2 not multiples of 64
    (1, 41, 37, 64, 64, 96),      # c = 64
])
def test_c2f_kernel_on_ragged_maps(cuda, dtype, shape):
    """The planner's plan on maps no tile divides, with biases of +-3, so
    that a pad ring that did not read as zero (silu(3) = 2.86) shows."""
    _check_c2f(cuda, dtype, shape, bias=3.0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(2, 20, 20, 512, 256, 512),
                                   (2, 40, 40, 64, 32, 64)])
def test_c2f_kernel_twice_in_one_cuda_graph(cuda, dtype, shape):
    """Two launches in one CUDA graph, replayed three times, on other inputs
    each: the persistent grid and its barrier carry no state from one call
    to the next."""
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    ins = [[a.to(cuda, dt) for a in _c2f_args(rng, *shape)] for _ in range(2)]
    outs = [c2f_fused(*args) for args in ins]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c2f_fused(*args) for args in ins]
    for _ in range(3):
        for args in ins:
            for a in args:
                a.copy_(torch.randn_like(a.float()).mul_(a.float().std())
                        .to(dt))
        graph.replay()
        torch.cuda.synchronize()
        for args, got in zip(ins, outs):
            _check_c2f_out(got, c2f_plain(*args), dtype)


@pytest.mark.parametrize("shape", [
    (1, 13, 7, 48, 16, 40),       # c = 16, W = 7, Cin != 2c
    (2, 37, 29, 64, 32, 64),      # c = 32, ragged bands and columns
    (3, 9, 1, 256, 128, 96),      # c = 128, W = 1
    (2, 20, 20, 512, 256, 512),   # c = 256, v8s layer 8
    (2, 11, 17, 64, 320, 64),     # c = 320, 3c % 32 = 16
])
def test_c2f_float32_kernel_on_ragged_maps(cuda, shape):
    """The float32 kernel's planned launch on maps no tile divides, with
    biases of +-3 (a pad ring that did not read as zero shows), held to the
    plain version, and its bits equal in a second call."""
    rng = np.random.default_rng(sum(shape))
    args = [a.to(cuda) for a in _c2f_args(rng, *shape, bias=3.0)]
    got = c2f_fused(*args)
    _check(got, c2f_plain(*args), "float32")
    assert torch.equal(got, c2f_fused(*args))


# float32 plans forced onto one shape (3 x 19 x 23, Cin 96, c 128, C2 256):
# every tile width of each GEMM, splits of each K sum that leave the last
# split fewer chunks, 3x3 tiles whose bands and columns are ragged
F32_PLANS = [
    C2fF32Plan(F32Gemm(64), F32Gemm(32, 1, 19, 23), F32Gemm(64)),
    C2fF32Plan(F32Gemm(128, 2), F32Gemm(64, 6, 7, 10), F32Gemm(128, 4)),
    C2fF32Plan(F32Gemm(256, 3), F32Gemm(128, 16, 4, 23), F32Gemm(256, 12)),
    C2fF32Plan(F32Gemm(64, 3), F32Gemm(256, 2, 3, 11), F32Gemm(64, 6)),
]


@pytest.mark.parametrize("plan", F32_PLANS, ids=lambda p: "-".join(
    map(str, p.ints())))
def test_c2f_float32_kernel_at_forced_plans(cuda, plan):
    """Each tile width, split and ragged 3x3 tile of the float32 kernel
    against the plain version; the split sums are added in a fixed order,
    so a second call gives the same bits."""
    rng = np.random.default_rng(5)
    args = [a.to(cuda) for a in _c2f_args(rng, 3, 19, 23, 96, 128, 256)]
    got = c2f_fused(*args, plan=plan)
    _check(got, c2f_plain(*args), "float32")
    assert torch.equal(got, c2f_fused(*args, plan=plan))


def test_c2f_float32_kernel_refuses_a_bad_plan(cuda):
    """A plan the launch cannot run (a split without K chunks, a 3x3 tile
    beyond its flat rows, 1x1s of two widths) raises: no silent
    fallback."""
    rng = np.random.default_rng(5)
    args = [a.to(cuda) for a in _c2f_args(rng, 1, 9, 9, 64, 32, 64)]
    for plan in (C2fF32Plan(F32Gemm(64, 3), F32Gemm(32, 1, 9, 9),
                            F32Gemm(64)),
                 C2fF32Plan(F32Gemm(64), F32Gemm(32, 1, 9, 200),
                            F32Gemm(64)),
                 C2fF32Plan(F32Gemm(64), F32Gemm(32, 1, 9, 9),
                            F32Gemm(128))):
        with pytest.raises(RuntimeError, match="cudaError"):
            c2f_fused(*args, plan=plan)


def test_c2f_float32_kernel_plans_the_phase2_shapes(cuda):
    """The planner's float32 plans of v8s layers 2 and 8 and v8s-cls's 56 x
    56 and 7 x 7 at B = 2 and 32 run and hold to the plain version."""
    rng = np.random.default_rng(3)
    for B in (2, 32):
        for shape in ((160, 160, 64, 32, 64), (20, 20, 512, 256, 512),
                      (56, 56, 64, 32, 64), (7, 7, 512, 256, 512)):
            args = [a.to(cuda) for a in _c2f_args(rng, B, *shape)]
            f32_c2f_plan(B, *shape, _sms(cuda))
            _check(c2f_fused(*args), c2f_plain(*args), "float32")


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 33, 77, 400, 1000, 1600])
def test_float32_attention_kernel(cuda, d, n):
    """The float32 kernel at every head dim, N ragged against its 64-key
    steps and 32-row warp tiles, N past the keys one block stages (the
    sequence streamed through two stages: f32_geometry's keys < N), on
    strided q / k / v of one qkv tensor as AAttn hands them over."""
    B, H = 2, 3
    rng = np.random.default_rng(d + n)
    qkv = _rand(rng, B, n, H, 3 * d, scale=2.0).to(cuda)
    q, k, v = qkv.split(d, dim=-1)
    got = attention_bihd(q, k, v, d ** -0.5)
    want = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), d ** -0.5).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)
    if 2 * n * d * 4 > 128 * 1024:   # K and V beyond what a block stages
        assert f32_geometry(B * H, n, d, _sms(cuda))[1] < n


def test_float32_stays_on_the_cuda_cores(cuda):
    """float32 sums in float32 end to end: both kernels stay within 1e-4 of
    the plain version and within float32 rounding (1e-5) of a float64
    evaluation, which a TF32 or bf16 tensor-core route (~1e-3) would not."""
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 17, 23, 64).to(cuda)
    w = _rand(rng, 3, 3, 64, 96, scale=(9 * 64) ** -0.5).to(cuda)
    b = _rand(rng, 96, scale=0.1).to(cuda)
    for fn, s in ((conv3x3_silu, 1), (conv3x3s2_silu, 2)):
        got = fn(x, w, b)
        _check(got, conv3x3_plain(x, w, b, "silu", s), "float32")
        ref = conv3x3_plain(x.double(), w.double(), b.double(), "silu", s)
        assert (got.double() - ref).abs().max() < 1e-5
    args = [a.to(cuda) for a in _c2f_args(rng, 1, 20, 20, 128, 64, 128)]
    got = c2f_fused(*args)
    _check(got, c2f_plain(*args), "float32")
    ref = c2f_plain(*[a.double() for a in args])
    assert (got.double() - ref).abs().max() < 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 1, 400, 32), (1, 2, 100, 64),
                                   (3, 2, 35, 16), (1, 3, 129, 128),
                                   (2, 4, 1, 32)])
def test_attention_kernel_matches_plain_on_ragged_shapes(cuda, dtype, shape):
    """Both wrappers: contiguous (B, H, N, D), and strided (B, N, H, D)
    views of one qkv tensor as AAttn gives them. N is ragged against the
    64-row and 64-key tiles."""
    B, H, N, D = shape
    rng = np.random.default_rng(sum(shape))
    dt = getattr(torch, dtype)
    q, k, v = (_rand(rng, B, H, N, D).to(cuda, dt) for _ in range(3))
    want = attention_plain(q, k, v, D ** -0.5)
    got = fused_attention(q, k, v, D ** -0.5)
    qkv = _rand(rng, B, N, H, 3 * D).to(cuda, dt)
    sq, sk, sv = qkv.split(D, dim=-1)
    got_s = attention_bihd(sq, sk, sv, D ** -0.5)
    want_s = attention_plain(sq.transpose(1, 2), sk.transpose(1, 2),
                             sv.transpose(1, 2), D ** -0.5).transpose(1, 2)
    if dtype == "float32":   # the tolerance of tests/test_pallas_attention.py
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)
        torch.testing.assert_close(got_s, want_s, atol=2e-5, rtol=2e-4)
    else:
        _check(got, want, dtype)
        _check(got_s, want_s, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 15, 63, 65, 300, 400, 1600])
def test_bf16_attention_on_the_tensor_cores(cuda, dtype, d, n):
    """The 16-bit tensor-core kernel (bfloat16 and float16) at every head
    dim and ragged N, against
    the plain version: strided q, k, v of one qkv tensor as AAttn gives them
    and contiguous (B, H, N, D) tensors, at B=1 (a sequence's query tiles
    split over blocks) and B=32 (one or two blocks a sequence). N=1600 at
    D >= 64 does not fit one block's shared memory and is streamed."""
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + d)
    scale = d ** -0.5
    for B, H in ((1, 4), (32, 4)):
        splits = launch_geometry(B * H, n, d, _sms(cuda))[0]
        if B == 1 and n > 16:
            assert splits > 1
        qkv = torch.randn(B, n, H, 3 * d, generator=g, device=cuda).to(
            getattr(torch, dtype))
        q, k, v = qkv.split(d, dim=-1)
        bhnd = [t.transpose(1, 2) for t in (q, k, v)]
        want = attention_plain(*bhnd, scale)
        _check(attention_bihd(q, k, v, scale).transpose(1, 2), want, dtype)
        _check(fused_attention(*[t.contiguous() for t in bhnd], scale), want,
               dtype)


def test_kernels_reject_what_they_cannot_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    w = torch.zeros(3, 3, 4, 8, device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        conv3x3_silu(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_silu(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        conv3x3_silu(x, w[:, :, :2], b)
    with pytest.raises(ValueError):
        conv3x3_silu(x, w, b.cpu())
    q = torch.zeros(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(q[..., :24], q[..., :24], q[..., :24], 0.2)
    with pytest.raises(ValueError, match="unit stride"):
        fused_attention(torch.zeros(1, 2, 32, 16, device=cuda).transpose(
            2, 3), q, q, 0.2)
    with pytest.raises(TypeError):
        fused_attention(q.double(), q.double(), q.double(), 0.2)


@pytest.mark.parametrize("end2end", [False, True])
def test_predict_on_the_card_matches_the_cpu(cuda, end2end):
    """v8n float32: the card's predict (through the kernels) against the
    CPU's (through the plain versions), same seeded weights."""
    cfg = Config(yolo_size=YoloSize.n, number_class=17, end2end=end2end,
                 scalar_type=ScalarType.float32)
    cpu = YoloTask(cfg, device="cpu")
    net = cpu.task._ensure_variables()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(".conv.weight"):
                p.mul_(2.5)
            elif ".2." in name and name.startswith("model.22."):
                p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, p.shape)
                                         .astype(np.float32)))
    card = YoloTask(cfg, device=cuda)
    card.task._ensure_variables().load_state_dict(net.state_dict())
    img = rng.integers(0, 255, (200, 264, 3), dtype=np.uint8)
    reset_launch_counts()
    got = card.image_predict(img, 0.5, 0.45)
    counts = launch_counts()
    assert min(counts[k] for k in ("conv3x3_silu", "conv3x3s2_silu",
                                   "c2f_fused")) > 0, counts
    want = cpu.image_predict(img, 0.5, 0.45)
    assert len(want) > 5 and abs(len(got) - len(want)) <= 2
    key = lambda r: (-r.score, r.center_x, r.center_y)  # noqa: E731
    for g, w in zip(sorted(got, key=key)[:10], sorted(want, key=key)[:10]):
        assert g.class_id == w.class_id and abs(g.score - w.score) < 1e-3
        assert abs(g.center_x - w.center_x) <= 1
        assert abs(g.center_y - w.center_y) <= 1


@pytest.mark.parametrize("end2end", [False, True])
def test_v12_predict_on_the_card_matches_the_cpu(cuda, end2end):
    """v12n float32: the card's predict (through the conv and attention
    kernels) against the CPU's, same seeded weights."""
    cfg = Config(yolo_type=YoloType.v12, yolo_size=YoloSize.n,
                 number_class=17, end2end=end2end,
                 scalar_type=ScalarType.float32)
    cpu = YoloTask(cfg, device="cpu")
    net = cpu.task._ensure_variables()
    rng = np.random.default_rng(0)
    head = net.model[21]
    towers = [head.cv2, head.cv3] + ([head.one2one_cv2, head.one2one_cv3]
                                     if end2end else [])
    with torch.no_grad():
        # x2.5, as for v8, saturates the untrained v12n's scores
        for m in net.modules():
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(2.0)
        for p in (t for tower in towers for branch in tower
                  for t in (branch[2].weight, branch[2].bias)):
            p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, p.shape)
                                     .astype(np.float32)))
    card = YoloTask(cfg, device=cuda)
    card.task._ensure_variables().load_state_dict(net.state_dict())
    img = rng.integers(0, 255, (200, 264, 3), dtype=np.uint8)
    # conf: ~100 of the 1260 anchors of the 224x288 canvas clear it
    x = pad_to_multiple(torch.from_numpy(img)[None]).permute(0, 3, 1, 2)
    with torch.no_grad():
        preds = cpu.task._predict_variables()(x.float() / 255.0)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 100 / flat.shape[1]))
    reset_launch_counts()
    got = card.image_predict(img, conf, 0.45)
    counts = launch_counts()
    assert min(counts[k] for k in ("conv3x3_silu", "conv3x3s2_silu",
                                   "fused_attention")) > 0, counts
    want = cpu.image_predict(img, conf, 0.45)
    assert len(want) > 5 and abs(len(got) - len(want)) <= 2
    key = lambda r: (-r.score, r.center_x, r.center_y)  # noqa: E731
    for g, w in zip(sorted(got, key=key)[:10], sorted(want, key=key)[:10]):
        assert g.class_id == w.class_id and abs(g.score - w.score) < 1e-3
        assert abs(g.center_x - w.center_x) <= 1
        assert abs(g.center_y - w.center_y) <= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [65, 400])
def test_attention_under_autograd(cuda, dtype, d, n):
    """With grad on, both wrappers run the kernel's forward (one launch,
    an output with a grad_fn) and the backward (16-bit: the kernel
    fused_attention_bwd, one launch; float32: the plain backward). Their
    outputs against
    the plain version's, as in the grad-free tests (float32 |d| <= 2e-5 +
    2e-4|ref|, 16-bit max|d| / max|ref| < 1e-2); the gradients of q, k
    and v (strided views of one qkv tensor) against full plain autograd:
    float32 |d| <= 1e-4 + 1e-4|ref|, 16-bit max|d| / max|ref| < 2e-2."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + d)
    B, H, scale = 3, 2, d ** -0.5
    qkv = torch.randn(B, n, H, 3 * d, generator=g, device=cuda).to(dt)
    grad_out = torch.randn(B, n, H, d, generator=g, device=cuda).to(dt)

    def grads(fn):
        t = qkv.clone().requires_grad_()
        out = fn(*t.split(d, dim=-1))
        out.backward(grad_out)
        return out, t.grad

    before = fused_attention.launches
    bwd_before = fused_attention_bwd.launches
    out, got = grads(lambda q, k, v: attention_bihd(q, k, v, scale))
    assert out.grad_fn is not None and fused_attention.launches == before + 1
    out_h, got_h = grads(lambda q, k, v: fused_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), scale).transpose(1, 2))
    assert out_h.grad_fn is not None
    assert fused_attention.launches == before + 2
    # 16-bit: the backward kernel, one launch a backward; float32: plain
    assert fused_attention_bwd.launches == bwd_before + (
        0 if dtype == "float32" else 2)
    want_out, want = grads(lambda q, k, v: attention_plain(
        *(x.transpose(1, 2) for x in (q, k, v)), scale).transpose(1, 2))
    for o in (out, out_h):
        if dtype == "float32":
            torch.testing.assert_close(o, want_out, atol=2e-5, rtol=2e-4)
        else:
            _check(o.detach(), want_out.detach(), dtype)
    for g_ in (got, got_h):
        if dtype == "float32":
            torch.testing.assert_close(g_, want, atol=1e-4, rtol=1e-4)
        else:
            rel = (g_.float() - want.float()).abs().max() / want.float(
            ).abs().max()
            assert rel < 2e-2, float(rel)


def _grads64(q, k, v, g, scale):
    """(dq, dk, dv) of softmax(q k^T scale) v over (B, N, H, D) tensors in
    float64 on the given (rounded) inputs."""
    qf, kf, vf, gf = (t.double() for t in (q, k, v, g))
    s = torch.einsum("bihd,bjhd->bhij", qf * scale, kf)
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bihd,bjhd->bhij", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (scale * torch.einsum("bhij,bjhd->bihd", ds, kf),
            scale * torch.einsum("bhij,bihd->bjhd", ds, qf),
            torch.einsum("bhij,bihd->bjhd", p, gf))


def _kernel_grads(qkv, grad_out, d, scale):
    t = qkv.clone().requires_grad_()
    attention_bihd(*t.split(d, dim=-1), scale).backward(grad_out)
    return t.grad


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 17, 65, 400, 1600])
def test_attention_backward_kernel_against_float64(cuda, dtype, d, n):
    """fused_attention_bwd under autograd, q, k and v strided views of one
    qkv tensor as AAttn gives them, against the backward evaluated in
    float64 on the same rounded inputs: per gradient, max|k - ref| /
    max|ref| within the larger of 2.5 u (u = 2^-8 bf16, 2^-11 f16: P and
    dS are rounded to the type as the A operands of the dV, dQ and dK
    products, and each gradient once) and twice the plain float32
    backward's own distance. At N = 1, dq and dk are 0 (one key: dS = P
    (dP - P dP) = 0) and the kernel's are held to 1e-5, rounding residue.
    N = 1600 streams through the ring; D = 128 holds 32 query rows a
    dK / dV stage."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(7 * n + d)
    B, H, scale = 2, 3, d ** -0.5
    qkv = torch.randn(B, n, H, 3 * d, generator=g, device=cuda).to(dt)
    grad_out = torch.randn(B, n, H, d, generator=g, device=cuda).to(dt)
    got = _kernel_grads(qkv, grad_out, d, scale).split(d, dim=-1)
    q, k, v = qkv.split(d, dim=-1)
    refs = _grads64(q, k, v, grad_out, scale)
    plain = attention_grads_plain(*(t.float() for t in (q, k, v)),
                                  grad_out.float(), scale)
    u = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -11
    for name, a, p, r in zip(("dq", "dk", "dv"), got, plain, refs):
        assert torch.isfinite(a).all(), name
        top = float(r.abs().max())
        if top == 0.0:
            assert n == 1 and name != "dv"
            assert float(a.abs().max()) <= 1e-5, name
            continue
        dk_ = float((a.double() - r).abs().max()) / top
        dp_ = float((p.double() - r).abs().max()) / top
        print(f"{name}: kernel {dk_ / u:.3f} u, plain float32 "
              f"{dp_ / u:.2e} u")
        assert dk_ <= max(2.5 * u, 2 * dp_), (name, dk_ / u, dp_ / u)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_attention_backward_is_deterministic(cuda, dtype):
    """No atomics: two backwards of one input give the same bits, at the
    v12s b16 layer-6 train shape (256 sequences, N = 400, D = 32)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(64, 400, 4, 96, generator=g, device=cuda).to(dt)
    grad_out = torch.randn(64, 400, 4, 32, generator=g, device=cuda).to(dt)
    a = _kernel_grads(qkv, grad_out, 32, 32 ** -0.5)
    b = _kernel_grads(qkv, grad_out, 32, 32 ** -0.5)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_attention_backward_twice_in_one_cuda_graph(cuda, dtype):
    """fused_attention_bwd allocates nothing itself (dq, dk, dv and its D
    buffer come from the wrapper's torch.empty), so two launches capture in
    one CUDA graph; each replay gives the eager result, bit for bit."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(12)
    qkv = torch.randn(4, 130, 2, 96, generator=g, device=cuda).to(dt)
    grad_out = torch.randn(4, 130, 2, 32, generator=g, device=cuda).to(dt)
    q, k, v = qkv.split(32, dim=-1)
    stats = attention_stats_plain(q, k, v, 0.2)
    want = fused_attention_bwd(q, k, v, grad_out, *stats, 0.2)
    twice = fused_attention_bwd(q, k, v, grad_out * 2, *stats, 0.2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_attention_bwd(q, k, v, grad_out, *stats, 0.2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        one = fused_attention_bwd(q, k, v, grad_out, *stats, 0.2)
        two = fused_attention_bwd(q, k, v, grad_out * 2, *stats, 0.2)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(one + two, want + twice):
            assert torch.equal(a, b)
    # the kernel against its plain twin on the same statistics
    for a, b in zip(want, attention_bwd_plain(q, k, v, grad_out, *stats,
                                              0.2)):
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert rel < 1e-2, float(rel)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_attention_backward_launches_and_route(cuda, dtype, monkeypatch):
    """Each 16-bit backward under autograd is one launch of
    fused_attention_bwd (its dQ and dK / dV kernels) and never calls the
    plain attention_grads_plain; float32 takes the plain backward and
    launches no backward kernel. The plans it launches with fit."""
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return attention_grads_plain(*a, **kw)

    monkeypatch.setattr(attn_module, "attention_grads_plain", counted)
    dt = getattr(torch, dtype)
    qkv = torch.randn(3, 200, 2, 96, device=cuda).to(dt)
    grad_out = torch.randn(3, 200, 2, 32, device=cuda).to(dt)
    for _ in range(2):
        before = fused_attention_bwd.launches
        _kernel_grads(qkv, grad_out, 32, 0.2)
        half = dtype != "float32"
        assert fused_attention_bwd.launches == before + (1 if half else 0)
        assert len(calls) == (0 if half else 1)
        calls.clear()
    for kind in ("dq", "dkdv"):
        plan = attention_plan(kind, 6, 200, 32, _sms(cuda))
        assert plan.units == 12 and plan.grid == min(12, _sms(cuda))


@pytest.mark.parametrize("version", ["v8", "v12"])
def test_bf16_train_step_on_the_card(cuda, version):
    """One bfloat16 train step of v8n / v12n at 128x128, batch 2, on the
    card: finite loss items, every parameter with a gradient updated, the
    attention kernel's forward and backward (8 AAttn a v12 forward) launched
    under autograd and no conv or C2f kernel launched."""
    from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                           make_train_step)

    cfg = Config(yolo_type=YoloType(version), yolo_size=YoloSize.n,
                 number_class=17)
    task = YoloTask(cfg, device=cuda)
    net = task.task._ensure_variables().to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=17, epochs=1, steps_per_epoch=1)
    state = TrainState(net, opt, scheds)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.integers(
                 0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(cuda),
             "cls": torch.tensor([[1, 5, 0], [16, 0, 0]], dtype=torch.int32,
                                 device=cuda),
             "bboxes": torch.tensor(
                 [[[0.5, 0.5, 0.3, 0.4], [0.3, 0.6, 0.2, 0.2], [0, 0, 0, 0]],
                  [[0.4, 0.4, 0.5, 0.5], [0, 0, 0, 0], [0, 0, 0, 0]]],
                 device=cuda),
             "mask_gt": torch.tensor([[True, True, False],
                                      [True, False, False]], device=cuda)}
    before = [p.detach().clone() for p in state.params]
    reset_launch_counts()
    loss, items = make_train_step(task.task._loss_fns()[0],
                                  compute_dtype=torch.bfloat16)(
        state, batch, {})
    counts = launch_counts()
    assert torch.isfinite(items).all() and float(items.sum()) > 0
    assert state.count == 1
    # a parameter with a gradient moves (weights also decay without one)
    for p, q in zip(state.params, before):
        if p.grad.abs().max() > 0:
            assert not torch.equal(p, q)
    assert counts["fused_attention"] == (8 if version == "v12" else 0)
    assert counts["fused_attention_bwd"] == (8 if version == "v12" else 0)
    assert counts["conv3x3_silu"] == counts["c2f_fused"] == 0


@pytest.mark.parametrize("version", ["v8", "v12"])
def test_true_fp16_train_step_on_the_card(cuda, version):
    """true_fp16: three float16 train steps of v8n / v12n at 128x128, batch
    2, with the dynamic loss scale from 65536: finite loss items, the
    attention kernel (v12) launched 8 times a forward in float16 under
    autograd and its float16 backward kernel 8 times a backward, no conv or
    C2f kernel launched, and the scale halved after
    each step whose gradients overflowed (the step then skipped) and kept
    otherwise."""
    from yolosharp_tpu_torch.nn import attention as nn_attention
    from yolosharp_tpu_torch.train import (MAX_LOSS_SCALE, TrainState,
                                           make_optimizer, make_train_step)

    cfg = Config(yolo_type=YoloType(version), yolo_size=YoloSize.n,
                 number_class=17, true_fp16=True)
    task = YoloTask(cfg, device=cuda)
    assert task.task.dtype == torch.float16
    net = task.task._ensure_variables().to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=17, epochs=1, steps_per_epoch=3)
    state = TrainState(net, opt, scheds, init_scale=MAX_LOSS_SCALE)
    step = make_train_step(task.task._loss_fns()[0],
                           compute_dtype=torch.float16,
                           dynamic_loss_scale=True)
    rng = np.random.default_rng(1)
    batch = {"images": torch.from_numpy(rng.integers(
                 0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(cuda),
             "cls": torch.tensor([[1, 5], [16, 0]], dtype=torch.int32,
                                 device=cuda),
             "bboxes": torch.tensor([[[0.5, 0.5, 0.3, 0.4],
                                      [0.3, 0.6, 0.2, 0.2]],
                                     [[0.4, 0.4, 0.5, 0.5], [0, 0, 0, 0]]],
                                    device=cuda),
             "mask_gt": torch.tensor([[True, True], [True, False]],
                                     device=cuda)}
    seen = []
    real = nn_attention.attention_bihd

    def traced(q, k, v, scale):
        out = real(q, k, v, scale)
        seen.append((out.dtype, out.grad_fn is not None))
        return out

    nn_attention.attention_bihd = traced
    try:
        for _ in range(3):
            scale, count = state.loss_scale, state.count
            reset_launch_counts()
            _, items = step(state, batch, {})
            counts = launch_counts()
            assert torch.isfinite(items).all()
            applied = state.count == count + 1
            assert state.loss_scale == (scale if applied
                                        else max(scale / 2, 1.0))
            assert counts["fused_attention"] == (8 if version == "v12"
                                                 else 0)
            assert counts["fused_attention_bwd"] == (8 if version == "v12"
                                                     else 0)
            assert counts["conv3x3_silu"] == counts["c2f_fused"] == 0
    finally:
        nn_attention.attention_bihd = real
    assert all(d == torch.float16 and g for d, g in seen)
    assert len(seen) == (24 if version == "v12" else 0)


@pytest.mark.parametrize("version", ["v8", "v12", "v11", "v5u"])
def test_true_fp16_predict_on_the_card(cuda, version):
    """true_fp16 predict of each n-size model: its path's kernels launch in
    float16 and the rows are finite."""
    cfg = Config(yolo_type=YoloType(version), yolo_size=YoloSize.n,
                 number_class=17, true_fp16=True)
    task = YoloTask(cfg, device=cuda)
    assert task.task._predict_variables().model[0].b_fold.dtype \
        == torch.float16
    img = np.random.default_rng(2).integers(0, 255, (200, 264, 3),
                                            dtype=np.uint8)
    reset_launch_counts()
    res = task.batch_predict([img, img[:100]], 0.0)
    counts = launch_counts()
    assert len(res) == 2 and all(np.isfinite(r.score) for rs in res
                                 for r in rs)
    assert counts["conv3x3_silu"] > 0 and counts["conv3x3s2_silu"] > 0
    assert (counts["c2f_fused"] > 0) == (version == "v8")
    assert (counts["fused_attention"] > 0) == (version == "v12")


@pytest.mark.parametrize("version,end2end", [("v11", False), ("v11", True),
                                             ("v5u", False)])
def test_v11_v5u_predict_on_the_card_matches_the_cpu(cuda, version, end2end):
    """v11n / v5un float32: the card's predict (through the conv kernels;
    v11's PSA takes its einsum path, neither has a C2f block) against the
    CPU's, same seeded weights (conv kernels x2.0, the head's final convs
    from U(-0.3, 0.3)); conf takes ~100 candidates of the 1260 anchors."""
    cfg = Config(yolo_type=YoloType(version), yolo_size=YoloSize.n,
                 number_class=17, end2end=end2end,
                 scalar_type=ScalarType.float32)
    cpu = YoloTask(cfg, device="cpu")
    net = cpu.task._ensure_variables()
    rng = np.random.default_rng(0)
    head = net.model[-1]
    towers = [head.cv2, head.cv3] + ([head.one2one_cv2, head.one2one_cv3]
                                     if end2end else [])
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(2.0)
        for p in (t for tower in towers for branch in tower
                  for t in (branch[2].weight, branch[2].bias)):
            p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, p.shape)
                                     .astype(np.float32)))
    card = YoloTask(cfg, device=cuda)
    card.task._ensure_variables().load_state_dict(net.state_dict())
    img = rng.integers(0, 255, (200, 264, 3), dtype=np.uint8)
    x = pad_to_multiple(torch.from_numpy(img)[None]).permute(0, 3, 1, 2)
    with torch.no_grad():
        preds = cpu.task._predict_variables()(x.float() / 255.0)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 100 / flat.shape[1]))
    reset_launch_counts()
    got = card.image_predict(img, conf, 0.45)
    counts = launch_counts()
    assert counts["conv3x3_silu"] > 0 and counts["conv3x3s2_silu"] > 0
    assert counts["c2f_fused"] == counts["fused_attention"] == 0
    want = cpu.image_predict(img, conf, 0.45)
    assert len(want) > 5 and abs(len(got) - len(want)) <= 2
    key = lambda r: (-r.score, r.center_x, r.center_y)  # noqa: E731
    for g, w in zip(sorted(got, key=key)[:10], sorted(want, key=key)[:10]):
        assert g.class_id == w.class_id and abs(g.score - w.score) < 1e-3
        assert abs(g.center_x - w.center_x) <= 1
        assert abs(g.center_y - w.center_y) <= 1


# the segment head's 3x3 shapes (B, H, W, Ci, Co) at 640x640: the Proto's cv1
# at 80x80 and cv2 at 160x160 (256 -> 256 in v11m-seg), and the cv4
# mask-coefficient towers at the three levels (Co = 64 in v11m, 32 in v11n)
SEGMENT_CONVS = {"proto_cv1_v11m": (2, 80, 80, 256, 256),
                 "proto_cv2_v11m": (2, 160, 160, 256, 256),
                 "cv4_p3_v11m": (2, 80, 80, 256, 64),
                 "cv4_p4_v11m": (2, 40, 40, 512, 64),
                 "cv4_p5_v11m": (2, 20, 20, 512, 64),
                 "cv4_tower_v11m": (2, 40, 40, 64, 64),
                 "cv4_p3_v11n": (2, 80, 80, 64, 32),
                 "cv4_tower_v11n": (2, 20, 20, 32, 32),
                 "proto_cv2_v11n": (2, 160, 160, 64, 64)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(SEGMENT_CONVS))
def test_conv_kernels_on_the_segment_shapes(cuda, dtype, name):
    """Both strides of the conv kernel against the plain version at the
    segment head's shapes (the stride-2 call covers the same operands at a
    quarter of the outputs)."""
    _check_conv(cuda, dtype, *SEGMENT_CONVS[name], acts=("silu",))


def test_bf16_conv_on_the_served_proto(cuda):
    """The Proto's cv2 of a batch of 32 at 640x640 in bfloat16: a
    32 x 160 x 160 x 256 input (0.42 GB, the largest activation the kernel
    takes) through the 128-channel tile, against the plain version."""
    B, H, W, ci, co = 32, 160, 160, 256, 256
    assert conv_plan(B, H, W, ci, co, 1, _sms(cuda)).bn == 128
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(B, H, W, ci, generator=g, device=cuda).bfloat16()
    w = (torch.randn(3, 3, ci, co, generator=g, device=cuda)
         * (9 * ci) ** -0.5).bfloat16()
    b = (torch.randn(co, generator=g, device=cuda) * 0.1).bfloat16()
    assert x.numel() * x.element_size() > 4e8
    _check(conv3x3_silu(x, w, b), conv3x3_plain(x, w, b, "silu", 1),
           "bfloat16")


@pytest.mark.parametrize("end2end", [False, True])
def test_segment_predict_on_the_card_matches_the_cpu(cuda, end2end):
    """v11n-seg float32: the card's predict (through the conv kernels, the
    Proto and cv4 towers included) against the CPU's, same seeded weights:
    the first ten rows by score, and each such row's mask (bool, the
    image's height and width) equal on at least 99.9% of its pixels."""
    cfg = Config(task_type=TaskType.segment, yolo_type=YoloType.v11,
                 yolo_size=YoloSize.n, number_class=17, end2end=end2end,
                 scalar_type=ScalarType.float32)
    cpu = YoloTask(cfg, device="cpu")
    net = cpu.task._ensure_variables()
    rng = np.random.default_rng(1)
    head = net.model[-1]
    towers = [head.cv2, head.cv3, head.cv4] + (
        [head.one2one_cv2, head.one2one_cv3, head.one2one_cv4]
        if end2end else [])
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(2.0)
        for p in (t for tower in towers for branch in tower
                  for t in (branch[2].weight, branch[2].bias)):
            p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, p.shape)
                                     .astype(np.float32)))
    card = YoloTask(cfg, device=cuda)
    card.task._ensure_variables().load_state_dict(net.state_dict())
    img = rng.integers(0, 255, (200, 264, 3), dtype=np.uint8)
    x = pad_to_multiple(torch.from_numpy(img)[None]).permute(0, 3, 1, 2)
    with torch.no_grad():
        preds = cpu.task._predict_variables()(x.float() / 255.0)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 100 / flat.shape[1]))
    reset_launch_counts()
    got = card.image_predict(img, conf, 0.45)
    counts = launch_counts()
    assert counts["conv3x3_silu"] > 0 and counts["conv3x3s2_silu"] > 0
    assert counts["c2f_fused"] == counts["fused_attention"] == 0
    want = cpu.image_predict(img, conf, 0.45)
    assert len(want) > 5 and abs(len(got) - len(want)) <= 2
    key = lambda r: (-r.score, r.center_x, r.center_y)  # noqa: E731
    same = total = 0
    for g, w in zip(sorted(got, key=key)[:10], sorted(want, key=key)[:10]):
        assert g.class_id == w.class_id and abs(g.score - w.score) < 1e-3
        assert abs(g.center_x - w.center_x) <= 1
        assert abs(g.center_y - w.center_y) <= 1
        assert g.mask.shape == w.mask.shape == img.shape[:2]
        assert g.mask.dtype == np.bool_
        same += int((g.mask == w.mask).sum())
        total += w.mask.size
    assert same >= 0.999 * total, same / total


# the pose head's odd-width 3x3 shapes (B, H, W, Ci, Co) at 640x640: the
# cv4 keypoint towers of v11s-pose and every n-size pose head are c4 =
# max(ch[0] // 4, 17 x 3) = 51 wide, so a 3x3 takes Co = 51 (bf16 rows of
# 102 bytes, not 4-byte aligned) and then Ci = 51; the last at the served
# batch of 32
POSE_CONVS = {"cv4_p3_v11s": (2, 80, 80, 128, 51),
              "cv4_tower_p3_v11s": (2, 80, 80, 51, 51),
              "cv4_p4_v11s": (2, 40, 40, 256, 51),
              "cv4_p5_v11s_b32": (32, 20, 20, 512, 51)}
# chip_smoke.py's rules: float32 |k - p| <= 1e-4 + 1e-4|p|; bfloat16 and
# float16 against the plain version evaluated in float64 on the same
# rounded inputs, max|k - ref| / max|ref| within 1.25 u (the kernel rounds
# its float32 sums once), u = 2^-8 and 2^-11
UNIT = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(POSE_CONVS))
def test_conv_kernels_on_the_odd_pose_widths(cuda, dtype, name, stride):
    """Each stride of the conv kernel at the pose towers' Co / Ci = 51
    shapes against the plain version, at chip_smoke's rules, with the
    output's last channel checked too (the ragged tail of the stores)."""
    B, H, W, ci, co = POSE_CONVS[name]
    rng = np.random.default_rng(B * H + ci + co + stride)
    dt = getattr(torch, dtype)
    x = _rand(rng, B, H, W, ci).to(cuda, dt)
    w = _rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(cuda, dt)
    b = _rand(rng, co, scale=0.1).to(cuda, dt)
    fn = conv3x3_silu if stride == 1 else conv3x3s2_silu
    got = fn(x, w, b).float()
    assert got.shape[-1] == co and bool(torch.isfinite(got).all())
    if dtype == "float32":
        torch.testing.assert_close(got, conv3x3_plain(x, w, b, "silu",
                                                      stride), **TOL[dtype])
        return
    ref = conv3x3_plain(x.double(), w.double(), b.double(), "silu", stride)
    dist = float((got.double() - ref).abs().max() / ref.abs().max())
    assert dist <= 1.25 * UNIT[dtype], dist / UNIT[dtype]
    tail = float((got[..., -1].double() - ref[..., -1]).abs().max()
                 / ref.abs().max())
    assert tail <= 1.25 * UNIT[dtype], tail / UNIT[dtype]


def test_v11s_pose_batch_predict_on_the_card_matches_the_cpu(cuda):
    """v11s-pose (cv4 towers 51 wide) float32 batch_predict of two images
    on the card, through the conv kernels, against the CPU's, same seeded
    weights (conv kernels x2.0, the head's final convs, keypoints' too,
    from U(-0.3, 0.3)): the first ten rows of each image by score, and
    their 17 keypoints within 0.5 px, visibility within 1e-3."""
    cfg = Config(task_type=TaskType.pose, yolo_type=YoloType.v11,
                 yolo_size=YoloSize.s, number_class=1, end2end=False,
                 scalar_type=ScalarType.float32)
    cpu = YoloTask(cfg, device="cpu")
    net = cpu.task._ensure_variables()
    rng = np.random.default_rng(2)
    head = net.model[-1]
    assert head.cv4[0][0].conv.out_channels == 51
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(2.0)
        for p in (t for tower in (head.cv2, head.cv3, head.cv4)
                  for branch in tower
                  for t in (branch[2].weight, branch[2].bias)):
            p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, p.shape)
                                     .astype(np.float32)))
    card = YoloTask(cfg, device=cuda)
    card.task._ensure_variables().load_state_dict(net.state_dict())
    imgs = [rng.integers(0, 255, (256, 320, 3), dtype=np.uint8),
            rng.integers(0, 255, (200, 264, 3), dtype=np.uint8)]
    x = pad_to_multiple(torch.from_numpy(imgs[0])[None]).permute(0, 3, 1, 2)
    with torch.no_grad():
        preds = cpu.task._predict_variables()(x.float() / 255.0)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 100 / flat.shape[1]))
    reset_launch_counts()
    got = card.batch_predict(imgs, conf, 0.45)
    counts = launch_counts()
    assert counts["conv3x3_silu"] > 0 and counts["conv3x3s2_silu"] > 0
    assert counts["c2f_fused"] == counts["fused_attention"] == 0
    want = cpu.batch_predict(imgs, conf, 0.45)
    key = lambda r: (-r.score, r.center_x, r.center_y)  # noqa: E731
    for got_i, want_i in zip(got, want):
        assert len(want_i) > 5 and abs(len(got_i) - len(want_i)) <= 2
        for g, w in zip(sorted(got_i, key=key)[:10],
                        sorted(want_i, key=key)[:10]):
            assert g.class_id == w.class_id and abs(g.score - w.score) < 1e-3
            assert abs(g.center_x - w.center_x) <= 1
            assert abs(g.center_y - w.center_y) <= 1
            gk = np.array([(p.x, p.y, p.visibility) for p in g.keypoints])
            wk = np.array([(p.x, p.y, p.visibility) for p in w.keypoints])
            assert gk.shape == wk.shape == (17, 3)
            assert np.abs(gk[:, :2] - wk[:, :2]).max() <= 0.5
            assert np.abs(gk[:, 2] - wk[:, 2]).max() <= 1e-3


# v12x-obb's 3x3 shapes (B, H, W, Ci, Co) at 640x640 that no detect, segment
# or pose path takes: the angle towers cv4 of c4 = max(384 // 4, 1) = 96
# channels (384 -> 96 at 80², 768 -> 96 at 40² and 20², 96 -> 96), and the
# backbone's 768 -> 768 at stride 2; the last ones at the served batch 32
OBB_CONVS = {"cv4_p3": (2, 80, 80, 384, 96),
             "cv4_tower_p3_b32": (32, 80, 80, 96, 96),
             "cv4_p5": (2, 20, 20, 768, 96),
             "backbone_768_b32": (32, 40, 40, 768, 768)}
# v12x-obb's attention at 640x640, (sequences, N, heads, D): 12 heads of 32;
# layer 6 (40², area 4) and layer 8 (20², area 1) at the served batch 32
OBB_ATTENTION = {"layer6_b32": (32 * 4, 400, 12, 32),
                 "layer8_b32": (32, 400, 12, 32)}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(OBB_CONVS))
def test_conv_kernels_on_the_v12x_obb_shapes(cuda, dtype, name, stride):
    """Each stride of the conv kernel at v12x-obb's shapes against the
    plain version, at chip_smoke's rules (float32 1e-4 + 1e-4|p|; bf16 /
    f16 within 1.25 u of the float64 evaluation)."""
    B, H, W, ci, co = OBB_CONVS[name]
    rng = np.random.default_rng(B * H + ci + co + stride)
    dt = getattr(torch, dtype)
    x = _rand(rng, B, H, W, ci).to(cuda, dt)
    w = _rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(cuda, dt)
    b = _rand(rng, co, scale=0.1).to(cuda, dt)
    fn = conv3x3_silu if stride == 1 else conv3x3s2_silu
    got = fn(x, w, b).float()
    assert got.shape[-1] == co and bool(torch.isfinite(got).all())
    if dtype == "float32":
        torch.testing.assert_close(got, conv3x3_plain(x, w, b, "silu",
                                                      stride), **TOL[dtype])
        return
    ref = conv3x3_plain(x.double(), w.double(), b.double(), "silu", stride)
    dist = float((got.double() - ref).abs().max() / ref.abs().max())
    assert dist <= 1.25 * UNIT[dtype], dist / UNIT[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(OBB_ATTENTION))
def test_attention_on_the_v12x_obb_shapes(cuda, dtype, name):
    """The attention kernel on strided q, k, v of one qkv tensor (as AAttn
    hands them over) at v12x-obb's served shapes: float32 within 2e-5 +
    2e-4|p| of the plain version, bf16 / f16 within 2.5 u of its float64
    evaluation (chip_smoke's rules); one launch a call."""
    b, n, h, d = OBB_ATTENTION[name]
    rng = np.random.default_rng(b + n)
    dt = getattr(torch, dtype)
    qkv = _rand(rng, b, n, h, 3 * d).to(cuda, dt)
    q, k, v = qkv.split(d, dim=-1)
    scale = d ** -0.5
    before = fused_attention.launches
    got = attention_bihd(q, k, v, scale).float()
    assert fused_attention.launches == before + 1
    bhnd = [t.transpose(1, 2) for t in (q, k, v)]
    if dtype == "float32":
        want = attention_plain(*bhnd, scale).transpose(1, 2)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)
        return
    ref = attention_plain(*[t.double() for t in bhnd], scale).transpose(1, 2)
    dist = float((got.double() - ref).abs().max() / ref.abs().max())
    assert dist <= 2.5 * UNIT[dtype], dist / UNIT[dtype]


def test_v12n_obb_batch_predict_on_the_card_matches_the_cpu(cuda):
    """v12n-obb float32 batch_predict (the rotated fast NMS) of two images
    on the card, through the conv and attention kernels, against the
    CPU's, same seeded weights (conv kernels x2.0, the head's final convs
    from U(-0.3, 0.3)): the first ten rows of each image by score, centre
    and sides within 1 px (int-truncated), the angle within 1e-4 rad."""
    cfg = Config(task_type=TaskType.obb, yolo_type=YoloType.v12,
                 yolo_size=YoloSize.n, number_class=15, end2end=False,
                 scalar_type=ScalarType.float32)
    cpu = YoloTask(cfg, device="cpu")
    net = cpu.task._ensure_variables()
    rng = np.random.default_rng(3)
    head = net.model[-1]
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(2.0)
        for p in (t for tower in (head.cv2, head.cv3, head.cv4)
                  for branch in tower
                  for t in (branch[2].weight, branch[2].bias)):
            p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, p.shape)
                                     .astype(np.float32)))
    card = YoloTask(cfg, device=cuda)
    card.task._ensure_variables().load_state_dict(net.state_dict())
    imgs = [rng.integers(0, 255, (256, 320, 3), dtype=np.uint8),
            rng.integers(0, 255, (200, 264, 3), dtype=np.uint8)]
    x = pad_to_multiple(torch.from_numpy(imgs[0])[None]).permute(0, 3, 1, 2)
    with torch.no_grad():
        preds = cpu.task._predict_variables()(x.float() / 255.0)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 100 / flat.shape[1]))
    reset_launch_counts()
    got = card.batch_predict(imgs, conf, 0.7)
    counts = launch_counts()
    assert counts["conv3x3_silu"] > 0 and counts["conv3x3s2_silu"] > 0
    assert counts["fused_attention"] > 0 and counts["c2f_fused"] == 0
    want = cpu.batch_predict(imgs, conf, 0.7)
    key = lambda r: (-r.score, r.center_x, r.center_y)  # noqa: E731
    for got_i, want_i in zip(got, want):
        assert len(want_i) > 5 and abs(len(got_i) - len(want_i)) <= 2
        for g, w in zip(sorted(got_i, key=key)[:10],
                        sorted(want_i, key=key)[:10]):
            assert g.class_id == w.class_id and abs(g.score - w.score) < 1e-3
            for a in ("center_x", "center_y", "width", "height"):
                assert abs(getattr(g, a) - getattr(w, a)) <= 1
            assert abs(g.radian - w.radian) <= 1e-4


# ------------------------------------------------------------------ int8
# the odd shapes of the int8 route: (B, H, W, Ci, Co, k, stride); the stem
# (Ci = 3, and v5u's 6x6 / 2), the pose towers' 51 channels in and out, a
# map neither 16 nor 32 divides
INT8_SHAPES = {"stem 3x3/2": (3, 9, 33, 3, 16, 3, 2),
               "v5u stem 6x6/2": (2, 64, 64, 3, 32, 6, 2),
               "pose tower 3x3 51->51": (3, 9, 33, 51, 51, 3, 1),
               "1x1 64->51": (2, 20, 20, 64, 51, 1, 1),
               "1x1 51->80": (3, 9, 33, 51, 80, 1, 1),
               "3x3/2 128->96": (2, 17, 23, 128, 96, 3, 2)}


@pytest.mark.parametrize("act", ["identity", "silu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(INT8_SHAPES))
def test_int8_kernels_match_plain(cuda, dtype, name, act):
    """The quantise pass equals its plain version to the bit; the int8 conv
    too, with either activation (the same int32 sums, the same float32
    scale and bias roundings, the same SiLU on the card)."""
    from yolosharp_tpu_torch.kernels.int8_conv import (
        activation_scale, int8_conv, int8_conv_plain, padded_channels,
        quantize_int8, quantize_plain, quantize_weight)

    B, H, W, ci, co, k, s = INT8_SHAPES[name]
    p = 2 if k == 6 else k // 2
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    x = _rand(rng, B, H, W, ci, scale=2.0).to(cuda, dt)
    w = _rand(rng, co, ci, k, k, scale=0.1).to(cuda)
    b = _rand(rng, co, scale=0.1).to(cuda, dt)
    a = activation_scale(x.float().abs().amax() * 0.8)   # some past 127
    wq, w_scale = quantize_weight(w)
    cp = padded_channels(ci)
    reset_launch_counts()
    xq = quantize_int8(x, a, cp)
    torch.testing.assert_close(xq, quantize_plain(x, a, cp), rtol=0, atol=0)
    got = int8_conv(xq, wq, (a * w_scale).contiguous(), b, s, p, act)
    want = int8_conv_plain(xq, wq, a * w_scale, b, s, p, act)
    torch.testing.assert_close(got, want.contiguous(), rtol=0, atol=0)
    assert launch_counts()["quantize_int8"] == 1
    assert launch_counts()["int8_conv"] == 1


def test_int8_predict_on_the_card_matches_the_cpu(cuda):
    """v8n float32 int8: calibrated on the card and on the CPU (stats within
    1e-4 relative), then the card's predict through the int8 kernels, no
    conv3x3 or C2f launch, against the CPU's plain int8 route."""
    cfg = Config(yolo_size=YoloSize.n, number_class=17, end2end=False,
                 scalar_type=ScalarType.float32, int8_predict=True)
    cpu = YoloTask(cfg, device="cpu")
    net = cpu.task._ensure_variables()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith(".conv.weight"):
                p.mul_(2.5)
            elif ".2." in n and n.startswith("model.22."):
                p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, p.shape)
                                         .astype(np.float32)))
    card = YoloTask(cfg, device=cuda)
    card.task._ensure_variables().load_state_dict(net.state_dict())
    imgs = [rng.integers(0, 255, (128, 160, 3), dtype=np.uint8)
            for _ in range(2)]
    want = cpu.calibrate_int8(images=imgs)
    got = card.calibrate_int8(images=imgs)
    from yolosharp_tpu_torch.ckpt import flatten
    want, got = flatten(want), flatten(got)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * float(v), k
    cpu.task._set_quant_stats(got)     # the same stats on both sides
    img = rng.integers(0, 255, (200, 264, 3), dtype=np.uint8)
    reset_launch_counts()
    rows = card.image_predict(img, 0.5, 0.45)
    counts = launch_counts()
    assert counts["int8_conv"] == counts["quantize_int8"] == len(got)
    assert counts["conv3x3_silu"] == counts["conv3x3s2_silu"] == \
        counts["c2f_fused"] == 0
    ref = cpu.image_predict(img, 0.5, 0.45)
    assert len(ref) > 3 and abs(len(rows) - len(ref)) <= 2


def test_quotients_on_the_card_equal_the_cpu(cuda):
    """divide_by_constant (all 256 uint8 levels and 10^6 seeded float32
    values in [0, 255]) and the int8 scales and weights (10^6 seeded
    absmax values and output channels) round on the card as on the CPU,
    bit for bit (the CPU results are held to the jitted JAX route in
    tests/test_torch_quotients.py)."""
    from yolosharp_tpu_torch.kernels.int8_conv import (activation_scale,
                                                       quantize_weight)
    from yolosharp_tpu_torch.utils.numerics import divide_by_constant
    rng = np.random.default_rng(0)
    levels = torch.arange(256, dtype=torch.uint8).reshape(1, 4, 64, 1)
    for x in (levels.repeat(1, 1, 1, 3), torch.from_numpy(
            (rng.random(10 ** 6) * 255).astype(np.float32))):
        assert torch.equal(divide_by_constant(x.to(cuda), 255.0).cpu(),
                           divide_by_constant(x, 255.0))
    a = torch.from_numpy((rng.random(10 ** 6) * 10 ** rng.uniform(
        -7, 2, 10 ** 6)).astype(np.float32))
    assert torch.equal(activation_scale(a[:1].to(cuda)).cpu(),
                       activation_scale(a[:1]))
    scaled = divide_by_constant(torch.clamp(a, min=1e-6), 127.0)
    assert torch.equal(divide_by_constant(torch.clamp(a.to(cuda), min=1e-6),
                                          127.0).cpu(), scaled)
    w = torch.from_numpy((rng.standard_normal((10 ** 6, 2, 1, 1)) * 10 **
                          rng.uniform(-13, 1, (10 ** 6, 1, 1, 1))).astype(
                              np.float32))
    wq, ws = quantize_weight(w.to(cuda))
    wq_h, ws_h = quantize_weight(w)
    assert torch.equal(ws.cpu(), ws_h) and torch.equal(wq.cpu(), wq_h)


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_normalisation_on_the_card_equals_the_cpu(cuda, dtype,
                                                        monkeypatch):
    """train.normalize_images of every uint8 level, and the planned
    batch's /255 in train.resolve_batch_images on a render (stubbed) of
    10^6 seeded float32 values in [0, 255], round on the card as on the
    CPU, bit for bit, in each working type (the CPU results are held to
    the jitted JAX step in tests/test_torch_quotients.py)."""
    from yolosharp_tpu_torch import train
    from yolosharp_tpu_torch.data import device_augment
    dt = getattr(torch, dtype)
    levels = torch.arange(256, dtype=torch.uint8).reshape(1, 4, 64, 1)
    levels = levels.repeat(1, 1, 1, 3)
    assert torch.equal(train.normalize_images(levels.to(cuda), dt).cpu(),
                       train.normalize_images(levels, dt))
    render = torch.from_numpy((np.random.default_rng(1).random(
        (1, 1000, 1000, 3)) * 255).astype(np.float32))
    got = {}
    for device in (cuda, torch.device("cpu")):
        monkeypatch.setattr(device_augment, "render_batch",
                            lambda batch, d=device: render.to(d))
        got[device.type] = train.resolve_batch_images(
            {"aug_pool": None}, dt)[0].cpu()
    assert torch.equal(got["cuda"], got["cpu"])


def test_fold_on_the_card_equals_the_cpu(cuda):
    """fold_bn with int8 stats of a seeded v8n on the card: every ConvBN's
    folded weights and bias and its int8 weights and scales equal the
    CPU fold's bit for bit (the BatchNorm factors are computed on the
    host, as the JAX fold computes them in numpy)."""
    import copy

    from yolosharp_tpu_torch.ckpt import fold_bn
    from yolosharp_tpu_torch.ckpt.fuse import stat_key
    from yolosharp_tpu_torch.nn import YoloNet
    from yolosharp_tpu_torch.nn.model import ArchCfg

    torch.manual_seed(0)
    net = YoloNet(ArchCfg(version="v8", size="n", nc=80)).eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(rng.normal(
                    0, 0.1, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(
                    0.01, 3, m.num_features).astype(np.float32)))
    stats = {stat_key(n): np.float32(rng.uniform(0.5, 20))
             for n, m in net.named_modules()
             if isinstance(m, ConvBN) and m.int8_eligible}
    host = fold_bn(copy.deepcopy(net), stats)
    card = fold_bn(copy.deepcopy(net).to(cuda), stats)
    cm = dict(card.named_modules())
    checked = 0
    for name, m in host.named_modules():
        if isinstance(m, ConvBN):
            for b in ("w_fold", "b_fold", "i8_w", "i8_scale", "i8_ascale"):
                if m._buffers.get(b) is not None:
                    assert torch.equal(cm[name]._buffers[b].cpu(),
                                       m._buffers[b]), (name, b)
                    checked += 1
    assert checked > 100


# ------------------------------------------- float32 under PyTorch's flags
@pytest.fixture
def cuda_default_flags(cuda):
    """The card with PyTorch's default TF32 flags (cuDNN's TF32 on, the
    float32 matmul's off), as a caller that sets none leaves them; the
    suite's own (both off) back afterwards."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = False


def test_float32_holds_under_pytorch_default_flags(cuda_default_flags):
    """With cuDNN's TF32 left on by the caller, v8n float32 predict on the
    card meets test_predict_on_the_card_matches_the_cpu's gate against the
    CPU, and one float32 train step (graft_entry.run_step) gives the
    CPU's loss items within 1e-4 relative and each gradient within 1e-3 of
    its tensor's largest (chip_smoke phase 6's rule); cuDNN's flag is back
    on afterwards. The port turns TF32 off inside its own work."""
    from yolosharp_tpu_torch.graft_entry import run_step

    cuda = cuda_default_flags
    test_predict_on_the_card_matches_the_cpu(cuda, False)
    assert torch.backends.cudnn.allow_tf32 is True
    cfg = Config(yolo_size=YoloSize.n, number_class=17,
                 scalar_type=ScalarType.float32, end2end=False)
    torch.manual_seed(0)
    sd = {k: v.clone() for k, v in
          YoloTask(cfg, device="cpu").task._ensure_variables()
          .state_dict().items()}
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 128, 128, 3), np.uint8),
             "cls": np.array([[1, 5, 0], [16, 0, 0]], np.int32),
             "bboxes": np.array(
                 [[[0.5, 0.5, 0.3, 0.4], [0.3, 0.6, 0.2, 0.2], [0, 0, 0, 0]],
                  [[0.4, 0.4, 0.5, 0.5], [0, 0, 0, 0], [0, 0, 0, 0]]],
                 np.float32),
             "mask_gt": np.array([[True, True, False],
                                  [True, False, False]])}
    from yolosharp_tpu_torch.nn.common import SPPF

    got = run_step(cfg, sd, batch, devices=[cuda])
    want = run_step(cfg, sd, batch, devices=["cpu"])
    assert torch.backends.cudnn.allow_tf32 is True
    np.testing.assert_allclose(got["items"], want["items"], rtol=1e-4)
    # gradients 0 by construction (chip_smoke.zero_gradient_leaves: the BN
    # bias of SPPF's cv1, which has no activation) are rounding noise on
    # both devices: held to 1e-6 of the net's largest gradient G
    net = YoloTask(cfg, device="cpu").task._ensure_variables()
    zero = {f"{n}.cv1.bn.bias" for n, m in net.named_modules()
            if isinstance(m, SPPF) and m.cv1.act == "identity"}
    big = max(float(g.abs().max()) for g in want["grads"].values())
    for name, g in want["grads"].items():
        err = float((got["grads"][name].cpu() - g).abs().max())
        limit = 1e-6 * big if name in zero else 1e-3 * float(g.abs().max())
        assert err <= limit, (name, err, limit)


# ------------------------------------------------- the int8 wgmma routes
def _int8_case(cuda, B, H, W, ci, co, k, s, dt, seed=0):
    """Seeded (xq, wq, scale, b, padding) of one int8 conv on the card."""
    from yolosharp_tpu_torch.kernels.int8_conv import (activation_scale,
                                                       padded_channels,
                                                       quantize_int8,
                                                       quantize_weight)

    rng = np.random.default_rng(seed)
    x = _rand(rng, B, H, W, ci, scale=2.0).to(cuda, dt)
    w = _rand(rng, co, ci, k, k, scale=0.1).to(cuda)
    b = _rand(rng, co, scale=0.1).to(cuda, dt)
    a = activation_scale(x.float().abs().amax() * 0.8)
    wq, w_scale = quantize_weight(w)
    xq = quantize_int8(x, a, padded_channels(ci))
    return xq, wq, (a * w_scale).contiguous(), b, k // 2


# (B, H, W, Ci, Co, k, stride) at each wgmma route's tile edges: Cp 32 to
# 512 (112 and 51 -> 64 not a multiple of the 128-byte chunk), Co 51, 7 and
# 130 (neither N tile divides them), maps neither 16 nor 32 divides, M not
# a multiple of the GEMM's 256 rows
INT8_EDGES = {"gemm 51->51": (3, 9, 33, 51, 51, 1, 1),
              "gemm 112->130": (2, 17, 23, 112, 130, 1, 1),
              "gemm 512->7": (1, 7, 7, 512, 7, 1, 1),
              "flat s1 32->7": (3, 9, 33, 32, 7, 3, 1),
              "flat s1 51->51": (2, 20, 20, 51, 51, 3, 1),
              "flat s1 256->130": (2, 11, 13, 256, 130, 3, 1),
              "flat s2 64->51": (3, 17, 23, 64, 51, 3, 2),
              "flat s2 512->96": (2, 9, 9, 512, 96, 3, 2)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(INT8_EDGES))
def test_int8_routes_at_forced_plans_in_a_graph(cuda, dtype, name):
    """Each wgmma route at its tile edges, with every N tile it takes and,
    on the flat route, band heights and W chunks from one pixel row up to the
    most that fit: two launches captured in one CUDA graph, each equal to
    the plain version to the bit (the same int32 sums, the same epilogue
    roundings), one counted launch a call."""
    from yolosharp_tpu_torch.kernels.int8_conv import (I8Plan, int8_conv,
                                                       int8_conv_plain,
                                                       int8_route,
                                                       int8_smem)

    B, H, W, ci, co, k, s = INT8_EDGES[name]
    dt = getattr(torch, dtype)
    xq, wq, scale, b, p = _int8_case(cuda, B, H, W, ci, co, k, s, dt)
    cp = xq.shape[-1]
    route = int8_route(k, s, p, cp, co)
    assert route == name.split()[0]
    want = int8_conv_plain(xq, wq, scale, b, s, p, "silu").contiguous()
    bns = (64, 128) if co > 64 and route == "gemm" else (64,)
    if route == "gemm":
        plans = [I8Plan(128, bn) for bn in bns]
    else:
        bk = 64 if s == 2 or cp <= 64 else 128
        ho, wo = (H - 1) // s + 1, (W - 1) // s + 1
        plans = [I8Plan(bk, bn, r, wt) for bn in bns
                 for r, wt in ((1, 1), (1, wo), (ho, wo), (2, -(-wo // 2)))
                 if r * (wt + 3 - s) <= 256]
    for plan in plans:
        assert int8_smem(route, s, plan, b.element_size()) <= 232448
        outs = []
        graph = torch.cuda.CUDAGraph()
        before = int8_conv.launches
        with torch.cuda.graph(graph):
            for _ in range(2):
                outs.append(int8_conv(xq, wq, scale, b, s, p, "silu",
                                      plan=plan))
        assert int8_conv.launches == before + 2
        graph.replay()
        torch.cuda.synchronize()
        for got in outs:
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       msg=f"{name} {plan}")


def test_int8_silu_equals_the_plain_silu_at_every_float(cuda):
    """The int8 epilogue's branch-free SiLU (silu_rn) gives the bits of
    v / (1 + expf(-v)) with the IEEE division, the plain version's SiLU,
    at all 2^32 float32 inputs."""
    from yolosharp_tpu_torch.kernels.int8_conv import silu_check

    assert silu_check(cuda) == 0


@pytest.mark.parametrize("bk", [64, 128])
def test_int8_descriptor_starts_at_any_row(cuda, bk):
    """The 8-bit descriptor probe: a 128 x bk int8 tile loaded by TMA under
    the 64- or 128-byte swizzle and read by wgmma s8 from every row r0 <
    64 (base offset 0, as a tap starts at any pixel row), against K-major
    int8 weights, gives A[r0 : r0 + 64] @ B^T exactly."""
    from yolosharp_tpu_torch.kernels.int8_conv import desc_probe

    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(-127, 128, (128, bk), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (64, bk), generator=g, device=cuda,
                      dtype=torch.int8)
    out = desc_probe(a, b, 64)
    ref = a.double() @ b.double().t()
    for r0 in range(64):
        assert torch.equal(out[r0].double(), ref[r0:r0 + 64]), r0


# ------------------------------------------------ the float32 conv's plans
@pytest.mark.parametrize("shape", [(3, 20, 20, 96, 40, 1), (2, 17, 23, 64, 52, 2),
                                   (3, 9, 33, 51, 51, 1), (2, 33, 9, 12, 20, 2),
                                   (1, 7, 7, 128, 128, 1), (2, 40, 36, 3, 32, 2),
                                   (1, 23, 17, 4, 20, 1)])
def test_float32_conv_at_forced_plans_and_splits(cuda, shape):
    """The float32 conv at every tile and at 1, 2 and 5 splits of the Ci
    sum (the stem, Ci <= 4, at its tiles in one chunk): within 1e-4 + 1e-4
    |p| of the plain version, and the same bits from one run to the next
    (the splits add in a fixed order)."""
    from yolosharp_tpu_torch.kernels.conv3x3 import (F32_ODD_TILE,
                                                     F32_STEM_TILES,
                                                     F32_TILES, F32Plan)

    B, H, W, ci, co, s = shape
    rng = np.random.default_rng(3)
    x = _rand(rng, B, H, W, ci).to(cuda)
    w = _rand(rng, 3, 3, ci, co, scale=(9 * ci) ** -0.5).to(cuda)
    b = _rand(rng, co, scale=0.1).to(cuda)
    name = "conv3x3_silu" if s == 1 else "conv3x3s2_silu"
    want = conv3x3_plain(x, w, b, "silu", s)
    tiles = F32_TILES if ci % 4 == 0 and co % 4 == 0 else (F32_ODD_TILE,)
    if ci <= 4:
        tiles = F32_STEM_TILES
    for tn, sw in tiles:
        for splits in ((1,) if ci <= 4 else (1, 2, 5)):
            plan = F32Plan(tn, sw, splits)
            got = conv_module._launch(name, x, w, b, "silu", s, plan)
            again = conv_module._launch(name, x, w, b, "silu", s, plan)
            torch.cuda.synchronize()
            _check(got, want, "float32")
            assert torch.equal(got, again), plan
