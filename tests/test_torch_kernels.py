"""The port's kernels (yolosharp_tpu_torch/kernels): plain versions against
the JAX package's Pallas kernels (interpret mode), the wrappers' routing
and the build's failure mode. The CUDA kernels themselves are checked on
the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolosharp_tpu.kernels.c2f import c2f_fused as jax_c2f_fused
from yolosharp_tpu.kernels.conv3x3 import conv3x3_silu as jax_conv3x3_silu
from yolosharp_tpu.kernels.conv3x3 import conv3x3s2_silu as jax_conv3x3s2_silu
from yolosharp_tpu_torch.kernels import (build, c2f_fused, c2f_plain,
                                         c2f_supported, conv3x3_plain,
                                         conv3x3_silu, conv3x3s2_silu,
                                         launch_counts)
from yolosharp_tpu_torch.kernels.c2f import (SMEM_LIMIT, C2fPlan, c2f_plan,
                                             f32_c2f_plan, f32_gemms,
                                             f32_rows, f32_scratch, f32_smem,
                                             gemms, plan_class)
from yolosharp_tpu_torch.kernels.c2f import tc_smem as c2f_smem
from yolosharp_tpu_torch.kernels.conv3x3 import (TC_ROWS, ConvPlan,
                                                 StemPlan, chunk, conv_plan,
                                                 padded, stem_plan, tc_smem)
from yolosharp_tpu_torch.nn import ArchCfg, C2f, YoloNet

# the tolerance of tests/test_pallas_conv.py: float32 sums in another order
ATOL, RTOL = 2e-5, 1e-4


def _conv_inputs(shape, seed):
    B, H, W, Ci, Co = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, Ci)).astype(np.float32),
            (rng.standard_normal((3, 3, Ci, Co)) * 0.1).astype(np.float32),
            (rng.standard_normal((Co,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("shape,act", [
    ((2, 16, 24, 8, 16), "silu"),
    ((1, 24, 16, 16, 8), "identity"),
    ((1, 16, 16, 8, 8), "relu"),
])
def test_conv3x3_plain_matches_pallas(shape, act):
    x, w, b = _conv_inputs(shape, 0)
    want = np.asarray(jax_conv3x3_silu(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), act=act,
                                       interpret=True))
    got = conv3x3_silu(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(2, 32, 48, 8, 16), (1, 64, 64, 32, 64),
                                   (1, 64, 64, 3, 16)])
def test_conv3x3s2_plain_matches_pallas(shape):
    x, w, b = _conv_inputs(shape, 3)
    want = np.asarray(jax_conv3x3s2_silu(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), interpret=True))
    got = conv3x3s2_silu(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def _c2f_inputs(B, H, W, cin, c, c2, seed=1):
    rng = np.random.default_rng(seed)

    def r(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return [r(B, H, W, cin, scale=0.5), r(cin, 2 * c, scale=cin ** -0.5),
            r(2 * c, scale=0.1), r(3, 3, c, c, scale=(9 * c) ** -0.5),
            r(c, scale=0.1), r(3, 3, c, c, scale=(9 * c) ** -0.5),
            r(c, scale=0.1), r(3 * c, c2, scale=(3 * c) ** -0.5),
            r(c2, scale=0.1)]


def test_c2f_plain_matches_pallas():
    args = _c2f_inputs(1, 32, 40, 64, 32, 64)
    want = np.asarray(jax_c2f_fused(*map(jnp.asarray, args), interpret=True))
    got = c2f_fused(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = launch_counts()
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs((1, 8, 8, 4, 8), 5))
    torch.testing.assert_close(conv3x3_silu(x, w, b),
                               conv3x3_plain(x, w, b, "silu", 1))
    torch.testing.assert_close(conv3x3s2_silu(x, w, b),
                               conv3x3_plain(x, w, b, "silu", 2))
    args = [torch.from_numpy(a) for a in _c2f_inputs(1, 8, 8, 8, 4, 8)]
    torch.testing.assert_close(c2f_fused(*args), c2f_plain(*args))
    assert launch_counts() == before


@pytest.mark.parametrize("wrapper", [conv3x3_silu, conv3x3s2_silu])
def test_non_cpu_tensors_never_fall_back(wrapper):
    """A tensor off the CPU goes to the kernel path, which raises here
    (a meta tensor is not a CUDA tensor) instead of running the plain
    version."""
    x = torch.empty(1, 8, 8, 4, device="meta")
    w = torch.empty(3, 3, 4, 8, device="meta")
    b = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(x, w, b)
    args = [torch.empty(t.shape, device="meta")
            for t in map(torch.from_numpy, _c2f_inputs(1, 8, 8, 8, 4, 8))]
    with pytest.raises(ValueError, match="CUDA"):
        c2f_fused(*args)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if build.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed, so nvcc is found")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("conv3x3")
    assert not (tmp_path / "build").exists()


def test_builds_of_two_libraries_run_side_by_side(monkeypatch, tmp_path):
    """Each library has its own build lock: two loader threads compile two
    libraries at once (each compile waits for the other to start), and a
    library built once is not compiled again."""
    import subprocess
    import threading
    from concurrent.futures import ThreadPoolExecutor

    src = tmp_path / "src"
    src.mkdir()
    for name in ("a", "b"):
        (src / f"{name}.cu").write_text(name)
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_build_locks", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    both = threading.Barrier(2, timeout=10)
    compiled = []

    def fake_compile(cmd, **kw):
        compiled.append(cmd[-1])
        both.wait()
        with open(cmd[cmd.index("-o") + 1], "wb"):
            pass
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build.subprocess, "run", fake_compile)

    def load(name):
        return build._load(name, ".cu", ("-O3",), lambda: "nvcc", [])

    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(load, ("a", "b")))
    assert sorted(compiled) == [str(src / "a.cu"), str(src / "b.cu")]
    assert load("a") == libs[0] and len(compiled) == 2


def test_c2f_supported_covers_v8s_layers():
    # v8s layer 2 (Cin 64, c 32, C2 64) and layer 8 (Cin 512, c 256, C2 512)
    assert c2f_supported(1, True, 1, 64, 32, 64)
    assert c2f_supported(1, True, 1, 512, 256, 512)
    # v8n's (c 16 and 128) too
    assert c2f_supported(1, True, 1, 32, 16, 32)
    assert c2f_supported(1, True, 1, 256, 128, 256)
    # n > 1, no shortcut, groups, widths the kernel cannot take
    assert not c2f_supported(2, True, 1, 64, 32, 64)
    assert not c2f_supported(1, False, 1, 64, 32, 64)
    assert not c2f_supported(1, True, 2, 64, 32, 64)
    assert not c2f_supported(1, True, 1, 64, 30, 64)
    # any c: neither route's shared memory grows with it
    assert c2f_supported(1, True, 1, 1024, 512, 1024)


@pytest.mark.parametrize("size", ["n", "s"])
def test_c2f_route_takes_v8_layers_2_and_8(size):
    """The static route, as the model builds it: the C2f blocks of layers 2
    and 8 (c = 16 / 128 for v8n, 32 / 256 for v8s) take the fused kernel."""
    net = YoloNet(ArchCfg(version="v8", size=size, nc=80))
    routed = sorted(n for n, m in net.named_modules()
                    if isinstance(m, C2f) and m.kernel_route)
    assert routed == ["model.2", "model.8"]
    widths = [net.get_submodule(n).c for n in routed]
    assert widths == ([16, 128] if size == "n" else [32, 256])


@pytest.mark.parametrize("bf16", [False, True])
def test_c2f_tiles_fit_shared_memory_for_every_admitted_width(bf16):
    """Every (Cin, c, C2) that c2f_supported admits has (float32) a plan at
    B = 1, 2 and 32 whose two ring stages fit the 232,448 bytes of shared
    memory and whose 3x3 tile stays within its flat rows, and (bf16) a
    16-bit plan
    at B = 1, 2 and 32 whose block fits them too, whose 3x3 tile stays
    within the two consumer warpgroups' 256 flat rows, and whose persistent
    grid (at most one block an SM, no cluster) is resident at once, as its
    grid barriers need."""
    admitted = 0
    for c in range(4, 520, 4):
        for cin, c2 in ((c, 2 * c), (2 * c, c), (8, 8)):
            if not c2f_supported(1, True, 1, cin, c, c2):
                continue
            admitted += 1
            if not bf16:
                for B in (1, 2, 32):
                    plan = f32_c2f_plan(B, 13, 11, cin, c, c2, 132)
                    assert f32_smem(plan) <= SMEM_LIMIT == 232448
                    m = plan.m
                    assert m.rows * (m.wt + 2) <= f32_rows(m.tn)
                continue
            for B in (1, 2, 32):
                plan = c2f_plan(B, 13, 11, cin, c, c2, 132)
                assert 0 < c2f_smem(B, 13, 11, plan) <= SMEM_LIMIT == 232448
                assert plan.rows * (plan.wt + 2) <= 2 * 64 * plan.ms
                assert plan.bk == (32 if c <= 32 else 64)
                assert plan.bn in (64, 128) and plan.ms in (1, 2)
                assert 2 * 64 * plan.ms >= max(g.rows for g in gemms(
                    B, 13, 11, cin, c, c2, plan))
    assert admitted > 3 * 20


# the plans kernels/c2f.py states for the model's shapes on a 132-SM card:
# v8s layer 2 (160x160, 64/32/64), v8s-cls's 56x56 (64/32/64), v8s layer 8
# (20x20, 512/256/512) and v8s-cls's 7x7 (512/256/512), at B = 1, 2, 32
STATED_PLANS = {
    (160, 160, 64, 32, 64): {1: C2fPlan(32, 64, 2, 10, 20),
                             2: C2fPlan(32, 64, 2, 10, 20),
                             32: C2fPlan(32, 64, 2, 6, 40)},
    (56, 56, 64, 32, 64): {1: C2fPlan(32, 64, 1, 4, 7),
                           2: C2fPlan(32, 64, 1, 7, 7),
                           32: C2fPlan(32, 64, 2, 14, 14)},
    (20, 20, 512, 256, 512): {1: C2fPlan(64, 64, 1, 2, 7),
                              2: C2fPlan(64, 64, 1, 5, 5),
                              32: C2fPlan(64, 128, 1, 10, 10)},
    (7, 7, 512, 256, 512): {1: C2fPlan(64, 64, 1, 1, 2),
                            2: C2fPlan(64, 64, 1, 2, 2),
                            32: C2fPlan(64, 64, 1, 7, 7)},
}


def test_c2f_bf16_tile_for_v8s_layer8_is_the_stated_one():
    """The plan the source note states for v8s layer 8 at the served batch
    of 32: 64-channel chunks, 128-wide N tiles, one m64 subtile a
    warpgroup (two would spill), 10 x 10 pixel 3x3 tiles (120 of 128 flat
    rows), so each 3x3 GEMM is 256 tiles, two rounds of the 132 SMs."""
    plan = c2f_plan(32, 20, 20, 512, 256, 512, 132)
    assert plan == C2fPlan(64, 128, 1, 10, 10)
    assert [g.tiles for g in gemms(32, 20, 20, 512, 256, 512, plan)] == \
        [400, 256, 256, 400]
    assert plan_class(256) == "deep" and plan_class(32) == "narrow"


@pytest.mark.parametrize("batch", [1, 2, 32])
@pytest.mark.parametrize("shape", list(STATED_PLANS),
                         ids=lambda s: "x".join(map(str, s)))
def test_c2f_plan_of_the_model_shapes(shape, batch):
    """v8s layers 2 and 8 and v8s-cls's two shapes take the stated plan at
    each batch on a 132-SM card, decided by shape and batch alone (the same
    answer however often and in whatever order it is asked)."""
    want = STATED_PLANS[shape][batch]
    assert c2f_plan(batch, *shape, 132) == want
    c2f_plan.cache_clear()
    assert c2f_plan(batch, *shape, 132) == want


@pytest.mark.parametrize("shape,want", [((1, 20, 20, 256), 128),
                                        ((1, 80, 80, 32), 48)])
def test_c2f_float32_tile_is_fixed_by_width(shape, want):
    """The float32 plan at these (B, H, W, c) shapes (Cin = C2 = 2c): each
    GEMM's items (tiles x splits) number at least `want` of the 132 SMs,
    its ring fits shared memory, and the plan is decided by the shape
    alone (the same answer however often it is asked)."""
    B, H, W, c = shape
    plan = f32_c2f_plan(B, H, W, 2 * c, c, 2 * c, 132)
    assert f32_smem(plan) <= SMEM_LIMIT
    items = [t * s for t, s, _, _, _ in
             f32_gemms(B, H, W, 2 * c, c, 2 * c, plan)]
    assert min(items) >= want, (plan, items)
    f32_c2f_plan.cache_clear()
    assert f32_c2f_plan(B, H, W, 2 * c, c, 2 * c, 132) == plan


# the C2f shapes (H, W, Cin, c, C2) that take the kernel in the zoo: v8n's
# and v8s's layers 2 and 8 (n = 1, shortcut; the larger sizes repeat their
# bottleneck) on the 640x640 canvas and the classify models' 224x224 one
ZOO_C2F = [(160, 160, 32, 16, 32), (20, 20, 256, 128, 256),
           (160, 160, 64, 32, 64), (20, 20, 512, 256, 512),
           (56, 56, 32, 16, 32), (7, 7, 256, 128, 256),
           (56, 56, 64, 32, 64), (7, 7, 512, 256, 512)]


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("shape", ZOO_C2F,
                         ids=lambda s: "x".join(map(str, s)))
def test_c2f_float32_plan_tiles_every_zoo_shape(shape, batch):
    """At every zoo C2f shape and served batch the float32 plan tiles each
    GEMM's whole output (the 3x3 bands cover the map within a tile's flat
    rows), leaves no split without K chunks, fills nine tenths of the 132
    SMs with the launch's largest GEMM (and each GEMM a third of them
    where its tiles and chunks allow), and fits shared memory; its scratch
    holds y1, t, z and the largest split's sums."""
    H, W, cin, c, c2 = shape
    plan = f32_c2f_plan(batch, H, W, cin, c, c2, 132)
    assert f32_smem(plan) <= SMEM_LIMIT
    m = plan.m
    assert 1 <= m.rows <= H and 1 <= m.wt <= W
    assert m.rows * (m.wt + 2) <= f32_rows(m.tn)
    npix = batch * H * W
    gs = f32_gemms(batch, H, W, cin, c, c2, plan)
    for g, (tiles, splits, chunks, n, spatial) in zip(
            (plan.cv1, m, m, plan.cv2), gs):
        if spatial:
            covered = (-(-H // m.rows) * m.rows, -(-W // m.wt) * m.wt)
            assert covered[0] >= H and covered[1] >= W
        else:
            assert tiles * f32_rows(g.tn) * g.tn >= npix * n
        assert 1 <= splits <= chunks
        assert (splits - 1) * -(-chunks // splits) < chunks   # none empty
        assert 3 * tiles * splits >= min(132, tiles * chunks)
    assert max(t * s for t, s, _, _, _ in gs) >= 0.9 * 132
    part = max(s * npix * n for _, s, _, n, _ in gs if s > 1) \
        if any(s > 1 for _, s, _, _, _ in gs) else 0
    assert f32_scratch(batch, H, W, cin, c, c2, plan) == npix * 4 * c + part


# every 3x3 conv shape (H, W, Ci, Co) of every path on the 640x640 canvas and
# the classify models' 224x224 one, and of chip_smoke's phase 15 blocks
S1_SHAPES = [
    (320, 320, 12, 32), (160, 160, 16, 32), (160, 160, 32, 16),
    (160, 160, 32, 32), (160, 160, 48, 48), (160, 160, 256, 256),
    (80, 80, 32, 32), (80, 80, 32, 64), (80, 80, 51, 51), (80, 80, 64, 32),
    (80, 80, 64, 64), (80, 80, 96, 96), (80, 80, 128, 51), (80, 80, 128, 64),
    (80, 80, 128, 96), (80, 80, 128, 128), (80, 80, 256, 64),
    (80, 80, 256, 256), (80, 80, 384, 96), (56, 56, 16, 32), (56, 56, 32, 16),
    (40, 40, 51, 51), (40, 40, 64, 64), (40, 40, 64, 128), (40, 40, 96, 96),
    (40, 40, 128, 64), (40, 40, 128, 128), (40, 40, 192, 192),
    (40, 40, 256, 51), (40, 40, 256, 64), (40, 40, 256, 128),
    (40, 40, 256, 256), (40, 40, 512, 64), (40, 40, 768, 96),
    (28, 28, 32, 64), (28, 28, 64, 32), (28, 28, 64, 64), (20, 20, 51, 51),
    (20, 20, 64, 64), (20, 20, 96, 96), (20, 20, 128, 128),
    (20, 20, 192, 192), (20, 20, 256, 256), (20, 20, 512, 51),
    (20, 20, 512, 64), (20, 20, 512, 128), (20, 20, 768, 96),
    (14, 14, 64, 64), (14, 14, 128, 128), (7, 7, 128, 128)]
S2_SHAPES = [
    (640, 640, 3, 32), (640, 640, 3, 64), (640, 640, 3, 96),
    (320, 320, 32, 32), (320, 320, 32, 64), (320, 320, 64, 32),
    (320, 320, 64, 128), (320, 320, 96, 192), (224, 224, 3, 32),
    (160, 160, 64, 128), (160, 160, 128, 128), (160, 160, 256, 256),
    (160, 160, 384, 384), (112, 112, 32, 64), (80, 80, 128, 128),
    (80, 80, 128, 256), (80, 80, 256, 256), (80, 80, 384, 384),
    (80, 80, 512, 512), (80, 80, 768, 768), (56, 56, 64, 128),
    (56, 56, 128, 128), (40, 40, 256, 256), (40, 40, 256, 512),
    (40, 40, 512, 512), (40, 40, 768, 768), (28, 28, 128, 256),
    (28, 28, 256, 256), (14, 14, 256, 512)]
# the batches the paths run: single requests, phase 2's B=2, the blocks'
# b8, the stream's b16, the served b32
PLAN_BATCHES = (1, 2, 8, 16, 32)


def _check_plan(B, H, W, ci, co, stride, sms=132):
    """The plan the wrapper passes for one call, checked as the kernel's
    launch checks it: the stem kernel's stem_plan for Ci <= 7
    (tests/test_torch_stem.py checks it); else an N tile of 64
    or 128 (128 only where Co > 64), a TMA box of (BK, P, R + 3 - S, 1)
    with P = Wt + 3 - S <= 256, R P <= 256 flat rows, the shared memory
    within the card's, and bands and W chunks that cover the output with
    none empty."""
    cip, cop = (ci, co) if ci <= 7 else (padded(ci), padded(co))
    plan = conv_plan(B, H, W, cip, cop, stride, sms)
    if ci <= 7:
        assert plan == stem_plan(B, H, W, ci, co, stride, sms)
        return plan
    bn, rows, wt = plan
    assert bn in ((64, 128) if co > 64 else (64,))
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    p = wt + 3 - stride
    box = (chunk(stride), p, rows + 3 - stride, 1)
    assert max(box) <= 256 and box[0] * 2 in (64, 128)
    assert 1 <= rows <= ho and 1 <= wt <= wo and rows * p <= TC_ROWS
    assert tc_smem(stride, rows, wt, bn) <= build.SMEM_LIMIT
    bands, chunks = -(-ho // rows), -(-wo // wt)
    assert (bands - 1) * rows < ho <= bands * rows
    assert (chunks - 1) * wt < wo <= chunks * wt
    return plan


@pytest.mark.parametrize("stride,shapes", [(1, S1_SHAPES), (2, S2_SHAPES)],
                         ids=["s1", "s2"])
def test_conv_plan_fits_every_path_shape(stride, shapes):
    """The 16-bit conv's plan at every shape of every path and each batch
    the paths run, on a 132-SM card."""
    for B in PLAN_BATCHES:
        for shape in shapes:
            _check_plan(B, *shape, stride)


@pytest.mark.parametrize("shape,stride,want", [
    ((2, 640, 640, 3, 32), 2, StemPlan(16, 1, 4, 2, 32)),  # the stem kernel
    ((32, 80, 80, 128, 128), 1, ConvPlan(128, 6, 40)),   # 6 x 42 = 252 rows
    ((2, 80, 80, 128, 128), 1, None),
    ((32, 20, 20, 512, 64), 1, None),                # Co <= 64: BN 64
    ((32, 160, 160, 64, 128), 2, ConvPlan(128, 12, 20)),  # 12 x 21 rows
    ((2, 160, 160, 128, 128), 2, None),
    ((3, 150, 142, 40, 200), 2, None),               # a card test's ragged shape
], ids=["shape0-2-0", "shape1-1-128", "shape2-1-64", "shape3-1-64",
        "shape4-2-128", "shape5-2-64", "shape6-2-128"])
def test_conv_n_tile_covers_the_sms(shape, stride, want):
    """The 16-bit conv's plan on a 132-SM card: valid (as _check_plan), the
    stated tile where one is given, and at a small batch a grid that
    gives most SMs a block: the plan trades tile size for blocks."""
    plan = _check_plan(*shape, stride)
    if want is not None:
        assert plan == want
    if isinstance(plan, ConvPlan):
        B, H, W, _, co = shape
        ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        blocks = (B * -(-ho // plan.rows) * -(-wo // plan.wt)
                  * -(-co // plan.bn))
        assert blocks >= 0.75 * 132 or plan.rows * plan.wt == 1


def test_conv_plan_pads_odd_widths_and_sizes_the_box():
    """Ci and Co not multiples of 8 reach the plan (and the kernel) padded;
    the box rows of a stride-2 plan are its parity planes' R + 1; the
    shared memory of the largest stride-1 and stride-2 tiles."""
    assert padded(51) == 56 and padded(12) == 16 and padded(64) == 64
    assert chunk(1) == 64 and chunk(2) == 32
    # S = 1, R = 3 rows of P = 82: (256 + 2 * 82 + 2) rows of 128 bytes a
    # slot, two slots, 4 weight slots of 64 x 128 x 2 bytes, 20 barriers
    assert tc_smem(1, 3, 80, 128) == 1024 + 2 * 54272 + 4 * 16384 + 160
    # S = 2, R = 3 rows of P = 81: planes 336 rows apart, a slot of 3 x 336
    # + 256 + 82 rows of 64 bytes
    assert tc_smem(2, 3, 80, 128) == 1024 + 2 * 87040 + 4 * 8192 + 160
    assert tc_smem(2, 3, 80, 128) <= build.SMEM_LIMIT
