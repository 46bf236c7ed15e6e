"""The port's attention kernel module (yolosharp_tpu_torch/kernels/attention):
its plain version, reached through the wrappers on CPU tensors, against the
JAX package's Pallas ``fused_attention`` (interpret mode) and its
``attention_bihd``; the backward's plain twin against the JAX custom VJP's
``_pallas_attn_bwd``; the wrappers' routing; the 16-bit kernels' plans.
The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolosharp_tpu.kernels.attention import _pallas_attn_bwd
from yolosharp_tpu.kernels.attention import attention_bihd as jax_bihd
from yolosharp_tpu.kernels.attention import fused_attention as jax_fused
from yolosharp_tpu_torch.kernels import (attention_bihd, attention_bwd_plain,
                                         attention_plain, attention_stats_plain,
                                         fused_attention, fused_attention_bwd,
                                         launch_counts)
from yolosharp_tpu_torch.kernels.attention import (
    HEAD_DIMS, KEY_TILE, KINDS, MAX_BLOCKS, MAX_STAGES, SM_SMEM, SMEM_LIMIT,
    STREAM_SMEM, UNIT_ROWS, F32_KEY_TILE, attention_plan, f32_geometry,
    f32_layout, f32_smem_bytes, kv_keys, launch_geometry, lse_rows,
    plan_smem, smem_bytes, stage_bytes, stream_tile)

# the tolerance of tests/test_pallas_attention.py: float32 sums in another
# order
ATOL, RTOL = 2e-5, 2e-4


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,h,n,d", [(2, 1, 400, 32), (1, 2, 100, 64),
                                     (1, 1, 300, 32), (2, 4, 192, 32),
                                     (1, 4, 300, 32)])
def test_fused_attention_matches_pallas(b, h, n, d):
    q, k, v = _qkv((b, h, n, d), n + d)
    scale = d ** -0.5
    want = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), scale=scale, block_rows=128,
                                interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fused_attention(tq, tk, tv, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.numpy(),
                                  attention_plain(tq, tk, tv, scale).numpy())


@pytest.mark.parametrize("b,n,h,d", [(2, 35, 2, 32), (1, 99, 3, 16)])
def test_attention_bihd_matches_jax(b, n, h, d):
    """(B, N, H, D) layout, with q, k and v strided views of one qkv tensor
    split per head, as AAttn gives them."""
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((b, n, h, 3 * d)).astype(np.float32)
    q, k, v = np.split(qkv, 3, axis=-1)
    scale = d ** -0.5
    want = np.asarray(jax_bihd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale))
    tq, tk, tv = torch.from_numpy(qkv).split(d, dim=-1)
    assert not tq.is_contiguous()
    got = attention_bihd(tq, tk, tv, scale)
    assert got.shape == (b, n, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = launch_counts()
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 50, 16), 0))
    torch.testing.assert_close(fused_attention(q, k, v, 0.25),
                               attention_plain(q, k, v, 0.25))
    attention_bihd(q, k, v, 0.25)
    assert launch_counts() == before


@pytest.mark.parametrize("wrapper", [fused_attention, attention_bihd])
def test_non_cpu_tensors_never_fall_back(wrapper):
    """A tensor off the CPU goes to the kernel path, which raises here (a
    meta tensor is not a CUDA tensor) instead of running the plain
    version."""
    q = torch.empty(1, 2, 64, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(q, q, q, 0.2)
    with pytest.raises(ValueError, match="head dim"):
        wrapper(*(torch.empty(1, 2, 64, 24, device="meta"),) * 3, 0.2)


@pytest.mark.parametrize("bh,n,d,want", [
    (512, 400, 32, (1, 400, 4)),    # v12s layer 6, batch 32: one block each
    (256, 400, 32, (2, 400, 4)),    # layer 8, batch 32: two per sequence
    (16, 400, 32, (25, 400, 4)),    # layer 6 of one request: a tile a block
    (8, 300, 32, (19, 304, 4)),     # layer 8 of one 480x640 request
    (32, 1600, 32, (4, 1600, 8)),   # 1280x1280, B=2: one block an SM
    (64, 400, 64, (4, 400, 4)),     # two blocks an SM
    (128, 1600, 128, (2, 192, 4)),  # too long to stage whole: streamed
    (1, 1, 16, (1, 16, 4)),
])
def test_attention_launch_geometry(bh, n, d, want):
    """132 SMs (an H100 SXM): the splits fill the blocks the SMs hold at
    once, the staged keys are the whole sequence where it fits, and a block
    that holds an SM alone has 8 warps."""
    assert launch_geometry(bh, n, d, 132) == want


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_attention_geometry_is_what_the_kernel_takes(d):
    """What csrc/attention.cu checks: 1 <= splits <= the 16-row tiles,
    staged keys a multiple of 16 that cover N (then within one block's
    shared memory) or key-tile chunks within STREAM_SMEM, and no more
    blocks than the SMs hold at once unless each sequence has one."""
    for n in (1, 15, 16, 17, 63, 65, 300, 400, 1000, 1600, 3000, 6400):
        for bh in (1, 8, 16, 64, 256, 512, 4096):
            splits, keys, warps = launch_geometry(bh, n, d, 132)
            assert 1 <= splits <= -(-n // 16)
            assert keys >= 16 and keys % 16 == 0 and keys < n + 16
            if keys >= n:
                assert keys == kv_keys(n, d)
                assert smem_bytes(keys, d) <= SMEM_LIMIT
            else:
                assert keys % KEY_TILE == 0
                assert smem_bytes(keys, d) <= STREAM_SMEM
            per_sm = min(MAX_BLOCKS, SM_SMEM // (smem_bytes(keys, d) + 1024))
            assert splits == 1 or splits * bh <= 132 * per_sm
            assert warps == (8 if per_sm == 1 else 4)


# the (sequences, N, D) of every attention call chip_smoke phase 2 times
# (v12s and v12x-obb at B=2 on the 640x640, 480x640, 512x384 and, v12s only,
# 1280x1280 canvases, and at B=32 on 640x640) and phase 5 (the v12s b16 and
# v12x-obb b8 train shapes, whose backward runs the kernels planned here);
# D = 32 in every v12 AAttn
MODEL_SHAPES = sorted(
    {(batch * areas * heads, n, 32)
     for batch in (2,) for areas, heads in ((4, 4), (1, 8), (4, 12), (1, 12))
     for n in (400, 300, 192)}
    | {(2 * areas * heads, 1600, 32) for areas, heads in ((4, 4), (1, 8))}
    | {(32 * areas * heads, 400, 32)
       for areas, heads in ((4, 4), (1, 8), (4, 12), (1, 12))}
    | {(64 * 4, 400, 32), (16 * 8, 400, 32), (32 * 12, 400, 32),
       (8 * 12, 400, 32)})


def _check_plan(plan, kind, S, N, D, sms=132):
    """What csrc/attention16.cuh checks, and that the units and the stream
    tiles cover every row: shared memory within what a block may use, 2 to
    MAX_STAGES ring stages (as many as fit), one persistent block an SM at
    most and never more blocks than units."""
    assert plan.kind == kind and plan.tile == stream_tile(kind, D)
    assert plan.smem == plan_smem(kind, D, plan.stages) <= SMEM_LIMIT
    assert plan.smem <= 227 * 1024
    assert 2 <= plan.stages <= MAX_STAGES
    assert (plan.stages == MAX_STAGES
            or plan.smem + stage_bytes(kind, D) > SMEM_LIMIT)
    assert plan.units == S * -(-N // UNIT_ROWS)
    assert plan.units * UNIT_ROWS >= S * N > (plan.units - S) * UNIT_ROWS
    assert plan.grid == min(plan.units, sms) >= 1


@pytest.mark.parametrize("S,n,d", MODEL_SHAPES)
def test_attention_plan_of_the_model_shapes(S, n, d):
    """The backward kernels' plans at every model shape on 132 SMs (an H100
    SXM): 64-row stream tiles, a ring of 8 stages that holds a whole
    N <= 400 sequence, and a grid of every SM (or one block a unit where
    the units are fewer); N = 1600 streams through the ring."""
    for kind in KINDS:
        plan = attention_plan(kind, S, n, d, 132)
        _check_plan(plan, kind, S, n, d)
        assert plan.tile == 64 and plan.stages == MAX_STAGES
        # the ring holds a whole N <= 400 sequence; N = 1600 streams
        assert (plan.stages * plan.tile >= n) == (n <= 512)
        assert plan.grid == min(132, S * -(-n // 128))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_attention_plan_is_what_the_kernel_takes(kind, d):
    """Every head dim and kernel kind at ragged N and many batch sizes,
    and on a card of fewer SMs: the plan fits, covers N, and streams where
    the sequence is longer than the ring (N = 1600 at every D; at D = 128
    the ring is shorter, 3 to 5 stages)."""
    for n in (1, 15, 16, 17, 63, 65, 300, 400, 1000, 1600, 3000, 6400):
        for S in (1, 8, 16, 64, 256, 512, 4096):
            for sms in (132, 78):
                _check_plan(attention_plan(kind, S, n, d, sms), kind, S, n,
                            d, sms)
    plan = attention_plan(kind, 64, 1600, d, 132)
    assert plan.stages * plan.tile < 1600   # streamed through the ring
    assert (plan.stages < MAX_STAGES) == (d == 128)


def test_attention_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        attention_plan("dq", 1, 64, 24, 132)
    with pytest.raises(ValueError):
        attention_plan("fwd", 1, 64, 32, 132)


def _bwd_case(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, h, 3 * d)).astype(np.float32)
    g = rng.standard_normal((b, n, h, d)).astype(np.float32)
    return qkv, g


@pytest.mark.parametrize("b,n,h,d", [(2, 35, 2, 32), (3, 64, 4, 16),
                                     (1, 17, 1, 64)])
def test_attention_bwd_plain_matches_jax(b, n, h, d):
    """The backward kernel's plain twin (gradients from q, k, v, g and the
    forward's row statistics) against _pallas_attn_bwd called directly,
    float32, to 1e-5; its statistics are the log2-sum-exp of each row,
    padded to lse_rows(N) with zeros, and the float32 output."""
    qkv, g = _bwd_case(b, n, h, d, n + d)
    scale = d ** -0.5
    q, k, v = np.split(qkv, 3, axis=-1)
    want = _pallas_attn_bwd(scale, tuple(map(jnp.asarray, (q, k, v))),
                            jnp.asarray(g))
    tq, tk, tv = torch.from_numpy(qkv).split(d, dim=-1)
    lse, o32 = attention_stats_plain(tq, tk, tv, scale)
    assert lse.shape == (b * h, lse_rows(n)) and lse.shape[1] % 4 == 0
    np.testing.assert_allclose(
        o32.numpy().reshape(b, h, n, d).transpose(0, 2, 1, 3),
        attention_bihd(tq, tk, tv, scale).numpy(), rtol=1e-6, atol=1e-6)
    s = np.einsum("bihd,bjhd->bhij", q.astype(np.float64) * scale, k)
    np.testing.assert_allclose(
        lse[:, :n].numpy().reshape(b, h, n),
        np.log2(np.exp(s).sum(-1)), rtol=1e-5, atol=1e-5)
    assert not lse[:, n:].any()
    got = attention_bwd_plain(tq, tk, tv, torch.from_numpy(g), lse, o32,
                              scale)
    for gg, w in zip(got, want):
        assert gg.dtype == torch.float32 and gg.shape == (b, n, h, d)
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("b,n,h,d", [(2, 35, 2, 32), (1, 64, 3, 16)])
def test_attention_bwd_plain_matches_jax_in_bfloat16(b, n, h, d):
    """At bf16 inputs both backwards round their gradients to bf16, but JAX
    also rounds q * scale and the scores to bf16 before its float32
    softmax, where the twin keeps them in float32: the twin's distance from
    float64 (on the same rounded inputs) is held to JAX's own plus one
    bf16 rounding, per gradient."""
    qkv, g = _bwd_case(b, n, h, d, 7 * n + d)
    scale = d ** -0.5
    tqkv = torch.from_numpy(qkv).bfloat16()
    tg = torch.from_numpy(g).bfloat16()
    q, k, v = tqkv.split(d, dim=-1)
    want = _pallas_attn_bwd(
        scale, tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                     for t in (q, k, v)),
        jnp.asarray(tg.float().numpy(), jnp.bfloat16))
    got = attention_bwd_plain(q, k, v, tg, *attention_stats_plain(q, k, v, scale),
                              scale)
    qd, kd, vd, gd = (t.double() for t in (q, k, v, tg))
    s = torch.einsum("bihd,bjhd->bhij", qd * scale, kd)
    p = torch.softmax(s, -1)
    dp = torch.einsum("bihd,bjhd->bhij", gd, vd)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    refs = (scale * torch.einsum("bhij,bjhd->bihd", ds, kd),
            scale * torch.einsum("bhij,bihd->bjhd", ds, qd),
            torch.einsum("bhij,bihd->bjhd", p, gd))
    for gg, w, ref in zip(got, want, refs):
        assert gg.dtype == torch.bfloat16
        top = float(ref.abs().max())
        mine = float((gg.double() - ref).abs().max())
        jax_d = float(np.abs(np.asarray(w, np.float64) - ref.numpy()).max())
        assert mine <= jax_d + 2.0 ** -8 * top, (mine, jax_d, top)


def test_fused_attention_bwd_takes_the_plain_twin_on_the_cpu():
    """On CPU tensors the backward wrapper is its plain twin and launches
    nothing; off the CPU it goes to the kernel path, which raises here."""
    qkv, g = _bwd_case(1, 20, 2, 16, 3)
    q, k, v = torch.from_numpy(qkv).split(16, dim=-1)
    tg = torch.from_numpy(g)
    stats = attention_stats_plain(q, k, v, 0.25)
    before = launch_counts()
    got = fused_attention_bwd(q, k, v, tg, *stats, 0.25)
    for a, b_ in zip(got, attention_bwd_plain(q, k, v, tg, *stats, 0.25)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert launch_counts() == before
    m = torch.empty(1, 20, 2, 16, dtype=torch.bfloat16, device="meta")
    mstats = [torch.empty(t.shape, device="meta") for t in stats]
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention_bwd(m, m, m, m, *mstats, 0.25)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        fused_attention_bwd(*(m.float(),) * 4, *mstats, 0.25)
    with pytest.raises(ValueError, match="lse and o32"):
        fused_attention_bwd(m, m, m, m, mstats[0], mstats[0], 0.25)


@pytest.mark.parametrize("S,n,d", MODEL_SHAPES)
def test_float32_attention_geometry_of_the_model_shapes(S, n, d):
    """The float32 kernel's geometry at every model shape on 132 SMs:
    blocks of 8 warps (32-row warp tiles at D = 32); a sequence of N <= 400
    staged whole (N rounded to 16), N = 1600 streamed in 64-key multiples
    through two stages; the splits fill the SMs without a second wave of
    blocks, every block has warp tiles, and where a block has fewer tiles
    than warps its warps share tiles in groups that leave none idle for
    want of a tile."""
    splits, keys, warps, group = f32_geometry(S, n, d, 132)
    _, wr, _ = f32_layout(d)
    tiles = -(-n // wr)
    assert warps == 8 and wr == 32
    assert (keys >= n) == (n <= 400)
    if keys >= n:
        assert keys == -(-n // 16) * 16
        assert f32_smem_bytes(keys, 1, warps, d) <= SMEM_LIMIT
    else:
        assert keys % F32_KEY_TILE == 0
        assert f32_smem_bytes(keys, 2, warps, d) <= SMEM_LIMIT
    assert 1 <= splits <= tiles
    assert S * splits <= 132 or splits == 1
    assert S * splits > 132 // 2 or splits == tiles
    per_block = -(-tiles // splits)
    assert group & (group - 1) == 0
    assert group == 1 or group * per_block <= warps
    assert 2 * group * per_block > warps or 2 * group > -(-n // 64)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_float32_attention_geometry_is_what_the_kernel_takes(d):
    """What csrc/attention.cu's float32 launch checks, at every head dim
    and a range of N and sequences: 1 <= splits <= the warp tiles, staged
    keys a multiple of 16 that cover N (one stage within a block's shared
    memory) or a multiple of the 64-key step (two stages within it), 1 to
    8 warps, and warp groups that divide the warps."""
    _, wr, _ = f32_layout(d)
    for n in (1, 15, 16, 17, 63, 65, 300, 400, 1000, 1600, 3000, 6400):
        for bh in (1, 8, 16, 64, 256, 512, 4096):
            splits, keys, warps, group = f32_geometry(bh, n, d, 132)
            assert group >= 1 and warps % group == 0
            assert 1 <= splits <= -(-n // wr)
            assert 1 <= warps <= 8 and keys >= 16 and keys % 16 == 0
            assert keys < n + 16
            stages = 1 if keys >= n else 2
            assert f32_smem_bytes(keys, stages, warps, d) <= SMEM_LIMIT
            if stages == 2:
                assert keys % F32_KEY_TILE == 0
