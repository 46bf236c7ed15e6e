"""The port's attention kernel module (yolosharp_tpu_torch/kernels/attention):
its plain version, reached through the wrappers on CPU tensors, against the
JAX package's Pallas ``fused_attention`` (interpret mode) and its
``attention_bihd``; the wrappers' routing; the bf16 kernel's launch geometry.
The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolosharp_tpu.kernels.attention import attention_bihd as jax_bihd
from yolosharp_tpu.kernels.attention import fused_attention as jax_fused
from yolosharp_tpu_torch.kernels import (attention_bihd, attention_plain,
                                         fused_attention, launch_counts)
from yolosharp_tpu_torch.kernels.attention import (
    HEAD_DIMS, KEY_TILE, MAX_BLOCKS, SM_SMEM, SMEM_LIMIT, STREAM_SMEM,
    kv_keys, launch_geometry, smem_bytes)

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
