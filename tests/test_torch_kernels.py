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
from yolosharp_tpu_torch.kernels.c2f import (SMEM_LIMIT, launch_tile,
                                             smem_bytes, tile_for)
from yolosharp_tpu_torch.kernels.conv3x3 import n_tile
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
    assert not c2f_supported(1, True, 1, 1024, 512, 1024)


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
    """Every (Cin, c, C2) that c2f_supported admits has a tile whose block
    fits the 232,448 bytes of shared memory in both types, and (bf16) a
    window of at most 640 pixels, the kernel's 8 warps x 5 m16 tiles."""
    admitted = 0
    for c in range(4, 520, 4):
        for cin, c2 in ((c, 2 * c), (2 * c, c), (8, 8)):
            if not c2f_supported(1, True, 1, cin, c, c2):
                continue
            admitted += 1
            tile = tile_for(c, bf16)
            assert smem_bytes(tile, c, bf16) <= SMEM_LIMIT == 232448
            assert not bf16 or (tile + 4) ** 2 <= 640
    assert admitted > 3 * 20


def test_c2f_bf16_tile_for_v8s_layer8_is_the_stated_one():
    """The bf16 tile the source note states: 16 for c <= 32, 8 for c = 256,
    whose bf16 block takes 219,456 bytes (float32: 4 for c > 64)."""
    assert tile_for(16, True) == tile_for(32, True) == 16
    assert tile_for(256, True) == 8
    assert smem_bytes(8, 256, True) == 219456
    assert tile_for(256) == 4 and tile_for(32) == 8


@pytest.mark.parametrize("shape,stride,want", [
    ((2, 640, 640, 3, 32), 2, 0),        # the stem kernel
    ((32, 80, 80, 128, 128), 1, 128),    # 1600 blocks of 128 x 128
    ((2, 80, 80, 128, 128), 1, 64),      # 100 blocks: too few for 132 SMs
    ((32, 20, 20, 512, 64), 1, 64),      # Co <= 64
    ((32, 160, 160, 64, 128), 2, 128),
    ((2, 160, 160, 128, 128), 2, 64),
    ((3, 150, 142, 40, 200), 2, 128),    # a card test's ragged shape
])
def test_conv_n_tile_covers_the_sms(shape, stride, want):
    """The bf16 conv's N tile on a 132-SM card: 128 channels where that
    grid of 128-pixel blocks still gives every SM a block, else 64."""
    assert n_tile(*shape, stride, 132) == want


@pytest.mark.parametrize("shape,bf16,want", [
    ((2, 20, 20, 256), True, 4),     # v8s layer 8 at B=2: 18 blocks of 8x8
    ((32, 20, 20, 256), True, 8),    # ... at the served batch of 32
    ((2, 160, 160, 32), True, 16),   # v8s layer 2 at B=2: 200 blocks
    ((1, 160, 160, 32), True, 8),    # one 640x640 request
    ((1, 4, 4, 32), True, 4),        # halved down to 4, no further
    ((1, 20, 20, 256), False, 4),    # float32 takes tile_for as it is
    ((1, 80, 80, 32), False, 8),
])
def test_c2f_launch_tile_halves_while_sms_idle(shape, bf16, want):
    """The C2f tile the wrapper passes to the kernel on a 132-SM card."""
    assert launch_tile(*shape, bf16, 132) == want
    assert smem_bytes(want, shape[3], bf16) <= SMEM_LIMIT
