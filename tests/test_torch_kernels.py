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
