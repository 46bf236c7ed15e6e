"""The port's quotients by a constant against the JAX reference's own route,
bit for bit, on the CPU.

The JAX package divides inside ``jax.jit`` on its normal routes: the
predict input (``x.astype(float32) / 255.0`` in the jitted predict), the
int8 scales (``max(absmax, 1e-6) / 127`` and the per-channel weight scale
of ``nn.common.int8_conv``, jitted inside predict) and the image
normalisation of the jitted train and eval steps. XLA turns each into a
multiply by a rounded reciprocal, so the eager or numpy quotient is not
the reference: on uint8 levels float32 true division agrees on 130 of 256
(checked below). ``utils.numerics.divide_by_constant`` writes XLA's route
out; these tests hold it to the jitted JAX expressions on all 256 uint8
levels and on 10^6 seeded float32 values, the predict
and int8 sites that use it on 10^6 seeded absmax values and channels, and
the train and eval normalisation (``train.normalize_images`` and the
planned batch's /255 in ``train.resolve_batch_images``) in float32,
bfloat16 and float16. The
host quotient of calibrate_int8 is numpy in both packages (the same line).
tests/test_torch_cuda.py holds the card to these CPU results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolosharp_tpu import train as jax_train
from yolosharp_tpu_torch import train as torch_train
from yolosharp_tpu_torch.data import device_augment
from yolosharp_tpu_torch.kernels.int8_conv import (activation_scale,
                                                   quantize_weight)
from yolosharp_tpu_torch.utils.numerics import divide_by_constant

LEVELS = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, 3)


def _bits(a) -> np.ndarray:
    """The raw bits of a float32 array for exact comparison."""
    return np.asarray(a, np.float32).view(np.uint32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.float32
    return _bits(t.contiguous().numpy())


# the working types of the train and eval steps, in both packages
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (torch.float16, jnp.float16)]


def _same_bits(got: torch.Tensor, want, dtype: torch.dtype) -> None:
    """got (a torch tensor of dtype) equal to want (a JAX array of the same
    type) bit for bit: both widened to float32, which is exact."""
    assert got.dtype == dtype
    np.testing.assert_array_equal(
        _torch_bits(got.float()), _bits(np.asarray(want).astype(np.float32)))


def test_divide_by_constant_matches_jitted_normalize_images():
    """divide_by_constant of every uint8 level by 255 equals the JAX
    package's normalize_images under jax.jit in float32."""
    want = jax.jit(lambda a: jax_train.normalize_images(a, jnp.float32))(
        LEVELS)
    got = divide_by_constant(torch.from_numpy(LEVELS), 255.0)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


def test_divide_by_constant_matches_the_jitted_render_quotient():
    """10^6 seeded float32 values in [0, 255] (a planned batch's render)
    divided by 255, as the jitted JAX step's resolve_batch_images computes
    it in float32."""
    x = (np.random.default_rng(0).random(10 ** 6) * 255).astype(np.float32)
    want = jax.jit(lambda a: a / 255.0)(x)
    got = divide_by_constant(torch.from_numpy(x), 255.0)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


def test_predict_input_matches_the_jitted_predict():
    """The predict input: uint8 -> float32 / 255 as the jitted JAX predict
    computes it (tasks.py's ``img.astype(jnp.float32) / 255.0``), and not
    as a true division: those differ on most levels."""
    want = jax.jit(lambda a: a.astype(jnp.float32) / 255.0)(LEVELS)
    got = divide_by_constant(torch.from_numpy(LEVELS), 255.0)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))
    true_div = LEVELS.astype(np.float32) / np.float32(255)
    assert (_bits(true_div) == _bits(want)).sum() == 130 * 3


def test_activation_scale_matches_the_jitted_int8_conv():
    """activation_scale of 10^6 seeded absmax values (with zeros and values
    below the 1e-6 floor) equals nn.common.int8_conv's a_scale under jit."""
    rng = np.random.default_rng(1)
    a = (rng.random(10 ** 6) * 10 ** rng.uniform(-7, 2, 10 ** 6)).astype(
        np.float32)
    a[:1000] = 0
    want = jax.jit(lambda v: (jnp.maximum(v, 1e-6) / 127.0).astype(
        jnp.float32))(a)
    got = torch.stack([activation_scale(t) for t in
                       torch.from_numpy(a[:2000])])
    np.testing.assert_array_equal(_torch_bits(got), _bits(want)[:2000])
    # the same route, vectorised over all 10^6
    got = divide_by_constant(torch.clamp(torch.from_numpy(a), min=1e-6),
                             127.0)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


def test_quantize_weight_matches_the_jitted_int8_conv():
    """quantize_weight's per-channel scales and int8 weights equal
    nn.common.int8_conv's w_scale and wq under jit, over 10^6 seeded
    output channels (k = 1, Ci = 2)."""
    rng = np.random.default_rng(2)
    co = 10 ** 6
    w = (rng.standard_normal((co, 2, 1, 1))
         * 10 ** rng.uniform(-13, 1, (co, 1, 1, 1))).astype(np.float32)
    w[:100] = 0

    def jax_route(kernel):        # HWIO, as int8_conv takes it
        w_absmax = jnp.max(jnp.abs(kernel), axis=(0, 1, 2))
        w_scale = (jnp.maximum(w_absmax, 1e-12) / 127.0).astype(jnp.float32)
        wq = jnp.clip(jnp.round(kernel.astype(jnp.float32) / w_scale),
                      -127, 127).astype(jnp.int8)
        return wq, w_scale

    wq_j, scale_j = jax.jit(jax_route)(w.transpose(2, 3, 1, 0))
    wq, scale = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(_torch_bits(scale), _bits(scale_j))
    np.testing.assert_array_equal(
        wq[:, 0, 0, :2].numpy(), np.asarray(wq_j)[0, 0].T)


@pytest.mark.parametrize("dtype,jdtype", DTYPES,
                         ids=["float32", "bfloat16", "float16"])
def test_normalize_images_matches_the_jitted_jax_normalize_images(
        dtype, jdtype):
    """train.normalize_images of every uint8 level equals the JAX
    package's normalize_images under jax.jit, in each working type (the
    port's (B, 3, H, W) against JAX's NHWC)."""
    want = jax.jit(lambda a: jax_train.normalize_images(a, jdtype))(LEVELS)
    got = torch_train.normalize_images(torch.from_numpy(LEVELS), dtype)
    _same_bits(got.permute(0, 2, 3, 1), want, dtype)


@pytest.mark.parametrize("dtype,jdtype", DTYPES,
                         ids=["float32", "bfloat16", "float16"])
def test_planned_batch_quotient_matches_the_jitted_jax_step(
        monkeypatch, dtype, jdtype):
    """The planned batch's /255 in train.resolve_batch_images on a render
    (stubbed) that holds every uint8 level and 10^6 seeded float32 values
    in [0, 255] equals the jitted JAX resolve_batch_images' quotient
    ``images.astype(dtype) / 255.0`` in each working type; on the levels
    that is also the jitted JAX normalize_images."""
    rng = np.random.default_rng(3)
    render = np.concatenate(
        [LEVELS.astype(np.float32).reshape(-1, 3),
         (rng.random((10 ** 6 // 3 * 3)) * 255).astype(np.float32)
         .reshape(-1, 3)]).reshape(1, -1, 1, 3)
    monkeypatch.setattr(device_augment, "render_batch",
                        lambda batch: torch.from_numpy(render))
    got, _ = torch_train.resolve_batch_images({"aug_pool": None}, dtype)
    got = got.permute(0, 2, 3, 1)
    want = jax.jit(lambda a: a.astype(jdtype) / 255.0)(render)
    _same_bits(got, want, dtype)
    levels = jax.jit(lambda a: jax_train.normalize_images(a, jdtype))(LEVELS)
    _same_bits(got[:, :LEVELS.size // 3].reshape(LEVELS.shape), levels,
               dtype)
