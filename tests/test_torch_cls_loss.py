"""classification_loss of the port against the JAX package's on the CPU: the
mean cross-entropy of float32 logits (bfloat16 logits are taken in float32,
as the JAX loss casts them) and its gradient against jax.grad of the JAX
loss, at a few batch sizes, class counts and logit scales."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolosharp_tpu.loss import losses as jax_losses
from yolosharp_tpu_torch.loss import classification_loss


@pytest.mark.parametrize("b,nc,scale", [(2, 5, 1.0), (4, 10, 8.0),
                                        (7, 1000, 3.0), (1, 3, 30.0)])
def test_classification_loss_matches_jax(b, nc, scale):
    """Loss and items to 1e-6 relative, the gradient of the loss with
    respect to the logits to 1e-6 of its largest."""
    rng = np.random.default_rng(b * nc)
    logits = (rng.normal(0, 1, (b, nc)) * scale).astype(np.float32)
    labels = rng.integers(0, nc, b).astype(np.int32)
    jloss, jitems = jax_losses.classification_loss(
        {"cls": jnp.asarray(logits)}, {"cls": jnp.asarray(labels)})
    jgrad = jax.grad(lambda z: jax_losses.classification_loss(
        {"cls": z}, {"cls": jnp.asarray(labels)})[0])(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    loss, items = classification_loss({"cls": z},
                                      {"cls": torch.from_numpy(labels)})
    loss.backward()
    assert loss.dtype == torch.float32 and items.shape == (1,)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(items.detach().numpy(), np.asarray(jitems),
                               rtol=1e-6)
    g, jg = z.grad.numpy(), np.asarray(jgrad)
    assert np.abs(g - jg).max() <= 1e-6 * np.abs(jg).max()


def test_bf16_logits_are_taken_in_float32():
    """bfloat16 logits: the loss of their float32 values, in float32, as
    the JAX loss's astype(float32); labels of any integer type."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(0, 4, (6, 12)).astype(
        np.float32)).to(torch.bfloat16)
    labels = rng.integers(0, 12, 6)
    loss, _ = classification_loss({"cls": logits},
                                  {"cls": torch.from_numpy(labels)})
    jloss, _ = jax_losses.classification_loss(
        {"cls": jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16)},
        {"cls": jnp.asarray(labels.astype(np.int32))})
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
