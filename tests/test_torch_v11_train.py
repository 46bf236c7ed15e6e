"""One float32 v11n train step of the port against the jitted JAX step on
the CPU (split from test_torch_v11.py so that its JAX compile runs beside
the other files' on the test workers)."""

from test_torch_train import (_batch, _one_thread,  # noqa: F401
                              check_step_pair, step_pair)


def test_v11n_train_step_matches_jax():
    """One float32 v11n step at 64x64, batch 2 against the JAX step, at
    the rules of tests/test_torch_train.py (check_step_pair), widened where
    v11n's deeper float32 graph (the PSA attention's softmax, the C3k2 and
    C2PSA depth, train-mode BN over the 8 values a channel of the 2x2
    stride-32 maps) carries more rounding than v8n's; the JAX package's
    FastBN variance (E[x^2] - E[x]^2) is the larger share of it. Measured:
    loss items 9.8e-5 relative apart, so held to 3e-4; running means
    1.7e-5 of their tensor's largest apart, held to 5e-5; the update's sign
    differs between the two packages on elements up to 4.7e-3 of their
    tensor's largest gradient, so the changes (within one float32 spacing
    of the parameter more) are held where |g| > 1e-2 max|g|, on at least
    60% of the elements. SPPF's cv1 BN bias (layer 9) is left out: its
    gradient is zero by construction (the identity activation and the max
    pools carry it into cv2's train-mode BN, which removes it), and
    rounding noise in both."""
    check_step_pair(step_pair("v11", _batch(5)), items_rtol=3e-4,
                    stats_rtol=5e-5, ulp=True, grad_noise=1e-2,
                    min_checked=0.6, skip=("model.9.cv1.bn.bias",))
