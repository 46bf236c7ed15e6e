"""One bfloat16 train step of v8n and v12n of the port against the JAX
package's on the CPU, and where the two part (split from
test_torch_train.py so that its JAX compiles run beside the other files'
on the test workers).
"""

import numpy as np
import pytest
import torch

from test_torch_train import _batch, port_step, step_pair
from yolosharp_tpu_torch.ckpt import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the suite runs
    several pytest workers on the host's cores, and oversubscribed torch
    threads made this file several times slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sign_agreement(a, b, init, resolved):
    """The share of the `resolved` parameter elements (name -> mask) whose
    changes a - init and b - init have the same sign (AdamW's first update
    is lr * sign(g))."""
    same = sum(int(((a[n] - init[n]).sign() == (b[n] - init[n]).sign())[m]
                   .sum()) for n, m in resolved.items())
    return same / sum(int(m.sum()) for m in resolved.values())


def _worst_stat(a, b, ref, kind):
    """max over the BN tensors of `kind` of max|a - b| / max|ref|."""
    return max(float((a[k] - b[k]).abs().max() / ref[k].abs().max())
               for k in ref if k.endswith(kind))


def _step_distance(a, b, init, resolved):
    """How far step a lies from step b (each a dict of state dict "sd" and
    loss "items"): loss items relative to b's, the sign agreement of the
    resolved updates, and the worst BN running mean and variance over
    their tensor's largest value."""
    d = {"items": np.abs(a["items"] - b["items"]) / np.abs(b["items"]),
         "agreement": _sign_agreement(a["sd"], b["sd"], init, resolved)}
    d.update({k: _worst_stat(a["sd"], b["sd"], b["sd"], k)
              for k in ("running_mean", "running_var")})
    return d


@pytest.fixture(scope="module")
def bf16_steps():
    """version -> (the bf16 step_pair, the port's float32 step from the same
    weights) of v8n / v12n at 128x128, batch 4 (_batch(5, 4, size=128)),
    made on first use."""
    cache = {}

    def get(version):
        if version not in cache:
            batch = _batch(5, b=4, size=128)
            s = step_pair(version, batch, dtype=torch.bfloat16)
            cache[version] = (s, port_step(s["variables"], version, batch))
        return cache[version]
    return get


def _fastbn_train(y, bn):
    """Train-mode BN with the JAX FastBN's arithmetic
    (yolosharp_tpu/nn/common.py:185-200): statistics E[x] and
    E[x^2] - E[x]^2 in float32, then y * k rounded to y's type and + b
    rounded again."""
    yf = y.float()
    mean = yf.mean((0, 2, 3))
    var = ((yf * yf).mean((0, 2, 3)) - mean * mean).clamp(min=0)
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1 - bn.momentum).add_(var, alpha=bn.momentum)
    k = bn.weight * torch.rsqrt(var + bn.eps)
    b = bn.bias - mean * k
    shape = (1, -1, 1, 1)
    return y * k.to(y.dtype).view(shape) + b.to(y.dtype).view(shape)


@pytest.mark.parametrize("version", ["v8", "v12"])
def test_bf16_train_step_matches_jax(version, bf16_steps):
    """One bfloat16 step of v8n / v12n at 128x128, batch 4, against the JAX
    make_train_step(compute_dtype=bf16) on the same weights and uint8
    batch. The float32 reference is the port's own float32 step: it lies
    within 3e-6 relative of the JAX float32 step here (loss items; BN
    statistics 2e-6), so the distance from it to the JAX bf16 step is the
    JAX package's own bf16-vs-f32 distance, measured live.

    - Bounds: loss items within 1e-2 relative, BN running means within
      2e-2 and variances within 1e-2 of their tensor's largest value.
    - Parameter changes where the float32 gradient fixes AdamW's first
      update (|g| > 0.1 max|g| of its tensor): the share whose sign
      agrees with the JAX bf16 step's at least the float32 step's share
      less 0.1 (bf16 rounding moves it by a hundredth or more with the
      torch thread count: v12n 0.780 on one thread, 0.792 on two).
    - Rounding, not divergence: the port's bf16 step no further from the
      JAX bf16 step than twice the float32 step is (largest loss item, BN
      statistics).
    - bfloat16, not float32: the port's bf16 step lies at least 1e-4
      from its own float32 step in its largest loss item (a port that
      ran this step in float32 would sit ~1e-6 from it, so the floor is
      ~100x that), and its BN running means at least a quarter of the JAX
      bf16-vs-f32 distance from it. The loss-item floor used to be a
      quarter of the JAX distance too, but that compared the maxima of
      different loss items, and the CPU's bf16 kernels moved it from one
      machine to the next (v12n: 1.18e-3 against 0.25 x 6.64e-3 on one
      machine, where another had passed).

    The two packages round at different points (FastBN applies x * k + b
    in bf16 with two roundings, the port normalises through F.batch_norm
    with one), so their bf16 steps are about as far from each other as
    each is from float32 (test_bf16_gap_is_the_bn_rounding_point shows it
    for v8n). Measured (the test prints them; one torch thread), port bf16
    vs JAX bf16 (port f32 vs JAX bf16; port bf16 vs port f32): v8n loss
    items 2.3e-3 / 4.1e-3 / 1.0e-3 (1.0e-3 / 4.9e-3 / 4.0e-3; up to
    5.0e-3), agreement 0.970 (0.977), BN means 6.4e-3 (6.8e-3; 5.1e-3),
    variances 7.4e-4 (7.5e-4); v12n loss items 3.7e-3 / 1.1e-3 / 3.2e-3
    (3.4e-5 / 2.3e-3 / 6.6e-3; up to 3.7e-3), agreement 0.780 (0.830),
    BN means 1.16e-2 (9.4e-3; 7.1e-3), variances 5.0e-3 (4.4e-3). On a
    second machine v12n read port bf16 vs port f32 3.81e-4 / 1.18e-3 /
    6.28e-4 and port f32 vs JAX bf16 3.39e-5 / 2.33e-3 / 6.64e-3; v8n's
    largest port bf16 vs port f32 item is ~4e-3 there."""
    s, f = bf16_steps(version)
    assert s["state"].count == s["state"].step == 1
    assert np.isfinite(s["items"]).all()
    init = state_dict_from_jax(s["variables"])
    resolved = {}
    for n, p in f["state"].net.named_parameters():
        if p.requires_grad:
            g = p.grad.abs()
            resolved[n] = g > 0.1 * g.max()
    port = {"sd": s["state"].net.state_dict(), "items": s["items"]}
    jax_bf16 = {"sd": state_dict_from_jax(s["jnew"].variables),
                "items": s["jitems"]}
    f32 = {"sd": f["state"].net.state_dict(), "items": f["items"]}
    got = _step_distance(port, jax_bf16, init, resolved)
    ref = _step_distance(f32, jax_bf16, init, resolved)
    own = _step_distance(port, f32, init, resolved)
    print(f"{version}n bf16, port bf16 vs JAX bf16 (port f32 vs JAX bf16; "
          "port bf16 vs port f32): " + "; ".join(
              f"{k} {got[k]} ({ref[k]}; {own[k]})" for k in got))
    assert got["items"].max() < 1e-2
    assert got["running_mean"] < 2e-2 and got["running_var"] < 1e-2
    assert got["agreement"] >= ref["agreement"] - 0.1
    assert got["items"].max() <= 2 * ref["items"].max()
    for kind in ("running_mean", "running_var"):
        assert got[kind] <= 2 * ref[kind], kind
    assert own["items"].max() >= 1e-4
    assert own["running_mean"] >= 0.25 * ref["running_mean"]


def test_bf16_gap_is_the_bn_rounding_point(bf16_steps, monkeypatch):
    """The v8n bf16 loss gap between the packages is BN's rounding point:
    with the port's train-mode BN replaced by FastBN's arithmetic
    (_fastbn_train), the port's bf16 step from the same weights and batch
    gives loss items each nearer to the JAX bf16 step's than the float32
    step's are, and all within 1e-3 relative. Measured: 2.6e-4 / 4.5e-4 /
    1.0e-4 (the float32 step's: 1.0e-3 / 4.9e-3 / 4.0e-3). v12n's gap does
    not close so, and the sign agreement of the updates does not move (the
    two backward passes round apart).

    Where v12n's step leaves JAX's, found by walking one bf16 train-mode
    forward module by module with FastBN's rounding patched in and every
    module's output replaced by JAX's, so that each is fed JAX's input
    (the JAX intermediates of ``capture_intermediates``, 128 px, batch 4):
    - every SiLU, from layer 0 on and in v8n too: XLA on the CPU rounds
      bf16 ``x * (1 / (1 + exp(-x)))`` to bf16 after each op, the port's
      F.silu once (40% of layer 0's outputs a bf16 ulp apart; the op by op
      form matches 98.5% of all bf16 inputs, XLA's exp the rest). The
      convs and FastBN's arithmetic match to the bit;
    - the first v12-only point, layer 6 (the first A2C2f), in its first
      ABlock's AAttn: the attention core (attention_bihd, a deliberate
      deviation: P rounded to bf16 before P.V; 30% of its outputs a bf16
      ulp from JAX's on the same q, k, v) and the BatchNorm of the pe
      ConvBN, the one biased conv (9% on the same conv output). The A2C2f
      gamma and the biased conv itself round as JAX's.
    Neither point is the port's own choice against JAX's (the kernels
    compute SiLU in float32 once, as a fused TPU step does), so the
    assertions stay as they are."""
    from yolosharp_tpu_torch.nn import common as port_common

    s, f = bf16_steps("v8")
    monkeypatch.setattr(port_common, "batch_norm_train", _fastbn_train)
    fast = port_step(s["variables"], "v8", _batch(5, b=4, size=128),
                     torch.bfloat16)
    got = np.abs(fast["items"] - s["jitems"]) / np.abs(s["jitems"])
    ref = np.abs(f["items"] - s["jitems"]) / np.abs(s["jitems"])
    print(f"v8n bf16 with FastBN's rounding vs JAX bf16: {got} (port f32: "
          f"{ref})")
    np.testing.assert_array_less(got, ref)
    assert got.max() < 1e-3
