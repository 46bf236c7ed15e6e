"""C3TR and its TransformerBlock / TransformerLayer
(yolosharp_tpu_torch/nn/attention.py) against the JAX modules on the same
weights: train-mode forward and the gradients of input and parameters,
eval-BN and folded forwards, at float32 ATOL = RTOL = 1e-4; and the layer's
``ma`` against torch.nn.MultiheadAttention, a reference independent of JAX
for the (3c, c) in-projection layout that the JAX exporter does not write."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_blocks import (ATOL, RTOL, _call, _nchw, _nhwc,
                               block_state_dict, init_variables)
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.ckpt import mapping as jax_mapping
from yolosharp_tpu.ckpt.fuse import fold_bn as jax_fold_bn
from yolosharp_tpu.nn import attention as ja
from yolosharp_tpu.nn.common import fused_inference
from yolosharp_tpu_torch.ckpt import fold_bn, variables_to_state_dict
from yolosharp_tpu_torch.nn import C3TR, TransformerBlock, TransformerLayer

C = 32      # 4 heads of 8

# name: (JAX module, torch module, input (H, W, C))
BLOCKS = {
    "transformer_block": (lambda: ja.TransformerBlock(C, 4, 2),
                          lambda: TransformerBlock(16, C, 4, 2), (6, 8, 16)),
    "c3tr": (lambda: ja.C3TR(C, 1), lambda: C3TR(16, C, 1), (6, 8, 16)),
}


@pytest.fixture(scope="module", params=list(BLOCKS))
def pair(request):
    name = request.param
    jmod, tmod, (h, w, c) = BLOCKS[name]
    jmod, tmod = jmod(), tmod()
    x = np.random.default_rng(len(name)).uniform(
        -1, 1, (2, h, w, c)).astype(np.float32)
    variables = init_variables(jmod, x, len(name))
    tmod.load_state_dict(block_state_dict(variables), strict=True)
    return jmod, variables, tmod, x


def test_train_forward_and_gradients_match_jax(pair):
    jmod, variables, tmod, x = pair
    stats = {"batch_stats": variables["batch_stats"]}
    want, vjp_fn, _ = jax.vjp(
        lambda p, xx: _call(jmod, {"params": p, **stats}, xx, True),
        variables["params"], jnp.asarray(x), has_aux=True)
    want = np.asarray(want)
    r = (np.random.default_rng(1).standard_normal(want.shape)
         / np.sqrt(want.size)).astype(np.float32)
    gp, gx = vjp_fn(jnp.asarray(r))
    m = copy.deepcopy(tmod).train()
    xt = _nchw(x).requires_grad_(True)
    out = m(xt)
    (out * _nchw(r)).sum().backward()
    np.testing.assert_allclose(_nhwc(out), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), atol=ATOL,
                               rtol=RTOL)
    want_g = block_state_dict({"params": gp})
    got_g = {k: p.grad for k, p in m.named_parameters()}
    assert set(got_g) == set(want_g)
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), g.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_eval_and_folded_forwards_match_jax(pair):
    jmod, variables, tmod, x = pair
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    m = copy.deepcopy(tmod).eval()
    with torch.no_grad():
        got = m(_nchw(x))
        got_fold = fold_bn(m)(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=RTOL)
    folded = jax_fold_bn({c: {"0": v} for c, v in variables.items()})
    with fused_inference():
        want = np.asarray(jmod.apply({c: v["0"] for c, v in folded.items()},
                                     jnp.asarray(x), False))
    np.testing.assert_allclose(_nhwc(got_fold), want, atol=ATOL, rtol=RTOL)


def test_layer_matches_jax_and_in_proj_is_torch_layout():
    """The layer alone on (B, N, C); the port's exporter writes
    ma.in_proj_weight as torch's (3c, c), the JAX exporter as the JAX
    tree's (c, 3c) (ROADMAP, standing notes: JAX faults the port does not
    copy)."""
    jmod = ja.TransformerLayer(C, 4)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 24, C)).astype(
        np.float32)
    variables = init_variables(jmod, x, 2, train_flag=False)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    wrapped = {"params": {"0": variables["params"]}}
    port = variables_to_state_dict(wrapped)["model.0.ma.in_proj_weight"]
    jax_sd = jax_mapping.variables_to_state_dict(wrapped)
    assert port.shape == (3 * C, C)
    assert jax_sd["model.0.ma.in_proj_weight"].shape == (C, 3 * C)
    np.testing.assert_array_equal(port, jax_sd["model.0.ma.in_proj_weight"].T)
    layer = TransformerLayer(C, 4)
    layer.load_state_dict(block_state_dict(variables), strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_torch_multihead_attention_state_dict_loads_and_agrees():
    """torch.nn.MultiheadAttention(c, 4)'s own state dict (in_proj_weight
    (3c, c)) loads into the port's ``ma`` with strict=True, and the port's
    attention equals torch's module on the same q, k, v (torch's takes
    (N, B, C))."""
    torch.manual_seed(0)
    mha = torch.nn.MultiheadAttention(C, 4)
    with torch.no_grad():
        mha.in_proj_bias.uniform_(-0.2, 0.2)
        mha.out_proj.bias.uniform_(-0.2, 0.2)
    layer = TransformerLayer(C, 4)
    layer.ma.load_state_dict(mha.state_dict(), strict=True)
    assert tuple(layer.ma.in_proj_weight.shape) == (3 * C, C)
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 24, C, generator=g) for _ in range(3))
    with torch.no_grad():
        got = layer.attention(q, k, v)
        want, _ = mha(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
                      need_weights=False)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 1).numpy(),
                               atol=1e-5, rtol=1e-5)
