"""The library's conv blocks no zoo model builds (the reference's Convs.cs
in yolosharp_tpu_torch/nn/common.py: Conv2, LightConv, DWConvTranspose2d,
Index, ConvTranspose, Focus, GhostConv, RepConv, Channel / SpatialAttention,
CBAM, and AGLU; the Block.cs ones are in tests/test_torch_blocks_csp.py)
against the JAX modules on the same weights, carried across
by state_dict_from_jax + load_state_dict(strict=True): the train-mode
forward (batch statistics), its updated running statistics and the
gradients of the input and of every parameter; the eval-BN forward; and the
folded forward (the port's fold_bn against the JAX fold_bn under
fused_inference(); the kernel routes run their plain versions here). Small
sizes (widths 8-32, 16x16 to 32x32, batch 2), float32, ATOL = RTOL = 1e-4
as tests/test_torch_model.py. The JAX modules run eagerly: nothing is
jitted per case."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.ckpt.fuse import fold_bn as jax_fold_bn
from yolosharp_tpu.nn import common as jc
from yolosharp_tpu.nn.common import fused_inference
from yolosharp_tpu_torch.ckpt import fold_bn, state_dict_from_jax
from yolosharp_tpu_torch.nn import (AGLU, CBAM, ChannelAttention, Conv2,
                                    ConvTranspose, DWConvTranspose2d, Focus,
                                    GhostConv, Index, LightConv, RepConv,
                                    SpatialAttention)

ATOL = RTOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def block_state_dict(variables, transposed_groups=None):
    """A JAX block's variables (or gradients) as the state dict of its
    torch twin: the tree under a layer "0", through state_dict_from_jax."""
    wrapped = {c: {"0": variables[c]} for c in ("params", "batch_stats")
               if c in variables}
    sd = state_dict_from_jax(wrapped, transposed_groups and {
        "0" + ("." + k if k else ""): g for k, g in transposed_groups.items()})
    return {k[len("model.0."):]: v for k, v in sd.items()
            if ".dfl." not in k}


# name: (JAX module, torch module, input (H, W, C)[, {JAX path under the
# block: groups} of grouped transposed kernels]). One input shape where the
# block allows it, so that the eager JAX ops compile once for the module.
X = (16, 16, 16)
BLOCKS = {
    "conv2": (lambda: jc.Conv2(16), lambda: Conv2(16, 16), X),
    "conv2_s2": (lambda: jc.Conv2(16, 3, 2), lambda: Conv2(16, 16, 3, 2), X),
    "lightconv": (lambda: jc.LightConv(16, 3), lambda: LightConv(16, 16, 3),
                  X),
    "dwconvtranspose2d": (lambda: jc.DWConvTranspose2d(16, 4, 2, 1),
                          lambda: DWConvTranspose2d(16, 16, 4, 2, 1), X),
    "dwconvtranspose2d_g4": (lambda: jc.DWConvTranspose2d(12, 3, 2, 1),
                             lambda: DWConvTranspose2d(16, 12, 3, 2, 1), X,
                             {"": 4}),
    "convtranspose": (lambda: jc.ConvTranspose(16),
                      lambda: ConvTranspose(16, 16), X),
    "convtranspose_no_bn": (lambda: jc.ConvTranspose(16, 3, 1, 1, False),
                            lambda: ConvTranspose(16, 16, 3, 1, 1, False),
                            X),
    "focus": (lambda: jc.Focus(16, 3), lambda: Focus(3, 16, 3),
              (32, 32, 3)),
    "ghostconv": (lambda: jc.GhostConv(16, 3, 2),
                  lambda: GhostConv(16, 16, 3, 2), X),
    "repconv_bn": (lambda: jc.RepConv(16, use_bn=True),
                   lambda: RepConv(16, 16, bn=True), X),
    "channel_attention": (lambda: jc.ChannelAttention(),
                          lambda: ChannelAttention(16), X),
    "spatial_attention": (lambda: jc.SpatialAttention(7),
                          lambda: SpatialAttention(7), X),
    "cbam": (lambda: jc.CBAM(7), lambda: CBAM(16, 7), X),
    "aglu": (lambda: jc.AGLU(), lambda: AGLU(), X),
}


def _call(jmod, variables, x, train):
    """The JAX module's forward (AGLU takes no train flag)."""
    if isinstance(jmod, jc.AGLU):
        return jmod.apply(variables, x), {}
    if train:
        return jmod.apply(variables, x, True, mutable=["batch_stats"])
    return jmod.apply(variables, x, False), {}


def init_variables(jmod, x, seed, train_flag=True):
    """The block's variables drawn with numpy, their shapes from
    jax.eval_shape of its init (which compiles nothing): conv kernels and
    linear weights U(+-1/sqrt(fan_in)) as torch's defaults, conv and linear
    biases likewise, AGLU's lambd and kappa U(0, 1), BatchNorm at identity
    statistics, then jittered (test_torch_model.jitter_bn)."""
    extra = (False,) if train_flag else ()
    shapes = jax.eval_shape(lambda key, xx: jmod.init(key, xx, *extra),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        name, shape = names[-1], leaf.shape
        if names[0] == "batch_stats":
            return np.full(shape, name == "var", np.float32)
        if len(names) > 2 and names[-2] == "bn":
            return np.full(shape, name == "scale", np.float32)
        if name in ("lambd", "kappa"):
            return rng.uniform(0, 1, shape).astype(np.float32)
        fan_in = (int(np.prod(shape[:-1])) if len(shape) > 1
                  else shape[0])
        bound = 1 / np.sqrt(max(fan_in, 1))
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    if "batch_stats" in variables:
        variables = jitter_bn(variables, seed=seed)
    return variables


def make_pair(blocks, name):
    """(name, JAX module, its jittered variables, torch module loaded with
    them, input x, transposed groups) of one entry of a BLOCKS table."""
    jmod, tmod, (h, w, c), *groups = blocks[name]
    groups = groups[0] if groups else None
    jmod, tmod = jmod(), tmod()
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-1, 1, (2, h, w, c)).astype(np.float32)
    variables = init_variables(jmod, x, len(name),
                               not isinstance(jmod, jc.AGLU))
    tmod.load_state_dict(block_state_dict(variables, groups), strict=True)
    return name, jmod, variables, tmod, x, groups


@pytest.fixture(scope="module", params=list(BLOCKS))
def pair(request):
    return make_pair(BLOCKS, request.param)


def check_train(pair):
    """Train-mode forward, updated running statistics, and the gradients
    of the input and of every parameter of sum(out * r), r ~ N(0, 1) /
    sqrt(out.size)."""
    name, jmod, variables, tmod, x, groups = pair
    params = variables["params"]
    stats = {k: v for k, v in variables.items() if k != "params"}

    want, vjp_fn, upd = jax.vjp(
        lambda p, xx: _call(jmod, {"params": p, **stats}, xx, True),
        params, jnp.asarray(x), has_aux=True)
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
    want_g = block_state_dict({"params": gp}, groups)
    got_g = {k: p.grad for k, p in m.named_parameters()}
    assert set(got_g) == set(want_g), name
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), g.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    if "batch_stats" in upd:
        want_s = block_state_dict({"params": params,
                                   "batch_stats": upd["batch_stats"]})
        got_s = m.state_dict()
        for k, v in want_s.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got_s[k].numpy(), v.numpy(),
                                           atol=1e-6, rtol=1e-5, err_msg=k)


def check_eval_and_folded(pair):
    """The eval-BN forward against JAX's, and the port's folded forward
    against the JAX fold_bn under fused_inference() (no block has a biased
    ConvBN, so the JAX fold is exact)."""
    name, jmod, variables, tmod, x, _ = pair
    want = np.asarray(_call(jmod, variables, jnp.asarray(x), False)[0])
    m = copy.deepcopy(tmod).eval()
    with torch.no_grad():
        got = m(_nchw(x))
        got_fold = fold_bn(m)(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=RTOL)
    if "batch_stats" in variables:
        # under a layer "0", as in a network: the JAX fold_bn finds a BN by
        # its ".bn.scale" suffix, which the block's own "bn" lacks
        folded = jax_fold_bn({c: {"0": v} for c, v in variables.items()})
        with fused_inference():
            want = np.asarray(jmod.apply({c: v["0"] for c, v in
                                          folded.items()},
                                         jnp.asarray(x), False))
    np.testing.assert_allclose(_nhwc(got_fold), want, atol=ATOL, rtol=RTOL)


def test_train_forward_and_gradients_match_jax(pair):
    check_train(pair)


def test_eval_and_folded_forwards_match_jax(pair):
    check_eval_and_folded(pair)


@pytest.mark.parametrize("lambd,kappa", [(-0.5, 0.7), (1e-3, 1.9),
                                         (0.5, 0.5), (2.0, 0.01)],
                         ids=["lambda_clipped", "small_lambda", "mid",
                              "flat"])
def test_aglu_matches_jax_at_large_inputs(lambd, kappa):
    """AGLU on x in [-100, 100], lambda from below the 1e-4 clip to 2: the
    output's zeros (a subnormal counts as one: XLA's CPU code flushes
    them, torch's exp does not) and the infinities and NaNs of the output
    and of its gradient wrt x fall where JAX's -log1p(exp(-z)) form puts
    them, and the finite values agree at ATOL = RTOL = 1e-4 (torch's
    Softplus(beta=-1) would switch branch past its threshold instead)."""
    x = np.linspace(-100, 100, 4001, dtype=np.float32)
    variables = {"params": {"lambd": np.float32([lambd]),
                            "kappa": np.float32([kappa])}}
    jmod = jc.AGLU()
    want, vjp_fn = jax.vjp(lambda xx: jmod.apply(variables, xx),
                           jnp.asarray(x))
    (want_g,) = vjp_fn(jnp.ones_like(want))
    m = AGLU()
    m.load_state_dict(block_state_dict(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = m(xt)
    got.sum().backward()
    out, want = got.detach().numpy(), np.asarray(want)
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_equal(np.abs(out) < tiny, np.abs(want) < tiny)
    for g, w in ((out, want), (xt.grad.numpy(), np.asarray(want_g))):
        for kind in (np.isnan, np.isinf):
            np.testing.assert_array_equal(kind(g), kind(w))
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], atol=ATOL, rtol=RTOL)


def test_grouped_transposed_kernel_needs_its_groups():
    """A DWConvTranspose2d kernel sits under a name the exporter cannot
    tell from a forward conv's: without its groups it comes out as a
    forward conv's (c2, c1 / g, k, k), which is not torch's (c1, c2 / g, k,
    k) where c1 != c2; with them, torch's layout (the dwconvtranspose2d_g4
    case holds its values against JAX)."""
    x = np.zeros((1, 16, 16, 16), np.float32)
    variables = init_variables(jc.DWConvTranspose2d(12, 3, 2, 1), x, 0)
    torch_shape = tuple(DWConvTranspose2d(16, 12, 3, 2, 1).weight.shape)
    assert torch_shape == (16, 3, 3, 3)
    assert tuple(block_state_dict(variables)["weight"].shape) == (12, 4, 3, 3)
    assert tuple(block_state_dict(variables, {"": 4})["weight"].shape) == \
        torch_shape


def test_index_matches_jax():
    xs = [np.full((1, 2, 2, 3), v, np.float32) for v in range(3)]
    want = np.asarray(jc.Index(2).apply({}, [jnp.asarray(a) for a in xs]))
    got = Index(2)([_nchw(a) for a in xs])
    np.testing.assert_array_equal(_nhwc(got), want)

