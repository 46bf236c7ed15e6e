"""The port's v8n model (yolosharp_tpu_torch/nn, ckpt) against the JAX
YoloNet with the same weights: JAX variables cross over through
state_dict_from_jax + load_state_dict(strict=True), and the raw head maps
agree in eval-BN mode and BN-folded mode (the kernel routes, run here by
their plain versions), with end2end False and True."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolosharp_tpu.ckpt import load_bin, state_dict_to_variables
from yolosharp_tpu.ckpt.fuse import bias_init as jax_bias_init
from yolosharp_tpu.ckpt.fuse import fold_bn as jax_fold_bn
from yolosharp_tpu.ckpt.mapping import clone_one2one as jax_clone_one2one
from yolosharp_tpu.ckpt.mapping import flatten, unflatten
from yolosharp_tpu.nn import ArchCfg as JaxArch
from yolosharp_tpu.nn import YoloNet as JaxNet
from yolosharp_tpu.nn.common import fused_inference
from yolosharp_tpu_torch import Config, ScalarType, YoloSize, YoloTask
from yolosharp_tpu_torch.ckpt import (bias_init, clone_one2one, fold_bn,
                                      state_dict_from_jax)
from yolosharp_tpu_torch.nn import ArchCfg, C2f, ConvBN, YoloNet

NC = 17
IMG = (96, 128)
ATOL = RTOL = 1e-4


def jitter_bn(variables, seed=0):
    """Per-channel BN statistics and affine away from identity, so the
    eval-mode BN and the folding do real work."""
    rng = np.random.default_rng(seed)
    v = dict(variables)
    stats = flatten(v["batch_stats"])
    for k, a in stats.items():
        a = np.asarray(a)
        stats[k] = (a + rng.normal(0, 0.05, a.shape) if k.endswith("mean")
                    else a * rng.uniform(0.8, 1.5, a.shape) + 0.02
                    ).astype(np.float32)
    params = flatten(v["params"])
    for k, a in params.items():
        if k.endswith(".bn.scale") or k.endswith(".bn.bias"):
            a = np.asarray(a)
            params[k] = (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
    v["batch_stats"] = unflatten(stats, variables["batch_stats"])
    v["params"] = unflatten(params, variables["params"])
    return v


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module", params=[False, True], ids=["nms", "e2e"])
def pair(request):
    end2end = request.param
    jnet = JaxNet(JaxArch(version="v8", size="n", task="detect", nc=NC,
                          end2end=end2end))
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, *IMG, 3)).astype(np.float32)
    variables = jax_bias_init(jnet.init(jax.random.PRNGKey(7),
                                        jnp.asarray(x), False), NC)
    variables = jitter_bn(variables)
    want = jnet.apply(variables, jnp.asarray(x), False)
    with fused_inference():
        want_fold = jnet.apply(jax_fold_bn(variables), jnp.asarray(x), False)

    net = YoloNet(ArchCfg(size="n", nc=NC, end2end=end2end)).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    return dict(end2end=end2end, variables=variables, net=net, xt=xt,
                want=want, want_fold=want_fold)


def _assert_heads(got, want):
    assert set(got) == set(want)
    for branch in want:
        for kind in ("box", "cls"):
            for lvl in range(3):
                np.testing.assert_allclose(
                    _nhwc(got[branch][kind][lvl]),
                    np.asarray(want[branch][kind][lvl]), atol=ATOL, rtol=RTOL)


def test_eval_bn_heads_match_jax(pair):
    with torch.no_grad():
        got = pair["net"](pair["xt"])
    _assert_heads(got, pair["want"])


def test_folded_heads_match_jax(pair):
    net = fold_bn(copy.deepcopy(pair["net"]))
    # every 3x3 ConvBN routes to the conv kernel, layers 2 and 8 to C2f's
    routed = [n for n, m in net.named_modules()
              if isinstance(m, ConvBN) and m.kernel_route]
    assert "model.0" in routed and "model.22.cv3.2.1" in routed
    fused_c2f = [n for n, m in net.named_modules()
                 if isinstance(m, C2f) and m.fused_weights]
    assert fused_c2f == ["model.2", "model.8"]
    with torch.no_grad():
        got = net(pair["xt"])
    _assert_heads(got, pair["want_fold"])


def test_bias_init_and_clone_one2one_match_jax(pair):
    variables = pair["variables"]
    net = copy.deepcopy(pair["net"])
    bias_init(net, NC)
    want = state_dict_from_jax(jax_bias_init(variables, NC))
    got = net.state_dict()
    heads = [k for k in want if ".2.bias" in k and k.startswith("model.22.")]
    assert len(heads) == (12 if pair["end2end"] else 6)
    for k in heads:
        torch.testing.assert_close(got[k], want[k])
    if pair["end2end"]:
        clone_one2one(net)
        want = state_dict_from_jax(jax_clone_one2one(
            jax_bias_init(variables, NC)))
        for k, v in net.state_dict().items():
            torch.testing.assert_close(v.float(), want[k].float())


def test_save_weight_roundtrip(pair, tmp_path):
    """save_weight writes a .bin the JAX package loads completely, and
    load_model reads it back into the port unchanged."""
    cfg = Config(yolo_size=YoloSize.n, number_class=NC,
                 end2end=pair["end2end"], scalar_type=ScalarType.float32)
    task = YoloTask(cfg, device="cpu")
    task.task.net = copy.deepcopy(pair["net"])
    path = str(tmp_path / "w.bin")
    task.save_weight(path)

    _, report = state_dict_to_variables(load_bin(path), pair["variables"])
    assert not report.unexpected
    missing = [k for k in report.missing if "one2one" not in k]
    assert not missing, missing

    other = YoloTask(cfg, device="cpu")
    other.load_model(path)
    want = pair["net"].state_dict()
    for k, v in other.task.net.state_dict().items():
        if "one2one" not in k:
            torch.testing.assert_close(v.float(), want[k].float())
