"""The port's classify networks against the JAX package on the same weights,
on the CPU: the Classify head (eval-BN, folded, bfloat16), the v8n, v5un,
v11n and v12n classify nets (the detect trunk cut at _CLS_KEEP, v12 on the
v11 trunk; float32 eval-BN and folded against the JAX eval forward, and
bfloat16 against the JAX bfloat16 forward), the v8s-cls state dict at
ImageNet's 1000 classes, the predict copy's float32 Linear, and .bin
weights written by one package and loaded by the other, with the
nc-mismatch skip of the linear layer."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from test_torch_v12 import ATOL, RTOL, _nchw, module_state_dict
from yolosharp_tpu.ckpt.mapping import flatten, unflatten
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.nn import ArchCfg as JaxArch
from yolosharp_tpu.nn import YoloNet as JaxNet
from yolosharp_tpu.nn import heads as jh
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import ScalarType as JaxScalar
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu.types import YoloType as JaxType
from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask, YoloType)
from yolosharp_tpu_torch.ckpt import fold_bn, state_dict_from_jax
from yolosharp_tpu_torch.nn import ArchCfg, Classify, YoloNet
from yolosharp_tpu_torch.tasks import Classifier

NC = 10
IMG = 64
# bfloat16: the JAX package's own criterion (tests/test_pallas_conv.py),
# max|port - jax| / max|jax| of the two bfloat16 forwards; measured
# 2.7e-3 - 8.3e-3 on these nets, each about the distance of the JAX
# bfloat16 logits from its float32 ones (the two round at other points)
BF16_REL = 1e-2
# the trunk layers each version keeps (the JAX _CLS_KEEP), and its head index
HEAD = {"v8": 9, "v5u": 11, "v11": 11, "v12": 11}


def scaled(variables, factor=2.5):
    """Every conv kernel x factor: activations that do not collapse through
    identity BN statistics, so the logits depend on the image."""
    params = {k: (np.asarray(v) * factor if k.endswith(".kernel") and
                  np.ndim(v) == 4 else np.asarray(v))
              for k, v in flatten(variables["params"]).items()}
    return {**variables, "params": unflatten(params, variables["params"])}


def jax_cls_variables(version, size="n", nc=NC, seed=1):
    """(the JAX classify YoloNet, its scaled and BN-jittered variables)."""
    jnet = JaxNet(JaxArch(version=version, size=size, task="classify",
                          nc=nc))
    x = jnp.zeros((1, IMG, IMG, 3))
    variables = jitter_bn(scaled(jnet.init(jax.random.PRNGKey(seed), x,
                                           False)), seed=seed + 1)
    return jnet, variables


def port_cls_net(version, variables, size="n", nc=NC):
    net = YoloNet(ArchCfg(version=version, size=size, task="classify",
                          nc=nc)).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net


def _bf16_close(got, want):
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= BF16_REL, rel


def test_classify_head_matches_jax():
    """Classify(64 -> 1280 -> 10) on a 5x7 map: float32 eval-BN and folded
    to ATOL / RTOL of tests/test_torch_v12.py, bfloat16 to BF16_REL; the
    logits are float32 in both types, as the JAX head's (a bfloat16 mean
    times the float32 kernel)."""
    jmod = jh.Classify(NC)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 5, 7, 64)).astype(
        np.float32)
    variables = jitter_bn(scaled(jmod.init(jax.random.PRNGKey(1),
                                           jnp.asarray(x), False)), seed=1)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False)["cls"])
    want16 = jmod.apply(variables, jnp.asarray(x).astype(jnp.bfloat16),
                        False)["cls"]
    tmod = Classify(64, NC)
    tmod.load_state_dict(module_state_dict(variables), strict=True)
    assert tuple(tmod.linear.weight.shape) == (NC, 1280)
    tmod.eval()
    with torch.no_grad():
        got = tmod(_nchw(x))["cls"]
        got_fold = fold_bn(copy.deepcopy(tmod))(_nchw(x))["cls"]
        got16 = tmod(_nchw(x).to(torch.bfloat16))["cls"]
    assert got.dtype == got16.dtype == torch.float32
    assert want16.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_fold.numpy(), want, atol=ATOL, rtol=RTOL)
    _bf16_close(got16.numpy(), np.asarray(want16))


@pytest.fixture(scope="module", params=["v8", "v5u", "v11", "v12"])
def cls_model(request):
    version = request.param
    jnet, variables = jax_cls_variables(version)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    # the second image blocky: the two means over H and W differ
    x[1] = np.kron(rng.uniform(0, 1, (8, 8, 3)), np.ones((8, 8, 1)))
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), False)["cls"])
    want16 = np.asarray(jnet.apply(
        variables, jnp.asarray(x).astype(jnp.bfloat16), False)["cls"])
    return dict(version=version, net=port_cls_net(version, variables),
                x=_nchw(x), want=want, want16=want16)


@pytest.mark.parametrize("mode", ["eval_bn", "folded", "bf16"])
def test_classify_nets_match_jax(cls_model, mode):
    """(2, 10) logits of the n-size net at 64 px: float32 eval-BN and folded
    to ATOL / RTOL, bfloat16 (channels-last input, the predict layout) to
    BF16_REL of the JAX bfloat16 forward. The head sits at HEAD[version];
    the two images' logits differ by more than 5e-3 of the largest (the
    kernels are scaled, one image is noise and one blocks: the global mean
    of v11's 1280 channels varies least, 8.6e-3)."""
    net, x, want = cls_model["net"], cls_model["x"], cls_model["want"]
    assert len(net.model) == HEAD[cls_model["version"]] + 1
    assert isinstance(net.model[-1], Classify)
    assert np.abs(want[0] - want[1]).max() > 5e-3 * np.abs(want).max()
    if mode == "folded":
        net = fold_bn(copy.deepcopy(net))
    if mode == "bf16":
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = net(x)
    assert set(got) == {"cls"} and got["cls"].dtype == torch.float32
    if mode == "bf16":
        _bf16_close(got["cls"].numpy(), cls_model["want16"])
    else:
        np.testing.assert_allclose(got["cls"].numpy(), want, atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("version", ["v8", "v11"])
def test_v8s_cls_state_dict_matches_the_jax_tree(version):
    """v8s-cls and v11s-cls at ImageNet's nc = 1000 (the chip's models):
    the JAX tree's names and shapes, exported from its shapes alone, load
    strictly into the port's net; the linear weight is (1000, 1280)."""
    jnet = JaxNet(JaxArch(version=version, size="s", task="classify",
                          nc=1000))
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), False))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    net = YoloNet(ArchCfg(version=version, size="s", task="classify",
                          nc=1000))
    sd = state_dict_from_jax(variables)
    net.load_state_dict(sd, strict=True)
    head = HEAD[version]
    assert tuple(sd[f"model.{head}.linear.weight"].shape) == (1000, 1280)
    # the trunk ends in 512 channels at size s (v8 C2f, v11 C2PSA)
    assert tuple(sd[f"model.{head}.conv.conv.weight"].shape) == (1280, 512,
                                                                 1, 1)


def _tasks(version, nc=NC):
    """(the port's classify task, the JAX one) of `version`, float32."""
    kw = dict(task_type=TaskType.classify, yolo_type=YoloType(version),
              yolo_size=YoloSize.n, number_class=nc, image_size=IMG)
    port = YoloTask(Config(scalar_type=ScalarType.float32, **kw),
                    device="cpu")
    jkw = dict(task_type=JaxTaskType.classify, yolo_type=JaxType(version),
               yolo_size=JaxSize.n, number_class=nc, image_size=IMG)
    jax_task = JaxYoloTask(JaxConfig(scalar_type=JaxScalar.float32, **jkw))
    return port, jax_task


@pytest.mark.parametrize("version", ["v8", "v12"])
def test_bin_round_trip_between_packages(version, tmp_path):
    """A .bin written by the JAX package loads into the port (every tensor
    loaded, none missing), and the port's .bin back into a fresh JAX task:
    the logits of all three equal to ATOL / RTOL."""
    port, jax_task = _tasks(version)
    _, variables = jax_cls_variables(version, seed=4)
    jax_task.task.variables = variables
    jax_bin, port_bin = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jax_task.save_weight(jax_bin)
    report = port.load_model(jax_bin)
    assert not report.missing and not report.unexpected and \
        not report.skipped
    port.save_weight(port_bin)
    _, back = _tasks(version)
    back.load_model(port_bin)
    x = np.random.default_rng(7).uniform(0, 1, (2, IMG, IMG, 3)).astype(
        np.float32)
    jnet = jax_task.task.net
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), False)["cls"])
    again = np.asarray(jnet.apply(back.task.variables, jnp.asarray(x),
                                  False)["cls"])
    with torch.no_grad():
        got = port.task.net(_nchw(x))["cls"].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(again, want, atol=ATOL, rtol=RTOL)


def test_nc_mismatch_skips_the_linear(tmp_path):
    """A 7-class .bin into a 10-class task: with skip_nc_not_equal_layers
    the linear layer is skipped (weight and bias; the head's prior is the
    JAX package's: none for classify) and every other tensor loads; without
    it the two mismatched tensors are reported unexpected. The JAX task
    skips the same keys."""
    port7, jax7 = _tasks("v8", nc=7)
    _, variables = jax_cls_variables("v8", nc=7, seed=2)
    jax7.task.variables = variables
    path = str(tmp_path / "nc7.bin")
    jax7.save_weight(path)
    port, jax_task = _tasks("v8")
    before = port.task._ensure_variables().model[-1].linear.weight.clone()
    report = port.load_model(path, skip_nc_not_equal_layers=True)
    assert sorted(report.skipped) == ["model.9.linear.bias",
                                      "model.9.linear.weight"]
    assert report.missing == ["model.9.linear.weight", "model.9.linear.bias"]
    assert not report.unexpected
    torch.testing.assert_close(port.task.net.model[-1].linear.weight, before)
    jreport = jax_task.load_model(path, skip_nc_not_equal_layers=True)
    assert sorted(jreport.skipped) == sorted(report.skipped)
    fresh, _ = _tasks("v8")
    plain = fresh.load_model(path)
    assert sorted(plain.unexpected) == sorted(report.skipped)


def test_predict_copy_keeps_a_float32_linear():
    """The bfloat16 predict copy: BN folded, the trunk and the head's conv
    in bfloat16, the Linear in float32 (the JAX head's float32 kernel); the
    master network stays float32."""
    task = YoloTask(Config(task_type=TaskType.classify, yolo_size=YoloSize.n,
                           number_class=NC, image_size=IMG), device="cpu")
    assert isinstance(task.task, Classifier) and not task.task.arch.end2end
    pred = task.task._predict_variables()
    head = pred.model[-1]
    assert head.conv.b_fold is not None
    assert head.conv.w_fold.dtype == torch.bfloat16
    assert head.linear.weight.dtype == head.linear.bias.dtype == \
        torch.float32
    assert task.task.net.model[0].conv.weight.dtype == torch.float32
