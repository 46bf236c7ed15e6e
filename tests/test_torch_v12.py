"""The port's v12 detection slice against the JAX package on the same
weights: the new modules one by one (DWConv, C3k, C3k2, AAttn, ABlock,
A2C2f), the fold of a biased ConvBN, the v12n model (layers 6 and 8 and the
head maps), and YoloTask predict (NMS and End2End).

The reference is always the JAX eval-BN (unfolded) forward: the JAX
package's fold_bn leaves a conv bias unscaled, so its folded v12 (the 7x7
``pe`` conv has a bias) is not what the eval-BN network computes. The
port's folded forward is held to the eval-BN one."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_predict import (IOU, _rows, assert_match,
                                assert_results_match, canvas,
                                synthetic_image)
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from util_calib import calibrate_task
from yolosharp_tpu.ckpt.fuse import bias_init as jax_bias_init
from yolosharp_tpu.ckpt.mapping import clone_one2one as jax_clone_one2one
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.nn import ArchCfg as JaxArch
from yolosharp_tpu.nn import YoloNet as JaxNet
from yolosharp_tpu.nn import attention as ja
from yolosharp_tpu.nn import common as jc
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType, YoloSize, YoloType
from yolosharp_tpu_torch import Config, ScalarType, YoloTask
from yolosharp_tpu_torch import TaskType as PortTaskType
from yolosharp_tpu_torch import YoloSize as PortYoloSize
from yolosharp_tpu_torch import YoloType as PortYoloType
from yolosharp_tpu_torch.ckpt import (bias_init, clone_one2one, fold_bn,
                                      state_dict_from_jax)
from yolosharp_tpu_torch.loss import flatten_levels
from yolosharp_tpu_torch.nn import (A2C2f, AAttn, ABlock, ArchCfg, C3k, C3k2,
                                    Classify, ConvBN, DWConv, YoloNet,
                                    build_arch)
from yolosharp_tpu_torch.tasks import _to_host

NC = 17
ATOL = RTOL = 1e-4


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def module_state_dict(variables):
    """A JAX module's variables as the state dict of its torch twin."""
    wrapped = {c: {"0": variables[c]} for c in ("params", "batch_stats")}
    return {k[len("model.0."):]: v
            for k, v in state_dict_from_jax(wrapped).items()
            if ".dfl." not in k}


# (JAX module, torch module, input (H, W, C)); hd = 32 attention heads, and
# areas of 35 and 99 positions, which no tile of the CUDA kernel divides
MODULES = {
    "dwconv": (lambda: jc.DWConv(16, 3), lambda: DWConv(16, 16, 3),
               (9, 11, 16)),
    "dwconv_g4": (lambda: jc.DWConv(12, 3, 2), lambda: DWConv(8, 12, 3, 2),
                  (9, 11, 8)),
    "c3k": (lambda: jc.C3k(24, 2), lambda: C3k(16, 24, 2), (9, 11, 16)),
    "c3k2": (lambda: jc.C3k2(32, 1, False, 0.25),
             lambda: C3k2(16, 32, 1, False, 0.25), (9, 11, 16)),
    "c3k2_c3k": (lambda: jc.C3k2(32, 1, True), lambda: C3k2(16, 32, 1, True),
                 (9, 11, 16)),
    "aattn_area1": (lambda: ja.AAttn(64, 2, 1), lambda: AAttn(64, 2, 1),
                    (9, 11, 64)),
    "aattn_area4": (lambda: ja.AAttn(64, 2, 4), lambda: AAttn(64, 2, 4),
                    (10, 14, 64)),
    "ablock": (lambda: ja.ABlock(64, 2, 2.0, 4), lambda: ABlock(64, 2, 2.0, 4),
               (10, 14, 64)),
    "a2c2f_residual": (
        lambda: ja.A2C2f(64, 1, True, 4, residual=True, mlp_ratio=1.2),
        lambda: A2C2f(64, 64, 1, True, 4, residual=True, mlp_ratio=1.2),
        (10, 14, 64)),
    "a2c2f_c3k": (lambda: ja.A2C2f(64, 1, False, -1),
                  lambda: A2C2f(48, 64, 1, False, -1), (9, 11, 48)),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name):
    """Eval-BN and folded forwards of the port against the JAX eval-BN
    forward, with BN statistics and affine jittered."""
    jmod, tmod, (h, w, c) = MODULES[name]
    jmod, tmod = jmod(), tmod()
    x = np.random.default_rng(len(name)).uniform(
        -1, 1, (2, h, w, c)).astype(np.float32)
    variables = jitter_bn(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                    False), seed=len(name))
    if name == "a2c2f_residual":     # gamma away from its init
        variables["params"]["gamma"] = np.linspace(
            -0.5, 0.5, 64).astype(np.float32)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    tmod.load_state_dict(module_state_dict(variables), strict=True)
    tmod.eval()
    with torch.no_grad():
        got = tmod(_nchw(x))
        got_fold = fold_bn(copy.deepcopy(tmod))(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_nhwc(got_fold), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("version,task", [("v11", "classify"),
                                          ("v5u", "classify"),
                                          ("v12", "classify")])
def test_build_arch_raises_for_what_is_not_ported(version, task):
    """These cases raised until the classify task was ported; now they
    build the Classify head (a constructor of its input channels), and
    build_arch raises for a version or a task that the port does not
    have."""
    *_, head = build_arch(ArchCfg(version=version, size="n", task=task))
    assert isinstance(head(64), Classify)
    for cfg in (ArchCfg(version="v10", size="n", task=task),
                ArchCfg(version=version, size="n", task="depth")):
        with pytest.raises(NotImplementedError,
                           match="v5u, v8, v11 and v12 detect"):
            build_arch(cfg)


def test_aattn_rejects_an_area_that_does_not_divide():
    with pytest.raises(ValueError, match="areas"):
        AAttn(64, 2, 4)(torch.zeros(1, 64, 3, 3))


def test_fold_of_a_biased_depthwise_convbn_is_the_eval_bn_forward():
    """The AAttn pe conv: 7x7 depthwise with a conv bias. Folding scales
    the conv bias with the BN (the JAX fold does not)."""
    torch.manual_seed(0)
    m = ConvBN(32, 32, 7, 1, 3, g=32, use_bias=True).eval()
    with torch.no_grad():
        m.conv.bias.fill_(1.0)
        m.bn.running_mean.uniform_(0.0, 1.0)
        m.bn.running_var.uniform_(2.0, 4.0)
        m.bn.weight.uniform_(0.5, 1.5)
        m.bn.bias.uniform_(-0.5, 0.5)
        x = torch.randn(2, 32, 12, 10)
        want = m(x)
        got = fold_bn(copy.deepcopy(m))(x)
    assert m.b_fold is None and got is not None
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- the model
IMG = (128, 128)


@pytest.fixture(scope="module", params=[False, True], ids=["nms", "e2e"])
def v12n(request):
    end2end = request.param
    jnet = JaxNet(JaxArch(version="v12", size="n", task="detect", nc=NC,
                          end2end=end2end))
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, *IMG, 3)).astype(np.float32)
    variables = jitter_bn(jnet.init(jax.random.PRNGKey(8), jnp.asarray(x),
                                    False), seed=4)
    want, state = jnet.apply(variables, jnp.asarray(x), False,
                             capture_intermediates=True,
                             mutable=["intermediates"])
    inter = state["intermediates"]
    layers = {i: np.asarray(inter[str(i)]["__call__"][0]) for i in (6, 8)}
    net = YoloNet(ArchCfg(version="v12", size="n", nc=NC,
                          end2end=end2end)).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return dict(end2end=end2end, variables=variables, net=net, x=_nchw(x),
                want=want, layers=layers)


def _run_with_layers(net, x):
    got = {}
    hooks = [net.model[i].register_forward_hook(
        lambda m, inp, out, i=i: got.__setitem__(i, _nhwc(out)))
        for i in (6, 8)]
    with torch.no_grad():
        preds = net(x)
    for h in hooks:
        h.remove()
    return preds, got


@pytest.mark.parametrize("folded", [False, True], ids=["eval_bn", "folded"])
def test_v12n_layers_and_heads_match_jax(v12n, folded):
    net = fold_bn(copy.deepcopy(v12n["net"])) if folded else v12n["net"]
    assert len(net.model) == 22 and type(net.model[21]).__name__ == "Detect"
    preds, layers = _run_with_layers(net, v12n["x"])
    for i in (6, 8):
        np.testing.assert_allclose(layers[i], v12n["layers"][i], atol=ATOL,
                                   rtol=RTOL, err_msg=f"layer {i}")
    want = v12n["want"]
    assert set(preds) == set(want)
    for branch in want:
        for kind in ("box", "cls"):
            for lvl in range(3):
                np.testing.assert_allclose(
                    _nhwc(preds[branch][kind][lvl]),
                    np.asarray(want[branch][kind][lvl]), atol=ATOL,
                    rtol=RTOL)


def test_v12n_bias_init_and_clone_one2one_match_jax(v12n):
    """The priors land on the final convs (``{i}.2``) of the nested
    non-legacy class towers, and clone_one2one copies them into
    ``one2one_cv3.{i}.0.0...`` as the JAX clone does."""
    variables, net = v12n["variables"], copy.deepcopy(v12n["net"])
    bias_init(net, NC)
    want = state_dict_from_jax(jax_bias_init(variables, NC))
    heads = [k for k in want if k.startswith("model.21.")
             and k.endswith(".2.bias")]
    assert len(heads) == (12 if v12n["end2end"] else 6)
    got = net.state_dict()
    for k in heads:
        torch.testing.assert_close(got[k], want[k])
    if v12n["end2end"]:
        clone_one2one(net)
        want = state_dict_from_jax(jax_clone_one2one(
            jax_bias_init(variables, NC)))
        assert "model.21.one2one_cv3.0.0.0.conv.weight" in want
        for k, v in net.state_dict().items():
            torch.testing.assert_close(v.float(), want[k].float())


def test_v12l_state_dict_matches_the_jax_tree():
    """v12l (A2C2f with n=4 and the residual gamma, C3k2 with C3k inner
    blocks): the JAX tree, exported from its shapes alone, loads into the
    port with strict=True, and gamma keeps its 0.01 init."""
    jnet = JaxNet(JaxArch(version="v12", size="l", task="detect", nc=NC,
                          end2end=True))
    shapes = jax.eval_shape(lambda key, x: jnet.init(key, x, False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, 0.5, a.dtype), shapes)
    net = YoloNet(ArchCfg(version="v12", size="l", nc=NC, end2end=True))
    assert [k for k in net.state_dict() if k.endswith("gamma")] == [
        "model.6.gamma", "model.8.gamma"]
    for i in (6, 8):
        gamma = net.model[i].gamma.detach()
        assert torch.equal(gamma, torch.full_like(gamma, 0.01))
    net.load_state_dict(state_dict_from_jax(zeros), strict=True)


def test_v12_load_model_skips_the_head_classes_on_nc_mismatch(tmp_path):
    """save_weight of a v12n, then load_model into an nc=5 v12n with
    skip_nc_not_equal_layers: only the class towers of head 21 are
    skipped."""
    kw = dict(yolo_type=PortYoloType.v12, yolo_size=PortYoloSize.n,
              scalar_type=ScalarType.float32, end2end=False)
    path = str(tmp_path / "v12n.bin")
    YoloTask(Config(number_class=NC, **kw), device="cpu").save_weight(path)
    report = YoloTask(Config(number_class=5, **kw), device="cpu").load_model(
        path, skip_nc_not_equal_layers=True)
    assert report.skipped and all(k.startswith("model.21.cv3.")
                                  for k in report.skipped)
    assert not report.unexpected
    assert all(k.startswith("model.21.cv3.") for k in report.missing)


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module", params=[False, True], ids=["nms", "e2e"])
def tasks(request):
    end2end = request.param
    kw = dict(task_type=TaskType.detect, yolo_type=YoloType.v12,
              yolo_size=YoloSize.n, number_class=NC, end2end=end2end,
              nms_pre_topk=2048)
    jax_task = JaxYoloTask(JaxConfig(host_s2d=False, fuse_inference=False,
                                     **kw))
    det = jax_task.task
    calibrate_task(det)
    variables = jitter_bn(det.variables, seed=2)
    if end2end:
        variables = jax_clone_one2one(variables)
    det.variables = variables

    # the port's config from the port's own enums
    port_kw = dict(kw, task_type=PortTaskType(kw["task_type"].value),
                   yolo_type=PortYoloType(kw["yolo_type"].value),
                   yolo_size=PortYoloSize(kw["yolo_size"].value))
    port = YoloTask(Config(scalar_type=ScalarType.float32, **port_kw),
                    device="cpu")
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)

    img = synthetic_image()
    x = torch.from_numpy(canvas(img)).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        preds = port.task._predict_variables()(x)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 200 / flat.shape[1]))
    return dict(end2end=end2end, det=det, port=port, img=img, conf=conf)


def test_v12_predict_fn_matches_jax(tasks):
    det, port, conf = tasks["det"], tasks["port"].task, tasks["conf"]
    arr = canvas(tasks["img"])
    c = 0.0 if tasks["end2end"] else conf
    want = jax.device_get(det._predict_fn(arr.shape)(
        det._predict_variables(), jnp.asarray(arr), c, IOU))
    got = _to_host(port._predict_fn(port._predict_variables(),
                                    torch.from_numpy(arr), c, IOU))
    if not tasks["end2end"]:
        assert not got.truncated.any() and not want.truncated.any()
    assert_match(_rows(got, tasks["end2end"], conf),
                 _rows(want, tasks["end2end"], conf))


def test_v12_image_and_batch_predict_match_jax(tasks):
    det, port, conf, img = (tasks["det"], tasks["port"], tasks["conf"],
                            tasks["img"])
    want = det.image_predict(img, conf, IOU)
    assert_results_match(port.image_predict(img, conf, IOU), want)
    batch = port.batch_predict([img, synthetic_image(200, 180, seed=1)],
                               conf, IOU)
    assert len(batch) == 2
    assert_results_match(batch[0], want)
