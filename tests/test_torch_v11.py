"""The port's v11 and v5u detection slice against the JAX package on the
same weights: the new modules one by one (AttentionPSA, PSABlock, C2PSA,
and v5u's C3 and 6x6 stem), the v11n and v5un models (inner layers and the
head maps, eval-BN and folded), the v11l / v5ul state-dict names and
shapes and YoloTask predict (NMS and End2End). One float32 v11n train step
is in test_torch_v11_train.py.

C2PSA builds its attention with attn_ratio 0.5 (keys half as wide as the
values), so the JAX package and the port take the einsum path there; the
port's PSA has only that path. Neither network has a biased conv, so the
JAX fold_bn is right for both; the reference is still the JAX eval-BN
forward, as in tests/test_torch_v12.py."""

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
from test_torch_v12 import ATOL, RTOL, _nchw, _nhwc, module_state_dict
from util_calib import calibrate_task
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
from yolosharp_tpu_torch.ckpt import fold_bn, state_dict_from_jax
from yolosharp_tpu_torch.loss import flatten_levels
from yolosharp_tpu_torch.nn import (C2PSA, C3, ArchCfg, AttentionPSA, ConvBN,
                                    PSABlock, YoloNet)
from yolosharp_tpu_torch.tasks import _to_host

NC = 17

# (JAX module, torch module, input (H, W, C)); the PSA shapes are v11n's
# layer 10 (c = 128, 2 heads of 64, keys of 32), v11s's (c = 256, 4 heads)
# and a wider one
MODULES = {
    "attention_psa": (lambda: ja.AttentionPSA(128, 2, 0.5),
                      lambda: AttentionPSA(128, 2), (5, 7, 128)),
    "attention_psa_4_heads": (lambda: ja.AttentionPSA(256, 4, 0.5),
                              lambda: AttentionPSA(256, 4), (4, 5, 256)),
    "psablock": (lambda: ja.PSABlock(128, 0.5, 2),
                 lambda: PSABlock(128, 2), (5, 7, 128)),
    "c2psa": (lambda: ja.C2PSA(256, 1), lambda: C2PSA(256, 256, 1),
              (4, 6, 256)),
    "c2psa_n2": (lambda: ja.C2PSA(384, 2), lambda: C2PSA(384, 384, 2),
                 (3, 5, 384)),
    "c3": (lambda: jc.C3(32, 2), lambda: C3(16, 32, 2), (9, 11, 16)),
    "c3_no_shortcut": (lambda: jc.C3(24, 1, False),
                       lambda: C3(32, 24, 1, False), (9, 11, 32)),
    "stem_6x6": (lambda: jc.ConvBN(16, 6, 2, 2),
                 lambda: ConvBN(3, 16, 6, 2, 2), (21, 26, 3)),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(name):
    """Eval-BN and folded forwards of the port against the JAX eval-BN
    forward, with BN statistics and affine jittered: ATOL = RTOL = 1e-4."""
    jmod, tmod, (h, w, c) = MODULES[name]
    jmod, tmod = jmod(), tmod()
    x = np.random.default_rng(len(name)).uniform(
        -1, 1, (2, h, w, c)).astype(np.float32)
    variables = jitter_bn(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                    False), seed=len(name))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    tmod.load_state_dict(module_state_dict(variables), strict=True)
    tmod.eval()
    with torch.no_grad():
        got = tmod(_nchw(x))
        got_fold = fold_bn(copy.deepcopy(tmod))(_nchw(x))
    assert got.shape == got_fold.shape == _nchw(want).shape
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_nhwc(got_fold), want, atol=ATOL, rtol=RTOL)


def test_the_v5u_stem_stays_off_the_conv_kernel():
    """The 6x6 stride-2 stem pads 2 (autopad(6) would give 3), so the 3x3
    kernel's predicate leaves it on F.conv2d, folded in OIHW."""
    m = fold_bn(ConvBN(3, 16, 6, 2, 2).eval())
    assert m.p == 2 and not m.kernel_route
    assert tuple(m.w_fold.shape) == (16, 3, 6, 6)


# ------------------------------------------------------------- the models
IMG = (128, 128)
# the inner layers held to JAX: v11's C2PSA (10) and its first neck block
# (13), v5u's stem (0), its last backbone C3 (8) and its first neck block
INNER = {"v11": (10, 13), "v5u": (0, 8, 13)}
HEADS = {"v11": 23, "v5u": 24}


@pytest.fixture(scope="module", params=[("v11", False), ("v11", True),
                                        ("v5u", False)],
                ids=["v11_nms", "v11_e2e", "v5u_nms"])
def model(request):
    version, end2end = request.param
    jnet = JaxNet(JaxArch(version=version, size="n", task="detect", nc=NC,
                          end2end=end2end))
    x = np.random.default_rng(5).uniform(0, 1, (2, *IMG, 3)).astype(
        np.float32)
    variables = jitter_bn(jnet.init(jax.random.PRNGKey(8), jnp.asarray(x),
                                    False), seed=4)
    want, state = jnet.apply(variables, jnp.asarray(x), False,
                             capture_intermediates=True,
                             mutable=["intermediates"])
    inter = state["intermediates"]
    layers = {i: np.asarray(inter[str(i)]["__call__"][0])
              for i in INNER[version]}
    net = YoloNet(ArchCfg(version=version, size="n", nc=NC,
                          end2end=end2end)).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return dict(version=version, net=net, x=_nchw(x), want=want,
                layers=layers)


@pytest.mark.parametrize("folded", [False, True], ids=["eval_bn", "folded"])
def test_layers_and_heads_match_jax(model, folded):
    net = fold_bn(copy.deepcopy(model["net"])) if folded else model["net"]
    head = HEADS[model["version"]]
    assert len(net.model) == head + 1
    assert type(net.model[head]).__name__ == "Detect"
    got = {}
    hooks = [net.model[i].register_forward_hook(
        lambda m, inp, out, i=i: got.__setitem__(i, _nhwc(out)))
        for i in model["layers"]]
    with torch.no_grad():
        preds = net(model["x"])
    for h in hooks:
        h.remove()
    for i, want in model["layers"].items():
        np.testing.assert_allclose(got[i], want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"layer {i}")
    want = model["want"]
    assert set(preds) == set(want)
    for branch in want:
        for kind in ("box", "cls"):
            for lvl in range(3):
                np.testing.assert_allclose(
                    _nhwc(preds[branch][kind][lvl]),
                    np.asarray(want[branch][kind][lvl]), atol=ATOL,
                    rtol=RTOL)


@pytest.mark.parametrize("version", ["v11", "v5u"])
def test_large_state_dict_matches_the_jax_tree(version):
    """v11l (C3k2 with C3k inner blocks, C2PSA with n = 2) and v5ul (C3
    with n = 9): the JAX tree's names and shapes, exported from its shapes
    alone, load into the port with strict=True."""
    jnet = JaxNet(JaxArch(version=version, size="l", task="detect", nc=NC,
                          end2end=True))
    shapes = jax.eval_shape(lambda key, x: jnet.init(key, x, False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    halves = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, 0.5, a.dtype), shapes)
    want = state_dict_from_jax(halves)
    net = YoloNet(ArchCfg(version=version, size="l", nc=NC, end2end=True))
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    net.load_state_dict(want, strict=True)


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module", params=[("v11", False), ("v11", True),
                                        ("v5u", False)],
                ids=["v11_nms", "v11_e2e", "v5u_nms"])
def tasks(request):
    version, end2end = request.param
    kw = dict(task_type=TaskType.detect, yolo_type=YoloType(version),
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


def test_predict_fn_matches_jax(tasks):
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


def test_image_and_batch_predict_match_jax(tasks):
    det, port, conf, img = (tasks["det"], tasks["port"], tasks["conf"],
                            tasks["img"])
    want = det.image_predict(img, conf, IOU)
    assert len(want) > 3
    assert_results_match(port.image_predict(img, conf, IOU), want)
    batch = port.batch_predict([img, synthetic_image(200, 180, seed=1)],
                               conf, IOU)
    assert len(batch) == 2
    assert_results_match(batch[0], want)
