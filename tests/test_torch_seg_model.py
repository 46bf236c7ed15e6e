"""The port's segment networks against the JAX package on the same weights,
float32 on the CPU: the Proto module (eval-BN and folded), the v8n, v11n,
v12n and v5un segment nets (every head map of both End2End branches and
the proto, eval-BN and BN-folded, against the JAX eval-BN forward), the
v11m / v12l state-dict names and shapes, fold_bn over every ConvBN of a
segment net with the ConvTranspose left alone, and .bin weights written by
one package and loaded by the other."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_v12 import ATOL, RTOL, _nchw, _nhwc, module_state_dict
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.nn import ArchCfg as JaxArch
from yolosharp_tpu.nn import YoloNet as JaxNet
from yolosharp_tpu.nn import common as jc
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu.types import YoloType as JaxType
from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask, YoloType)
from yolosharp_tpu_torch.ckpt import fold_bn, state_dict_from_jax
from yolosharp_tpu_torch.kernels import conv3x3
from yolosharp_tpu_torch.nn import (ArchCfg, ConvBN, ConvTranspose2d, Proto,
                                    Segment, YoloNet)

NC = 5


def test_proto_matches_jax():
    """Proto(64 -> 48 -> 32) on a 5x7 map: its 10x14 prototypes, eval-BN
    and folded, against the JAX Proto's eval-BN forward (ATOL / RTOL of
    tests/test_torch_v12.py); the upsample's HWIO kernel crosses over as
    (Cin, Cout, 2, 2)."""
    jmod = jc.Proto(48, 32)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 5, 7, 64)).astype(
        np.float32)
    variables = jitter_bn(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                    False), seed=1)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    tmod = Proto(64, 48, 32)
    tmod.load_state_dict(module_state_dict(variables), strict=True)
    assert tuple(tmod.upsample.weight.shape) == (48, 48, 2, 2)
    tmod.eval()
    with torch.no_grad():
        got = tmod(_nchw(x))
        got_fold = fold_bn(copy.deepcopy(tmod))(_nchw(x))
    assert want.shape == (2, 10, 14, 32)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_nhwc(got_fold), want, atol=ATOL, rtol=RTOL)


IMG = (64, 96)


@pytest.fixture(scope="module", params=["v8", "v11", "v12", "v5u"])
def seg_model(request):
    version = request.param
    jnet = JaxNet(JaxArch(version=version, size="n", task="segment", nc=NC,
                          end2end=True))
    x = np.random.default_rng(5).uniform(0, 1, (2, *IMG, 3)).astype(
        np.float32)
    variables = jitter_bn(jnet.init(jax.random.PRNGKey(8), jnp.asarray(x),
                                    False), seed=4)
    want = jnet.apply(variables, jnp.asarray(x), False)
    net = YoloNet(ArchCfg(version=version, size="n", task="segment", nc=NC,
                          end2end=True)).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return dict(net=net, x=_nchw(x), want=want)


@pytest.mark.parametrize("folded", [False, True], ids=["eval_bn", "folded"])
def test_segment_nets_match_jax(seg_model, folded):
    """Both branches' box, cls and mask maps at the three levels and the
    proto (2, 32, 16, 24) against the JAX eval-BN forward, ATOL = RTOL =
    1e-4 (v12's pe conv is biased: the JAX fold_bn would differ, so the
    eval-BN forward is the reference, as in tests/test_torch_v12.py); the
    one2one proto is the one2many proto, detached."""
    net = seg_model["net"]
    if folded:
        net = fold_bn(copy.deepcopy(net))
    with torch.no_grad():
        preds = net(seg_model["x"])
    want = seg_model["want"]
    assert isinstance(net.model[-1], Segment)
    assert set(preds) == set(want) == {"one2many", "one2one"}
    for branch in want:
        assert set(preds[branch]) == {"box", "cls", "mask", "proto"}
        for kind in ("box", "cls", "mask"):
            for lvl in range(3):
                np.testing.assert_allclose(
                    _nhwc(preds[branch][kind][lvl]),
                    np.asarray(want[branch][kind][lvl]), atol=ATOL,
                    rtol=RTOL, err_msg=f"{branch} {kind} {lvl}")
        np.testing.assert_allclose(_nhwc(preds[branch]["proto"]),
                                   np.asarray(want[branch]["proto"]),
                                   atol=ATOL, rtol=RTOL)
    assert preds["one2many"]["mask"][0].shape == (2, 32, 8, 12)
    torch.testing.assert_close(preds["one2one"]["proto"],
                               preds["one2many"]["proto"])
    with torch.no_grad():
        e2e = net(seg_model["x"], skip_one2many=True)
    assert set(e2e) == {"one2one"}
    torch.testing.assert_close(e2e["one2one"]["proto"],
                               preds["one2one"]["proto"])


@pytest.mark.parametrize("version,size", [("v11", "m"), ("v12", "l"),
                                          ("v8", "s")])
def test_segment_state_dict_matches_the_jax_tree(version, size):
    """v11m-seg (Proto 256 wide, cv4 towers of 64), v12l-seg and v8s-seg:
    the JAX tree's names and shapes, exported from its shapes alone, load
    into the port with strict=True."""
    jnet = JaxNet(JaxArch(version=version, size=size, task="segment", nc=80,
                          end2end=True))
    shapes = jax.eval_shape(lambda key, x: jnet.init(key, x, False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    halves = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, 0.5, a.dtype), shapes)
    want = state_dict_from_jax(halves)
    net = YoloNet(ArchCfg(version=version, size=size, task="segment", nc=80,
                          end2end=True))
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    net.load_state_dict(want, strict=True)
    head = net.model[-1]
    if (version, size) == ("v11", "m"):
        assert head.proto.cv1.conv.out_channels == 256
        assert head.cv4[0][0].conv.out_channels == 64


def test_fold_bn_reaches_every_convbn_of_a_segment_net():
    """fold_bn sets folded weights on every ConvBN (the Proto's and the cv4
    towers' included: cv1 and cv2 of the Proto and the towers' 3x3s in the
    3x3 kernel's HWIO layout) and leaves the ConvTranspose and the
    checkpointed parameters as they were."""
    net = YoloNet(ArchCfg(version="v11", size="n", task="segment", nc=NC,
                          end2end=True)).eval()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    fold_bn(net)
    convs = [m for m in net.modules() if isinstance(m, ConvBN)]
    assert len(convs) > 100 and all(m.b_fold is not None for m in convs)
    head = net.model[-1]
    for m in (head.proto.cv1, head.proto.cv2, head.cv4[2][0],
              head.one2one_cv4[1][1]):
        assert m.kernel_route and tuple(m.w_fold.shape[:2]) == (3, 3)
    assert not head.proto.cv3.kernel_route
    up = head.proto.upsample
    assert isinstance(up, ConvTranspose2d)
    assert not hasattr(up, "w_fold") and not hasattr(up, "b_fold")
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert conv3x3.supported(3, 1, 1, 1, 1)


def _seg_config(version, **kw):
    return dict(task_type=TaskType.segment, yolo_type=YoloType(version),
                yolo_size=YoloSize.n, number_class=NC, **kw)


@pytest.mark.parametrize("version", ["v8", "v11"])
def test_bin_weights_cross_both_ways(version, tmp_path):
    """A .bin written by the port's save_weight loads into the JAX
    Segmenter with only the one2one towers missing, and the JAX package's
    .bin loads into
    the port's: the same tensors both ways (one2one towers excluded from
    the files, as SaveWeight does, and cloned from one2many on load)."""
    port = YoloTask(Config(scalar_type=ScalarType.float32,
                           **_seg_config(version)), device="cpu")
    net = port.task._ensure_variables()
    with torch.no_grad():
        for p in net.parameters():
            if p.requires_grad:     # not the fixed DFL projection
                p.add_(torch.randn_like(p) * 0.01)
    path = str(tmp_path / "port.bin")
    port.save_weight(path)
    jtask = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.segment, yolo_type=JaxType(version),
        yolo_size=JaxSize.n, number_class=NC, scalar_type="float32"))
    report = jtask.load_model(path)
    assert not report.skipped and report.missing
    assert all("one2one" in k for k in report.missing)
    got = state_dict_from_jax(jtask.task.variables)
    saved = {k: v for k, v in net.state_dict().items()
             if "one2one" not in k and "num_batches" not in k}
    assert len(saved) > 300
    for k, v in saved.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)

    jpath = str(tmp_path / "jax.bin")
    jtask.save_weight(jpath)
    fresh = YoloTask(Config(scalar_type=ScalarType.float32,
                            **_seg_config(version)), device="cpu")
    report = fresh.load_model(jpath)
    assert not report.skipped and not report.unexpected
    assert all("one2one" in k for k in report.missing)
    loaded = fresh.task.net.state_dict()
    for k, v in saved.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=k)
    head = fresh.task.net.model[-1]
    torch.testing.assert_close(head.one2one_cv4[0][2].weight,
                               head.cv4[0][2].weight)
