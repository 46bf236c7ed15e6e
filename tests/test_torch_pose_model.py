"""The port's pose networks against the JAX package on the same weights,
float32 on the CPU: the Pose head alone, the v8n, v11n, v12n and v5un
pose nets (every head map of both End2End branches, eval-BN and BN-folded,
against the JAX eval-BN forward) at 17 x 3 keypoints and a v11n at 5 x 2,
the v11m / v11s / v8n state-dict names and shapes (cv4 widths 64 and 51),
.bin weights written by one package and loaded by the other, and
load_model's skip of the keypoint towers when K kd differs."""

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
from yolosharp_tpu.nn import heads as jh
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu.types import YoloType as JaxType
from yolosharp_tpu_torch import (Config, PoseDetector, ScalarType, TaskType,
                                 YoloSize, YoloTask, YoloType)
from yolosharp_tpu_torch.ckpt import fold_bn, state_dict_from_jax
from yolosharp_tpu_torch.nn import ArchCfg, Pose, YoloNet

NC = 5
KINDS = ("box", "cls", "kpt")


@pytest.mark.parametrize("legacy,kpt_shape", [(True, (17, 3)),
                                              (False, (5, 2))],
                         ids=["legacy_k17", "dw_k5"])
def test_pose_head_matches_jax(legacy, kpt_shape):
    """The Pose head on three levels of features (widths 32 / 64 / 128, so
    c4 = max(8, K kd)): both End2End branches' box, cls and kpt maps,
    eval-BN and folded, against the JAX Pose's eval-BN forward; the one2one
    branch alone when skip_one2many."""
    k, kd = kpt_shape
    ch = (32, 64, 128)
    rng = np.random.default_rng(1)
    feats = [rng.uniform(-1, 1, (2, s, s, c)).astype(np.float32)
             for s, c in zip((8, 4, 2), ch)]
    jmod = jh.Pose(nc=NC, ch=ch, legacy=legacy, end2end=True, kpt_num=k,
                   kpt_dim=kd)
    variables = jitter_bn(jmod.init(jax.random.PRNGKey(2),
                                    [jnp.asarray(f) for f in feats], False),
                          seed=2)
    want = jmod.apply(variables, [jnp.asarray(f) for f in feats], False)
    tmod = Pose(NC, 16, ch, legacy, True, k, kd)
    missing, unexpected = tmod.load_state_dict(module_state_dict(variables),
                                               strict=False)
    assert missing == ["dfl.conv.weight"] and not unexpected
    assert tmod.cv4[0][0].conv.out_channels == max(ch[0] // 4, k * kd)
    tmod.eval()
    x = [_nchw(f) for f in feats]
    for net in (tmod, fold_bn(copy.deepcopy(tmod))):
        with torch.no_grad():
            got = net(x)
        for branch in ("one2many", "one2one"):
            assert set(got[branch]) == set(KINDS)
            for kind in KINDS:
                for lvl in range(3):
                    np.testing.assert_allclose(
                        _nhwc(got[branch][kind][lvl]),
                        np.asarray(want[branch][kind][lvl]), atol=ATOL,
                        rtol=RTOL, err_msg=f"{branch} {kind} {lvl}")
    with torch.no_grad():
        e2e = tmod(x, skip_one2many=True)
    assert set(e2e) == {"one2one"}
    assert e2e["one2one"]["kpt"][0].shape == (2, k * kd, 8, 8)


IMG = (64, 96)


@pytest.fixture(scope="module",
                params=[("v8", (17, 3)), ("v11", (17, 3)), ("v12", (17, 3)),
                        ("v5u", (17, 3)), ("v11", (5, 2))],
                ids=["v8", "v11", "v12", "v5u", "v11_k5"])
def pose_model(request):
    version, (k, kd) = request.param
    jnet = JaxNet(JaxArch(version=version, size="n", task="pose", nc=NC,
                          kpt_num=k, kpt_dim=kd, end2end=True))
    x = np.random.default_rng(5).uniform(0, 1, (2, *IMG, 3)).astype(
        np.float32)
    variables = jitter_bn(jnet.init(jax.random.PRNGKey(8), jnp.asarray(x),
                                    False), seed=4)
    want = jnet.apply(variables, jnp.asarray(x), False)
    net = YoloNet(ArchCfg(version=version, size="n", task="pose", nc=NC,
                          kpt_num=k, kpt_dim=kd, end2end=True)).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return dict(net=net, x=_nchw(x), want=want, nk=k * kd)


@pytest.mark.parametrize("folded", [False, True], ids=["eval_bn", "folded"])
def test_pose_nets_match_jax(pose_model, folded):
    """Both branches' box, cls and kpt maps at the three levels against
    the JAX eval-BN forward, ATOL = RTOL = 1e-4 (v12's pe conv is biased:
    the JAX fold_bn would differ, so the eval-BN forward is the reference,
    as in tests/test_torch_v12.py); End2End predict runs the one2one
    towers alone, to the same maps."""
    net = pose_model["net"]
    if folded:
        net = fold_bn(copy.deepcopy(net))
    with torch.no_grad():
        preds = net(pose_model["x"])
    want = pose_model["want"]
    assert isinstance(net.model[-1], Pose)
    assert set(preds) == set(want) == {"one2many", "one2one"}
    for branch in want:
        assert set(preds[branch]) == set(KINDS)
        for kind in KINDS:
            for lvl in range(3):
                np.testing.assert_allclose(
                    _nhwc(preds[branch][kind][lvl]),
                    np.asarray(want[branch][kind][lvl]), atol=ATOL,
                    rtol=RTOL, err_msg=f"{branch} {kind} {lvl}")
    assert preds["one2many"]["kpt"][0].shape == (2, pose_model["nk"], 8, 12)
    with torch.no_grad():
        e2e = net(pose_model["x"], skip_one2many=True)
    assert set(e2e) == {"one2one"}
    for lvl in range(3):
        torch.testing.assert_close(e2e["one2one"]["kpt"][lvl],
                                   preds["one2one"]["kpt"][lvl])


@pytest.mark.parametrize("version,size,c4", [("v11", "m", 64),
                                             ("v11", "s", 51),
                                             ("v8", "n", 51)])
def test_pose_state_dict_matches_the_jax_tree(version, size, c4):
    """v11m-pose (cv4 towers of 64), v11s-pose and v8n-pose (51, the odd
    width the 3x3 kernels take): the JAX tree's names and shapes, exported
    from its shapes alone, load into the port with strict=True; the
    cv4 and one2one_cv4 names are there."""
    jnet = JaxNet(JaxArch(version=version, size=size, task="pose", nc=1,
                          end2end=True))
    shapes = jax.eval_shape(lambda key, x: jnet.init(key, x, False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    halves = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, 0.5, a.dtype), shapes)
    want = state_dict_from_jax(halves)
    net = YoloNet(ArchCfg(version=version, size=size, task="pose", nc=1,
                          end2end=True))
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    net.load_state_dict(want, strict=True)
    head = len(net.model) - 1
    assert f"model.{head}.cv4.2.2.weight" in got
    assert f"model.{head}.one2one_cv4.0.0.conv.weight" in got
    tower = net.model[-1].cv4[0]
    assert tower[0].conv.out_channels == tower[1].conv.in_channels == c4
    assert tower[2].out_channels == 51


def _pose_config(version, **kw):
    return dict(task_type=TaskType.pose, yolo_type=YoloType(version),
                yolo_size=YoloSize.n, number_class=NC, **kw)


def test_bin_weights_cross_both_ways(tmp_path):
    """A v11n-pose .bin written by the port's save_weight loads into the
    JAX PoseDetector with only the one2one towers missing, and the JAX
    package's .bin loads into the port's: the same tensors both ways
    (one2one towers excluded from the files, as SaveWeight does, and
    cloned from one2many on load)."""
    port = YoloTask(Config(scalar_type=ScalarType.float32,
                           **_pose_config("v11")), device="cpu")
    assert isinstance(port.task, PoseDetector)
    net = port.task._ensure_variables()
    with torch.no_grad():
        for p in net.parameters():
            if p.requires_grad:     # not the fixed DFL projection
                p.add_(torch.randn_like(p) * 0.01)
    path = str(tmp_path / "port.bin")
    port.save_weight(path)
    jtask = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.pose, yolo_type=JaxType.v11,
        yolo_size=JaxSize.n, number_class=NC, scalar_type="float32"))
    report = jtask.load_model(path)
    assert not report.skipped and report.missing
    assert all("one2one" in k for k in report.missing)
    got = state_dict_from_jax(jtask.task.variables)
    saved = {k: v for k, v in net.state_dict().items()
             if "one2one" not in k and "num_batches" not in k}
    assert any(".cv4." in k for k in saved)
    for k, v in saved.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)

    jpath = str(tmp_path / "jax.bin")
    jtask.save_weight(jpath)
    fresh = YoloTask(Config(scalar_type=ScalarType.float32,
                            **_pose_config("v11")), device="cpu")
    report = fresh.load_model(jpath)
    assert not report.skipped and not report.unexpected
    assert all("one2one" in k for k in report.missing)
    loaded = fresh.task.net.state_dict()
    for k, v in saved.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=k)
    head = fresh.task.net.model[-1]
    torch.testing.assert_close(head.one2one_cv4[1][2].weight,
                               head.cv4[1][2].weight)


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
def test_load_model_skips_the_keypoint_towers_on_a_kpt_mismatch(tmp_path,
                                                                 skip):
    """A 17 x 3 v8n-pose checkpoint loaded into a 5 x 2 v8n-pose: with
    skip_nc_not_equal_layers the whole of head 22's cv4 (its widths follow
    K kd) is skipped, the skip list is the JAX package's, nothing is
    unexpected and the rest loads; without it the mismatched cv4 tensors
    are reported unexpected and left at their init. The classes match, so
    cv3 loads."""
    path = str(tmp_path / "k17.bin")
    YoloTask(Config(scalar_type=ScalarType.float32,
                    **_pose_config("v8", end2end=False)),
             device="cpu").save_weight(path)
    kw = _pose_config("v8", end2end=False, keypoint_num=5, keypoint_dim=2)
    port = YoloTask(Config(scalar_type=ScalarType.float32, **kw),
                    device="cpu")
    report = port.load_model(path, skip_nc_not_equal_layers=skip)
    jtask = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.pose, yolo_type=JaxType.v8,
        yolo_size=JaxSize.n, number_class=NC, keypoint_num=5,
        keypoint_dim=2, scalar_type="float32", end2end=False))
    jreport = jtask.load_model(path, skip_nc_not_equal_layers=skip)
    assert sorted(report.skipped) == sorted(jreport.skipped)
    cv4 = [k for k in report.skipped + report.unexpected
           if k.startswith("model.22.cv4.")]
    assert cv4 and not any(".cv3." in k for k in report.skipped)
    if skip:
        assert not report.unexpected
        assert len(report.skipped) > 10
        assert all(k.startswith("model.22.cv4.") for k in report.skipped)
        assert all(k.startswith("model.22.cv4.") for k in report.missing)
    else:
        assert not report.skipped and report.unexpected
        assert all(k.startswith("model.22.cv4.") for k in report.unexpected)
    assert port.task.net.model[-1].cv4[0][2].out_channels == 10
    img = np.zeros((64, 64, 3), np.uint8)
    res = port.image_predict(img, 0.0)
    assert res and len(res[0].keypoints) == 5
    assert all(p.visibility == 1.0 for p in res[0].keypoints)
