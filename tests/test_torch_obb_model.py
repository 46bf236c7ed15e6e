"""The port's OBB networks against the JAX package on the same weights,
float32 on the CPU: the Obb head alone (angle maps (sigmoid - 0.25) pi),
the v8n, v11n and v12n OBB nets End2End and NMS (every head map of every
branch, eval-BN and BN-folded, against the JAX eval-BN forward), the
v12x-obb End2End forward at 64 px (the v12l / x assembly: A2C2f with the
residual gamma, the 96-wide angle towers), .bin weights written by one
package and loaded by the other, and load_model's skip on a class-count
mismatch."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from test_torch_v12 import ATOL, RTOL, _nchw, _nhwc, module_state_dict
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.nn import ArchCfg as JaxArch
from yolosharp_tpu.nn import YoloNet as JaxNet
from yolosharp_tpu.nn import heads as jh
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu.types import YoloType as JaxType
from yolosharp_tpu_torch import (Config, Obber, ScalarType, TaskType,
                                 YoloSize, YoloTask, YoloType)
from yolosharp_tpu_torch.ckpt import fold_bn, state_dict_from_jax
from yolosharp_tpu_torch.nn import ArchCfg, Obb, YoloNet

NC = 5
KINDS = ("box", "cls", "angle")


def _assert_maps(got, want, branches):
    for branch in branches:
        assert set(got[branch]) == set(KINDS)
        for kind in KINDS:
            for lvl in range(3):
                np.testing.assert_allclose(
                    _nhwc(got[branch][kind][lvl]),
                    np.asarray(want[branch][kind][lvl]), atol=ATOL,
                    rtol=RTOL, err_msg=f"{branch} {kind} {lvl}")


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "dw"])
def test_obb_head_matches_jax(legacy):
    """The Obb head on three levels of features (widths 32 / 64 / 128, so
    c4 = 8): both End2End branches' box, cls and angle maps, eval-BN and
    folded, against the JAX Obb's eval-BN forward; the angles in
    [-pi/4, 3pi/4); the one2one branch alone when skip_one2many."""
    ch = (32, 64, 128)
    rng = np.random.default_rng(1)
    feats = [rng.uniform(-1, 1, (2, s, s, c)).astype(np.float32)
             for s, c in zip((8, 4, 2), ch)]
    jmod = jh.Obb(nc=NC, ch=ch, legacy=legacy, end2end=True, ne=1)
    variables = jitter_bn(jmod.init(jax.random.PRNGKey(2),
                                    [jnp.asarray(f) for f in feats], False),
                          seed=2)
    want = jmod.apply(variables, [jnp.asarray(f) for f in feats], False)
    tmod = Obb(NC, 16, ch, legacy, True)
    missing, unexpected = tmod.load_state_dict(module_state_dict(variables),
                                               strict=False)
    assert missing == ["dfl.conv.weight"] and not unexpected
    assert tmod.cv4[0][0].conv.out_channels == 8
    assert tmod.cv4[0][2].out_channels == 1
    tmod.eval()
    x = [_nchw(f) for f in feats]
    for net in (tmod, fold_bn(copy.deepcopy(tmod))):
        with torch.no_grad():
            got = net(x)
        _assert_maps(got, want, ("one2many", "one2one"))
        for a in got["one2many"]["angle"]:
            assert a.min() >= -np.pi / 4 and a.max() < 3 * np.pi / 4
    with torch.no_grad():
        e2e = tmod(x, skip_one2many=True)
    assert set(e2e) == {"one2one"}
    assert e2e["one2one"]["angle"][0].shape == (2, 1, 8, 8)


IMG = (64, 96)


@pytest.fixture(scope="module",
                params=[("v8", True), ("v8", False), ("v11", True),
                        ("v11", False), ("v12", True), ("v12", False)],
                ids=["v8_e2e", "v8_nms", "v11_e2e", "v11_nms", "v12_e2e",
                     "v12_nms"])
def obb_model(request):
    version, end2end = request.param
    jnet = JaxNet(JaxArch(version=version, size="n", task="obb", nc=NC,
                          end2end=end2end))
    x = np.random.default_rng(5).uniform(0, 1, (2, *IMG, 3)).astype(
        np.float32)
    variables = jitter_bn(jnet.init(jax.random.PRNGKey(8), jnp.asarray(x),
                                    False), seed=4)
    want = jnet.apply(variables, jnp.asarray(x), False)
    net = YoloNet(ArchCfg(version=version, size="n", task="obb", nc=NC,
                          end2end=end2end)).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return dict(net=net, x=_nchw(x), want=want, end2end=end2end)


@pytest.mark.parametrize("folded", [False, True], ids=["eval_bn", "folded"])
def test_obb_nets_match_jax(obb_model, folded):
    """Every branch's box, cls and angle maps at the three levels against
    the JAX eval-BN forward, ATOL = RTOL = 1e-4 (v12's pe conv is biased:
    the JAX fold_bn would differ, so the eval-BN forward is the reference,
    as in tests/test_torch_v12.py); End2End predict runs the one2one
    towers alone, to the same maps."""
    net = obb_model["net"]
    if folded:
        net = fold_bn(copy.deepcopy(net))
    with torch.no_grad():
        preds = net(obb_model["x"])
    want = obb_model["want"]
    assert isinstance(net.model[-1], Obb)
    assert set(preds) == set(want)
    assert ("one2one" in preds) == obb_model["end2end"]
    _assert_maps(preds, want, want)
    assert preds["one2many"]["angle"][0].shape == (2, 1, 8, 12)
    if obb_model["end2end"]:
        with torch.no_grad():
            e2e = net(obb_model["x"], skip_one2many=True)
        assert set(e2e) == {"one2one"}
        for lvl in range(3):
            torch.testing.assert_close(e2e["one2one"]["angle"][lvl],
                                       preds["one2one"]["angle"][lvl])


def test_v12x_obb_end2end_forward_matches_jax():
    """v12x-obb End2End (nc = 15, the JAX bench's workload 5) at 64 x 64,
    batch 1, float32, on numpy-seeded weights: the JAX tree's names and
    shapes load with strict=True (A2C2f gamma at layers 6 and 8, angle
    towers 384 -> 96 -> 96 -> 1), and every map of both branches equals
    the JAX eval-BN forward."""
    arch = dict(version="v12", size="x", task="obb", nc=15, end2end=True)
    jnet = JaxNet(JaxArch(**arch))
    x = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    variables = jitter_bn(jnet.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                    False), seed=5)
    want = jax.jit(lambda v, t: jnet.apply(v, t, False))(variables,
                                                         jnp.asarray(x))
    net = YoloNet(ArchCfg(**arch)).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert [k for k in net.state_dict() if k.endswith("gamma")] == [
        "model.6.gamma", "model.8.gamma"]
    tower = net.model[-1].cv4[0]
    assert (tower[0].conv.in_channels, tower[0].conv.out_channels,
            tower[2].out_channels) == (384, 96, 1)
    with torch.no_grad():
        preds = net(_nchw(x))
    _assert_maps(preds, want, ("one2many", "one2one"))


def _obb_config(version, **kw):
    return dict(task_type=TaskType.obb, yolo_type=YoloType(version),
                yolo_size=YoloSize.n, number_class=NC, **kw)


def test_bin_weights_cross_both_ways(tmp_path):
    """A v11n-obb .bin written by the port's save_weight loads into the JAX
    Obber with only the one2one towers missing, and the JAX package's .bin
    loads into the port's: the same tensors both ways, cv4 included (one2one
    towers excluded from the files and cloned from one2many on load)."""
    port = YoloTask(Config(scalar_type=ScalarType.float32,
                           **_obb_config("v11")), device="cpu")
    assert isinstance(port.task, Obber)
    net = port.task._ensure_variables()
    with torch.no_grad():
        for p in net.parameters():
            if p.requires_grad:     # not the fixed DFL projection
                p.add_(torch.randn_like(p) * 0.01)
    path = str(tmp_path / "port.bin")
    port.save_weight(path)
    jtask = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.obb, yolo_type=JaxType.v11,
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
                            **_obb_config("v11")), device="cpu")
    report = fresh.load_model(jpath)
    assert not report.skipped and not report.unexpected
    assert all("one2one" in k for k in report.missing)
    loaded = fresh.task.net.state_dict()
    for k, v in saved.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=k)
    head = fresh.task.net.model[-1]
    torch.testing.assert_close(head.one2one_cv4[1][2].weight,
                               head.cv4[1][2].weight)


def test_load_model_skips_the_class_towers_on_an_nc_mismatch(tmp_path):
    """A 5-class v8n-obb checkpoint loaded into a 15-class v8n-obb with
    skip_nc_not_equal_layers: the skip list is the JAX package's (head 22's
    cv3, whose widths follow nc; the angle towers load), nothing is
    unexpected, and the net serves."""
    path = str(tmp_path / "nc5.bin")
    YoloTask(Config(scalar_type=ScalarType.float32,
                    **_obb_config("v8", end2end=False)),
             device="cpu").save_weight(path)
    kw = _obb_config("v8", end2end=False)
    kw["number_class"] = 15
    port = YoloTask(Config(scalar_type=ScalarType.float32, **kw),
                    device="cpu")
    report = port.load_model(path, skip_nc_not_equal_layers=True)
    jtask = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.obb, yolo_type=JaxType.v8,
        yolo_size=JaxSize.n, number_class=15, scalar_type="float32",
        end2end=False))
    jreport = jtask.load_model(path, skip_nc_not_equal_layers=True)
    assert sorted(report.skipped) == sorted(jreport.skipped)
    assert report.skipped and not report.unexpected
    assert all(k.startswith("model.22.cv3.") for k in report.skipped)
    res = port.image_predict(np.zeros((64, 64, 3), np.uint8), 0.0)
    assert res and all(-np.pi / 4 <= r.radian < 3 * np.pi / 4 for r in res)
