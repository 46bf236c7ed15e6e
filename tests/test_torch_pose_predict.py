"""The port's pose predict slice against the JAX package, float32 on the
CPU: decode_inference and decode_inference_topk with keypoints (17 x 3
and 5 x 2, NMS and End2End decodes) on random head maps, then YoloTask
with TaskType.pose against the JAX PoseDetector with the same seeded
weights on a synthetic image: the predict function's rows and keypoints
(NMS with select-then-decode, and End2End), and image_predict /
batch_predict YoloResults with their KeyPoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_predict import (IOU, _result_rows, assert_match,
                                assert_results_match, canvas,
                                synthetic_image)
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from util_calib import calibrate_task
from yolosharp_tpu import predict as jax_predict
from yolosharp_tpu.ckpt.mapping import clone_one2one as jax_clone_one2one
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType, YoloSize, YoloType
from yolosharp_tpu_torch import Config, KeyPoint, PoseDetector, ScalarType
from yolosharp_tpu_torch import TaskType as PortTaskType
from yolosharp_tpu_torch import YoloSize as PortYoloSize
from yolosharp_tpu_torch import YoloTask
from yolosharp_tpu_torch import YoloType as PortYoloType
from yolosharp_tpu_torch import predict as port_predict
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.loss import flatten_levels

NC = 3
LEVELS = ((8, 12), (4, 6), (2, 3))      # a 64x96 canvas


def _branch(rng, nk, b=2):
    """NHWC raw maps of a pose branch: box (64), cls (NC) and kpt (nk)."""
    def maps(c, scale, shift=0.0):
        return [(rng.standard_normal((b, h, w, c)) * scale + shift).astype(
            np.float32) for h, w in LEVELS]

    return {"box": maps(64, 1.0), "cls": maps(NC, 1.5, -1.0),
            "kpt": maps(nk, 0.7)}


def _torch_branch(branch):
    return {k: tuple(torch.from_numpy(m).permute(0, 3, 1, 2) for m in v)
            for k, v in branch.items()}


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["k17", "k5"])
@pytest.mark.parametrize("end2end", [False, True], ids=["xywh", "e2e"])
def test_decode_inference_keypoints_match_jax(kpt_shape, end2end):
    """The decode's (B, 4 + nc + K kd, A) tensor against the JAX package's:
    keypoints x, y = (raw * 2 + anchor - 0.5) * stride and the visibility's
    sigmoid when kd = 3, to 1e-4 + 1e-5|ref| (the bound of the detect
    decode's test in tests/test_torch_ops.py: the DFL softmax rounds in
    another order); then e2e_postprocess carries them as the rows'
    extras."""
    k, kd = kpt_shape
    branch = _branch(np.random.default_rng(k + end2end), k * kd)
    kw = dict(end2end=end2end, kpt_num=k, kpt_dim=kd)
    want = np.asarray(jax_predict.decode_inference(
        {n: [jnp.asarray(m) for m in v] for n, v in branch.items()},
        nc=NC, **kw))
    got = port_predict.decode_inference(_torch_branch(branch), **kw)
    assert got.shape == want.shape == (2, 4 + NC + k * kd, 126)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    if kd == 3:
        vis = got[:, 4 + NC + 2::3]
        assert float(vis.min()) > 0 and float(vis.max()) < 1
    if end2end:
        rows = port_predict.e2e_postprocess(got.transpose(-1, -2), nc=NC,
                                            max_det=50)
        jrows = jax_predict.e2e_postprocess(
            jnp.asarray(want).swapaxes(-1, -2), nc=NC, max_det=50,
            extra=k * kd)
        np.testing.assert_allclose(rows.numpy(), np.asarray(jrows),
                                   atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["k17", "k5"])
def test_decode_inference_topk_keypoints_match_jax(kpt_shape):
    """Select-then-decode of the top 40 anchors: the selected rows with
    their keypoints and the truncation flag equal the JAX package's (to
    1e-4 + 1e-5|ref|), and each row is the full decode's row of its
    anchor."""
    k, kd = kpt_shape
    branch = _branch(np.random.default_rng(k), k * kd)
    kw = dict(conf_thres=0.3, k=40, kpt_num=k, kpt_dim=kd)
    want, wtrunc = jax_predict.decode_inference_topk(
        {n: [jnp.asarray(m) for m in v] for n, v in branch.items()},
        nc=NC, **kw)
    got, trunc = port_predict.decode_inference_topk(_torch_branch(branch),
                                                    **kw)
    assert got.shape == (2, 4 + NC + k * kd, 40)
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(wtrunc))
    assert trunc.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    full = port_predict.decode_inference(_torch_branch(branch), kpt_num=k,
                                         kpt_dim=kd)
    cls = flatten_levels(_torch_branch(branch)["cls"]).amax(-1)
    idx = cls.topk(40, dim=-1).indices
    ref = full.gather(2, idx[:, None].expand(-1, full.shape[1], -1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-6)


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module", params=[("v8", False), ("v8", True),
                                        ("v11", True)],
                ids=["v8_nms", "v8_e2e", "v11_e2e"])
def tasks(request):
    version, end2end = request.param
    kw = dict(task_type=TaskType.pose, yolo_type=YoloType(version),
              yolo_size=YoloSize.n, number_class=NC, end2end=end2end,
              nms_pre_topk=2048)
    pose = JaxYoloTask(JaxConfig(host_s2d=False, fuse_inference=False,
                                 **kw)).task
    calibrate_task(pose)
    variables = jitter_bn(pose.variables, seed=2)
    if end2end:
        variables = jax_clone_one2one(variables)
    pose.variables = variables
    port_kw = dict(kw, task_type=PortTaskType(kw["task_type"].value),
                   yolo_type=PortYoloType(kw["yolo_type"].value),
                   yolo_size=PortYoloSize(kw["yolo_size"].value))
    port = YoloTask(Config(scalar_type=ScalarType.float32, **port_kw),
                    device="cpu")
    assert isinstance(port.task, PoseDetector)
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)
    img = synthetic_image()
    x = torch.from_numpy(canvas(img)).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        preds = port.task._predict_variables()(x)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 150 / flat.shape[1]))
    return dict(end2end=end2end, pose=pose, port=port, img=img, conf=conf)


def _matched(got_boxes, got_cls, want_boxes, want_cls, px):
    """For each reference row, the index of the row of `got` with the same
    class within `px` pixels, or -1."""
    out = []
    for b, c in zip(want_boxes, want_cls):
        d = np.abs(got_boxes - b).max(1) + 1e3 * (got_cls != c)
        j = int(d.argmin()) if len(d) else -1
        out.append(j if j >= 0 and d[j] < px else -1)
    return np.array(out)


def test_predict_fn_matches_jax(tasks):
    """The rows of the predict function (boxes 0.5 px, scores 1e-3, by the
    match rule of tests/test_torch_predict.py) and the 17 x 3 keypoints of
    the matched rows to 1e-3 + 1e-3|ref| (canvas pixels, visibilities)."""
    pose, port, conf, e2e = (tasks["pose"], tasks["port"].task,
                             tasks["conf"], tasks["end2end"])
    arr = canvas(tasks["img"])
    want = jax.device_get(pose._predict_fn(arr.shape)(
        pose._predict_variables(), jnp.asarray(arr), conf, IOU))
    got = port._host(port._predict_fn(port._predict_variables(),
                                      torch.from_numpy(arr),
                                      0.0 if e2e else conf, IOU))
    if not e2e:
        assert not got.truncated.any() and not want.truncated.any()
        want = type(got)(*(np.asarray(t) for t in want))
    g = port._rows(got, 0, conf)
    w = port._rows(want, 0, conf)
    assert_match(g[:3], w[:3])
    assert g[3].shape[1] == w[3].shape[1] == 51
    j = _matched(g[0], g[2], w[0], w[2], 0.5)
    ok = j >= 0
    assert ok.mean() > 0.95
    np.testing.assert_allclose(g[3][j[ok]], w[3][ok], atol=1e-3, rtol=1e-3)


def _keypoints(results):
    rs = sorted(results, key=lambda r: -r.score)
    return np.array([[(p.x, p.y, p.visibility) for p in r.keypoints]
                     for r in rs], float).reshape(len(rs), -1, 3)


def _assert_keypoints_match(got, want):
    """The keypoints of the results matched by box and class (within the
    1.5 px of integer-truncated result boxes) to 1e-3 + 1e-3|ref|."""
    gb, _, gc = _result_rows(got)
    wb, _, wc = _result_rows(want)
    j = _matched(gb, gc, wb, wc, 1.5)
    ok = j >= 0
    assert ok.mean() > 0.95
    gk, wk = _keypoints(got), _keypoints(want)
    assert gk.shape[1:] == wk.shape[1:] == (17, 3)
    np.testing.assert_allclose(gk[j[ok]], wk[ok], atol=1e-3, rtol=1e-3)


def test_image_and_batch_predict_match_jax(tasks):
    """image_predict of a 316x236 image and batch_predict of it with a
    200x180 image: the YoloResults' boxes and scores by the match rule of
    tests/test_torch_predict.py, each with 17 KeyPoints (canvas pixels,
    visibility in (0, 1)) equal to the JAX PoseDetector's."""
    pose, port, conf, img = (tasks["pose"], tasks["port"], tasks["conf"],
                             tasks["img"])
    want = pose.image_predict(img, conf, IOU)
    got = port.image_predict(img, conf, IOU)
    assert len(want) > 5
    assert_results_match(got, want)
    assert all(len(r.keypoints) == 17 and isinstance(r.keypoints[0],
                                                     KeyPoint) for r in got)
    vis = _keypoints(got)[..., 2]
    assert vis.min() > 0 and vis.max() < 1
    _assert_keypoints_match(got, want)

    small = synthetic_image(200, 180, seed=1)
    jbatch = pose.batch_predict([img, small], conf, IOU)
    batch = port.batch_predict([img, small], conf, IOU)
    assert len(batch) == 2
    for got_i, want_i in zip(batch, jbatch):
        assert_results_match(got_i, want_i)
        _assert_keypoints_match(got_i, want_i)


def test_results_are_built_with_the_collector_paused(tasks, monkeypatch):
    """batch_predict builds each image's results with the cyclic garbage
    collector paused and leaves it as it found it: enabled, or disabled
    by the caller."""
    import gc

    port, conf, img = tasks["port"].task, tasks["conf"], tasks["img"]
    seen = []
    real = port._batch_results
    monkeypatch.setattr(port, "_batch_results",
                        lambda *a: seen.append(gc.isenabled()) or real(*a))
    assert gc.isenabled()
    res = port.batch_predict([img, img], conf, IOU)
    assert seen == [False, False] and gc.isenabled()
    assert len(res[0]) > 5 and len(res[0][0].keypoints) == 17
    gc.disable()
    try:
        port.batch_predict([img], conf, IOU)
        assert not gc.isenabled()
    finally:
        gc.enable()
