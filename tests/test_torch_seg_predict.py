"""The port's segment predict slice (YoloTask with TaskType.segment, CPU,
float32) against the JAX Segmenter with the same seeded weights on a
synthetic image: the predict function's rows (NMS with select-then-decode,
and End2End), and image_predict / batch_predict YoloResults with their
masks (bool, the image's own height and width)."""

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
from yolosharp_tpu.ckpt.mapping import clone_one2one as jax_clone_one2one
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType, YoloSize, YoloType
from yolosharp_tpu_torch import Config, ScalarType, YoloTask
from yolosharp_tpu_torch import TaskType as PortTaskType
from yolosharp_tpu_torch import YoloSize as PortYoloSize
from yolosharp_tpu_torch import YoloType as PortYoloType
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.loss import flatten_levels
from yolosharp_tpu_torch.tasks import Segmenter

NC = 7


@pytest.fixture(scope="module", params=[("v8", False), ("v8", True),
                                        ("v11", True)],
                ids=["v8_nms", "v8_e2e", "v11_e2e"])
def tasks(request):
    version, end2end = request.param
    kw = dict(task_type=TaskType.segment, yolo_type=YoloType(version),
              yolo_size=YoloSize.n, number_class=NC, end2end=end2end,
              nms_pre_topk=2048)
    seg = JaxYoloTask(JaxConfig(host_s2d=False, fuse_inference=False,
                                **kw)).task
    calibrate_task(seg)
    variables = jitter_bn(seg.variables, seed=2)
    if end2end:
        variables = jax_clone_one2one(variables)
    seg.variables = variables
    port_kw = dict(kw, task_type=PortTaskType(kw["task_type"].value),
                   yolo_type=PortYoloType(kw["yolo_type"].value),
                   yolo_size=PortYoloSize(kw["yolo_size"].value))
    port = YoloTask(Config(scalar_type=ScalarType.float32, **port_kw),
                    device="cpu")
    assert isinstance(port.task, Segmenter)
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)
    img = synthetic_image()
    x = torch.from_numpy(canvas(img)).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        preds = port.task._predict_variables()(x)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 150 / flat.shape[1]))
    return dict(end2end=end2end, seg=seg, port=port, img=img, conf=conf)


def test_predict_fn_matches_jax(tasks):
    """The rows of the predict function (boxes 0.5 px, scores 1e-3, by the
    match rule of tests/test_torch_predict.py), their 32 mask coefficients
    to 1e-3 + 1e-3|ref| on the matched rows, and the proto (1, 32, 80, 64)
    to 1e-4 + 1e-4|ref|."""
    seg, port, conf, e2e = (tasks["seg"], tasks["port"].task, tasks["conf"],
                            tasks["end2end"])
    arr = canvas(tasks["img"])
    want = jax.device_get(seg._predict_fn(arr.shape)(
        seg._predict_variables(), jnp.asarray(arr), conf, IOU))
    got = port._host(port._predict_fn(port._predict_variables(),
                                      torch.from_numpy(arr),
                                      0.0 if e2e else conf, IOU))
    key = "rows" if e2e else "nms"
    if not e2e:
        assert not got[key].truncated.any() and not want[key].truncated.any()
    g = port._rows(got[key], 0, conf)
    w = port._rows(want[key] if e2e else type(got[key])(
        *(np.asarray(t) for t in want[key])), 0, conf)
    assert_match(g[:3], w[:3])
    # the coefficients of the rows that match by box and class
    d = np.abs(g[0][None] - w[0][:, None]).max(-1) + 1e3 * (
        g[2][None] != w[2][:, None])
    j = d.argmin(1)
    ok = d[np.arange(len(j)), j] < 0.5
    assert ok.mean() > 0.95
    np.testing.assert_allclose(g[3][j[ok]], w[3][ok], atol=1e-3, rtol=1e-3)
    proto = got["proto"].permute(0, 2, 3, 1).numpy()
    assert proto.shape == (1, 80, 64, 32)
    np.testing.assert_allclose(proto, np.asarray(want["proto"]), atol=1e-4,
                               rtol=1e-4)


def _matched_masks(got, want):
    """(pixels equal, pixels) over the masks of the results of `want`
    matched to `got` by box and class."""
    gb, _, gc = _result_rows(got)
    wb, _, wc = _result_rows(want)
    gs = sorted(got, key=lambda r: -r.score)
    ws = sorted(want, key=lambda r: -r.score)
    same = total = 0
    for i, r in enumerate(ws):
        d = np.abs(gb - wb[i]).max(1) + 1e3 * (gc != wc[i])
        j = int(d.argmin())
        if d[j] <= 1.5:
            assert gs[j].mask.shape == r.mask.shape
            assert gs[j].mask.dtype == np.bool_
            same += int((gs[j].mask == r.mask).sum())
            total += r.mask.size
    return same, total


def test_image_and_batch_predict_match_jax(tasks):
    """image_predict of a 316x236 image and batch_predict of it with a
    200x180 image: the YoloResults' boxes and scores by the match rule of
    tests/test_torch_predict.py, and each matched result's mask (bool, the
    image's own height and width) equal to the JAX Segmenter's on at least
    99.9% of its pixels (a mask value within rounding of 0 can flip;
    measured: every pixel equal)."""
    seg, port, conf, img = (tasks["seg"], tasks["port"], tasks["conf"],
                            tasks["img"])
    want = seg.image_predict(img, conf, IOU)
    got = port.image_predict(img, conf, IOU)
    assert len(want) > 5
    assert_results_match(got, want)
    assert all(r.mask.shape == img.shape[:2] for r in got)
    same, total = _matched_masks(got, want)
    assert total > 0.9 * len(want) * img.shape[0] * img.shape[1]
    print(f"image_predict: {same / total:.6f} of the mask pixels equal")
    assert same >= 0.999 * total

    small = synthetic_image(200, 180, seed=1)
    jbatch = seg.batch_predict([img, small], conf, IOU)
    batch = port.batch_predict([img, small], conf, IOU)
    assert len(batch) == 2
    for got_i, want_i, im in zip(batch, jbatch, (img, small)):
        assert_results_match(got_i, want_i)
        assert all(r.mask.shape == im.shape[:2] for r in got_i)
        same, total = _matched_masks(got_i, want_i)
        assert total > 0 and same >= 0.999 * total
