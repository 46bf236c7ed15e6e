"""The port's OBB predict slice against the JAX package, float32 on the
CPU: decode_inference and decode_inference_topk with an angle (rotated
centre-form xywh in NMS and End2End decodes alike, the angle the last
extra) on random head maps, then YoloTask with TaskType.obb against the
JAX Obber with the same seeded weights on a synthetic image: the predict
function's rows (the rotated fast NMS with select-then-decode and
untruncated, and End2End), and image_predict / batch_predict YoloResults
with their radian."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_predict import canvas, synthetic_image
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from util_calib import calibrate_task
from yolosharp_tpu import predict as jax_predict
from yolosharp_tpu.ckpt.mapping import clone_one2one as jax_clone_one2one
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType, YoloSize, YoloType
from yolosharp_tpu_torch import Config, Obber, ScalarType
from yolosharp_tpu_torch import TaskType as PortTaskType
from yolosharp_tpu_torch import YoloSize as PortYoloSize
from yolosharp_tpu_torch import YoloTask
from yolosharp_tpu_torch import YoloType as PortYoloType
from yolosharp_tpu_torch import predict as port_predict
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.loss import flatten_levels

NC = 3
# the calibrated untrained nets' boxes are large and overlap: a high NMS
# threshold keeps enough rows to compare
IOU = 0.9
LEVELS = ((8, 12), (4, 6), (2, 3))      # a 64x96 canvas


def _branch(rng, b=2):
    """NHWC raw maps of an OBB branch: box (64), cls (NC) and the head's
    angle, in [-pi/4, 3pi/4)."""
    def maps(c, scale, shift=0.0):
        return [(rng.standard_normal((b, h, w, c)) * scale + shift).astype(
            np.float32) for h, w in LEVELS]

    angle = [rng.uniform(-math.pi / 4, 3 * math.pi / 4, (b, h, w, 1))
             .astype(np.float32) for h, w in LEVELS]
    return {"box": maps(64, 1.0), "cls": maps(NC, 1.5, -1.0),
            "angle": angle}


def _torch_branch(branch):
    return {k: tuple(torch.from_numpy(m).permute(0, 3, 1, 2) for m in v)
            for k, v in branch.items()}


@pytest.mark.parametrize("end2end", [False, True], ids=["nms", "e2e"])
def test_decode_inference_angle_matches_jax(end2end):
    """The decode's (B, 4 + nc + 1, A) tensor against the JAX package's:
    dist2rbox's rotated xywh in pixels (End2End too: an OBB box is never
    xyxy) and the angle last, to 1e-4 + 1e-5|ref| (the DFL softmax rounds
    in another order); then e2e_postprocess carries the angle as the rows'
    extra."""
    branch = _branch(np.random.default_rng(1 + end2end))
    want = np.asarray(jax_predict.decode_inference(
        {n: [jnp.asarray(m) for m in v] for n, v in branch.items()},
        nc=NC, end2end=end2end))
    got = port_predict.decode_inference(_torch_branch(branch),
                                        end2end=end2end)
    assert got.shape == want.shape == (2, 4 + NC + 1, 126)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    flat = flatten_levels(_torch_branch(branch)["angle"])[..., 0]
    np.testing.assert_array_equal(got[:, -1].numpy(), flat.numpy())
    if end2end:
        rows = port_predict.e2e_postprocess(got.transpose(-1, -2), nc=NC,
                                            max_det=50)
        jrows = jax_predict.e2e_postprocess(
            jnp.asarray(want).swapaxes(-1, -2), nc=NC, max_det=50, extra=1)
        assert rows.shape == (2, 50, 7)
        np.testing.assert_allclose(rows.numpy(), np.asarray(jrows),
                                   atol=1e-4, rtol=1e-5)


def test_decode_inference_topk_angle_matches_jax():
    """Select-then-decode of the top 40 anchors: the selected rotated rows
    with their angle and the truncation flag equal the JAX package's (to
    1e-4 + 1e-5|ref|), and each row is the full decode's row of its
    anchor."""
    branch = _branch(np.random.default_rng(3))
    kw = dict(conf_thres=0.3, k=40)
    want, wtrunc = jax_predict.decode_inference_topk(
        {n: [jnp.asarray(m) for m in v] for n, v in branch.items()},
        nc=NC, **kw)
    got, trunc = port_predict.decode_inference_topk(_torch_branch(branch),
                                                    **kw)
    assert got.shape == (2, 4 + NC + 1, 40)
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(wtrunc))
    assert trunc.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    full = port_predict.decode_inference(_torch_branch(branch))
    cls = flatten_levels(_torch_branch(branch)["cls"]).amax(-1)
    idx = cls.topk(40, dim=-1).indices
    ref = full.gather(2, idx[:, None].expand(-1, full.shape[1], -1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-6)


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module", params=[("v8", False, 2048),
                                        ("v8", False, None),
                                        ("v8", True, 2048),
                                        ("v12", True, 2048)],
                ids=["v8_nms_topk", "v8_nms_exact", "v8_e2e", "v12_e2e"])
def tasks(request):
    version, end2end, pre_topk = request.param
    kw = dict(task_type=TaskType.obb, yolo_type=YoloType(version),
              yolo_size=YoloSize.n, number_class=NC, end2end=end2end,
              nms_pre_topk=pre_topk)
    obb = JaxYoloTask(JaxConfig(host_s2d=False, fuse_inference=False,
                                **kw)).task
    calibrate_task(obb)
    variables = jitter_bn(obb.variables, seed=2)
    if end2end:
        variables = jax_clone_one2one(variables)
    obb.variables = variables
    port_kw = dict(kw, task_type=PortTaskType(kw["task_type"].value),
                   yolo_type=PortYoloType(kw["yolo_type"].value),
                   yolo_size=PortYoloSize(kw["yolo_size"].value))
    port = YoloTask(Config(scalar_type=ScalarType.float32, **port_kw),
                    device="cpu")
    assert isinstance(port.task, Obber)
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)
    img = synthetic_image()
    x = torch.from_numpy(canvas(img)).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        preds = port.task._predict_variables()(x)
    branch = preds["one2one" if end2end else "one2many"]
    flat = flatten_levels(branch["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 150 / flat.shape[1]))
    return dict(end2end=end2end, obb=obb, port=port, img=img, conf=conf)


def assert_rows_match(got, want, px=0.5, rad=1e-4):
    """Rotated rows (xywhr, score, class): counts within 2 (threshold-edge
    flips), each reference row reproduced by one of the same class within
    `px` pixels (centre and sides), `rad` radians and 1e-3 score, at most
    max(2, n/50) unmatched."""
    gb, gs, gc = got
    wb, ws, wc = want
    assert len(wb) > 5
    assert abs(len(gb) - len(wb)) <= 2, (len(gb), len(wb))
    used = np.zeros(len(gb), bool)
    unmatched = 0
    for b, s, c in zip(wb, ws, wc):
        d = (np.abs(gb[:, :4] - b[:4]).max(1) + 1e3 * (gc != c)
             + 1e3 * (np.abs(gb[:, 4] - b[4]) > rad))
        j = int(np.argmin(d + 1e6 * used))
        if d[j] < px and abs(gs[j] - s) < 1e-3:
            used[j] = True
        else:
            unmatched += 1
    assert unmatched <= max(2, len(wb) // 50), unmatched


def test_predict_fn_matches_jax(tasks):
    """The rows of the predict function, xywhr: centre and sides within
    0.5 px, the angle within 1e-4 rad, scores 1e-3 (the match rule of
    tests/test_torch_predict.py for rotated rows)."""
    obb, port, conf, e2e = (tasks["obb"], tasks["port"].task,
                            tasks["conf"], tasks["end2end"])
    arr = canvas(tasks["img"])
    want = jax.device_get(obb._predict_fn(arr.shape)(
        obb._predict_variables(), jnp.asarray(arr), conf, IOU))
    got = port._host(port._predict_fn(port._predict_variables(),
                                      torch.from_numpy(arr),
                                      0.0 if e2e else conf, IOU))
    if not e2e:
        assert got.boxes.shape[-1] == 5
        assert not got.truncated.any() and not want.truncated.any()
        want = type(got)(*(np.asarray(t) for t in want))
    else:
        want = np.asarray(want)
    assert_rows_match(port._rboxes(got, 0, conf), port._rboxes(want, 0,
                                                                conf))


def _result_rows(results):
    rs = sorted(results, key=lambda r: -r.score)
    return (np.array([[r.center_x, r.center_y, r.width, r.height, r.radian]
                      for r in rs], float).reshape(-1, 5),
            np.array([r.score for r in rs]),
            np.array([r.class_id for r in rs]))


def test_image_and_batch_predict_match_jax(tasks):
    """image_predict of a 316x236 image and batch_predict of it with a
    200x180 image: the YoloResults' int-truncated centres and sides (within
    1.5 px), radians (1e-4) and scores equal to the JAX Obber's; every row
    has w, h > 0 and an angle in [-pi/4, 3pi/4)."""
    obb, port, conf, img = (tasks["obb"], tasks["port"], tasks["conf"],
                            tasks["img"])
    want = obb.image_predict(img, conf, IOU)
    got = port.image_predict(img, conf, IOU)
    assert_rows_match(_result_rows(got), _result_rows(want), px=1.5)
    rows = _result_rows(got)[0]
    assert (rows[:, 2:4] >= 0).all()
    assert ((rows[:, 4] >= -math.pi / 4) & (rows[:, 4] < 3 * math.pi / 4)
            ).all()
    assert all(isinstance(r.center_x, int) for r in got)

    small = synthetic_image(200, 180, seed=1)
    jbatch = obb.batch_predict([img, small], conf, IOU)
    batch = port.batch_predict([img, small], conf, IOU)
    assert len(batch) == 2
    for got_i, want_i in zip(batch, jbatch):
        assert_rows_match(_result_rows(got_i), _result_rows(want_i), px=1.5)
