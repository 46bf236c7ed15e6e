"""predict_stream of the port against the JAX package's, float32 on the CPU,
for all five task families on the same weights: 10 synthetic images of
mixed sizes streamed at batch 4 (the last batch partial: padded with
repeats, the padding dropped), one result list per image, in order, in the
original image's pixels. Detect (v8, NMS), segment (v11, End2End; masks
as float32 from resize_linear_f32 against cv2.resize), pose (v8, NMS;
keypoints un-letterboxed and clipped), OBB (v11, NMS; rotated boxes
scaled back) and classify (v8; the centre crop, top 5). Then the stream
against the port's own batch_predict of the same letterboxed canvases,
mapped back."""

import numpy as np
import pytest
import torch

from test_torch_cls_model import jax_cls_variables
from test_torch_model import jitter_bn
from test_torch_predict import synthetic_image
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from util_calib import calibrate_task
from yolosharp_tpu.ckpt.mapping import clone_one2one as jax_clone_one2one
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import ScalarType as JaxScalar
from yolosharp_tpu.types import TaskType, YoloSize, YoloType
from yolosharp_tpu_torch import Config, ScalarType
from yolosharp_tpu_torch import TaskType as PortTaskType
from yolosharp_tpu_torch import YoloSize as PortYoloSize
from yolosharp_tpu_torch import YoloTask
from yolosharp_tpu_torch import YoloType as PortYoloType
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.data.augment import _resize_pad
from yolosharp_tpu_torch.loss import flatten_levels

S = 128
BATCH = 4
IOU = 0.7
NC = 5
# (h, w) of the streamed images: wide, tall, square, smaller and larger
# than the canvas; 10 of them at batch 4 leave a partial last batch
SIZES = ((96, 128), (128, 96), (70, 150), (150, 70), (128, 128), (50, 60),
         (200, 120), (100, 100), (64, 200), (130, 90))
# each family: (task, version, end2end, candidates an image above conf)
FAMILIES = {"detect": (TaskType.detect, "v8", False, 60),
            "segment": (TaskType.segment, "v11", True, 40),
            "pose": (TaskType.pose, "v8", False, 40),
            "obb": (TaskType.obb, "v11", False, 40)}


def stream_images():
    return [synthetic_image(h, w, seed=20 + i)
            for i, (h, w) in enumerate(SIZES)]


def _port_kw(kw):
    return dict(kw, task_type=PortTaskType(kw["task_type"].value),
                yolo_type=PortYoloType(kw["yolo_type"].value),
                yolo_size=PortYoloSize(kw["yolo_size"].value))


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(name, port YoloTask, JAX task, conf) with the same calibrated
    weights (conv kernels x2.5, the head's final convs from U(-0.3, 0.3),
    BN jittered; End2End towers cloned), conf so that about the family's
    candidate count clears it on the first letterboxed canvas."""
    task_type, version, end2end, cand = FAMILIES[request.param]
    kw = dict(task_type=task_type, yolo_type=YoloType(version),
              yolo_size=YoloSize.n, number_class=NC, end2end=end2end,
              nms_pre_topk=2048, image_size=S)
    jtask = JaxYoloTask(JaxConfig(host_s2d=False, fuse_inference=False,
                                  scalar_type=JaxScalar.float32, **kw))
    calibrate_task(jtask.task)
    variables = jitter_bn(jtask.task.variables, seed=2)
    if end2end:
        variables = jax_clone_one2one(variables)
    jtask.task.variables = variables
    port = YoloTask(Config(scalar_type=ScalarType.float32, **_port_kw(kw)),
                    device="cpu")
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)
    _, _, canvas = _resize_pad(stream_images()[0], S, S, S, S, 114)
    x = torch.from_numpy(canvas[None]).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        preds = port.task._predict_variables()(x)
    branch = preds["one2one" if end2end else "one2many"]
    flat = flatten_levels(branch["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - cand / flat.shape[1]))
    return request.param, port, jtask, conf


def _stream(task, conf):
    return list(task.predict_stream(iter(stream_images()), batch_size=BATCH,
                                    imgsz=S, predict_threshold=conf,
                                    iou_threshold=IOU, workers=2))


def _pairs(got, want):
    """Rows of one image matched by class, box (centre and size, integer
    pixels, within 1) and score (1e-4): [(got row, want row)], after the
    counts are held equal (float32 on the same weights: no row sits at the
    threshold's edge here)."""
    assert len(got) == len(want), (len(got), len(want))
    used, pairs = set(), []
    for w in want:
        cands = [j for j, g in enumerate(got) if j not in used
                 and g.class_id == w.class_id
                 and abs(g.score - w.score) <= 1e-4
                 and max(abs(g.center_x - w.center_x),
                         abs(g.center_y - w.center_y),
                         abs(g.width - w.width),
                         abs(g.height - w.height)) <= 1]
        assert cands, (w, got)
        j = min(cands, key=lambda j: abs(got[j].score - w.score))
        used.add(j)
        pairs.append((got[j], w))
    return pairs


def test_stream_matches_jax(family):
    """One list per image, in order; per image the same rows (_pairs: boxes
    within 1 px, as both truncate to int), their scores in descending
    order where the JAX ones are; per family: masks of the image's (h, w),
    float32, equal within 1e-6 on at least 99.9% of the pixels and
    thresholded at 0.5 equal on 99.9%; keypoints within 1e-3 px,
    visibility within 1e-5; angles within 1e-5 rad. Rows exist."""
    name, port, jtask, conf = family
    got, want = _stream(port, conf), _stream(jtask, conf)
    assert len(got) == len(want) == len(SIZES)
    rows = 0
    same = total = same_bin = 0
    for img_res, (h, w) in zip(zip(got, want), SIZES):
        for g, wr in _pairs(*img_res):
            rows += 1
            if name == "segment":
                assert g.mask.shape == wr.mask.shape == (h, w)
                assert g.mask.dtype == np.float32
                same += int((np.abs(g.mask - wr.mask) <= 1e-6).sum())
                same_bin += int(((g.mask > 0.5) == (wr.mask > 0.5)).sum())
                total += g.mask.size
            if name == "pose":
                gk = np.array([[p.x, p.y, p.visibility] for p in g.keypoints])
                wk = np.array([[p.x, p.y, p.visibility]
                               for p in wr.keypoints])
                assert gk.shape == wk.shape == (17, 3)
                assert np.abs(gk[:, :2] - wk[:, :2]).max() <= 1e-3
                assert np.abs(gk[:, 2] - wk[:, 2]).max() <= 1e-5
                assert (gk[:, 0] <= w).all() and (gk[:, 1] <= h).all()
            if name == "obb":
                assert abs(g.radian - wr.radian) <= 1e-5
    assert rows >= 2 * len(SIZES), rows
    if name == "segment":
        assert same >= 0.999 * total and same_bin >= 0.999 * total


def test_classify_stream_matches_jax():
    """v8n-cls: the centre-cropped images' top 5 (classes, and scores
    within 1e-5) equal to the JAX stream's, in order, and to the port's
    batch_predict of the same crops."""
    from yolosharp_tpu_torch.data.dataset import center_crop

    kw = dict(task_type=TaskType.classify, yolo_type=YoloType.v8,
              yolo_size=YoloSize.n, number_class=10, image_size=64)
    jtask = JaxYoloTask(JaxConfig(scalar_type=JaxScalar.float32, **kw))
    _, variables = jax_cls_variables("v8", seed=13)
    jtask.task.variables = variables
    port = YoloTask(Config(scalar_type=ScalarType.float32, **_port_kw(kw)),
                    device="cpu")
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)
    imgs = stream_images()
    got = list(port.predict_stream(iter(imgs), batch_size=BATCH, workers=2))
    want = list(jtask.predict_stream(iter(imgs), batch_size=BATCH,
                                     workers=2))
    crops = port.batch_predict([center_crop(im, 64) for im in imgs])
    assert len(got) == len(want) == len(crops) == len(SIZES)
    for g, wr, c in zip(got, want, crops):
        assert [r.class_id for r in g] == [r.class_id for r in wr] == \
            [r.class_id for r in c]
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in wr], atol=1e-5)


def test_stream_equals_batch_predict_mapped_back(family):
    """The stream against the port's batch_predict of the same letterboxed
    s x s canvases, each canvas row mapped back through the letterbox:
    the same rows, centre and size within 1 / ratio + 1 px (the canvas
    rows are truncated to integers before the mapping, the stream's
    after), the same scores and classes."""
    name, port, _, conf = family
    imgs = stream_images()
    got = _stream(port, conf)
    packed = [_resize_pad(im, S, S, S, S, 114) for im in imgs]
    canvas_rows = port.batch_predict([c for _, _, c in packed], conf, IOU)
    for g, c, (pl, pu, _), (h, w) in zip(got, canvas_rows, packed, SIZES):
        ratio = min(S / w, S / h)
        assert len(g) == len(c)
        tol = 1 / ratio + 1
        gs = sorted(g, key=lambda r: -r.score)
        cs = sorted(c, key=lambda r: -r.score)
        for a, b in zip(gs, cs):
            assert a.class_id == b.class_id and a.score == b.score
            if name == "obb":
                cx, cy = (b.center_x - pl) / ratio, (b.center_y - pu) / ratio
                bw, bh = b.width / ratio, b.height / ratio
                assert a.radian == b.radian
            else:
                x1 = np.clip((b.center_x - b.width / 2 - pl) / ratio, 0, w)
                x2 = np.clip((b.center_x + b.width / 2 - pl) / ratio, 0, w)
                y1 = np.clip((b.center_y - b.height / 2 - pu) / ratio, 0, h)
                y2 = np.clip((b.center_y + b.height / 2 - pu) / ratio, 0, h)
                cx, cy, bw, bh = (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, \
                    y2 - y1
            assert max(abs(a.center_x - cx), abs(a.center_y - cy),
                       abs(a.width - bw), abs(a.height - bh)) <= tol, \
                (a, b, ratio)
