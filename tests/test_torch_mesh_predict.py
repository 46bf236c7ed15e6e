"""batch_predict and predict_stream over a mesh (the ``mesh`` argument,
parallel.create_mesh): on a 2-entry CPU mesh, for all five task families,
equal to the unsharded calls with n + 1 images (a padded shard); the
detect rows against the JAX package's batch_predict over a 2-device mesh;
and dryrun_multichip(2)."""

import jax
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_predict import (IOU, NC, assert_results_match,
                                synthetic_image)
from util_calib import calibrate_task
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.parallel import create_mesh as jax_create_mesh
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu.types import YoloType as JaxType
from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask, YoloType)
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.graft_entry import dryrun_multichip
from yolosharp_tpu_torch.parallel import create_mesh

MESH = create_mesh(devices=["cpu", "cpu"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = {
    "detect": dict(task_type=TaskType.detect),
    "detect_e2e": dict(task_type=TaskType.detect, end2end=True),
    "segment": dict(task_type=TaskType.segment),
    "pose": dict(task_type=TaskType.pose, number_class=1),
    "obb": dict(task_type=TaskType.obb),
    "classify": dict(task_type=TaskType.classify),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    kw = {"yolo_size": YoloSize.n, "number_class": 5, "image_size": 64,
          "scalar_type": ScalarType.float32, "end2end": False,
          **FAMILIES[request.param]}
    task = YoloTask(Config(**kw), device="cpu")
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((64, 64), (48, 64), (64, 40))]
    return request.param, task, images


def assert_same(got, want, name):
    """Result lists equal: classes, integer boxes, scores to 1e-5, masks,
    keypoints and angles to float32 rounding."""
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (name, i)
        for a, b in zip(g, w):
            assert (a.class_id, a.center_x, a.center_y, a.width,
                    a.height) == (b.class_id, b.center_x, b.center_y,
                                  b.width, b.height), (name, i)
            assert abs(a.score - b.score) < 1e-5, (name, i)
            assert abs((a.radian or 0) - (b.radian or 0)) < 1e-5
            if b.mask is not None:
                assert a.mask.shape == b.mask.shape
                assert (np.asarray(a.mask) == np.asarray(b.mask)).mean() \
                    > 0.999
            if b.keypoints is not None:
                np.testing.assert_allclose(
                    [[k.x, k.y, k.visibility] for k in a.keypoints],
                    [[k.x, k.y, k.visibility] for k in b.keypoints],
                    atol=1e-3)


def test_mesh_batch_predict_equals_unsharded(family):
    """Three images over two CPU devices (the second shard padded with a
    repeat of the last image) give the unsharded call's results."""
    name, task, images = family
    conf = 0.0 if name != "obb" else 0.001
    want = task.batch_predict(images, conf)
    got = task.batch_predict(images, conf, mesh=MESH)
    assert any(len(r) for r in want)
    assert_same(got, want, name)


def test_mesh_predict_stream_equals_unsharded(family):
    """A stream of five images at batch 3 over the mesh (rounded up to 4,
    two rows a device; the last batch one real image) gives the unsharded
    stream's results, in order."""
    name, task, images = family
    conf = 0.0 if name != "obb" else 0.001
    stream = images + images[:2]
    want = list(task.predict_stream(iter(stream), batch_size=2, imgsz=64,
                                    predict_threshold=conf, workers=1))
    got = list(task.predict_stream(iter(stream), batch_size=3, imgsz=64,
                                   predict_threshold=conf, workers=2,
                                   mesh=MESH))
    assert len(got) == len(stream)
    assert_same(got, want, name)


def test_2d_mesh_splits_rows_over_its_data_axis():
    """On a (2, 2) mesh (data 2, model 2) the rows go over the data axis
    only, one replica a data-axis entry: 5 images through batch_predict,
    and a stream of 7 at batch 6 (not a multiple of the 4 devices) give
    the unsharded calls' results, every image once, in order."""
    mesh = create_mesh((2, 2), devices=["cpu"] * 4)
    assert len(mesh.data_devices) == 2
    task = YoloTask(Config(yolo_size=YoloSize.n, number_class=5,
                           image_size=64, end2end=False,
                           scalar_type=ScalarType.float32), device="cpu")
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (64, 48 + 8 * i, 3), dtype=np.uint8)
              for i in range(7)]
    assert_same(task.batch_predict(images[:5], 0.0, mesh=mesh),
                task.batch_predict(images[:5], 0.0), "batch_predict")
    want = list(task.predict_stream(iter(images), batch_size=6, imgsz=64,
                                    predict_threshold=0.0, workers=1))
    got = list(task.predict_stream(iter(images), batch_size=6, imgsz=64,
                                   predict_threshold=0.0, workers=2,
                                   mesh=mesh))
    assert len(got) == len(images)
    assert_same(got, want, "predict_stream")


def test_mesh_batch_predict_matches_jax_mesh():
    """The detect rows of three synthetic images by the port over a
    2-entry CPU mesh against the JAX package's batch_predict over 2
    virtual devices, same weights (the calibrated v8n of
    test_torch_predict): each image by assert_results_match."""
    kw = dict(yolo_type=JaxType.v8, yolo_size=JaxSize.n, number_class=NC,
              end2end=False, nms_pre_topk=2048)
    det = JaxYoloTask(JaxConfig(host_s2d=False, task_type=JaxTaskType.detect,
                                **kw)).task
    calibrate_task(det)
    det.variables = jitter_bn(det.variables, seed=2)
    port = YoloTask(Config(task_type=TaskType.detect, yolo_type=YoloType.v8,
                           yolo_size=YoloSize.n, number_class=NC,
                           end2end=False, nms_pre_topk=2048,
                           scalar_type=ScalarType.float32), device="cpu")
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(det.variables), strict=True)
    images = [synthetic_image(seed=s) for s in (0, 1, 2)]
    conf = 0.25
    want = det.batch_predict(images, conf, IOU,
                             mesh=jax_create_mesh(devices=jax.devices()[:2]))
    got = port.batch_predict(images, conf, IOU, mesh=MESH)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_results_match(g, w)


def test_dryrun_multichip_two_ranks(capsys):
    """dryrun_multichip(2): the six DP steps over 2 gloo ranks give finite
    losses, and the mesh batch_predict of 3 images runs."""
    losses = dryrun_multichip(2)
    assert set(losses) == {"loss", "fsdp_loss", "pose_loss", "seg_loss",
                           "obb_e2e_loss", "cls_loss"}
    assert all(np.isfinite(v) for v in losses.values())
    np.testing.assert_allclose(losses["fsdp_loss"], losses["loss"],
                               rtol=1e-6)
    assert "dryrun_multichip(2) OK:" in capsys.readouterr().out
