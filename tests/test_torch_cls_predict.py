"""The port's classify predict (YoloTask with TaskType.classify, CPU,
float32) against the JAX Classifier on the same weights: image_predict and
batch_predict squash each image to s x s (the JAX package's cv2.resize,
here resize_linear) and return the top-5 classes with their softmax
scores, on square and non-square images; the folded predict copy against
the unfolded master."""

import numpy as np
import pytest
import torch

from test_torch_cls_model import IMG, jax_cls_variables
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import ScalarType as JaxScalar
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu.types import YoloType as JaxType
from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask, YoloType)
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.data.image_ops import resize_linear

NC = 10
# softmax scores of float32 logits that agree to ~1e-7
SCORE_ATOL = 1e-5


def images():
    """Square (64x64: no resize), non-square (48x80, 100x37: squashed)
    smooth images."""
    out = []
    for seed, (h, w) in enumerate(((IMG, IMG), (48, 80), (100, 37))):
        rng = np.random.default_rng(seed)
        low = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(low, np.ones((8, 8, 1)))[:h, :w]
        out.append(np.clip(img + rng.normal(0, 10, img.shape), 0,
                           255).astype(np.uint8))
    return out


@pytest.fixture(scope="module", params=["v8", "v5u", "v11", "v12"])
def tasks(request):
    version = request.param
    jtask = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.classify, yolo_type=JaxType(version),
        yolo_size=JaxSize.n, number_class=NC, image_size=IMG,
        scalar_type=JaxScalar.float32))
    _, variables = jax_cls_variables(version, seed=11)
    jtask.task.variables = variables
    port = YoloTask(Config(task_type=TaskType.classify,
                           yolo_type=YoloType(version), yolo_size=YoloSize.n,
                           number_class=NC, image_size=IMG,
                           scalar_type=ScalarType.float32), device="cpu")
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)
    return port, jtask


def assert_top5_match(got, want):
    """The same classes in the same order (where two scores are within
    SCORE_ATOL the order may swap), scores to SCORE_ATOL."""
    assert len(got) == len(want) == 5
    gs = np.array([r.score for r in got])
    ws = np.array([r.score for r in want])
    np.testing.assert_allclose(gs, ws, atol=SCORE_ATOL)
    assert np.all(np.diff(gs) <= 0)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.class_id != w.class_id:
            assert abs(ws[i] - ws[min(i + 1, 4)]) < SCORE_ATOL or \
                abs(ws[i] - ws[max(i - 1, 0)]) < SCORE_ATOL
    assert all(r.width == r.height == 0 and r.mask is None for r in got)


def test_image_predict_matches_jax(tasks):
    port, jtask = tasks
    for img in images():
        assert_top5_match(port.image_predict(img),
                          jtask.image_predict(img))


def test_batch_predict_matches_jax_and_image_predict(tasks):
    """One batch of the three images: each list equal to the JAX batch's
    and to the port's image_predict of the image."""
    port, jtask = tasks
    imgs = images()
    got = port.batch_predict(imgs)
    want = jtask.batch_predict(imgs)
    assert len(got) == len(want) == 3
    for g, w, img in zip(got, want, imgs):
        assert_top5_match(g, w)
        assert_top5_match(g, port.image_predict(img))


def test_predict_copy_matches_the_master(tasks):
    """The folded predict copy's softmax against the unfolded eval-mode
    master's on the squashed images, to 1e-6."""
    port, _ = tasks
    task = port.task
    batch = np.stack([resize_linear(im, IMG, IMG) for im in images()])
    x = torch.from_numpy(batch)
    got = task._probs(task._predict_variables(), x)
    with torch.no_grad():
        logits = task.net(x.permute(0, 3, 1, 2).float() / 255.0)["cls"]
    np.testing.assert_allclose(got.numpy(), torch.softmax(logits, -1).numpy(),
                               atol=1e-6)
    assert got.shape == (3, NC) and got.dtype == torch.float32
