"""YoloTask's segment task end to end on the CPU, float32, at 64 px:
train() of v8n, v11n, v12n and v5un for two epochs on a PNG polygon
dataset (epoch 1 through the mosaic: the device render of images and
masks, or the host mosaic4 + random_perspective; epoch 2 letterbox), its
outputs, and the trained best.bin served by a fresh task with masks; the
End2End gain schedule that the segment task takes; the task that still
raises (classify)."""

import os

import numpy as np
import pytest

from test_torch_seg_data import make_seg_dataset
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask, YoloType)
from yolosharp_tpu_torch.data import augment, device_augment
from yolosharp_tpu_torch.tasks import Classifier, Detector, Segmenter

NC = 3


@pytest.fixture(scope="module")
def seg_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seg_train_pngs"))
    make_seg_dataset(root, 4, 2, [(64, 48), (48, 64), (64, 64)], NC, seed=2)
    return root


def _config(root, out, version, **kw):
    return Config(task_type=TaskType.segment, yolo_type=YoloType(version),
                  yolo_size=YoloSize.n, number_class=NC,
                  scalar_type=ScalarType.float32, root_path=root,
                  train_data_path="images/train",
                  val_data_path="images/val", output_path=out,
                  image_size=64, batch_size=2, epochs=2, close_mosaic=1,
                  workers=1, **kw)


@pytest.mark.parametrize("version,end2end,device_render",
                         [("v8", False, True), ("v11", True, True),
                          ("v12", True, False), ("v5u", False, False)])
def test_segment_train_two_epochs(seg_root, tmp_path, monkeypatch, version,
                                  end2end, device_render):
    """Epoch 1 under the mosaic (the device render draws the masks with
    the images, or the host mosaic4 carries them), epoch 2 on letterbox
    batches; both write their weights, the log has the five loss columns
    and the eight metrics with finite values, and best.bin served by a
    fresh Segmenter gives rows with (h, w) bool masks."""
    renders, mosaics = [], []
    real_render, real_mosaic = device_augment.render_masks, augment.mosaic4
    monkeypatch.setattr(device_augment, "render_masks",
                        lambda b: renders.append(1) or real_render(b))
    monkeypatch.setattr(augment, "mosaic4",
                        lambda *a: mosaics.append(1) or real_mosaic(*a))
    out = str(tmp_path / version)
    task = YoloTask(_config(seg_root, out, version, end2end=end2end,
                            device_augment=device_render), device="cpu")
    task.train()
    assert [s["epoch"] for s in task.task.epoch_stats] == [1, 2]
    if device_render:
        assert len(renders) == 2 and not mosaics   # 4 images, batch 2
    else:
        assert not renders and len(mosaics) == 4
    for f in ("config.txt", "log.csv", "weights/best.bin", "weights/last.bin",
              "weights/last_state.npz"):
        assert os.path.exists(os.path.join(out, f)), f
    rows = open(os.path.join(out, "log.csv")).read().strip().splitlines()
    head = [h.strip() for h in rows[0].split(",")]
    assert "train/seg_loss" in head and "metrics/mAP50-95(M)" in head
    values = np.array([float(v) for v in rows[-1].split(",")])
    assert len(rows) == 3 and np.isfinite(values).all()

    fresh = YoloTask(_config(seg_root, out, version, end2end=end2end),
                     device="cpu")
    fresh.load_model(os.path.join(out, "weights", "best.bin"))
    img = np.random.default_rng(0).integers(0, 256, (50, 70, 3), np.uint8)
    res = fresh.image_predict(img, 0.0, 0.7)
    assert res and all(r.mask.shape == (50, 70) and r.mask.dtype == np.bool_
                       for r in res)


def test_segment_takes_the_end2end_gain_schedule():
    """The task comes from Config.task_type, so End2End segment gets the
    o2m / o2o gains (0.8 / 0.2 at epoch 1 of 10), as the JAX package gives
    every task but detect; End2End detect sums both branches at 1.0."""
    kw = dict(yolo_size=YoloSize.n, number_class=NC, epochs=10,
              end2end=True)
    seg = YoloTask(Config(task_type=TaskType.segment, **kw), device="cpu")
    det = YoloTask(Config(**kw), device="cpu")
    assert isinstance(seg.task, Segmenter) and seg.task.arch.task == "segment"
    assert type(det.task) is Detector and det.task.arch.task == "detect"
    gains = seg.task._loss_kwargs(1)
    assert gains["o2m_gain"] == pytest.approx(0.8)
    assert gains["o2o_gain"] == pytest.approx(0.2)
    assert det.task._loss_kwargs(1) == {}


@pytest.mark.parametrize("task", [TaskType.classify])
def test_the_other_tasks_still_raise(task):
    """Classify raised here until it was ported; the facade now gives it a
    Classifier, with End2End off whatever Config.end2end says, as the JAX
    package's BaseTask does."""
    cls = YoloTask(Config(task_type=task), device="cpu")
    assert isinstance(cls.task, Classifier)
    assert cls.task.arch.task == "classify" and not cls.task.arch.end2end
