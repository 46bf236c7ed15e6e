"""The port's OBB training against the JAX package on the CPU, float32:
one v11n-obb End2End train step against the jitted JAX make_train_step
(loss items, parameter changes where the gradient fixes AdamW's first
update, BN statistics), val (the four loss items and the four box metrics,
matched by probiou) against the JAX Obber's val on the same weights and
data, and YoloTask.train() of v8n, v11n, v12n and v5un OBB for two epochs
(the mosaic, then letterbox) with the trained weights served by a fresh
task."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
from test_torch_obb_data import _same_images, make_obb_dataset
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from test_torch_train import check_step_pair
from yolosharp_tpu import train as jax_train
from yolosharp_tpu.ckpt import state_dict_to_variables
from yolosharp_tpu.ckpt.fuse import bias_init as jax_bias_init
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data.dataset import YoloDataset as JaxDataset
from yolosharp_tpu.data.loader import DataLoader as JaxLoader
from yolosharp_tpu.nn import ArchCfg as JaxArch
from yolosharp_tpu.nn import YoloNet as JaxNet
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu.types import YoloType as JaxType
from yolosharp_tpu_torch import (Config, Obber, ScalarType, TaskType,
                                 YoloSize, YoloTask, YoloType)
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.data import DataLoader, YoloDataset, augment
from yolosharp_tpu_torch.data import device_augment
from yolosharp_tpu_torch.data.image_ops import read_image_rgb
from yolosharp_tpu_torch.nn import ArchCfg, ConvBN, YoloNet
from yolosharp_tpu_torch.ops import xywhr2xyxyxyxy, xyxyxyxy2xywhr
from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                       make_train_step)
from yolosharp_tpu_torch.types import ImageProcessType

NC = 3
GAINS = {"o2m_gain": 0.8, "o2o_gain": 0.2}   # epoch 1 of 10


def _obb_batch(seed, b=2, m=8, size=64):
    """A uint8 batch of b random images with 5 and 3 rotated boxes
    (normalised xywh and the angle, as minAreaRect gives them)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    rb = np.concatenate([rng.uniform(0.25, 0.75, (b, m, 2)) * size,
                         rng.uniform(0.1, 0.4, (b, m, 2)) * size,
                         rng.uniform(-math.pi, math.pi, (b, m, 1))], -1)
    rb = xyxyxyxy2xywhr(xywhr2xyxyxyxy(torch.from_numpy(rb)).numpy())
    rb[..., :4] /= size
    valid = np.zeros((b, m), bool)
    for i, n in enumerate((5, 3, 4, 2)[:b]):
        valid[i, :n] = True
    return {"images": images,
            "cls": rng.integers(0, NC, (b, m)).astype(np.int32),
            "bboxes": np.where(valid[..., None], rb, 0).astype(np.float32),
            "mask_gt": valid}


def _port_config(**kw):
    return Config(task_type=TaskType.obb, yolo_size=YoloSize.n,
                  number_class=NC, scalar_type=ScalarType.float32, **kw)


def test_obb_train_step_matches_jax():
    """One float32 v11n-obb End2End step at 64x64, batch 2 (the o2m / o2o
    gains of epoch 1 of 10: one2many at TAL top-k 10, one2one at 7 then
    1) against the JAX step. v11n, not v12n: the jitted JAX v12n-obb step
    compiles in more than 300 s on an 8-core CPU. Loss items to 1e-4
    relative; parameter changes at the rule of
    tests/test_torch_pose_train.py
    (within one float32 spacing of the parameter more, where |g| > 1e-2
    max|g|, on at least 60% of the elements); running statistics to 1e-4
    of their tensor's largest. SPPF's cv1 BN bias is left out (zero
    gradient by construction)."""
    batch = _obb_batch(5)
    jnet = JaxNet(JaxArch(version="v11", size="n", task="obb", nc=NC,
                          end2end=True))
    variables = jitter_bn(jax_bias_init(jnet.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)), False), NC), 5)
    jtask = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.obb, yolo_type=JaxType.v11,
        yolo_size=JaxSize.n, number_class=NC, scalar_type="float32",
        end2end=True)).task
    tx = jax_train.make_optimizer(nc=NC, epochs=2, steps_per_epoch=1)
    jstate = jax_train.TrainState.create(variables, tx)
    jstep = jax_train.make_train_step(jnet, jtask._loss_fns()[0],
                                      donate=False)
    jnew, jl, jitems = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, GAINS)

    obb = YoloTask(_port_config(yolo_type=YoloType.v11, end2end=True),
                   device="cpu").task
    assert isinstance(obb, Obber)
    net = YoloNet(ArchCfg(version="v11", size="n", task="obb", nc=NC,
                          end2end=True))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    net = net.to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=NC, epochs=2, steps_per_epoch=1)
    state = TrainState(net, opt, scheds)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    loss, items = make_train_step(obb._loss_fns()[0])(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, GAINS)
    assert items.shape == (4,) and float(items[3]) > 0
    print(f"items: port {items.numpy().tolist()}, JAX "
          f"{np.asarray(jitems).tolist()}")
    check_step_pair(dict(state=state, before=before, loss=float(loss),
                         items=items.numpy(), variables=variables,
                         jnew=jnew, jloss=float(jl),
                         jitems=np.asarray(jitems)),
                    items_rtol=1e-4, stats_rtol=1e-4, ulp=True,
                    grad_noise=1e-2, min_checked=0.6,
                    skip=("model.9.cv1.bn.bias",))
    angle_w = net.model[-1].one2one_cv4[0][2].weight
    assert angle_w.grad is not None and angle_w.grad.abs().max() > 0


def _self_labelled_val(root, port, seed=4):
    """Val images labelled from the port's own first four detections
    (conf 0.1): each rotated box's corners moved by up to 2 pixels (the
    last detection's by up to 6), and one random rotated box: probiou
    matches at many thresholds, misses and false positives. Images are
    64x64, so val pads them to 96x96 with 16 pixels on each side."""
    make_obb_dataset(root, 1, 4, [(64, 64)], NC, seed=seed)
    rng = np.random.default_rng(seed)
    vdir = os.path.join(root, "images", "val")
    for name in sorted(os.listdir(vdir)):
        img = read_image_rgb(os.path.join(vdir, name))
        canvas = np.full((96, 96, 3), 114, np.uint8)
        canvas[16:80, 16:80] = img
        rows = []
        res = port.image_predict(canvas, 0.1, 0.7)[:4]
        assert len(res) == 4
        for i, r in enumerate(res):
            rb = torch.tensor([[r.center_x - 16.0, r.center_y - 16.0,
                                float(r.width), float(r.height), r.radian]])
            spread = 6 if i == 3 else 2
            cor = (xywhr2xyxyxyxy(rb)[0].numpy()
                   + rng.uniform(-spread, spread, (4, 2))) / 64
            rows.append(f"{r.class_id} " + " ".join(
                f"{v:.6f}" for v in cor.reshape(-1)))
        c = rng.uniform(0.3, 0.7, 2)
        rand = np.array([[c[0] - 0.2, c[1] - 0.1], [c[0] + 0.2, c[1] - 0.1],
                         [c[0] + 0.2, c[1] + 0.1], [c[0] - 0.2, c[1] + 0.1]])
        rows.append(f"{rng.integers(NC)} " + " ".join(
            f"{v:.6f}" for v in rand.reshape(-1)))
        label = os.path.join(root, "labels", "val",
                             os.path.splitext(name)[0] + ".txt")
        with open(label, "w") as f:
            f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("end2end", [False, True], ids=["nms", "e2e"])
def test_obb_val_matches_jax(tmp_path, end2end):
    """val of v8n-obb, NMS (the rotated fast NMS at 0.7, every candidate
    above 0.01) or End2End, on the same weights (conv kernels x2.5, the
    head's final box and class convs from U(-0.3, 0.3), so that there are
    detections) on images labelled from its own rotated detections: the
    four loss items to 1e-4 relative and the four box metrics (matched by
    batch_probiou) to 1e-4, every metric non-trivial."""
    root = str(tmp_path)
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", number_class=NC,
                  image_size=64, batch_size=2, end2end=end2end)
    cfg = _port_config(image_process_type=ImageProcessType.letterbox,
                       **{k: v for k, v in common.items()
                          if k != "number_class"})
    port = YoloTask(cfg, device="cpu")
    net = port.task._ensure_variables()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(2.5)
        head = net.model[-1]
        towers = (head.cv2, head.cv3) + ((head.one2one_cv2,
                                          head.one2one_cv3)
                                         if end2end else ())
        for tower in towers:
            for branch in tower:
                for p in (branch[2].weight, branch[2].bias):
                    p.copy_(torch.from_numpy(
                        rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)))
    _self_labelled_val(root, port)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    jcfg = JaxConfig(task_type=JaxTaskType.obb, yolo_size=JaxSize.n,
                     scalar_type="float32", image_process_type="letterbox",
                     **common)
    obb = JaxYoloTask(jcfg).task
    obb.variables, report = state_dict_to_variables(
        sd, obb._ensure_variables())
    assert not report.missing
    jds = JaxDataset(jcfg, is_val=True)
    want_items, want_metrics = obb.val(
        JaxLoader(jds, 2, shuffle=False, workers=1,
                  max_labels=jds.max_label_count), 0)
    ds = YoloDataset(cfg, is_val=True)
    _same_images(ds, jds)
    got_items, got_metrics = port.val(
        DataLoader(ds, 2, shuffle=False, workers=1,
                   max_labels=ds.max_label_count))
    assert len(got_items) == 4 and len(got_metrics) == 4
    print(f"metrics: port {np.round(got_metrics, 4).tolist()}, JAX "
          f"{np.round(want_metrics, 4).tolist()}")
    np.testing.assert_allclose(got_items, np.asarray(want_items), rtol=1e-4)
    np.testing.assert_allclose(got_metrics, want_metrics, atol=1e-4)
    assert min(want_metrics) > 0 and max(want_metrics) < 0.99


# ------------------------------------------------------------- train()
@pytest.fixture(scope="module")
def obb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obb_train_pngs"))
    make_obb_dataset(root, 4, 2, [(64, 48), (48, 64), (64, 64)], NC,
                     seed=2)
    return root


def _config(root, out, version, **kw):
    return Config(task_type=TaskType.obb, yolo_type=YoloType(version),
                  yolo_size=YoloSize.n, number_class=NC,
                  scalar_type=ScalarType.float32, root_path=root,
                  train_data_path="images/train",
                  val_data_path="images/val", output_path=out,
                  image_size=64, batch_size=2, epochs=2, close_mosaic=1,
                  workers=1, **kw)


@pytest.mark.parametrize("version,end2end,device_render",
                         [("v8", False, True), ("v11", True, True),
                          ("v12", True, False), ("v5u", False, False)])
def test_obb_train_two_epochs(obb_root, tmp_path, monkeypatch, version,
                              end2end, device_render):
    """Epoch 1 under the mosaic (the device render of planned batches whose
    corners the planner moved, or the host mosaic4 carrying them), epoch 2
    on letterbox batches; both write their weights, the log has the four
    loss columns (angle_loss among them) with finite values, and best.bin
    served by a fresh Obber gives rotated rows."""
    renders, mosaics, boxes = [], [], []
    real_render, real_mosaic = device_augment.render_batch, augment.mosaic4
    monkeypatch.setattr(device_augment, "render_batch",
                        lambda b: boxes.append(tuple(b["bboxes"].shape))
                        or renders.append(1) or real_render(b))
    monkeypatch.setattr(augment, "mosaic4",
                        lambda *a: mosaics.append(1) or real_mosaic(*a))
    out = str(tmp_path / version)
    task = YoloTask(_config(obb_root, out, version, end2end=end2end,
                            device_augment=device_render), device="cpu")
    task.train()
    assert [s["epoch"] for s in task.task.epoch_stats] == [1, 2]
    if device_render:
        assert len(renders) == 2 and not mosaics   # 4 images, batch 2
        assert all(s[-1] == 5 for s in boxes)
    else:
        assert not renders and len(mosaics) == 4
    for f in ("config.txt", "log.csv", "weights/best.bin", "weights/last.bin",
              "weights/last_state.npz"):
        assert os.path.exists(os.path.join(out, f)), f
    rows = open(os.path.join(out, "log.csv")).read().strip().splitlines()
    head = [h.strip() for h in rows[0].split(",")]
    assert "train/angle_loss" in head and "metrics/mAP50-95(B)" in head
    values = np.array([float(v) for v in rows[-1].split(",")])
    assert len(rows) == 3 and np.isfinite(values).all()

    fresh = YoloTask(_config(obb_root, out, version, end2end=end2end),
                     device="cpu")
    report = fresh.load_model(os.path.join(out, "weights", "best.bin"))
    assert not report.unexpected and not report.skipped
    img = np.random.default_rng(0).integers(0, 256, (50, 70, 3), np.uint8)
    res = fresh.image_predict(img, 0.0, 0.7)
    assert res and all(-math.pi / 4 <= r.radian < 3 * math.pi / 4
                       for r in res)
