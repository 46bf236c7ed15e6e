"""The port's segment training against the JAX package on the CPU, float32:
one v8n-seg train step against the jitted JAX make_train_step (loss items,
parameter changes where the gradient fixes AdamW's first update, BN
statistics), and val (the five loss items and the eight box and mask
metrics) against the JAX Segmenter's val on the same weights and data."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_model import jitter_bn
from test_torch_seg_data import _same_records, make_seg_dataset
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
from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask)
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.data import DataLoader, YoloDataset
from yolosharp_tpu_torch.nn import ArchCfg, ConvBN, YoloNet
from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                       make_train_step)
from yolosharp_tpu_torch.types import ImageProcessType

NC = 3


def _seg_batch(seed, b=2, m=8, size=64):
    """A uint8 batch of b random images with 5 and 3 boxes and their
    overlap-id masks at size / 4 (each box's region, later over earlier)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    c = rng.uniform(0.25, 0.75, (b, m, 2))
    wh = rng.uniform(0.1, 0.5, (b, m, 2))
    valid = np.zeros((b, m), bool)
    for i, n in enumerate((5, 3, 4, 2)[:b]):
        valid[i, :n] = True
    boxes = np.where(valid[..., None], np.concatenate([c, wh], -1), 0)
    masks = np.zeros((b, size // 4, size // 4), np.float32)
    s = size // 4
    for i in range(b):
        for j in np.flatnonzero(valid[i]):
            x1, y1 = ((boxes[i, j, :2] - boxes[i, j, 2:] / 2) * s).astype(int)
            x2, y2 = np.ceil((boxes[i, j, :2] + boxes[i, j, 2:] / 2)
                             * s).astype(int)
            masks[i, y1:y2, x1:x2] = j + 1
    return {"images": images,
            "cls": rng.integers(0, NC, (b, m)).astype(np.int32),
            "bboxes": boxes.astype(np.float32), "mask_gt": valid,
            "masks": masks}


def _port_config(**kw):
    return Config(task_type=TaskType.segment, yolo_size=YoloSize.n,
                  number_class=NC, scalar_type=ScalarType.float32, **kw)


def test_segment_train_step_matches_jax():
    """One float32 v8n-seg (NMS) step at 64x64, batch 2, against the JAX
    step, at the rules of tests/test_torch_train.py (check_step_pair): the
    five loss items to 1e-4 relative, BN statistics to 1e-5, parameter
    changes where the sign of the gradient is resolved against 2e-3 of its
    tensor's largest, within one float32 spacing of the parameter more
    (the first update is ~1e-8 on BN scales near 1, below their spacing of
    6e-8, and the two packages apply AdamW's update in another order);
    SPPF's cv1 BN bias is left out (its gradient is zero by construction,
    as in the detect step)."""
    batch = _seg_batch(5)
    jnet = JaxNet(JaxArch(version="v8", size="n", task="segment", nc=NC))
    variables = jitter_bn(jax_bias_init(jnet.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)), False), NC), 5)
    jtask = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.segment, yolo_size=JaxSize.n, number_class=NC,
        scalar_type="float32", end2end=False)).task
    tx = jax_train.make_optimizer(nc=NC, epochs=2, steps_per_epoch=1)
    jstate = jax_train.TrainState.create(variables, tx)
    jstep = jax_train.make_train_step(jnet, jtask._loss_fns()[0],
                                      donate=False)
    jnew, jl, jitems = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, {})

    det = YoloTask(_port_config(end2end=False), device="cpu").task
    net = YoloNet(ArchCfg(version="v8", size="n", task="segment", nc=NC))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    net = net.to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=NC, epochs=2, steps_per_epoch=1)
    state = TrainState(net, opt, scheds)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    loss, items = make_train_step(det._loss_fns()[0])(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, {})
    assert float(items[1]) > 0
    check_step_pair(dict(state=state, before=before, loss=float(loss),
                         items=items.numpy(), variables=variables,
                         jnew=jnew, jloss=float(jl),
                         jitems=np.asarray(jitems)),
                    ulp=True, skip=("model.9.cv1.bn.bias",))


def _self_labelled_val(root, port, seed=4):
    """Val images labelled from the port's own first three detections
    (conf 0.1, the val threshold): the first and third as octagons
    inscribed in their boxes (the extremes are the box, the corners cut at
    a quarter of the sides; each corner of the box moved by up to 3
    pixels), then the second as the outer contour of its mask (cv2), whose
    ids cover the octagons' where they overlap: box matches for the
    octagons, mask matches for the contour, misses and false positives.
    Images are 64x64, so val pads them to 96x96 with 16 pixels on each
    side."""
    import cv2

    from yolosharp_tpu_torch.data.image_ops import read_image_rgb

    make_seg_dataset(root, 1, 4, [(64, 64)], NC, seed=seed)
    rng = np.random.default_rng(seed)
    vdir = os.path.join(root, "images", "val")
    unit = np.array([[0.25, 0], [0.75, 0], [1, 0.25], [1, 0.75], [0.75, 1],
                     [0.25, 1], [0, 0.75], [0, 0.25]])

    def row(cls, pts):
        return f"{cls} " + " ".join(f"{v:.6f}" for v in pts.reshape(-1))

    for name in sorted(os.listdir(vdir)):
        img = read_image_rgb(os.path.join(vdir, name))
        canvas = np.full((96, 96, 3), 114, np.uint8)
        canvas[16:80, 16:80] = img
        res = port.image_predict(canvas, 0.1, 0.7)
        rows = []
        for r in (res[0], res[2]):
            # image pixels, boxes past the border kept as they are
            x1 = r.center_x - r.width / 2 - 16 + rng.uniform(-3, 3)
            y1 = r.center_y - r.height / 2 - 16 + rng.uniform(-3, 3)
            x2 = x1 + r.width + rng.uniform(-3, 3)
            y2 = y1 + r.height + rng.uniform(-3, 3)
            rows.append(row(r.class_id,
                            ([x1, y1] + unit * [x2 - x1, y2 - y1]) / 64.0))
        contours, _ = cv2.findContours(
            res[1].mask[16:80, 16:80].astype(np.uint8), cv2.RETR_EXTERNAL,
            cv2.CHAIN_APPROX_SIMPLE)
        rows.append(row(res[1].class_id,
                        max(contours, key=len).reshape(-1, 2) / 64.0))
        label = os.path.join(root, "labels", "val",
                             os.path.splitext(name)[0] + ".txt")
        with open(label, "w") as f:
            f.write("\n".join(rows) + "\n")


def test_segment_val_matches_jax(tmp_path):
    """val of the NMS v8n-seg on the same weights (conv kernels x2.5, the
    head's final box and class convs from U(-0.3, 0.3), the mask
    coefficients near 1) on images labelled from its own detections: the
    five loss items to 1e-4 relative and the eight metrics (P, R, mAP50,
    mAP50-95 of boxes, then of masks) to 1e-4. The
    port's dataset gets the JAX dataset's masks (fill_poly against
    cv2.fillPoly is measured in tests/test_torch_seg_data.py)."""
    root = str(tmp_path)
    common = dict(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", number_class=NC,
                  image_size=64, batch_size=2, end2end=False)
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
        for tower in (head.cv2, head.cv3):
            for branch in tower:
                for p in (branch[2].weight, branch[2].bias):
                    p.copy_(torch.from_numpy(
                        rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)))
        # coefficients 1 + noise: masks that fill most of their boxes
        for branch in head.cv4:
            branch[2].weight.mul_(0.1)
            branch[2].bias.fill_(1.0)
    _self_labelled_val(root, port)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    jcfg = JaxConfig(task_type=JaxTaskType.segment, yolo_size=JaxSize.n,
                     scalar_type="float32", image_process_type="letterbox",
                     **common)
    seg = JaxYoloTask(jcfg).task
    seg.variables, report = state_dict_to_variables(
        sd, seg._ensure_variables())
    assert not report.missing
    jds = JaxDataset(jcfg, is_val=True)
    want_items, want_metrics = seg.val(
        JaxLoader(jds, 2, shuffle=False, workers=1,
                  max_labels=jds.max_label_count), 0)
    ds = YoloDataset(cfg, is_val=True)
    _same_records(ds, jds)
    got_items, got_metrics = port.val(
        DataLoader(ds, 2, shuffle=False, workers=1,
                   max_labels=ds.max_label_count))
    assert len(got_items) == 5 and len(got_metrics) == 8
    print(f"metrics: port {np.round(got_metrics, 4).tolist()}, JAX "
          f"{np.round(want_metrics, 4).tolist()}")
    np.testing.assert_allclose(got_items, np.asarray(want_items), rtol=1e-4)
    np.testing.assert_allclose(got_metrics, want_metrics, atol=1e-4)
    # every metric non-trivial (measured: mask mAP50-95 1.2e-3, the rest
    # 0.05-0.56)
    assert min(want_metrics) > 0 and max(want_metrics) < 0.99
