"""int8_predict through every route of all five task families on the CPU,
once calibrated (split from test_torch_int8.py so that its nets spread
over the test workers).
"""

import numpy as np
import pytest
import torch

from test_torch_predict import synthetic_image
from yolosharp_tpu_torch import Config, ScalarType
from yolosharp_tpu_torch import TaskType as PortTaskType
from yolosharp_tpu_torch import YoloSize as PortYoloSize
from yolosharp_tpu_torch import YoloTask
from yolosharp_tpu_torch import YoloType as PortYoloType
from yolosharp_tpu_torch.ckpt import clone_one2one
from yolosharp_tpu_torch.nn import ConvBN
from yolosharp_tpu_torch.parallel import create_mesh


S = 160
NC = 80


def _port_config(kw, **extra):
    return Config(**dict(kw, task_type=PortTaskType(kw["task_type"].value),
                         yolo_type=PortYoloType(kw["yolo_type"].value),
                         yolo_size=PortYoloSize(kw["yolo_size"].value)),
                  **extra)


# -------------------------------------------------- every route, family
FAMILIES = {"detect": ("v8", False), "segment": ("v11", True),
            "pose": ("v8", False), "obb": ("v12", False),
            "classify": ("v8", False)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_route_takes_the_int8_net(family):
    """Each family at 64 px, float32: once calibrated, image_predict,
    batch_predict, mesh batch_predict (two CPU replicas) and
    predict_stream each run every int8-eligible conv of the predict net
    on the int8 route in each of their forwards, and return results; the
    int8 net's outputs differ from the float net's."""
    version, e2e = FAMILIES[family]
    cfg = Config(task_type=PortTaskType(family),
                 yolo_type=PortYoloType(version), yolo_size=PortYoloSize.n,
                 number_class=1 if family == "pose" else 5, image_size=64,
                 end2end=e2e, int8_predict=True,
                 scalar_type=ScalarType.float32)
    t = YoloTask(cfg, device="cpu")
    _seed(t.task._ensure_variables())
    imgs = [synthetic_image(64, 64, seed=i) for i in range(2)]
    t.calibrate_int8(images=imgs)
    net = t.task._predict_variables()
    convs = [m for m in net.modules() if isinstance(m, ConvBN)]
    int8 = [m for m in convs if m.i8_w is not None]
    assert len(int8) == sum(m.int8_eligible for m in convs) > 10
    calls = []
    for m in int8:
        m.register_forward_hook(lambda *_: calls.append(1))
    x = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).float() / 255
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = net(x, skip_one2many=e2e)
    per_forward = len(calls)
    assert per_forward > 10
    mesh = create_mesh(devices=["cpu", "cpu"])
    for route, forwards in (
            (lambda: [t.image_predict(im, 0.0) for im in imgs], 2),
            (lambda: t.batch_predict(imgs, 0.0), 1),
            (lambda: t.batch_predict(imgs, 0.0, mesh=mesh), 2),
            (lambda: list(t.predict_stream(imgs, batch_size=2, imgsz=64,
                                           predict_threshold=0.0,
                                           workers=1)), 1)):
        calls.clear()
        results = route()
        assert len(results) == 2 and all(results)
        assert len(calls) == forwards * per_forward
    off = YoloTask(Config(**{**cfg.__dict__, "int8_predict": False}),
                   device="cpu")
    off.task._ensure_variables().load_state_dict(
        t.task._ensure_variables().state_dict())
    with torch.no_grad():
        ref = off.task._predict_variables()(x, skip_one2many=e2e)
    leaf = (lambda o: o["cls"]) if family == "classify" else \
        (lambda o: o["one2one" if e2e else "one2many"]["cls"][0])
    assert not torch.equal(leaf(out), leaf(ref))


@torch.no_grad()
def _seed(net):
    """Scores that tell the rows apart: ConvBN kernels x 2.5, the head's
    final convs (a classify head's Linear) drawn from U(-0.3, 0.3), the
    one2one towers cloned (chip_smoke.seed_weights' recipe)."""
    g = torch.Generator().manual_seed(3)
    for m in net.modules():
        if isinstance(m, ConvBN):
            m.conv.weight.mul_(2.5)
    head = net.model[-1]
    finals = [head.linear] if hasattr(head, "linear") else [
        b[2] for tower in (head.cv2, head.cv3, getattr(head, "cv4", ()))
        for b in tower]
    for f in finals:
        for p in (f.weight, f.bias):
            p.uniform_(-0.3, 0.3, generator=g)
    clone_one2one(net)
