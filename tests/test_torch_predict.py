"""The port's whole predict slice (yolosharp_tpu_torch.YoloTask, v8n, CPU,
float32) against the JAX Detector with the same seeded weights on a
synthetic 236x316 image: the NMS path (select-then-decode top-k + greedy
NMS), the End2End path, and the YoloResults of image_predict and
batch_predict. Plus: importing and running the port loads no JAX and
nothing of the JAX package."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jitter_bn
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
from yolosharp_tpu_torch.tasks import _to_host

NC = 17
IOU = 0.45
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synthetic_image(h=316, w=236, seed=0):
    """Smooth blobs plus noise: structured enough for varied detections."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
    img = np.kron(low, np.ones((16, 16, 1)))[:h, :w]
    img = img + rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def canvas(img):
    arr = img[None]
    ph, pw = (-arr.shape[1]) % 32, (-arr.shape[2]) % 32
    return np.pad(arr, ((0, 0), (0, ph), (0, pw), (0, 0)),
                  constant_values=114)


@pytest.fixture(scope="module", params=[False, True], ids=["nms", "e2e"])
def tasks(request):
    end2end = request.param
    kw = dict(task_type=TaskType.detect, yolo_type=YoloType.v8,
              yolo_size=YoloSize.n, number_class=NC, end2end=end2end,
              nms_pre_topk=2048)
    jax_task = JaxYoloTask(JaxConfig(host_s2d=False, **kw))
    det = jax_task.task
    calibrate_task(det)
    variables = jitter_bn(det.variables, seed=2)
    if end2end:     # give the one2one towers the randomised finals too
        variables = jax_clone_one2one(variables)
    det.variables = variables

    # the port's config from the port's own enums
    port_kw = dict(kw, task_type=PortTaskType(kw["task_type"].value),
                   yolo_type=PortYoloType(kw["yolo_type"].value),
                   yolo_size=PortYoloSize(kw["yolo_size"].value))
    port = YoloTask(Config(scalar_type=ScalarType.float32, **port_kw),
                    device="cpu")
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)

    img = synthetic_image()
    # conf so that ~200 anchors of the one2many branch clear it
    x = torch.from_numpy(canvas(img)).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        preds = port.task._predict_variables()(x)
    flat = flatten_levels(preds["one2many"]["cls"]).sigmoid().amax(-1)
    conf = float(np.quantile(flat.numpy(), 1 - 200 / flat.shape[1]))
    return dict(end2end=end2end, det=det, port=port, img=img, conf=conf)


def _rows(out, end2end, conf):
    """(boxes xyxy, scores, classes) of image 0 of a host predict output."""
    if end2end:
        rows = np.asarray(out)[0]
        rows = rows[rows[:, 4] > conf]
        return rows[:, :4], rows[:, 4], rows[:, 5].astype(int)
    v = np.asarray(out.valid[0])
    return (np.asarray(out.boxes[0])[v], np.asarray(out.scores[0])[v],
            np.asarray(out.classes[0])[v])


def assert_match(got, want, px=0.5):
    """The match rule of tests/test_golden_bus_predict.py: counts within 2
    (threshold-edge flips), each reference row reproduced within `px` px
    and 1e-3 score, at most max(2, n/50) unmatched."""
    gb, gs, gc = got
    wb, ws, wc = want
    assert len(wb) > 5
    assert abs(len(gb) - len(wb)) <= 2, (len(gb), len(wb))
    used = np.zeros(len(gb), bool)
    unmatched = 0
    for b, s, c in zip(wb, ws, wc):
        d = np.abs(gb - b).max(1) + 1e3 * (gc != c)
        j = int(np.argmin(d + 1e6 * used))
        if d[j] < px and abs(gs[j] - s) < 1e-3:
            used[j] = True
        else:
            unmatched += 1
    assert unmatched <= max(2, len(wb) // 50), unmatched


def test_predict_fn_matches_jax(tasks):
    det, port, conf = tasks["det"], tasks["port"].task, tasks["conf"]
    arr = canvas(tasks["img"])
    c = 0.0 if tasks["end2end"] else conf
    want = jax.device_get(det._predict_fn(arr.shape)(
        det._predict_variables(), jnp.asarray(arr), c, IOU))
    got = _to_host(port._predict_fn(port._predict_variables(),
                                    torch.from_numpy(arr), c, IOU))
    if not tasks["end2end"]:
        np.testing.assert_array_equal(got.truncated, want.truncated)
        assert not got.truncated.any()
    assert_match(_rows(got, tasks["end2end"], conf),
                 _rows(want, tasks["end2end"], conf))


def _result_rows(results):
    rs = sorted(results, key=lambda r: -r.score)
    return (np.array([[r.center_x - r.width // 2, r.center_y - r.height // 2,
                       r.center_x + r.width - r.width // 2,
                       r.center_y + r.height - r.height // 2] for r in rs],
                     float).reshape(-1, 4),
            np.array([r.score for r in rs]),
            np.array([r.class_id for r in rs]))


def assert_results_match(got, want):
    """YoloResults hold integer-truncated boxes: corners may differ by one
    pixel where the float boxes straddle an integer."""
    assert_match(_result_rows(got), _result_rows(want), px=1.5)


def test_image_and_batch_predict_results_match_jax(tasks):
    det, port, conf, img = (tasks["det"], tasks["port"], tasks["conf"],
                            tasks["img"])
    want = det.image_predict(img, conf, IOU)
    got = port.image_predict(img, conf, IOU)
    assert_results_match(got, want)
    # batch: a smaller second image shares image 0's canvas
    small = synthetic_image(200, 180, seed=1)
    batch = port.batch_predict([img, small], conf, IOU)
    assert len(batch) == 2
    assert_results_match(batch[0], want)
    assert_results_match(batch[1], port.image_predict(
        np.pad(small, ((0, 116), (0, 56), (0, 0)), constant_values=114),
        conf, IOU))


def test_port_runs_without_jax(tmp_path):
    """Importing every module of the port, predicting on the CPU (detect,
    in float and int8 after calibrate_int8 and a calibration file's round
    trip, segment with its masks, pose with its keypoints, OBB with its angle
    and through predict_stream, classify's top 5 and its stream), the OBB
    labels' minimum-area rectangle, saving, loading and converting a
    checkpoint, the folded forward of blocks no zoo model builds, and a
    data-parallel train step over two gloo ranks (whose spawned rank checks
    its own modules) loads neither jax nor flax nor cv2 (the GPU
    machine has none of them), nor any module of the JAX package
    yolosharp_tpu."""
    path = str(tmp_path / "v8n.bin")
    pkg = os.path.join(REPO, "yolosharp_tpu_torch")
    modules = sorted(
        "yolosharp_tpu_torch." + os.path.relpath(
            os.path.join(d, f), pkg)[:-3].replace(os.sep, ".")
        .replace(".__init__", "")
        for d, _, files in os.walk(pkg) for f in files
        if f.endswith(".py") and f != "__init__.py")
    assert {"yolosharp_tpu_torch.train", "yolosharp_tpu_torch.loss.tal",
            "yolosharp_tpu_torch.data.image_ops",
            "yolosharp_tpu_torch.ckpt.resume",
            "yolosharp_tpu_torch.utils.metrics"} <= set(modules)
    code = (
        "import importlib, sys, numpy as np\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from yolosharp_tpu_torch import Config, ScalarType, TaskType, "
        "YoloSize, YoloTask\n"
        "assert 'yolosharp_tpu_torch' in sys.modules\n"
        "t = YoloTask(Config(yolo_size=YoloSize.n, number_class=5, "
        "scalar_type=ScalarType.float32, end2end=False), device='cpu')\n"
        "r = t.image_predict(np.zeros((64, 96, 3), np.uint8), 0.0)\n"
        "assert isinstance(r, list) and r\n"
        f"t.save_weight({path!r})\n"
        f"t.load_model({path!r})\n"
        "t.config.int8_predict = True\n"
        "t.calibrate_int8(images=[np.zeros((64, 96, 3), np.uint8)])\n"
        f"t.save_calibration({path + '.npz'!r})\n"
        f"t.load_calibration({path + '.npz'!r})\n"
        "r = t.image_predict(np.zeros((64, 96, 3), np.uint8), 0.0)\n"
        "assert r and t.task._predict_variables().model[0].i8_w "
        "is not None\n"
        "s = YoloTask(Config(task_type=TaskType.segment, "
        "yolo_size=YoloSize.n, number_class=5, "
        "scalar_type=ScalarType.float32), device='cpu')\n"
        "r = s.image_predict(np.zeros((64, 96, 3), np.uint8), 0.0)\n"
        "assert r and r[0].mask.shape == (64, 96), r\n"
        "p = YoloTask(Config(task_type=TaskType.pose, "
        "yolo_size=YoloSize.n, number_class=1, "
        "scalar_type=ScalarType.float32), device='cpu')\n"
        "r = p.image_predict(np.zeros((64, 96, 3), np.uint8), 0.0)\n"
        "assert r and len(r[0].keypoints) == 17, r\n"
        "o = YoloTask(Config(task_type=TaskType.obb, "
        "yolo_size=YoloSize.n, number_class=5, "
        "scalar_type=ScalarType.float32), device='cpu')\n"
        "r = o.image_predict(np.zeros((64, 96, 3), np.uint8), 0.0)\n"
        "assert r and -1 < r[0].radian < 3, r\n"
        "r = list(o.predict_stream([np.zeros((64, 96, 3), np.uint8)] * 3, "
        "batch_size=2, imgsz=64, predict_threshold=0.0, workers=2))\n"
        "assert len(r) == 3 and r[2], r\n"
        "c = YoloTask(Config(task_type=TaskType.classify, "
        "yolo_size=YoloSize.n, number_class=5, image_size=64, "
        "scalar_type=ScalarType.float32), device='cpu')\n"
        "r = c.image_predict(np.zeros((64, 96, 3), np.uint8))\n"
        "assert len(r) == 5 and r[0].score >= r[4].score, r\n"
        "r = list(c.predict_stream([np.zeros((64, 96, 3), np.uint8)] * 3, "
        "batch_size=2))\n"
        "assert len(r) == 3 and len(r[2]) == 5, r\n"
        "from yolosharp_tpu_torch.ops import xyxyxyxy2xywhr\n"
        "assert xyxyxyxy2xywhr(np.float32([[[0, 0], [10, 0], [10, 5], "
        "[0, 5]]])).shape == (1, 5)\n"
        "import torch\n"
        "from yolosharp_tpu_torch import convert_checkpoint\n"
        "from yolosharp_tpu_torch.ckpt import fold_bn\n"
        "from yolosharp_tpu_torch.nn import C3TR, HGStem, RepC3\n"
        f"assert convert_checkpoint({path!r}, {path + '.f16'!r}, "
        "np.float16) > 0\n"
        "x = torch.zeros(1, 3, 32, 32)\n"
        "for m in (HGStem(3, 8, 16), RepC3(16, 16, 1), C3TR(16, 32)):\n"
        "    x = fold_bn(m.eval())(x)\n"
        "assert x.shape == (1, 32, 8, 8), x.shape\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "import torch_rank_fns\n"
        "from yolosharp_tpu_torch.parallel.dist import run_ranks\n"
        "from yolosharp_tpu_torch.tasks import Detector\n"
        "cfg = Config(yolo_size=YoloSize.n, number_class=5, image_size=64, "
        "scalar_type=ScalarType.float32, end2end=False)\n"
        "sd = Detector(cfg, 'cpu')._ensure_variables().state_dict()\n"
        "rng = np.random.default_rng(0)\n"
        "batch = {'images': rng.integers(0, 256, (2, 64, 64, 3), "
        "dtype=np.uint8), 'cls': np.zeros((2, 8), np.int32), "
        "'bboxes': np.full((2, 8, 4), 0.3, np.float32), "
        "'mask_gt': np.ones((2, 8), bool)}\n"
        "args = (cfg, sd, batch)\n"
        "loss = run_ranks(lambda: torch_rank_fns.step_without_jax(*args), "
        "torch_rank_fns.step_without_jax, args, ['cpu', 'cpu'])\n"
        "assert np.isfinite(loss), loss\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'cv2', "
        "'ml_dtypes', 'yolosharp_tpu') or m.startswith(('jax.', 'flax.', "
        "'yolosharp_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
