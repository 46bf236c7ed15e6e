"""int8 post-training quantisation through the port's facade against the
JAX package's, on the CPU (split from test_torch_int8.py so that its
nets spread over the test workers): v8n at 160 (the JAX facade test's
weights, JAX built with host_s2d=False), calibration on arrays and on PNG
paths (read BGR, as cv2.imread reads them), npz files across both
packages, the int8 head outputs of the image_predict and batch_predict
inputs, float32 and bfloat16, against JAX's int8 ones, and int8_predict
without stats predicting float.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_predict import synthetic_image
from util_calib import calibrate_task
from yolosharp_tpu.ckpt.mapping import flatten
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType, YoloSize, YoloType
from yolosharp_tpu_torch import Config, ScalarType
from yolosharp_tpu_torch import TaskType as PortTaskType
from yolosharp_tpu_torch import YoloSize as PortYoloSize
from yolosharp_tpu_torch import YoloTask
from yolosharp_tpu_torch import YoloType as PortYoloType
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.data.image_ops import encode_png
from yolosharp_tpu_torch.nn import ConvBN


S = 160
NC = 80
# the port's int8 head outputs' RMS distance from JAX's, over JAX int8's
# from JAX float (measured 0.50-0.71 in float32, 1.20 in bfloat16; the
# float32 gate: nearer JAX's int8 than int8 lies from float). Each conv
# equals JAX's to the bit on the same input (the ConvBN test), but a float
# ulp apart in a conv's input moves its rounding to int8 now and then, and
# the next layers' roundings follow: the two int8 nets drift apart like two
# draws of the quantisation noise. In float32 the seed is the float convs'
# 1e-7; in bfloat16 the activations' roundings (the port's float bf16 net
# lies 2.7e-3 RMS from JAX's), so there the int8 nets end up farther apart
# than int8 is from float. A port that did not quantise would pass these
# gates too (it reads ~1 in both types): INT8_FLOAT_FLOOR and the count of
# ConvBNs that carry i8_w are what rule it out.
INT8_FACTOR = {"float32": 1.0, "bfloat16": 1.5}
# the port's int8 head outputs' RMS distance from the port's own float net
# in the same type, over JAX int8's from JAX float, at least this: a net
# that quantises reads ~1, one that ran float reads 0 (the same float net)
INT8_FLOAT_FLOOR = 0.5


def _port_config(kw, **extra):
    return Config(**dict(kw, task_type=PortTaskType(kw["task_type"].value),
                         yolo_type=PortYoloType(kw["yolo_type"].value),
                         yolo_size=PortYoloSize(kw["yolo_size"].value)),
                  **extra)


# ------------------------------------------------------------ facade
@pytest.fixture(scope="module")
def facade(tmp_path_factory):
    """The JAX facade test's v8n (x2.5 kernels, random head finals) at
    160, float32 on the CPU, its weights in the port's f32 and bf16 tasks,
    two images (the second, a mirror image, as the JAX test's), PNG copies
    of them; JAX's int8 and float head outputs of the batch, one jit each."""
    root = tmp_path_factory.mktemp("int8")
    kw = dict(task_type=TaskType.detect, yolo_type=YoloType.v8,
              yolo_size=YoloSize.n, number_class=NC, end2end=False,
              image_size=S, int8_predict=True, root_path=str(root))
    jt = JaxYoloTask(JaxConfig(host_s2d=False, **kw))
    calibrate_task(jt.task)
    sd = state_dict_from_jax(jt.task.variables)
    ports = {}
    for dtype, scalar in (("float32", ScalarType.float32),
                          ("bfloat16", ScalarType.bfloat16)):
        t = YoloTask(_port_config(kw, scalar_type=scalar), device="cpu")
        t.task._ensure_variables().load_state_dict(sd, strict=True)
        ports[dtype] = t
    img = synthetic_image(S, S, seed=5)
    imgs = [img, np.ascontiguousarray(img[:, ::-1])]
    paths = []
    for i, im in enumerate(imgs):
        paths.append(str(root / f"im{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(encode_png(im))
    stats = jt.calibrate_int8(images=imgs, n_images=2)
    det = jt.task
    x = jnp.asarray(np.stack(imgs), jnp.float32) / 255.0

    def head(int8, dtype):
        det.config.int8_predict = int8
        out = jax.jit(lambda v, xx: det._apply_eval(v, xx))(
            det._predict_variables(), x.astype(dtype))
        det.config.int8_predict = True
        return _head(out)

    heads = {(int8, name): head(int8, dt) for int8 in (True, False)
             for name, dt in (("float32", jnp.float32),
                              ("bfloat16", jnp.bfloat16))}
    return dict(jax=jt, ports=ports, imgs=imgs, paths=paths, root=root,
                stats=stats, heads=heads)


def _head(preds):
    """The one2many branch's raw box and class maps of a forward, as one
    float32 array (B, n) (NHWC maps of JAX, NCHW of the port alike: each
    flattened channels-last)."""
    parts = []
    for kind in ("box", "cls"):
        for t in preds["one2many"][kind]:
            if isinstance(t, torch.Tensor):
                t = t.float().permute(0, 2, 3, 1).numpy()
            t = np.asarray(t, np.float32)
            parts.append(t.reshape(t.shape[0], -1))
    return np.concatenate(parts, 1)


def _dist(a, b):
    """Root-mean-square distance of a from b over b's root mean square."""
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def test_facade_calibration_matches_jax(facade):
    """Arrays: the port's stats equal JAX's (float32, same weights: within
    1e-5 relative). PNG paths: read BGR as cv2.imread reads them, so they
    equal the stats of the channel-reversed arrays, not the arrays'."""
    t = facade["ports"]["float32"]
    want = flatten(facade["stats"])
    got = flatten(t.calibrate_int8(images=facade["imgs"], n_images=2))
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * float(v), k
    bgr = YoloTask(t.config, device="cpu")
    bgr.task._ensure_variables().load_state_dict(
        t.task._ensure_variables().state_dict())
    from_paths = flatten(bgr.calibrate_int8(images=facade["paths"]))
    reversed_ = YoloTask(t.config, device="cpu")
    reversed_.task._ensure_variables().load_state_dict(
        t.task._ensure_variables().state_dict())
    flipped = flatten(reversed_.calibrate_int8(
        images=[im[..., ::-1] for im in facade["imgs"]]))
    assert from_paths == flipped
    assert from_paths["1.absmax"] != got["1.absmax"]
    # root_path: the sorted PNGs under it, as JAX's glob finds them
    assert flatten(reversed_.calibrate_int8()) == flipped


def test_calibration_files_cross_both_ways(facade, tmp_path):
    jt, t = facade["jax"], facade["ports"]["float32"]
    t.calibrate_int8(images=facade["imgs"], n_images=2)
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "j.npz")
    t.save_calibration(port_file)
    jt.save_calibration(jax_file)
    with np.load(port_file) as zp, np.load(jax_file) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].shape == zj[k].shape == () and zp[k].dtype == \
                zj[k].dtype == np.float32
    other = JaxYoloTask(JaxConfig(**{**jt.config.__dict__}))
    loaded = flatten(other.load_calibration(port_file))
    assert loaded.keys() == flatten(facade["stats"]).keys()
    port2 = YoloTask(t.config, device="cpu")
    got = flatten(port2.load_calibration(jax_file))
    want = flatten(facade["stats"])
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    with pytest.raises(ValueError, match="calibrate_int8"):
        YoloTask(t.config, device="cpu").save_calibration(port_file)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_head_outputs_near_jax_int8(facade, dtype, tmp_path):
    """The port's int8 net, stats loaded from JAX's file, on the inputs of
    image_predict (one image) and batch_predict (both), against the JAX
    net on the same inputs in the same type: its head outputs lie from
    JAX's int8 ones at most INT8_FACTOR times JAX int8's distance from JAX
    float (nearer in float32) and from the port's float net at least
    INT8_FLOAT_FLOOR times it, and its results match the float results by
    the JAX facade test's rule (at least 70% of the float boxes within
    max(4 px, 5%)); batch_predict's rows are image_predict's."""
    jt, t = facade["jax"], facade["ports"][dtype]
    f = str(tmp_path / "j.npz")
    jt.save_calibration(f)
    t.load_calibration(f)
    net = t.task._predict_variables()
    assert sum(m.i8_w is not None for m in net.modules()
               if isinstance(m, ConvBN)) == len(flatten(facade["stats"]))
    float_task = YoloTask(t.config.__class__(
        **{**t.config.__dict__, "int8_predict": False}), device="cpu")
    float_task.task._ensure_variables().load_state_dict(
        t.task._ensure_variables().state_dict())
    float_net = float_task.task._predict_variables()
    imgs = facade["imgs"]
    jint8 = facade["heads"][True, dtype]
    ref = _dist(jint8, facade["heads"][False, dtype])
    for rows in ([0], [0, 1]):      # image_predict's input, batch_predict's
        x = torch.from_numpy(np.stack([imgs[i] for i in rows]))
        x = (x.permute(0, 3, 1, 2).float() / 255.0).to(t.task.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            got, fl = _head(net(x)), _head(float_net(x))
        d, q = _dist(got, jint8[rows]), _dist(got, fl)
        print(f"{dtype} rows {rows}: port int8 vs JAX int8 {d:.4g}, JAX "
              f"int8 vs JAX float {ref:.4g}: {d / ref:.4g}; port int8 vs "
              f"port float {q / ref:.4g} of it")
        assert d <= INT8_FACTOR[dtype] * ref
        assert q >= INT8_FLOAT_FLOOR * ref
    conf = 0.57
    for img in imgs:
        ref_rows = float_task.image_predict(img, conf, 0.45)
        got_rows = t.image_predict(img, conf, 0.45)
        assert len(ref_rows) > 0
        assert _matched(got_rows, ref_rows) >= 0.7 * len(ref_rows)
    batched = t.batch_predict(imgs, conf, 0.45)
    for img, rows in zip(imgs, batched):
        assert _row_set(rows) == _row_set(t.image_predict(img, conf, 0.45))


def _row_set(rows):
    """Results as a sorted list (bfloat16 scores tie, and tied rows come
    in either order)."""
    return sorted((r.score, r.class_id, r.center_x, r.center_y, r.width,
                   r.height) for r in rows)


def _matched(got, ref) -> int:
    """tests/test_int8.py's rule: a float box is matched by an int8 box
    with centre and size within max(4, 5% of its larger side)."""
    b = np.array([[r.center_x, r.center_y, r.width, r.height] for r in got],
                 np.float32).reshape(-1, 4)
    n = 0
    for r in ref:
        row = np.float32([r.center_x, r.center_y, r.width, r.height])
        if len(b) and np.abs(b - row).max(1).min() <= max(
                4.0, 0.05 * max(row[2], row[3])):
            n += 1
    return n


def test_int8_without_stats_predicts_float(facade):
    """int8_predict=True before any calibration predicts float, silently,
    as JAX does; stats with int8_predict=False change nothing either."""
    t = facade["ports"]["float32"]
    fresh = YoloTask(t.config, device="cpu")
    fresh.task._ensure_variables().load_state_dict(
        t.task._ensure_variables().state_dict())
    off = YoloTask(t.config.__class__(
        **{**t.config.__dict__, "int8_predict": False}), device="cpu")
    off.task._ensure_variables().load_state_dict(
        t.task._ensure_variables().state_dict())
    img = facade["imgs"][0]
    want = off.image_predict(img, 0.3, 0.45)
    assert fresh.image_predict(img, 0.3, 0.45) == want
    off.calibrate_int8(images=facade["imgs"])
    assert off.image_predict(img, 0.3, 0.45) == want
    assert not any(m.i8_w is not None
                   for m in off.task._predict_variables().modules()
                   if isinstance(m, ConvBN))
