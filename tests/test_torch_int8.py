"""int8 post-training quantisation of the port against the JAX package's,
on the CPU:

- the plain int8 conv (quantise, int8 x int8 -> int32 sums, dequantise)
  equals the JAX int8_conv to the bit, inputs and weights on exact .5
  boundaries and past +-127 included;
- a ConvBN's calibration equals quant_calibrate's absmax and its int8
  output quant_int8's, float32;
- the calibrated key set equals JAX's for v8n, v12n and v5un detect and
  v8n-cls (DWConv and Conv2 are never int8, a C2f's convs each are);
- the facade on v8n at 160 (the JAX facade test's weights, JAX built with
  host_s2d=False): calibration on arrays and on PNG paths (read BGR, as
  cv2.imread reads them), npz files across both packages, and the int8
  head outputs of the image_predict and batch_predict inputs, float32 and
  bfloat16, against JAX's int8 ones;
- int8_predict without stats predicts float; every route of all five
  families takes the int8 net once calibrated.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_predict import synthetic_image
from util_calib import calibrate_task
from yolosharp_tpu.ckpt.mapping import flatten
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.nn.common import ConvBN as JaxConvBN
from yolosharp_tpu.nn.common import (fused_inference, int8_conv,
                                     quant_calibrate, quant_int8)
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import TaskType, YoloSize, YoloType
from yolosharp_tpu_torch import Config, ScalarType
from yolosharp_tpu_torch import TaskType as PortTaskType
from yolosharp_tpu_torch import YoloSize as PortYoloSize
from yolosharp_tpu_torch import YoloTask
from yolosharp_tpu_torch import YoloType as PortYoloType
from yolosharp_tpu_torch.ckpt import (clone_one2one, fold_bn,
                                      state_dict_from_jax)
from yolosharp_tpu_torch.ckpt.fuse import start_calibration
from yolosharp_tpu_torch.data.image_ops import encode_png
from yolosharp_tpu_torch.kernels.int8_conv import (activation_scale,
                                                   int8_conv_plain,
                                                   padded_channels,
                                                   quantize_plain,
                                                   quantize_weight)
from yolosharp_tpu_torch.nn import ConvBN
from yolosharp_tpu_torch.parallel import create_mesh

S = 160
NC = 80


def _port_config(kw, **extra):
    return Config(**dict(kw, task_type=PortTaskType(kw["task_type"].value),
                         yolo_type=PortYoloType(kw["yolo_type"].value),
                         yolo_size=PortYoloSize(kw["yolo_size"].value)),
                  **extra)


# ------------------------------------------------------------ the conv
# a_scale = (127 / 16) / 127 = 2**-4 exactly, so x = (n + 0.5) / 16 lies on
# a rounding tie of x / a_scale; w_scale = 2**-6 where max |w| = 127 / 64
ABSMAX = np.float32(127 / 16)


@pytest.mark.parametrize("ci", [3, 51, 64])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_int8_conv_plain_equals_jax_to_the_bit(k, s, ci):
    """The plain int8 conv against the JAX int8_conv under jax.jit, its
    route inside the jitted predict: there XLA multiplies the scales'
    max(|.|, eps) by the float32 reciprocal of 127, as the port's
    activation_scale and quantize_weight do (eager JAX divides, and its
    scales differ from the jitted ones on some channels)."""
    rng = np.random.default_rng(k * 100 + s * 10 + ci)
    p = k // 2
    x = rng.normal(0, 3, (2, 13, 17, ci)).astype(np.float32)
    ties = rng.random(x.shape) < 0.2
    x[ties] = (rng.integers(-140, 140, ties.sum()) + 0.5) / 16  # ties, past 127
    w = rng.normal(0, 0.3, (k, k, ci, 24)).astype(np.float32)
    w[..., ::2] = (rng.integers(-126, 126, w[..., ::2].shape) + 0.5) / 64
    w[0, 0, 0, ::2] = 127 / 64                  # w_scale 2**-6: ties in wq
    jitted = jax.jit(int8_conv, static_argnums=(2, 3))
    want = np.asarray(jitted(jnp.asarray(x), jnp.asarray(w), (s, s),
                             ((p, p), (p, p)), jnp.asarray(ABSMAX)))
    a = activation_scale(torch.tensor(ABSMAX))
    wq, w_scale = quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    assert float(a) == 2.0 ** -4
    assert (w_scale[::2] == 2.0 ** -6).all()
    xq = quantize_plain(torch.from_numpy(x), a, padded_channels(ci))
    assert xq.shape[-1] % 16 == 0 and not xq[..., ci:].any()
    got = int8_conv_plain(xq, wq, a * w_scale, torch.zeros(24), s, p)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["identity", "silu"])
def test_convbn_calibration_and_int8_match_jax(act, dtype):
    """A folded ConvBN (3x3, 8 -> 24, BN statistics jittered): the absmax
    it records equals quant_calibrate's over two batches, and its int8
    output quant_int8's with that stat, in float32 and (the module cast,
    the input rounded) bfloat16: to the bit with the identity, the
    activation's ulps apart otherwise."""
    rng = np.random.default_rng(1)
    m = ConvBN(8, 24, 3, act=act)
    with torch.no_grad():
        m.conv.weight.normal_(0, 0.2, generator=torch.Generator()
                              .manual_seed(0))
        m.bn.running_mean.copy_(torch.from_numpy(rng.normal(0, .1, 24)))
        m.bn.running_var.copy_(torch.from_numpy(rng.uniform(.5, 2, 24)))
        m.bn.bias.copy_(torch.from_numpy(rng.normal(0, .1, 24)))
    m.eval()
    xs = [rng.normal(0, s, (1, 16, 16, 8)).astype(np.float32)
          for s in (1.0, 2.0)]
    net = fold_bn(start_calibration(copy.deepcopy(m)))
    assert net.kernel_route
    with torch.no_grad():
        for x in xs:
            net(torch.from_numpy(x).permute(0, 3, 1, 2))
    # the JAX module on the port's fold (both fold in float32 alike)
    variables = {"params": {
        "conv": {"kernel": net.w_fold.numpy()},     # HWIO: a 3x3 route
        "bn": {"bias": net.b_fold.numpy()}}}
    jm = JaxConvBN(24, 3, act=act)
    stats = None
    for x in xs:
        with fused_inference(), quant_calibrate():
            _, upd = jm.apply(variables, jnp.asarray(x), False,
                              mutable=["quant_stats"])
        new = jax.device_get(upd["quant_stats"])
        stats = new if stats is None else jax.tree_util.tree_map(
            np.maximum, stats, new)
    assert float(net.absmax) == float(stats["absmax"])
    x = torch.from_numpy(xs[1]).to(getattr(torch, dtype))
    with fused_inference(), quant_int8():
        want = jm.apply({**variables, "quant_stats": stats},
                        jnp.asarray(x.float().numpy(), dtype), False)
    want = np.asarray(want.astype(jnp.float32))
    m2 = fold_bn(m, {"absmax": stats["absmax"]}).to(x.dtype)
    assert m2.i8_w is not None and m2.i8_scale.dtype == torch.float32
    with torch.no_grad():
        got = m2(x.permute(0, 3, 1, 2))
    got = got.float().permute(0, 2, 3, 1).numpy()
    if act == "identity":
        np.testing.assert_array_equal(got, want)
    else:
        # XLA's bfloat16 SiLU rounds its sigmoid before the product,
        # torch's does not: up to two bfloat16 steps apart (2 x 2**-8)
        tol = 1e-6 if dtype == "float32" else 2.0 ** -6
        np.testing.assert_allclose(got, want, rtol=tol, atol=1e-6)


# ------------------------------------------------------ the key sets
MODELS = {"v8n": (TaskType.detect, YoloType.v8),
          "v12n": (TaskType.detect, YoloType.v12),
          "v5un": (TaskType.detect, YoloType.v5u),
          "v8n-cls": (TaskType.classify, YoloType.v8)}


@pytest.mark.parametrize("model", list(MODELS))
def test_calibrated_convs_are_jax_s(model):
    """calibrate_int8 on two arrays at 64 px, the same weights: the same
    stat keys as the JAX package's (DWConv, Conv2 and biased or grouped
    convs have none; a C2f's convs each have one), the same values but for
    v12n, whose JAX fold leaves the area attention's pe bias unscaled
    (ROADMAP, standing notes: JAX faults the port does not copy), within
    1e-5 relative."""
    task, version = MODELS[model]
    kw = dict(task_type=task, yolo_type=version, yolo_size=YoloSize.n,
              number_class=5, image_size=64, int8_predict=True)
    jt = JaxYoloTask(JaxConfig(host_s2d=False, **kw))
    port = YoloTask(_port_config(kw, scalar_type=ScalarType.float32),
                    device="cpu")
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(jt.task._ensure_variables()), strict=True)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (64, 80, 3), np.uint8) for _ in range(3)]
    want = flatten(jt.calibrate_int8(images=imgs, n_images=3,
                                     batch_size=2))
    got = flatten(port.calibrate_int8(images=imgs, n_images=3,
                                      batch_size=2))
    assert set(got) == set(want)
    if model != "v12n":
        for k, v in want.items():
            assert abs(float(got[k]) - float(v)) <= 1e-5 * float(v), k


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



def test_calibrate_int8_without_images_raises(tmp_path):
    t = YoloTask(Config(yolo_size=PortYoloSize.n, number_class=5,
                        int8_predict=True, root_path=str(tmp_path),
                        scalar_type=ScalarType.float32), device="cpu")
    with pytest.raises(FileNotFoundError, match="no images"):
        t.calibrate_int8()
    with pytest.raises(ValueError, match="empty image list"):
        t.calibrate_int8(images=[])
    assert os.listdir(tmp_path) == []
