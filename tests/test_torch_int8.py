"""int8 post-training quantisation of the port against the JAX package's,
on the CPU:

- the plain int8 conv (quantise, int8 x int8 -> int32 sums, dequantise)
  equals the JAX int8_conv to the bit, inputs and weights on exact .5
  boundaries and past +-127 included;
- a ConvBN's calibration equals quant_calibrate's absmax and its int8
  output quant_int8's, float32;
- the calibrated key set equals JAX's for v8n, v12n and v5un detect and
  v8n-cls (DWConv and Conv2 are never int8, a C2f's convs each are);
- calibrate_int8 without images raises.

The facade's calibration, files and head outputs are in
test_torch_int8_facade.py, every route of the five families in
test_torch_int8_routes.py.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from yolosharp_tpu_torch.ckpt import fold_bn, state_dict_from_jax
from yolosharp_tpu_torch.ckpt.fuse import start_calibration
from yolosharp_tpu_torch.kernels.int8_conv import (activation_scale,
                                                   int8_conv_plain,
                                                   padded_channels,
                                                   quantize_plain,
                                                   quantize_weight)
from yolosharp_tpu_torch.nn import ConvBN

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


def test_calibrate_int8_without_images_raises(tmp_path):
    t = YoloTask(Config(yolo_size=PortYoloSize.n, number_class=5,
                        int8_predict=True, root_path=str(tmp_path),
                        scalar_type=ScalarType.float32), device="cpu")
    with pytest.raises(FileNotFoundError, match="no images"):
        t.calibrate_int8()
    with pytest.raises(ValueError, match="empty image list"):
        t.calibrate_int8(images=[])
    assert os.listdir(tmp_path) == []
