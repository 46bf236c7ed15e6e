"""The rest of the port's single-device surface against the JAX package:
convert_checkpoint (.pt written by torch.save, .safetensors and .bin, with
and without a dtype; every tensor keeps its shape and type, the .bin it
writes loads bit-equal in JAX's load_bin, and it equals the JAX
convert_checkpoint's file byte for byte but where the JAX .pt reader makes
a 0-d tensor 1-d), the box helpers xyxy2xywhn / xywhn2xyxy / clip_boxes,
focal_loss and bce_blur_loss, and a mesh_shape of one device at predict.
Config.profile_dir is in test_torch_surface_trace.py, the settings of the
JAX package's multi-device and int8 layers on one device in
test_torch_surface_settings.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_surface_trace import _config
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.ckpt import binio as jax_binio
from yolosharp_tpu.ckpt import convert_checkpoint as jax_convert_checkpoint
from yolosharp_tpu.loss import losses as jax_losses
from yolosharp_tpu.ops import boxes as jax_boxes
from yolosharp_tpu_torch import YoloTask, convert_checkpoint
from yolosharp_tpu_torch.ckpt import (load_bin, load_state_dict_file,
                                      save_bin, save_safetensors)
from yolosharp_tpu_torch.loss import bce_blur_loss, focal_loss
from yolosharp_tpu_torch.ops import clip_boxes, xywhn2xyxy, xyxy2xywhn


# ----------------------------------------------------------- checkpoints
def _state_dict():
    """float32 weights and statistics, an int64 counter, a bfloat16 tensor
    (as torch holds them)."""
    g = torch.Generator().manual_seed(0)
    return {"model.0.conv.weight": torch.randn(8, 3, 3, 3, generator=g),
            "model.0.bn.weight": torch.rand(8, generator=g) + 0.5,
            "model.0.bn.running_var": torch.rand(8, generator=g) + 0.5,
            "model.0.bn.num_batches_tracked": torch.tensor(7),
            "model.1.linear.weight": torch.randn(5, 8, generator=g).to(
                torch.bfloat16)}


def _write(fmt, path, sd):
    if fmt == "pt":
        torch.save(sd, path)
    elif fmt == "safetensors":
        save_safetensors(path, sd)
    else:
        save_bin(path, sd)


def _numpy(v):
    """A loaded tensor as numpy; bfloat16 as its int16 bit patterns."""
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 \
            else v.numpy()
    a = np.asarray(v)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", [None, np.float16], ids=["as_is", "f16"])
@pytest.mark.parametrize("fmt", ["pt", "safetensors", "bin"])
def test_convert_checkpoint_round_trips(fmt, dtype, tmp_path):
    sd = _state_dict()
    src = str(tmp_path / f"w.{fmt}")
    _write(fmt, src, sd)
    dst, jax_dst = str(tmp_path / "out.bin"), str(tmp_path / "jax.bin")
    assert convert_checkpoint(src, dst, dtype) == len(sd)
    assert jax_convert_checkpoint(src, jax_dst, dtype) == len(sd)
    got, in_jax = load_bin(dst), jax_binio.load_bin(dst)
    by_jax = jax_binio.load_bin(jax_dst)
    assert list(got) == list(sd) == list(in_jax) == list(by_jax)
    for k, v in sd.items():
        want = (v.float().numpy().astype(dtype) if dtype is not None
                else _numpy(v))
        for name, t in (("port", got[k]), ("port's in JAX", in_jax[k])):
            a = _numpy(t)
            assert a.dtype == want.dtype and a.shape == want.shape, (name, k)
            np.testing.assert_array_equal(a, want, err_msg=f"{name} {k}")
        a = _numpy(by_jax[k])
        if fmt == "pt" and v.dim() == 0:
            # the JAX .pt reader makes a 0-d tensor 1-d (ROADMAP, standing
            # notes: JAX faults the port does not copy)
            assert a.shape == (1,)
            a = a.reshape(())
        np.testing.assert_array_equal(a, want, err_msg=f"JAX's {k}")
        assert a.dtype == want.dtype and a.shape == want.shape, k
    if fmt != "pt":
        assert open(dst, "rb").read() == open(jax_dst, "rb").read()
    if dtype is None:
        assert got["model.1.linear.weight"].dtype == torch.bfloat16
    # the source reads back as it was written
    back = load_state_dict_file(src)
    for k, v in sd.items():
        assert tuple(back[k].shape) == tuple(v.shape), k
        np.testing.assert_array_equal(_numpy(back[k]), _numpy(v), err_msg=k)


# ----------------------------------------------------------- box helpers
def test_box_helpers_match_test_ops_boxes_cases():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.2, 0.6, size=(8, 4)).astype(np.float32)
    back = xyxy2xywhn(xywhn2xyxy(torch.from_numpy(x), w=320, h=240),
                      w=320, h=240)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)
    out = clip_boxes(torch.tensor([[-5.0, -5.0, 700.0, 700.0]]), (480, 640))
    np.testing.assert_allclose(out.numpy(), [[0, 0, 640, 480]])


@pytest.mark.parametrize("kw", [{}, {"clip": True}, {"clip": True, "eps": 3}],
                         ids=["plain", "clip", "clip_eps"])
def test_xyxy2xywhn_matches_jax(kw):
    x = np.random.default_rng(1).uniform(-40, 700, (3, 7, 4)).astype(
        np.float32)
    want = np.asarray(jax_boxes.xyxy2xywhn(jnp.asarray(x), 640, 480, **kw))
    got = xyxy2xywhn(torch.from_numpy(x), 640, 480, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pad", [(0, 0), (12.5, 3)], ids=["no_pad", "pad"])
def test_xywhn2xyxy_and_clip_boxes_match_jax(pad):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (11, 4)).astype(np.float32)
    want = np.asarray(jax_boxes.xywhn2xyxy(jnp.asarray(x), 320, 256, *pad))
    got = xywhn2xyxy(torch.from_numpy(x), 320, 256, *pad).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    boxes = rng.uniform(-50, 400, (11, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        clip_boxes(torch.from_numpy(boxes), (256, 320)).numpy(),
        np.asarray(jax_boxes.clip_boxes(jnp.asarray(boxes), (256, 320))))


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("fn,kw", [
    ("focal_loss", {}), ("focal_loss", {"gamma": 2.0, "alpha": 0.5}),
    ("bce_blur_loss", {}), ("bce_blur_loss", {"alpha": 0.2})],
    ids=["focal", "focal_g2_a05", "blur", "blur_a02"])
def test_focal_and_blur_losses_match_jax(fn, kw):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 37)) * 3).astype(np.float32)
    targets = np.where(rng.uniform(size=(4, 37)) < 0.5,
                       rng.integers(0, 2, (4, 37)),
                       rng.uniform(size=(4, 37))).astype(np.float32)
    want = float(getattr(jax_losses, fn)(jnp.asarray(logits),
                                         jnp.asarray(targets), **kw))
    port = {"focal_loss": focal_loss, "bce_blur_loss": bce_blur_loss}[fn]
    got = float(port(torch.from_numpy(logits), torch.from_numpy(targets),
                     **kw))
    assert got == pytest.approx(want, rel=1e-6)


def test_single_device_mesh_shape_runs():
    task = YoloTask(_config("", "", mesh_shape=(1, 1)), device="cpu")
    assert isinstance(task.image_predict(np.zeros((32, 32, 3), np.uint8),
                                         0.5), list)
