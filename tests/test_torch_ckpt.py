"""The port's own copies of the JAX package's numpy-only modules (Config,
types, the checkpoint file formats and the state-dict name map) against the
originals: same fields and defaults, the same files read and written in
both directions (bfloat16 included, decoded by torch in the port), the same
state dicts from the same variables."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from yolosharp_tpu import config as jax_config
from yolosharp_tpu import types as jax_types
from yolosharp_tpu.ckpt import binio as jax_binio
from yolosharp_tpu.ckpt import mapping as jax_mapping
from yolosharp_tpu.ckpt import pickle_pt as jax_pickle_pt
from yolosharp_tpu.ckpt import safetensors_io as jax_safetensors
from yolosharp_tpu_torch import config, types
from yolosharp_tpu_torch.ckpt import (binio, load_state_dict_file, mapping,
                                      pickle_pt, safetensors_io,
                                      state_dict_from_jax)

BF16 = np.dtype(ml_dtypes.bfloat16)


def test_config_fields_and_defaults_match_the_jax_config():
    ours = {f.name: f for f in dataclasses.fields(config.Config)}
    theirs = {f.name: f for f in dataclasses.fields(jax_config.Config)}
    assert list(ours) == list(theirs)
    for name, f in theirs.items():
        assert ours[name].default == f.default, name
        assert ours[name].default_factory == f.default_factory, name
    cfg, jcfg = config.Config(), jax_config.Config()
    assert cfg.describe() == jcfg.describe()
    assert cfg.kpt_shape == jcfg.kpt_shape
    assert not hasattr(cfg, "compute_dtype")


@pytest.mark.parametrize("scalar,fp16,want", [
    ("float32", False, torch.float32), ("float16", False, torch.bfloat16),
    ("bfloat16", False, torch.bfloat16), ("float16", True, torch.float16)])
def test_torch_dtype_maps_as_compute_dtype(scalar, fp16, want):
    cfg = config.Config(scalar_type=types.ScalarType(scalar), true_fp16=fp16)
    assert config.torch_dtype(cfg) == want
    jcfg = jax_config.Config(scalar_type=jax_types.ScalarType(scalar),
                             true_fp16=fp16)
    assert jnp.dtype(jcfg.compute_dtype).name == str(want)[len("torch."):]


@pytest.mark.parametrize("name", ["YoloType", "YoloSize", "TaskType",
                                  "ImageProcessType", "ScalarType",
                                  "AutoAugmentType"])
def test_enums_match(name):
    ours, theirs = getattr(types, name), getattr(jax_types, name)
    assert [(m.name, m.value) for m in ours] == [(m.name, m.value)
                                               for m in theirs]


def test_result_types_match():
    for name in ("YoloResult", "KeyPoint"):
        ours = [(f.name, f.default) for f in
                dataclasses.fields(getattr(types, name))]
        theirs = [(f.name, f.default) for f in
                  dataclasses.fields(getattr(jax_types, name))]
        assert ours == theirs


def _arrays(seed=0):
    """Names -> numpy arrays of every dtype the formats carry, bfloat16 as
    ml_dtypes (the JAX package's own type), 0-d and empty included."""
    rng = np.random.default_rng(seed)
    return {
        "model.0.conv.weight": rng.standard_normal((4, 3, 3, 3)).astype(
            np.float32),
        "model.0.bn.weight": rng.standard_normal(4).astype(np.float16),
        "model.1.w64": rng.standard_normal((2, 5)),
        "model.1.bf16": rng.standard_normal((3, 7)).astype(BF16),
        "model.0.bn.num_batches_tracked": np.array(7, np.int64),
        "model.2.mask": rng.random((2, 3)) > 0.5,
        "model.2.idx": rng.integers(-100, 100, (6,), dtype=np.int32),
        "model.2.bytes": rng.integers(0, 255, (5,), dtype=np.uint8),
        "model.3.empty": np.zeros((0, 4), np.float32),
    }


def _same(got, want):
    """One entry of the port's reader (bf16 as a torch tensor) against the
    JAX package's (bf16 as ml_dtypes): dtype, shape and values."""
    want = np.asarray(want)
    if want.dtype == BF16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
        return
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _port_arrays(arrays):
    """The same entries as the port writes them: bf16 as torch tensors."""
    return {k: (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                if v.dtype == BF16 else v) for k, v in arrays.items()}


FORMATS = {
    "bin": (jax_binio.save_bin, jax_binio.load_bin, binio.save_bin,
            binio.load_bin),
    "safetensors": (jax_safetensors.save_safetensors,
                    jax_safetensors.load_safetensors,
                    safetensors_io.save_safetensors,
                    safetensors_io.load_safetensors),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_files_written_by_the_jax_package_load_in_the_port(fmt, tmp_path):
    jax_save, jax_load, _, load = FORMATS[fmt]
    arrays = _arrays()
    if fmt == "safetensors":   # its writer promotes 0-d arrays to 1-d
        arrays.pop("model.0.bn.num_batches_tracked")
    path = str(tmp_path / f"w.{fmt}")
    jax_save(path, arrays)
    got, want = load(path), jax_load(path)
    assert list(got) == list(want) == list(arrays)
    for k in arrays:
        _same(got[k], want[k])
    assert list(load_state_dict_file(path)) == list(arrays)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_files_written_by_the_port_load_in_the_jax_package(fmt, tmp_path):
    _, jax_load, save, load = FORMATS[fmt]
    arrays = _arrays(1)
    if fmt == "safetensors":
        arrays.pop("model.0.bn.num_batches_tracked")
    path = str(tmp_path / f"w.{fmt}")
    save(path, _port_arrays(arrays))
    want = jax_load(path)
    assert list(want) == list(arrays)
    for k, v in arrays.items():
        assert want[k].dtype == v.dtype and want[k].shape == v.shape
        np.testing.assert_array_equal(np.asarray(want[k], np.float64)
                                      if v.dtype == BF16 else want[k],
                                      np.asarray(v, np.float64)
                                      if v.dtype == BF16 else v)
        _same(load(path)[k], v)


@pytest.mark.parametrize("wrap", ["state_dict", "model"])
def test_pt_files_load_alike_in_both_packages(wrap, tmp_path):
    """A torch.save checkpoint: a plain state dict, and an Ultralytics-style
    {"model": nn.Module} whose names are rebuilt from the module tree; every
    tensor in torch's own shape (the JAX reader makes a 0-d one 1-d)."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                              torch.nn.BatchNorm2d(4))
    net[0].to(torch.bfloat16)
    obj = net.state_dict() if wrap == "state_dict" else {"model": net,
                                                         "epoch": 3}
    path = str(tmp_path / "w.pt")
    torch.save(obj, path)
    got, want = pickle_pt.load_pt(path), jax_pickle_pt.load_pt(path)
    assert list(got) == list(want)
    assert set(got) == set(net.state_dict())
    for k in want:
        assert tuple(got[k].shape) == tuple(net.state_dict()[k].shape), k
        if net.state_dict()[k].dim() == 0:
            # the 0-d num_batches_tracked: the JAX reader makes it (1,)
            assert want[k].shape == (1,)
            _same(got[k], want[k].reshape(()))
            continue
        _same(got[k], want[k])
    assert got["0.weight"].dtype == torch.bfloat16
    assert torch.equal(got["0.weight"], net[0].weight.detach())


def _variables(seed=0, as_jax=False):
    """A small flax-style variables tree with every kind of leaf the name
    map handles: conv kernels, BN scale/bias/stats, a linear weight, a
    plain parameter, the head's DFL-bearing cv2 and a one2one tower."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return jnp.asarray(x) if as_jax else x

    params = {
        "0": {"conv": {"kernel": a(3, 3, 3, 8)},
              "bn": {"scale": a(8), "bias": a(8)}},
        "1": {"linear.weight": a(8, 5), "linear": {"bias": a(5)},
              "gamma": a(8)},
        "2": {"cv2": {"0": {"2": {"kernel": a(1, 1, 8, 64), "bias": a(64)}}},
              "one2one_cv2": {"0": {"2": {"kernel": a(1, 1, 8, 64),
                                          "bias": a(64)}}}},
    }
    stats = {"0": {"bn": {"mean": a(8), "var": a(8)}}}
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("one2one", [False, True])
def test_variables_to_state_dict_matches_the_jax_exporter(one2one):
    variables = _variables()
    got = mapping.variables_to_state_dict(variables,
                                          include_one2one=one2one)
    want = jax_mapping.variables_to_state_dict(variables,
                                               include_one2one=one2one)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert mapping.head_index(variables["params"]) == 2
    assert mapping.flatten(variables["params"]).keys() == \
        jax_mapping.flatten(variables["params"]).keys()


def test_state_dict_from_jax_takes_numpy_and_jax_trees_alike():
    from_numpy = state_dict_from_jax(_variables())
    from_jax = state_dict_from_jax(_variables(as_jax=True))
    assert list(from_numpy) == list(from_jax)
    for k, v in from_jax.items():
        assert v.dtype == from_numpy[k].dtype
        assert torch.equal(v, from_numpy[k]), k


@pytest.mark.parametrize("task,nc,nk", [("detect", 80, None),
                                        ("detect", 5, None),
                                        ("classify", 10, None),
                                        ("classify", 4, None),
                                        ("pose", 1, 17), ("pose", 1, 5)])
def test_skip_patterns_match_the_jax_package(task, nc, nk):
    sd = {"model.22.cv3.2.2.bias": np.zeros(80, np.float32),
          "model.22.cv4.2.2.bias": np.zeros(51, np.float32),
          "model.22.linear.bias": np.zeros(10, np.float32)}
    want = jax_mapping.skip_patterns_for_nc_mismatch(task, 22, sd, nc, nk)
    got = mapping.skip_patterns_for_nc_mismatch(task, 22, sd, nc, nk)
    assert got == want
    # the port's readers hand bf16 entries over as torch tensors
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert mapping.skip_patterns_for_nc_mismatch(task, 22, tsd, nc, nk) == want
