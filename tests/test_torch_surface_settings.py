"""The settings of the JAX package's multi-device and int8 layers on one
device: each builds, and runs as in the JAX package (split from
test_torch_surface.py so that its train() runs spread over the test
workers)."""

import os

import numpy as np
import pytest

from test_torch_surface_trace import _config, roots  # noqa: F401
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu_torch import YoloTask

NC = 3


# --------------------------------- the multi-device settings on one device
@pytest.mark.parametrize("field,value,where", [
    ("int8_predict", True, "predict"), ("fsdp", True, "train"),
    ("resume_format", "orbax", "train"), ("mesh_shape", (2,), "train"),
    ("mesh_shape", (1, 2), "predict")],
    ids=["int8_predict", "fsdp", "orbax", "mesh_train", "mesh_predict"])
def test_settings_not_ported_raise_where_jax_acts(field, value, where,
                                                  roots, tmp_path):
    """The Config and the task build with each setting (so a config.txt
    with them reads), and each runs as in the JAX package on one device:
    int8_predict predicts in float until calibrate_int8 or
    load_calibration gives it stats (tests/test_torch_int8.py runs the
    int8 route), fsdp trains unsharded,
    resume_format="orbax" writes weights/last_state.dcp (a
    torch.distributed.checkpoint directory) that train(resume_from=) reads,
    and mesh_shape is read nowhere, at train() as at predict."""
    out = tmp_path / "out"
    cfg = _config(roots[6], str(out), **{field: value})
    task = YoloTask(cfg, device="cpu")
    img = np.zeros((32, 32, 3), np.uint8)
    if field == "int8_predict":
        plain = YoloTask(_config(roots[6], str(out)), device="cpu")
        plain.task._ensure_variables().load_state_dict(
            task.task._ensure_variables().state_dict())
        assert task.image_predict(img, 0.5) == plain.image_predict(img, 0.5)
        assert not os.path.exists(out)
        return
    if where == "predict":
        assert isinstance(task.image_predict(img, 0.5), list)
        assert not os.path.exists(out)
        return
    task.train()
    weights = sorted(os.listdir(out / "weights"))
    state = "last_state.dcp" if field == "resume_format" else \
        "last_state.npz"
    assert weights == sorted(["best.bin", "last.bin", state])
    if field == "resume_format":
        assert os.path.isdir(out / "weights" / state)
        cfg2 = _config(roots[6], str(out), **{field: value})
        cfg2.epochs = 2
        again = YoloTask(cfg2, device="cpu")
        again.train(resume_from=str(out / "weights" / state))
        assert [s["epoch"] for s in again.task.epoch_stats] == [2]
        assert again.task.epoch_stats[0]["step_s"]
