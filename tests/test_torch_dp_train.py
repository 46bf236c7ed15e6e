"""Data-parallel training of the port over 2 gloo CPU ranks
(parallel.dist.run_ranks; graft_entry.run_step / run_steps and
YoloTask.train): the 2-rank v8n step against the JAX package's step on a
2-device mesh, FSDP against DP, the DP step against the single-device step
for segment, pose, OBB End2End and classify, a 2-rank train() and its val
against one device's, and the sharded-directory resume at 2 -> 1 ranks."""

import os

import jax
import numpy as np
import pytest
import torch

from test_torch_data import make_dataset
from test_torch_train import (ADAM_EPS, GRAD_NOISE, NC, _batch,
                              _delta_close, _self_labelled_val,
                              net_variables)
from yolosharp_tpu import train as jax_train
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.parallel import create_mesh as jax_create_mesh
from yolosharp_tpu.parallel import replicate_tree
from yolosharp_tpu.parallel import shard_batch as jax_shard_batch
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import ScalarType as JaxScalar
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask)
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.graft_entry import _dryrun_batch, run_step, \
    run_steps
from yolosharp_tpu_torch.nn import ConvBN
from yolosharp_tpu_torch.parallel import create_mesh, fsdp_spec
from yolosharp_tpu_torch.tasks import _TASKS

CPU1 = ["cpu"]
CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**kw):
    return Config(**{"yolo_size": YoloSize.n, "number_class": NC,
                     "scalar_type": ScalarType.float32, "end2end": False,
                     "image_size": 64, "batch_size": 4, **kw})


def _resolved(g: np.ndarray) -> np.ndarray:
    """Where a gradient's sign fixes AdamW's first update against the
    float32 noise of test_torch_train (GRAD_NOISE of the tensor's
    largest)."""
    dg = GRAD_NOISE * np.abs(g).max()
    return np.abs(g) > max(dg, (2e3 * ADAM_EPS * dg) ** 0.5)


def _check_params(got, init, want, grads, min_checked=0.8, ulp=False):
    """Each parameter's change against `want`'s by _delta_close where the
    gradient is resolved (not in a leaf whose gradient is rounding noise,
    below 1e-6 of the net's largest: SPPF's cv1 BN bias, which cv2's
    train-mode BN removes); at least min_checked of the elements checked.
    ulp: plus one float32 spacing of each parameter (a second step's
    change near lr = 1e-8 is a fraction of a BN scale's spacing)."""
    big = max(float(g.abs().max()) for g in grads.values())
    checked = total = 0
    for name, g in grads.items():
        g = g.numpy()
        res = _resolved(g) & (np.abs(g).max() >= 1e-6 * big)
        d_got = (got[name] - init[name]).numpy()
        d_want = (want[name] - init[name]).numpy()
        spacing = (np.spacing(np.abs(init[name].numpy())) if ulp
                   else np.zeros(g.shape, np.float32))
        if res.any():
            _delta_close(d_got[res], d_want[res], name, spacing[res])
        checked += int(res.sum())
        total += g.size
    assert checked > min_checked * total, (checked, total)


def _check_stats(got, want, rtol=1e-5):
    """Each running statistic to rtol of itself plus rtol of its tensor's
    largest; a running mean plus rtol of its layer's largest standard
    deviation too (a mean near 0 is a sum of values of that spread, and
    the ranks' partial sums round in another order than one sum)."""
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        ref = want[k].numpy()
        scale = np.abs(ref).max()
        if k.endswith("running_mean"):
            var = want[k[:-len("mean")] + "var"].numpy()
            scale = max(scale, float(np.sqrt(var).max()))
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=rtol,
                                   atol=rtol * scale, err_msg=k)


@pytest.fixture(scope="module")
def v8n_steps():
    """The v8n NMS model's step at 64x64 on a batch of 4 (the JAX step
    tests' jittered weights): by the JAX package's make_train_step on a
    2-device mesh (the conftest's virtual CPU devices), and by the port's
    DP and FSDP steps over 2 gloo ranks, in one launch."""
    batch = _batch(5, b=4)
    jnet, variables = net_variables("v8", False, 5)
    jloss = JaxYoloTask(JaxConfig(
        yolo_size=JaxSize.n, number_class=NC, scalar_type=JaxScalar.float32,
        end2end=False)).task._loss_fns()[0]
    tx = jax_train.make_optimizer(nc=NC, epochs=2, steps_per_epoch=1)
    mesh = jax_create_mesh(devices=jax.devices()[:2])
    jstate = jax_train.TrainState.create(variables, tx)
    jstate = jstate.replace(
        params=replicate_tree(jstate.params, mesh),
        batch_stats=replicate_tree(jstate.batch_stats, mesh),
        opt_state=replicate_tree(jstate.opt_state, mesh))
    jstep = jax_train.make_train_step(jnet, jloss, mesh=mesh, donate=False)
    jnew, jl, jitems = jstep(jstate, jax_shard_batch(batch, mesh), {})
    sd = state_dict_from_jax(variables)
    spec = dict(config=_config(), state_dict=sd, batch=batch)
    dp, fsdp = run_steps([spec, dict(spec, fsdp=True)], CPU2)
    return dict(dp=dp, fsdp=fsdp, init=sd, jloss=float(jl),
                jitems=np.asarray(jitems),
                jnew=state_dict_from_jax(jnew.variables))


def test_dp_step_matches_jax_mesh_step(v8n_steps):
    """The port's 2-rank DP step against the JAX 2-device mesh step from
    the same weights and batch, by the rules of the single-device step
    test (test_torch_train.test_train_step_matches_jax): loss and items to
    1e-4 relative, parameter changes where the gradient is resolved, BN
    statistics to 1e-5 relative; one update counted."""
    dp = v8n_steps["dp"]
    np.testing.assert_allclose(dp["items"], v8n_steps["jitems"], rtol=1e-4)
    np.testing.assert_allclose(dp["loss"], v8n_steps["jloss"], rtol=1e-4)
    assert dp["count"] == dp["step"] == 1
    _check_params(dp["state_dict"], v8n_steps["init"], v8n_steps["jnew"],
                  dp["grads"])
    _check_stats(dp["state_dict"], v8n_steps["jnew"])


def test_fsdp_step_equals_dp_step(v8n_steps):
    """FSDP (the AdamW state and master weights sharded by fsdp_spec,
    gradients reduce-scattered) gives the DP step's loss, items, weights
    and statistics; each rank holds sharded_param_bytes of the state, less
    than the whole, besides the full working weights of the sharded
    parameters."""
    dp, fs = v8n_steps["dp"], v8n_steps["fsdp"]
    np.testing.assert_allclose(fs["loss"], dp["loss"], rtol=1e-6)
    np.testing.assert_allclose(fs["items"], dp["items"], rtol=1e-6)
    for k, v in dp["state_dict"].items():
        torch.testing.assert_close(fs["state_dict"][k], v, rtol=1e-6,
                                   atol=1e-7, msg=k)
    assert fs["state_bytes"] == fs["sharded_param_bytes"]
    full = sum(v.numel() * v.element_size() * (3 if "running" not in k
                                               else 1)
               for k, v in dp["state_dict"].items()
               if v.dtype == torch.float32)
    assert fs["state_bytes"] < 0.7 * full
    assert fs["working_bytes"] == sum(
        v.numel() * v.element_size() for k, v in v8n_steps["init"].items()
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))
        and fsdp_spec(v.shape, 2) is not None)


def _family_specs():
    """(name, config, batch, loss_kwargs) of the segment, pose, OBB
    End2End and classify steps: dryrun_multichip's batches at 64x64,
    batch 4."""
    rng = np.random.default_rng(1)
    b = 4
    kpts = rng.uniform(0.2, 0.8, (b, 8, 4, 3)).astype(np.float32)
    kpts[..., 2] = rng.integers(0, 3, (b, 8, 4))
    obb = np.concatenate([rng.uniform(0.2, 0.6, (b, 8, 4)),
                          rng.uniform(-0.7, 0.7, (b, 8, 1))],
                         -1).astype(np.float32)
    cls = _dryrun_batch(rng, b, NC)
    cls["cls"] = rng.integers(0, NC, (b,)).astype(np.int32)
    return {
        "segment": (_config(task_type=TaskType.segment), _dryrun_batch(
            rng, b, NC, masks=rng.integers(0, 9, (b, 16, 16)).astype(
                np.float32)), {}),
        "pose": (_config(task_type=TaskType.pose, number_class=1,
                         keypoint_num=4, keypoint_dim=3),
                 _dryrun_batch(rng, b, 1, keypoints=kpts,
                               cls=np.zeros((b, 8), np.int32)), {}),
        "obb_e2e": (_config(task_type=TaskType.obb, end2end=True),
                    _dryrun_batch(rng, b, NC, bboxes=obb),
                    {"o2m_gain": 0.8, "o2o_gain": 0.2}),
        "classify": (_config(task_type=TaskType.classify), cls, {}),
    }


@pytest.fixture(scope="module")
def family_steps():
    """Each family's step on one device and over 2 gloo ranks (the four in
    one launch), from the task's seeded weights."""
    specs = {}
    for name, (cfg, batch, kw) in _family_specs().items():
        sd = _TASKS[cfg.task_type](cfg, "cpu")._ensure_variables() \
            .state_dict()
        specs[name] = dict(config=cfg, state_dict=sd, batch=batch,
                           loss_kwargs=kw)
    names = list(specs)
    one = run_steps([specs[n] for n in names], CPU1)
    dp = run_steps([specs[n] for n in names], CPU2)
    return {n: (o, d, specs[n]["state_dict"])
            for n, o, d in zip(names, one, dp)}


@pytest.mark.parametrize("family", ["segment", "pose", "obb_e2e",
                                    "classify"])
def test_dp_step_equals_single_device_step(family, family_steps):
    """The 2-rank step of each family equals one device's on the whole
    batch: loss and items to 1e-4 relative; summed gradients within 1e-3
    of each tensor's largest (leaves whose gradient is rounding noise,
    below 1e-6 of the net's largest, read as such on both); parameter
    changes where the gradient is resolved; BN statistics to 1e-5."""
    one, dp, init = family_steps[family]
    np.testing.assert_allclose(dp["items"], one["items"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-4)
    big = max(float(g.abs().max()) for g in one["grads"].values())
    for name, g in one["grads"].items():
        top = float(g.abs().max())
        if top < 1e-6 * big:
            assert float(dp["grads"][name].abs().max()) < 1e-6 * big, name
            continue
        torch.testing.assert_close(dp["grads"][name], g, rtol=0,
                                   atol=1e-3 * top, msg=name)
    _check_params(dp["state_dict"], init, one["state_dict"], one["grads"],
                  min_checked=0.5)
    if family != "classify" or any("running" in k for k in init):
        _check_stats(dp["state_dict"], one["state_dict"])


def _train_config(root, out, **kw):
    return _config(root_path=root, train_data_path="images/train",
                   val_data_path="images/val", output_path=out, epochs=2,
                   workers=1, flip_lr=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
                   **kw)


def _detections_possible(net):
    """Conv kernels x2.5 and the head's final convs from U(-0.3, 0.3), as
    test_torch_train.test_val_matches_jax: the untrained net detects."""
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(2.5)
        for tower in (net.model[22].cv2, net.model[22].cv3):
            for branch in tower:
                for p in (branch[2].weight, branch[2].bias):
                    p.copy_(torch.from_numpy(
                        rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)))


def test_two_rank_train_and_val(tmp_path):
    """train() over 2 gloo ranks (batch 4, 2 epochs) writes one log.csv of
    two epochs, one config.txt and one set of weights; val() of the
    trained weights over 2 ranks equals one device's val of them: loss
    items to 1e-4 relative, P, R, mAP50 and mAP50-95 to 1e-4, on images
    labelled from the net's own detections."""
    root = str(tmp_path / "data")
    make_dataset(root, 8, 1, [(64, 48), (48, 64), (64, 64)], NC, seed=2)
    out = str(tmp_path / "out")
    task = YoloTask(_train_config(root, out), device="cpu")
    _detections_possible(task.task._ensure_variables())
    _self_labelled_val(root, task)
    state = task.train(mesh=create_mesh(devices=CPU2))
    assert state.step == 2 * 2 and not task.task.net.training
    rows = open(os.path.join(out, "log.csv")).read().strip().splitlines()
    assert len(rows) == 3 and [r.split(",")[0] for r in rows[1:]] == \
        ["1", "2"]
    assert sorted(os.listdir(os.path.join(out, "weights"))) == \
        ["best.bin", "last.bin", "last_state.npz"]
    assert sorted(os.listdir(out)) == ["config.txt", "log.csv",
                                       "results.png", "weights"]
    ranks = task.task.epoch_stats[-1]["ranks"]
    assert len(ranks) == 2 and all(len(r["step_s"]) == 2 for r in ranks)

    items2, metrics2 = task.val(mesh=create_mesh(devices=CPU2))
    items1, metrics1 = task.val()
    np.testing.assert_allclose(items2, items1, rtol=1e-4)
    np.testing.assert_allclose(metrics2, metrics1, atol=1e-4)
    assert max(metrics1) > 0


def test_sharded_directory_resume_two_ranks_to_one(tmp_path):
    """Two FSDP steps over 2 ranks, the state saved after the first as a
    torch.distributed.checkpoint directory; one device reads it back (the
    counts of one step) and takes the second step: its loss and items
    equal the uninterrupted run's to 1e-5 relative, its counts are 2, and
    its weights follow the uninterrupted run's where the gradient is
    resolved."""
    cfg = _config()
    sd = _TASKS[cfg.task_type](cfg, "cpu")._ensure_variables().state_dict()
    batch = _batch(7, b=4)
    ck = str(tmp_path / "last_state.dcp")
    two = run_step(cfg, sd, batch, fsdp=True, devices=CPU2, steps=2,
                   save_dcp=ck)
    assert os.path.isdir(ck)
    saved = run_step(cfg, sd, batch, resume=ck, steps=0, devices=CPU1)
    assert saved["count"] == saved["step"] == 1
    res = run_step(cfg, sd, batch, resume=ck, devices=CPU1)
    assert res["count"] == res["step"] == 2
    np.testing.assert_allclose(res["loss"], two["loss"], rtol=1e-5)
    np.testing.assert_allclose(res["items"], two["items"], rtol=1e-5)
    _check_params(res["state_dict"], saved["state_dict"],
                  two["state_dict"], res["grads"], ulp=True)
    _check_stats(res["state_dict"], two["state_dict"])
