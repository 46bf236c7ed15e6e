"""The port's classify training against the JAX package on the CPU: the
optimizer groups of a classify net (the Linear's bias with the weights, as
the JAX labeller puts its "linear.bias" leaf), one float32 train step of
v8n-cls against the jitted JAX step from the same weights and batch,
YoloTask.train() of v5u, v8, v11 and v12 classify over two epochs (the
five output files, the log's columns, finite losses, no kernel launched),
and val's loss and top1 / top5 against the JAX val on the same weights and
images."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cls_data import cls_configs, make_cls_dataset
from test_torch_cls_model import jax_cls_variables, port_cls_net
from test_torch_train import ADAM_EPS, GRAD_NOISE, _delta_close
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu import train as jax_train
from yolosharp_tpu.ckpt.mapping import flatten
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data.dataset import ClassificationDataset as JaxDataset
from yolosharp_tpu.data.loader import DataLoader as JaxLoader
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import ScalarType as JaxScalar
from yolosharp_tpu.types import TaskType as JaxTaskType
from yolosharp_tpu.types import YoloType as JaxType
from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                 YoloTask, YoloType)
from yolosharp_tpu_torch.ckpt import state_dict_from_jax
from yolosharp_tpu_torch.data import ClassificationDataset, DataLoader
from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts
from yolosharp_tpu_torch.nn import ArchCfg, YoloNet
from yolosharp_tpu_torch.tasks import Classifier
from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                       make_train_step, param_group)

NC = 5
S = 64


def test_param_groups_match_jax():
    """Every trainable parameter of v8n-cls lands in the group the JAX
    optimizer labels its leaf with (the leaf key of the tree path: the
    head's "linear.weight" and "linear.bias" are single leaves, both in
    the weight group)."""
    jnet, _ = jax_cls_variables("v8", nc=NC)
    params = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), False))["params"]
    want = {}
    for key in flatten(params):
        path = key.split(".")
        if key.startswith("9.linear."):
            path = ["9", ".".join(path[1:])]
        stem, leaf = key.rsplit(".", 1)
        leaf = "weight" if leaf in ("kernel", "scale") else leaf
        want[f"model.{stem}.{leaf}"] = jax_train.param_group(tuple(path))
    net = YoloNet(ArchCfg(version="v8", size="n", task="classify", nc=NC))
    got = {n: param_group(n) for n, p in net.named_parameters()
           if p.requires_grad}
    assert got == want
    assert got["model.9.linear.bias"] == got["model.9.linear.weight"] == \
        "weight"
    assert got["model.9.conv.bn.bias"] == "bias"


def _cls_batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8),
            "cls": rng.integers(0, NC, b).astype(np.int32)}


def _assert_cls_stats(net, variables, batch_stats, rtol=1e-5):
    """Every running mean and variance to rtol of itself plus rtol of its
    tensor's largest (the rule of tests/test_torch_train.py)."""
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": batch_stats})
    got = net.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 52      # the 26 ConvBNs of v8n-cls
    for k in keys:
        ref = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(), err_msg=k)


def test_train_step_matches_jax():
    """One float32 step of v8n-cls at 64x64, batch 4, from the same weights
    and batch, held to the bounds of tests/test_torch_train.py's
    check_step_pair: the loss and items to 1e-4 relative, one update, each
    parameter's change by _delta_close wherever its gradient's sign is
    resolved against GRAD_NOISE of the tensor's largest (at least 0.8 of
    the elements), BN statistics to 1e-5 relative."""
    jnet, variables = jax_cls_variables("v8", nc=NC, seed=5)
    batch = _cls_batch(5)
    jloss_fn = JaxYoloTask(JaxConfig(
        task_type=JaxTaskType.classify, yolo_type=JaxType.v8,
        number_class=NC, scalar_type=JaxScalar.float32)).task._loss_fns()[0]
    tx = jax_train.make_optimizer(nc=NC, epochs=2, steps_per_epoch=1)
    jstate = jax_train.TrainState.create(variables, tx)
    jstep = jax_train.make_train_step(jnet, jloss_fn,
                                      compute_dtype=jnp.float32, donate=False)
    jnew, jl, jitems = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, {})

    net = port_cls_net("v8", variables, nc=NC).to(
        memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=NC, epochs=2, steps_per_epoch=1)
    state = TrainState(net, opt, scheds)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    loss_fn = Classifier(Config(task_type=TaskType.classify, number_class=NC,
                                scalar_type=ScalarType.float32),
                         device="cpu")._loss_fns()[0]
    loss, items = make_train_step(loss_fn)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, {})
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    assert state.count == state.step == 1
    want = state_dict_from_jax(jnew.variables)
    init = state_dict_from_jax(variables)
    checked = total = 0
    for name, p in net.named_parameters():
        g = p.grad.abs().numpy()
        dg = GRAD_NOISE * g.max()
        resolved = g > max(dg, (2e3 * ADAM_EPS * dg) ** 0.5)
        got = p.detach().numpy() - before[name].numpy()
        ref = (want[name] - init[name]).numpy()
        if resolved.any():
            _delta_close(got[resolved], ref[resolved], name)
        checked += int(resolved.sum())
        total += g.size
    assert checked > 0.8 * total, (checked, total)
    _assert_cls_stats(net, variables, jnew.batch_stats)


@pytest.fixture(scope="module")
def cls_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cls_train"))
    make_cls_dataset(root, 3, 2, NC, seed=3)
    return root


@pytest.mark.parametrize("version", ["v8", "v5u", "v11", "v12"])
def test_train_writes_outputs(cls_root, tmp_path, version):
    """train() of the n-size classify net over two epochs at 64 px, batch 4,
    the default augment stack (AutoAugment, erasing 0.4): config.txt,
    log.csv (train/cls_loss, val/cls_loss, metrics/top1, metrics/top5),
    best.bin, last.bin and last_state.npz; finite losses, top1 and top5 in
    [0, 1]; the master back in eval mode; no kernel launched (the train
    step runs no kernel; val runs the unfolded master)."""
    out = str(tmp_path / version)
    cfg, _ = cls_configs(cls_root, batch_size=4, epochs=2, workers=2,
                         output_path=out)
    cfg.yolo_type, cfg.yolo_size = YoloType(version), YoloSize.n
    cfg.scalar_type = ScalarType.float32
    task = YoloTask(cfg, device="cpu")
    assert isinstance(task.task, Classifier)
    reset_launch_counts()
    task.train()
    assert not any(launch_counts().values())
    for f in ("config.txt", "log.csv", "weights/best.bin", "weights/last.bin",
              "weights/last_state.npz"):
        assert os.path.exists(os.path.join(out, f)), f
    rows = [r.split(",") for r in open(os.path.join(out, "log.csv")).read()
            .strip().splitlines()]
    assert rows[0] == ["Epoch", "Time", "train/cls_loss", "val/cls_loss",
                       "metrics/top1", "metrics/top5", "train/loss",
                       "val/loss"]
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    values = np.array([[float(v) for v in r[2:]] for r in rows[1:]])
    assert np.isfinite(values).all()
    assert ((values[:, 2:4] >= 0) & (values[:, 2:4] <= 1)).all()
    assert not task.task.net.training
    assert len(task.task.epoch_stats) == 2
    assert len(task.task.epoch_stats[0]["step_s"]) == 4     # 15 images, b4


def test_val_matches_jax(tmp_path):
    """val of v8n-cls on the same weights and val set (10 classes, 3 images
    each, batch 4, the last batch padded with repeats as both loaders do):
    the loss items to 1e-4 relative, top1 and top5 equal. The weights are
    scaled so that the logits depend on the image."""
    root = str(tmp_path)
    nc = 10
    make_cls_dataset(root, 1, 3, nc, seed=6)
    jnet, variables = jax_cls_variables("v8", nc=nc, seed=7)
    common = dict(root_path=root, train_data_path="train",
                  val_data_path="val", image_size=S, number_class=nc,
                  batch_size=4)
    jtask = JaxYoloTask(JaxConfig(task_type=JaxTaskType.classify,
                                  scalar_type=JaxScalar.float32,
                                  **common)).task
    jtask.variables = variables
    jds = JaxDataset(jtask.config, is_val=True)
    want_items, want = jtask.val(JaxLoader(jds, 4, shuffle=False,
                                           workers=1, max_labels=1))
    port = YoloTask(Config(task_type=TaskType.classify,
                           scalar_type=ScalarType.float32, **common),
                    device="cpu")
    port.task._ensure_variables().load_state_dict(
        state_dict_from_jax(variables), strict=True)
    ds = ClassificationDataset(port.config, is_val=True)
    got_items, got = port.val(DataLoader(ds, 4, shuffle=False, workers=1))
    np.testing.assert_allclose(got_items, np.asarray(want_items), rtol=1e-4)
    assert got == [float(v) for v in want]
    assert 0 < got[0] < 1 and got[0] <= got[1]
    # the default loader: the configured val split
    assert port.val()[1] == got
