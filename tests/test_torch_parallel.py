"""The port's multi-device layer (yolosharp_tpu_torch/parallel) on the CPU:
fsdp_spec, sharded_param_bytes and _make_mesh against the JAX package's,
shard_batch's padding, the global batch_norm_train of 2 gloo ranks
against one process, and the launcher's failure reports."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_rank_fns import bn_rank
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.nn import ArchCfg as JaxArch
from yolosharp_tpu.nn import YoloNet as JaxNet
from yolosharp_tpu.parallel import create_mesh as jax_create_mesh
from yolosharp_tpu.parallel.fsdp import fsdp_spec as jax_fsdp_spec
from yolosharp_tpu.parallel.fsdp import \
    sharded_param_bytes as jax_sharded_param_bytes
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu import train as jax_train
from yolosharp_tpu_torch import Config, YoloTask
from yolosharp_tpu_torch.nn import ArchCfg, YoloNet
from yolosharp_tpu_torch.parallel import (create_mesh, dist, fsdp_spec,
                                          shard_batch, sharded_param_bytes)
from yolosharp_tpu_torch.parallel.dist import RankFailure, run_ranks
from yolosharp_tpu_torch.train import make_optimizer

CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the spawned ranks take the caller's count):
    the suite runs several pytest workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dim(spec: P):
    return next((i for i, a in enumerate(spec) if a is not None), None)


@pytest.mark.parametrize("shape,axis,min_size", [
    ((), 8, 4096), ((16,), 8, 4096), ((3, 3, 64, 128), 8, 1),
    ((3, 3, 128, 128), 8, 1), ((3, 3, 256, 128), 8, 1),
    ((3, 3, 3, 11), 8, 1), ((64, 3, 3, 3), 2, 4096),
    ((256, 128, 3, 3), 2, 4096), ((255, 64), 2, 1)],
    ids=lambda v: str(v))
def test_fsdp_spec_matches_jax(shape, axis, min_size):
    """The dim the port shards is the one the JAX rule names (the cases of
    tests/test_fsdp.py and three more): scalars and small leaves
    replicated, the largest divisible dim, ties to the trailing one."""
    want = _jax_dim(jax_fsdp_spec(shape, axis, min_size=min_size))
    assert fsdp_spec(shape, axis, min_size=min_size) == want


def test_sharded_param_bytes_matches_jax_v8n():
    """On the JAX v8n TrainState's own leaves the port's count equals the
    JAX count over a 2-device mesh; and the port's state (parameters, BN
    statistics, AdamW's two moments) counts what the JAX parameters, BN
    statistics and optax moments count."""
    jnet = JaxNet(JaxArch(version="v8", size="n", task="detect", nc=3))
    variables = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                          False)
    tx = jax_train.make_optimizer(nc=3, epochs=2, steps_per_epoch=1)
    jstate = jax_train.TrainState.create(variables, tx)
    mesh = jax_create_mesh(devices=jax.devices()[:2])
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    assert sharded_param_bytes(leaves, 2) == \
        jax_sharded_param_bytes(jstate, mesh)

    params = jax.tree_util.tree_leaves(variables["params"])
    jtree = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "mu": variables["params"], "nu": variables["params"]}
    net = YoloNet(ArchCfg(version="v8", size="n", nc=3))
    trainable = [p for p in net.parameters() if p.requires_grad]
    assert sum(p.numel() for p in trainable) == sum(
        int(np.prod(np.shape(p))) for p in params)
    stats = [b for n, b in net.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    port = trainable * 3 + stats
    assert sharded_param_bytes(port, 2) == jax_sharded_param_bytes(jtree,
                                                                   mesh)
    assert sharded_param_bytes(port, 2) < sharded_param_bytes(port, 1)


@pytest.mark.parametrize("batch", [16, 6, 7, 12, 1, 5])
def test_make_mesh_matches_jax(batch, capsys, monkeypatch):
    """Over 8 visible devices (the conftest's virtual CPU devices on the
    JAX side), the port's mesh has the JAX mesh's device count for the
    batch, prints the same warning, and is cached per batch size."""
    jtask = JaxYoloTask(JaxConfig()).task
    want = jtask._make_mesh(batch)
    want_d = 1 if want is None else len(want.devices.flat)
    want_out = capsys.readouterr().out
    task = YoloTask(Config(), device="cpu").task
    monkeypatch.setattr(task, "_visible_devices",
                        lambda: [torch.device("cpu")] * 8)
    mesh = task._make_mesh(batch)
    got_d = 1 if mesh is None else mesh.size
    assert got_d == want_d
    assert capsys.readouterr().out == want_out
    assert task._make_mesh(batch) is mesh
    assert capsys.readouterr().out == ""


def test_make_mesh_reuses_an_equal_mesh(monkeypatch):
    task = YoloTask(Config(), device="cpu").task
    monkeypatch.setattr(task, "_visible_devices",
                        lambda: [torch.device("cpu")] * 8)
    assert task._make_mesh(12) is task._make_mesh(6)
    assert task._make_mesh(16).size == 8


def test_one_device_makes_no_mesh(capsys):
    task = YoloTask(Config(), device="cpu").task
    assert task._make_mesh(16) is None
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("n,dp", [(1, 2), (3, 2), (4, 2), (5, 4), (8, 4)])
def test_shard_batch_pads_with_the_last_row(n, dp):
    """Rows split over the data axis, padded with repeats of the last row
    to a multiple of it (the JAX _sharded_predict_inputs)."""
    batch = np.arange(n * 6, dtype=np.uint8).reshape(n, 2, 3)
    parts, real = shard_batch(batch, create_mesh(devices=["cpu"] * dp))
    assert real == n and len(parts) == dp
    per = -(-n // dp)
    assert all(p.shape == (per, 2, 3) for p in parts)
    whole = np.concatenate(parts)
    np.testing.assert_array_equal(whole[:n], batch)
    assert (whole[n:] == batch[-1]).all()


def test_mesh_shapes():
    mesh = create_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4} and mesh.size == 4
    mesh2 = create_mesh((2, 2), devices=["cpu", "cpu:1", "cpu:2",
                                          "cpu:3"])
    assert mesh2.shape == {"data": 2, "model": 2}
    # rows go to the first device of each data-axis entry
    assert [str(d) for d in mesh2.data_devices] == ["cpu", "cpu:2"]
    assert mesh.data_devices == mesh.devices
    with pytest.raises(ValueError, match="does not hold"):
        create_mesh((3,), devices=["cpu"] * 4)


def test_global_batch_norm_matches_one_process():
    """batch_norm_train over 2 gloo ranks of 2 rows each equals one
    process's over the 4 rows: the output and dL/dx (every rank's rows),
    dL/dweight and dL/dbias summed over the ranks, and the running mean and
    (biased) variance, to float32 rounding."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (4, 6, 5, 7)).astype(np.float32)
    gy = rng.normal(0, 1, x.shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = rng.normal(0, 0.3, 6).astype(np.float32)
    args = (x, gy, w, b)
    want = bn_rank(*args)
    got = run_ranks(lambda: bn_rank(*args), bn_rank, args, CPU2)
    for g, r, name in zip(got, want, ("y", "dx", "dw db", "mean", "var")):
        np.testing.assert_allclose(g, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


def test_a_failed_rank_raises_its_traceback():
    """A spawned rank that fails makes run_ranks raise RankFailure with
    that rank's traceback, while rank 0 waits in a collective."""
    def local():
        return dist.all_reduce_(torch.ones(3))

    with pytest.raises(RankFailure, match="(?s)rank 1 failed.*ValueError"):
        run_ranks(local, int, ("not a number",), CPU2)
    assert dist.active() is None


def test_a_failed_rank_zero_raises_its_own_error():
    def local():
        raise KeyError("rank 0 broke")

    with pytest.raises(KeyError, match="rank 0 broke"):
        run_ranks(local, dist.all_reduce_, (torch.ones(2),), CPU2)
    assert dist.active() is None


def test_allsum_is_the_identity_on_one_device():
    t = torch.arange(3.0, requires_grad=True)
    assert dist.allsum(t) is t
    net = YoloNet(ArchCfg(version="v8", size="n", nc=3))
    opt, _ = make_optimizer(net, nc=3, epochs=1, steps_per_epoch=1)
    assert len(opt.param_groups) == 3
