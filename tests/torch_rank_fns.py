"""Rank-side functions of the multi-process CPU tests of the port (spawned
ranks import this module, so it imports neither jax nor the JAX package).

Each runs on every rank of a parallel.dist.run_ranks group and returns
what rank 0 reports."""

import sys

import numpy as np
import torch
from torch import nn

from yolosharp_tpu_torch.nn.common import batch_norm_train
from yolosharp_tpu_torch.parallel import dist


def foreign_modules():
    """The loaded modules of jax, flax or the JAX package yolosharp_tpu."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "flax", "yolosharp_tpu")
                  or m.startswith(("jax.", "flax.", "yolosharp_tpu.")))


def bn_rank(x: np.ndarray, gy: np.ndarray, weight: np.ndarray,
            bias: np.ndarray):
    """batch_norm_train on this rank's rows of x (B, C, H, W) with a BN of
    `weight` / `bias` and identity statistics, backward of sum(y * gy):
    (every rank's y and dL/dx gathered in rank order, dL/dweight and
    dL/dbias summed over the ranks, the running mean and variance)."""
    ctx = dist.active()
    rank, world = (ctx.rank, ctx.world) if ctx is not None else (0, 1)
    per = x.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    bn = nn.BatchNorm2d(x.shape[1], eps=1e-3, momentum=0.03)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xs = torch.from_numpy(x[rows]).requires_grad_()
    y = batch_norm_train(xs, bn)
    (y * torch.from_numpy(gy[rows])).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    if world > 1:
        y = dist.all_gather(y.detach())
        dx = dist.all_gather(xs.grad)
        dist.all_reduce_(grads)
    else:
        dx = xs.grad
    return (y.detach().numpy(), dx.numpy(), grads.numpy(),
            bn.running_mean.numpy().copy(), bn.running_var.numpy().copy())


def step_without_jax(config, state_dict, batch):
    """A data-parallel train step (graft_entry.run_step's rank side), then
    a failure if this process has loaded JAX or the JAX package."""
    from yolosharp_tpu_torch.graft_entry import _rank_step

    out = _rank_step(config, state_dict, batch)
    found = foreign_modules()
    if found:
        raise RuntimeError(f"a rank imported {found}")
    return out["loss"]
