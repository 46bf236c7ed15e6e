"""The device mesh of the port (counterpart of
yolosharp_tpu/parallel/mesh.py:24-53).

A ``Mesh`` is an ordered list of ``torch.device``s with axis names and a
shape (row-major: the data axis first). The JAX package shards one SPMD
program over it; the port uses it in two ways: ``batch_predict`` /
``predict_stream`` split a batch's rows over its data axis in one process
(``shard_batch``, a replica of the folded net on each data-axis device from
``replicate_tree``), and ``train()`` / ``val()`` run one process a device of
a 1-D mesh under a process group (``parallel.dist``). The model axis, as in
the JAX package, is reserved: nothing is split along it, so a 2-D mesh
computes on ``data_devices``, the first device of each data-axis entry (the
JAX program replicates the same rows over the model axis). A mesh of
repeated ``cpu`` entries is allowed, so that the CPU runs the same code at
two devices.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """Devices laid out on named axes (the data axis first)."""

    def __init__(self, devices: Sequence, shape: Tuple[int, ...],
                 axis_names: Tuple[str, ...]):
        self.devices = [torch.device(d) for d in devices]
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = tuple(axis_names)
        if int(np.prod(shape)) != len(self.devices):
            raise ValueError(f"mesh shape {tuple(shape)} does not hold "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data_devices(self):
        """The first device of each data-axis entry: where the rows go."""
        return self.devices[::self.size // self.shape[DATA_AXIS]]

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{tuple(self.shape.values())}, {self.axis_names})")


def visible_devices(kind: str = "cuda"):
    """Every visible CUDA device (``kind="cuda"``), or the one CPU."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                devices=None) -> Mesh:
    """1-D data mesh over `devices` (default: every visible CUDA device);
    shape=(dp, tp) gives a 2-D mesh, the model axis reserved as in the JAX
    package."""
    devices = list(visible_devices() if devices is None else devices)
    if not devices:
        raise RuntimeError("create_mesh: no device (no CUDA device is "
                           "visible; pass devices=['cpu', ...] for a CPU "
                           "mesh)")
    if shape is None:
        shape = (len(devices),)
    names = (DATA_AXIS,) if len(shape) == 1 else (DATA_AXIS, MODEL_AXIS)
    return Mesh(devices, tuple(shape), names)


def shard_batch(batch: np.ndarray, mesh: Mesh):
    """(row slices of `batch`, one a data-axis entry (its data_devices), the
    real row count): the batch padded with repeats of its last row to a
    multiple of the data axis, as the JAX package's _sharded_predict_inputs
    (yolosharp_tpu/tasks.py:107-124); callers slice results back."""
    dp = mesh.shape[DATA_AXIS]
    n = batch.shape[0]
    pad = (-n) % dp
    if pad:
        batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])
    per = batch.shape[0] // dp
    return [batch[i * per:(i + 1) * per] for i in range(dp)], n


def replicate_tree(module: torch.nn.Module, mesh: Mesh):
    """One copy of `module` on each of the mesh's data_devices: `module`
    itself on the device it lives on, a copy elsewhere."""
    on = next(module.parameters()).device
    return [module if dev == on else copy.deepcopy(module).to(dev)
            for dev in mesh.data_devices]


__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "create_mesh",
           "replicate_tree", "shard_batch", "visible_devices"]
