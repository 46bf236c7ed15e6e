"""Full training-state checkpoint for exact resume (the port's own module;
the JAX package's ckpt/resume.py serialises a jax pytree).

Two formats, which ``restore_train_state`` tells apart (a directory is the
second):

- npz (the default), ``weights/last_state.npz``: the master network's
  state dict (parameters and BN statistics) under ``net.<name>``, each
  optimizer entry (AdamW moments and per-parameter update counts) under
  ``opt.<index>.<name>``, and in ``__meta__`` (JSON) the step and update
  counts, the loss scale and its grow count, and the caller's extras (the
  epoch). Under FSDP the AdamW state is gathered for it, and rank 0 writes.
- a ``torch.distributed.checkpoint`` directory
  (``Config.resume_format="orbax"``), ``weights/last_state.dcp``: the tree
  of the JAX package's orbax checkpoint (yolosharp_tpu/ckpt/resume.py:
  40-78: state.{step, params, batch_stats, opt_state, loss_scale,
  grow_count} and extra.epoch), each rank writing its own shards of an
  FSDP state; it reads back at the same or another rank count. It is not
  an orbax checkpoint: the JAX package cannot read it, nor the port an
  orbax one.

The reference checkpoints weights only (SURVEY.md section 5).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel import dist
from ..train import TrainState


def _opt_state_by_name(state: TrainState) -> Dict[str, Dict]:
    """Each parameter's AdamW state, by name (this rank's slices under
    FSDP)."""
    return {n: state.optimizer.state.get(p, {})
            for n, p in zip(state.param_names(), state.params)}


def save_train_state(path: str, state: TrainState,
                     extra: Optional[Dict] = None) -> None:
    """The npz format. Every rank calls it under a group (FSDP gathers the
    AdamW state); rank 0 writes."""
    opt = (state.shards.gather_state(state.optimizer)
           if state.shards is not None else _opt_state_by_name(state))
    ctx = dist.active()
    if ctx is not None and not ctx.is_main:
        return
    arrays = {f"net.{k}": v.detach().cpu().numpy()
              for k, v in state.net.state_dict().items()}
    for i, name in enumerate(state.param_names()):
        for k, v in opt.get(name, {}).items():
            arrays[f"opt.{i}.{k}"] = torch.as_tensor(v).detach().cpu().numpy()
    meta = {"step": state.step, "count": state.count,
            "loss_scale": state.loss_scale, "grow_count": state.grow_count,
            **(extra or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def _set_opt_state(state: TrainState, by_name: Dict[str, Dict]) -> None:
    """Load full (unsharded) AdamW state by name into the optimizer, each
    rank taking its slice under FSDP."""
    dims = ({n: d for n, _, d, _ in state.shards.entries}
            if state.shards is not None else {})
    for name, p in zip(state.param_names(), state.params):
        entry = by_name.get(name)
        if not entry:
            continue
        dim = dims.get(name)
        out = {}
        for k, v in entry.items():
            if dim is not None and v.dim():
                v = v.chunk(state.shards.world, dim)[state.shards.rank]
            out[k] = (v.clone().float() if k == "step"
                      else v.to(p.device, p.dtype).clone())
        state.optimizer.state[p] = out


def _sync_masters(state: TrainState) -> None:
    """The FSDP masters set from the network's (just loaded) parameters."""
    if state.shards is None:
        return
    with torch.no_grad():
        for _, p, dim, m in state.shards.entries:
            if dim is not None:
                m.copy_(p.chunk(state.shards.world, dim)[state.shards.rank])


def restore_train_state(path: str, state: TrainState) -> Dict:
    """Load a save_train_state file or a save_train_state_dcp directory
    into `state` (the same model and optimizer groups), in place; returns
    the metadata (the epoch)."""
    if os.path.isdir(path):
        return restore_train_state_dcp(path, state)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        net = {k[4:]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith("net.")}
        opt: Dict[int, Dict[str, torch.Tensor]] = {}
        for k in data.files:
            if k.startswith("opt."):
                _, i, name = k.split(".", 2)
                opt.setdefault(int(i), {})[name] = torch.from_numpy(data[k])
    state.net.load_state_dict(net, strict=True)
    _sync_masters(state)
    names = state.param_names()
    _set_opt_state(state, {names[i]: v for i, v in opt.items()})
    state.step = int(meta["step"])
    state.count = int(meta["count"])
    state.loss_scale = float(meta["loss_scale"])
    state.grow_count = int(meta["grow_count"])
    return meta


def _dcp_tree(state: TrainState, epoch: int) -> Dict:
    """The checkpoint tree: the network's own tensors and the optimizer's
    (created as zeros where no step has run), so that a load fills them in
    place; an FSDP slice as a DTensor sharded on its spec's dim."""
    mesh = None
    dims = {}
    if state.shards is not None:
        from torch.distributed.device_mesh import DeviceMesh

        ctx = dist.active()
        mesh = DeviceMesh.from_group(torch.distributed.group.WORLD,
                                     ctx.device.type)
        dims = {n: d for n, _, d, _ in state.shards.entries}
    opt = {}
    for name, p in zip(state.param_names(), state.params):
        st = state.optimizer.state[p]
        if not st:
            st.update(step=torch.zeros((), dtype=torch.float32),
                      exp_avg=torch.zeros_like(p),
                      exp_avg_sq=torch.zeros_like(p))
        dim = dims.get(name)
        if dim is not None:
            from torch.distributed.tensor import DTensor, Shard

            opt[name] = {k: (DTensor.from_local(v, mesh, [Shard(dim)],
                                                run_check=False)
                             if v.dim() else v) for k, v in st.items()}
        else:
            opt[name] = dict(st)
    return {"state": {
        "step": torch.tensor(state.step, dtype=torch.int64),
        "count": torch.tensor(state.count, dtype=torch.int64),
        "params": {n: p.data for n, p in state.net.named_parameters()},
        "batch_stats": {n: b for n, b in state.net.named_buffers()},
        "opt_state": opt,
        "loss_scale": torch.tensor(state.loss_scale, dtype=torch.float64),
        "grow_count": torch.tensor(state.grow_count, dtype=torch.int64)},
        "extra": {"epoch": torch.tensor(epoch, dtype=torch.int64)}}


def save_train_state_dcp(path: str, state: TrainState,
                         extra: Optional[Dict] = None) -> None:
    """The directory format (torch.distributed.checkpoint); every rank of
    an active group calls it and writes its shards."""
    import torch.distributed.checkpoint as dcp

    tree = _dcp_tree(state, int((extra or {}).get("epoch", 0)))
    dcp.save(tree, checkpoint_id=os.path.abspath(path))


def restore_train_state_dcp(path: str, state: TrainState) -> Dict:
    """Load a save_train_state_dcp directory into `state` in place, at this
    process's rank count (every rank of an active group calls it)."""
    import torch.distributed.checkpoint as dcp

    tree = _dcp_tree(state, 0)
    dcp.load(tree, checkpoint_id=os.path.abspath(path))
    _sync_masters(state)
    st = tree["state"]
    state.step = int(st["step"])
    state.count = int(st["count"])
    state.loss_scale = float(st["loss_scale"])
    state.grow_count = int(st["grow_count"])
    return {"epoch": int(tree["extra"]["epoch"])}
