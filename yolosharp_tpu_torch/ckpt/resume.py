"""Full training-state checkpoint for exact resume (the port's own module;
the JAX package's ckpt/resume.py serialises a jax pytree).

``weights/last_state.npz`` holds, as numpy arrays: the master network's
state dict (parameters and BN statistics) under ``net.<name>``, each
optimizer entry (AdamW moments and per-parameter update counts) under
``opt.<index>.<name>``, and in ``__meta__`` (JSON) the step and update
counts, the loss scale and its grow count, and the caller's extras (the
epoch). The reference checkpoints weights only (SURVEY.md section 5).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..train import TrainState


def save_train_state(path: str, state: TrainState,
                     extra: Optional[Dict] = None) -> None:
    arrays = {f"net.{k}": v.detach().cpu().numpy()
              for k, v in state.net.state_dict().items()}
    for i, entry in state.optimizer.state_dict()["state"].items():
        for k, v in entry.items():
            arrays[f"opt.{i}.{k}"] = torch.as_tensor(v).detach().cpu().numpy()
    meta = {"step": state.step, "count": state.count,
            "loss_scale": state.loss_scale, "grow_count": state.grow_count,
            **(extra or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def restore_train_state(path: str, state: TrainState) -> Dict:
    """Load a save_train_state file into `state` (the same model and
    optimizer groups), in place; returns the metadata."""
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
    sd = state.optimizer.state_dict()
    state.optimizer.load_state_dict({"state": opt,
                                     "param_groups": sd["param_groups"]})
    state.step = int(meta["step"])
    state.count = int(meta["count"])
    state.loss_scale = float(meta["loss_scale"])
    state.grow_count = int(meta["grow_count"])
    return meta
