"""State-dict bridge between the JAX package's checkpoints and the torch
modules (counterpart of yolosharp_tpu/ckpt/mapping.py).

The port's modules already carry Ultralytics state-dict names, so a JAX
variables tree crosses over through the JAX package's own numpy exporter
(``variables_to_state_dict``) and checkpoint files load by name.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from yolosharp_tpu.ckpt.mapping import LoadReport, variables_to_state_dict


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind not in "iub":   # bf16 / fp16 files load as float32
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))   # a copy; keeps 0-d shapes


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """A JAX variables tree as a torch state dict (one2one towers included)
    that ``YoloNet.load_state_dict(..., strict=True)`` takes."""
    sd = variables_to_state_dict(variables, include_one2one=True)
    return {k: _tensor(v) for k, v in sd.items()}


@torch.no_grad()
def clone_one2one(net: nn.Module) -> nn.Module:
    """Copy the one2many head towers into their one2one twins, in place
    (One2one_Init, YoloBaseTaskModel.cs:452-459)."""
    sd = net.state_dict()
    for key, val in sd.items():
        m = re.search(r"\.(one2one_(cv\d))\.", key)
        if m:
            src = key.replace(m.group(1), m.group(2))
            if src in sd:
                val.copy_(sd[src])
    return net


@torch.no_grad()
def load_state_dict_into(net: nn.Module, state_dict,
                         skip_patterns: Tuple[str, ...] = ()) -> LoadReport:
    """Load a (numpy or torch) state dict by name with the reference's
    LoadModel semantics: keys matching `skip_patterns`, unknown keys and
    shape mismatches are reported, not loaded."""
    report = LoadReport()
    own = net.state_dict()
    compiled = [re.compile(p) for p in skip_patterns]
    new = {}
    for key, arr in state_dict.items():
        if any(c.search(key) for c in compiled):
            report.skipped.append(key)
            continue
        t = arr if isinstance(arr, torch.Tensor) else _tensor(arr)
        if key not in own or tuple(own[key].shape) != tuple(t.shape):
            report.unexpected.append(key)
            continue
        new[key] = t
        report.loaded.append(key)
    report.missing = [k for k in own if k not in new]
    net.load_state_dict(new, strict=False)
    return report


def export_state_dict(net: nn.Module, dtype=np.float32) -> Dict[str, np.ndarray]:
    """The net's state dict as numpy arrays for .bin saving, one2one towers
    excluded as SaveWeight does (YoloBaseTaskModel.cs:474-480)."""
    return {k: v.detach().cpu().float().numpy().astype(dtype)
            for k, v in net.state_dict().items() if "one2one" not in k}
