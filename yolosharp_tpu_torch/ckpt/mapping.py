"""State-dict bridge between the JAX package's checkpoints and the torch
modules (counterpart of yolosharp_tpu/ckpt/mapping.py).

The port's modules already carry Ultralytics state-dict names, so a JAX
variables tree crosses over by the JAX package's rename + layout transpose
(``variables_to_state_dict``, copied here with ``flatten``, ``head_index``,
``LoadReport`` and ``skip_patterns_for_nc_mismatch``) and checkpoint files
load by name.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_TRANSPOSE_CT = ("upsample", "conv_transpose")  # torch (cin,cout,kh,kw)


def flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = v
    return out


class LoadReport:
    def __init__(self):
        self.loaded = []
        self.skipped = []
        self.missing = []
        self.unexpected = []

    def __repr__(self):
        return (f"LoadReport(loaded={len(self.loaded)}, "
                f"skipped={len(self.skipped)}, missing={len(self.missing)}, "
                f"unexpected={len(self.unexpected)})")


def head_index(params: dict) -> int:
    """Layer index of the task head (largest numeric top-level name)."""
    return max(int(k) for k in params.keys() if k.isdigit())


def skip_patterns_for_nc_mismatch(task: str, head_idx: int,
                                  state_dict, nc: int,
                                  nk: Optional[int] = None
                                  ) -> Tuple[str, ...]:
    """Reference skipNcNotEqualLayers semantics (YoloBaseTaskModel.cs:41-98)."""
    pats = []
    if task == "classify":
        pat = rf"model\.{head_idx}\.linear"
        keys = [k for k in state_dict if re.search(pat + r".+bias", k)
                or re.search(pat + r"\.bias", k)]
        if keys and state_dict[keys[-1]].shape[0] != nc:
            pats.append(pat)
        return tuple(pats)
    pat_cv3 = rf"model\.{head_idx}\.cv3"
    keys = [k for k in state_dict if re.search(pat_cv3 + r".+bias", k)]
    if keys and state_dict[keys[-1]].shape[0] != nc:
        pats.append(pat_cv3)
    if task == "pose" and nk is not None:
        pat_cv4 = rf"model\.{head_idx}\.cv4"
        keys4 = [k for k in state_dict if re.search(pat_cv4 + r".+bias", k)]
        if keys4 and state_dict[keys4[-1]].shape[0] != nk:
            pats.append(pat_cv4)
    return tuple(pats)


def _grouped_transpose_kernel(val: np.ndarray, g: int) -> np.ndarray:
    """A grouped transposed conv's HWIO kernel (k, k, c1 / g, c2), as the
    JAX DWConvTranspose2d holds it, in torch's (c1, c2 / g, k, k) layout:
    input channel i * c1/g + j feeds output i * c2/g + o through
    kernel[..., j, i * c2/g + o]."""
    kh, kw, c1g, c2 = val.shape
    return (val.reshape(kh, kw, c1g, g, c2 // g).transpose(3, 2, 4, 0, 1)
            .reshape(g * c1g, c2 // g, kh, kw))


def variables_to_state_dict(variables, reg_max: int = 16,
                            include_one2one: bool = False,
                            dtype=np.float32,
                            transposed_groups: Optional[Dict[str, int]] = None
                            ) -> Dict[str, np.ndarray]:
    """Export a JAX variables tree ({"params", "batch_stats"} of arrays, or
    of anything ``np.asarray`` takes) as a torch-named state dict.

    Emits synthetic `dfl.conv.weight` (the fixed arange projection) and
    `num_batches_tracked` buffers so the tensor COUNT matches what the C#
    reference expects on load (it falls back to random weights on count
    mismatch, YoloBaseTaskModel.cs:32-35). one2one branches are excluded by
    default, as in SaveWeight (YoloBaseTaskModel.cs:474-480).

    Two leaves go where the JAX exporter does not send them, to torch's
    layouts. A TransformerLayer's ``ma.in_proj_weight`` is (c, 3c) in the
    JAX tree (``x @ w``); torch's nn.MultiheadAttention holds (3c, c), so it
    is transposed here (the JAX exporter writes it as it is). A
    DWConvTranspose2d's kernel sits under a name the exporter cannot tell
    from a forward conv's, and its torch layout depends on the groups:
    ``transposed_groups`` maps such a module's JAX path (e.g. ``"0"``, or
    ``"3.m"``) to its groups, gcd(c1, c2). Without an entry it is exported
    as a forward conv's (c2, c1 / g, k, k), which is torch's (c1, c2 / g,
    k, k) only where c1 == c2.
    """
    transposed_groups = transposed_groups or {}
    params_flat = flatten(variables["params"])
    stats_flat = flatten(variables.get("batch_stats", {}))
    head_idx = head_index(variables["params"])
    out: Dict[str, np.ndarray] = {}

    def put(key, val):
        out["model." + key] = np.asarray(val).astype(dtype)

    for key, val in params_flat.items():
        if not include_one2one and "one2one" in key:
            continue
        stem, leaf = key.rsplit(".", 1)
        parent = stem.rsplit(".", 1)[-1]
        val = np.asarray(val)
        if leaf == "scale":
            put(f"{stem}.weight", val)
        elif leaf == "kernel" and stem in transposed_groups:
            put(f"{stem}.weight",
                _grouped_transpose_kernel(val, transposed_groups[stem]))
        elif leaf == "in_proj_weight":
            put(key, val.T)
        elif leaf == "kernel":
            if val.ndim == 4:
                perm = (2, 3, 0, 1) if parent in _TRANSPOSE_CT else (3, 2, 0, 1)
                put(f"{stem}.weight", np.transpose(val, perm))
            else:
                put(f"{stem}.weight", val.T)
        elif leaf == "weight" and val.ndim == 2:
            # torch-named linear weights stored (in, out) -> save (out, in)
            put(key, val.T)
        else:
            put(key, val)
    for key, val in stats_flat.items():
        if not include_one2one and "one2one" in key:
            continue
        stem, leaf = key.rsplit(".", 1)
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        put(f"{stem}.{name}", val)
        put(f"{stem}.num_batches_tracked",
            np.zeros((), dtype=np.int64))
    # fixed DFL projection conv (Block.cs DFL ctor, Modules/Block.cs:26-33)
    if any(k.startswith(f"{head_idx}.cv2.") for k in params_flat):
        put(f"{head_idx}.dfl.conv.weight",
            np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1))
    return out


def _tensor(arr) -> torch.Tensor:
    """A state-dict entry as a torch tensor: floating types (bf16 / fp16
    files) as float32, integers and bools as they are; always a copy."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        return (t.float() if t.is_floating_point() else t).clone()
    a = np.asarray(arr)
    if a.dtype.kind not in "iub":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))   # a copy; keeps 0-d shapes


def state_dict_from_jax(variables,
                        transposed_groups: Optional[Dict[str, int]] = None
                        ) -> Dict[str, torch.Tensor]:
    """A JAX variables tree (of numpy arrays, or of anything ``np.asarray``
    takes) as a torch state dict (one2one towers included) that
    ``YoloNet.load_state_dict(..., strict=True)`` takes;
    ``transposed_groups`` as in ``variables_to_state_dict``."""
    sd = variables_to_state_dict(variables, include_one2one=True,
                                 transposed_groups=transposed_groups)
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
        t = _tensor(arr)
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
