import numpy as np
import torch

from .binio import load_bin, save_bin
from .fuse import bias_init, fold_bn
from .mapping import (LoadReport, clone_one2one, export_state_dict, flatten,
                      head_index, load_state_dict_into,
                      skip_patterns_for_nc_mismatch, state_dict_from_jax,
                      variables_to_state_dict)
from .pickle_pt import load_pt
from .safetensors_io import load_safetensors, save_safetensors


def load_state_dict_file(path: str):
    """Auto-detect checkpoint format by extension and load it."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    if path.endswith((".pt", ".pth")):
        return load_pt(path)
    return load_bin(path)


def convert_checkpoint(src: str, dst: str, dtype=None) -> int:
    """Convert any checkpoint ``load_state_dict_file`` reads (``.pt`` /
    ``.pth`` zip pickle, ``.safetensors``, ``.bin``) into a YoloSharp
    ``.bin``, every tensor cast to the numpy ``dtype`` when one is given
    (the Tools.TransModelFromSafetensors / LoadTensorFromPT equivalent,
    Utils/Tools.cs:16-117). Returns the tensor count."""
    sd = load_state_dict_file(src)
    if dtype is not None:
        sd = {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)).astype(dtype) for k, v in sd.items()}
    save_bin(dst, sd)
    return len(sd)


__all__ = ["LoadReport", "bias_init", "clone_one2one", "convert_checkpoint",
           "export_state_dict", "flatten", "fold_bn", "head_index",
           "load_bin", "load_pt", "load_safetensors", "load_state_dict_file",
           "load_state_dict_into", "save_bin", "save_safetensors",
           "skip_patterns_for_nc_mismatch", "state_dict_from_jax",
           "variables_to_state_dict"]
