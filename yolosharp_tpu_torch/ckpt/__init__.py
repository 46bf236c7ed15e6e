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


__all__ = ["LoadReport", "bias_init", "clone_one2one", "export_state_dict",
           "flatten", "fold_bn", "head_index", "load_bin", "load_pt",
           "load_safetensors", "load_state_dict_file", "load_state_dict_into",
           "save_bin", "save_safetensors", "skip_patterns_for_nc_mismatch",
           "state_dict_from_jax", "variables_to_state_dict"]
