from .fuse import bias_init, fold_bn
from .mapping import (clone_one2one, export_state_dict, load_state_dict_into,
                      state_dict_from_jax)

__all__ = ["bias_init", "clone_one2one", "export_state_dict", "fold_bn",
           "load_state_dict_into", "state_dict_from_jax"]
