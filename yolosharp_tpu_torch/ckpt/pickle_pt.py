"""PyTorch `.pt` (zip + pickle) checkpoint reader, a copy of
yolosharp_tpu/ckpt/pickle_pt.py. It unpickles with stubs instead of
``torch.load``, so no class of the checkpoint's code is ever imported.

Counterpart of the reference's hand-rolled C# pickle VM
(ModelLoader/PickleLoader.cs:89-438). In Python the pickle VM is built in;
we supply `persistent_load` (storage references into the zip) and a
class-stubbing `find_class`, then reconstruct tensors with numpy stride
tricks. Handles:
  - plain state_dict checkpoints ({name: Tensor});
  - Ultralytics-style {"model": <pickled nn.Module>} checkpoints, by walking
    the stubbed module tree (_modules/_parameters/_buffers) to rebuild
    dotted names.
BFloat16 storages load as ``torch.bfloat16`` tensors (decoded by torch, no
ml_dtypes), the rest as ndarrays.
"""

from __future__ import annotations

import pickle
import zipfile
from typing import Any, Dict, Optional

import numpy as np

from .binio import Array, bf16_from_bits

_STORAGE_DTYPES = {
    "FloatStorage": np.dtype(np.float32),
    "DoubleStorage": np.dtype(np.float64),
    "HalfStorage": np.dtype(np.float16),
    "LongStorage": np.dtype(np.int64),
    "IntStorage": np.dtype(np.int32),
    "ShortStorage": np.dtype(np.int16),
    "CharStorage": np.dtype(np.int8),
    "ByteStorage": np.dtype(np.uint8),
    "BoolStorage": np.dtype(np.bool_),
    # read as bit patterns, decoded by bf16_from_bits
    "BFloat16Storage": np.dtype(np.int16),
}


class _Storage:
    """Lazy reference to a flat storage blob inside the zip archive."""

    def __init__(self, zf: zipfile.ZipFile, prefix: str, key: str,
                 dtype: np.dtype, bf16: bool = False):
        self.zf, self.prefix, self.key, self.dtype = zf, prefix, key, dtype
        self.bf16 = bf16
        self._data: Optional[np.ndarray] = None

    def data(self) -> np.ndarray:
        if self._data is None:
            raw = self.zf.read(f"{self.prefix}/data/{self.key}")
            self._data = np.frombuffer(raw, dtype=self.dtype)
        return self._data


class _Tensor:
    """Rebuilt tensor: numpy view over a storage with torch strides."""

    def __init__(self, storage: _Storage, offset: int, size, stride):
        self.storage, self.offset = storage, offset
        self.size, self.stride = tuple(size), tuple(stride)

    def numpy(self) -> Array:
        flat = self.storage.data()
        itemsize = flat.dtype.itemsize
        arr = np.lib.stride_tricks.as_strided(
            flat[self.offset:],
            shape=self.size,
            strides=tuple(s * itemsize for s in self.stride))
        # a copy in C order; np.ascontiguousarray, which the JAX package's
        # reader takes, would make a 0-d tensor (num_batches_tracked) 1-d
        arr = np.array(arr, order="C")
        return bf16_from_bits(arr) if self.storage.bf16 else arr


class _ODict(dict):
    """OrderedDict stand-in that tolerates pickled instance state
    (torch attaches `_metadata` to state_dict OrderedDicts)."""

    def __setstate__(self, state):
        pass


class _Stub:
    """Catch-all stand-in for any class we don't implement (nn.Module,
    ultralytics model classes, dtype markers, ...)."""

    def __init__(self, *args, **kwargs):
        self._args = args

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __call__(self, *args, **kwargs):  # e.g. _rebuild_from_type_v2 inner
        return _Stub()


def _rebuild_tensor_v2(storage, storage_offset, size, stride,
                       requires_grad=None, backward_hooks=None, metadata=None):
    return _Tensor(storage, storage_offset, size, stride)


def _rebuild_parameter(data, requires_grad=True, backward_hooks=None):
    return data


def _rebuild_from_type_v2(func, new_type, args, state):
    return func(*args)


class _TorchUnpickler(pickle.Unpickler):
    def __init__(self, file, zf: zipfile.ZipFile, prefix: str):
        super().__init__(file, encoding="latin1")
        self.zf, self.prefix = zf, prefix

    def persistent_load(self, pid):
        # ('storage', StorageType, key, location, numel)
        if isinstance(pid, tuple) and pid and pid[0] == "storage":
            storage_type, key = pid[1], pid[2]
            name = getattr(storage_type, "_name", None) or getattr(
                storage_type, "__name__", str(storage_type))
            name = name.split(".")[-1]
            dtype = _STORAGE_DTYPES.get(name, np.dtype(np.float32))
            return _Storage(self.zf, self.prefix, str(key), dtype,
                            bf16=name == "BFloat16Storage")
        raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")

    def find_class(self, module, name):
        if name == "_rebuild_tensor_v2":
            return _rebuild_tensor_v2
        if name == "_rebuild_parameter":
            return _rebuild_parameter
        if name == "_rebuild_from_type_v2":
            return _rebuild_from_type_v2
        if module == "collections" and name == "OrderedDict":
            return _ODict
        if module == "torch" and name.endswith("Storage"):
            t = type(name, (), {"_name": name})
            return t
        # everything else (nn.Module subclasses, dtypes, ultralytics
        # classes, numpy reconstructors) becomes an inert stub
        return type(name, (_Stub,), {"_qualname": f"{module}.{name}"})


def _walk_module(obj: Any, prefix: str, out: Dict[str, Array],
                 seen: set) -> None:
    """Reconstruct torch state_dict names from a stubbed nn.Module tree."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    d = getattr(obj, "__dict__", None)
    if d is None:
        return
    for coll in ("_parameters", "_buffers"):
        for k, v in (d.get(coll) or {}).items():
            if isinstance(v, _Tensor):
                out[prefix + k] = v.numpy()
    for k, v in (d.get("_modules") or {}).items():
        if v is not None:
            _walk_module(v, f"{prefix}{k}.", out, seen)


def _collect(obj: Any) -> Dict[str, Array]:
    out: Dict[str, Array] = {}
    if isinstance(obj, dict):
        # plain state_dict (possibly nested checkpoint dict)
        tensors = {k: v for k, v in obj.items() if isinstance(v, _Tensor)}
        if tensors:
            return {k: v.numpy() for k, v in tensors.items()}
        for key in ("model", "ema", "state_dict", "model_state_dict"):
            if key in obj and obj[key] is not None:
                sub = _collect(obj[key])
                if sub:
                    return sub
        return out
    if isinstance(obj, _Stub):
        # ultralytics DetectionModel etc: the root module's children live
        # in _modules (usually {"model": Sequential(...)})
        _walk_module(obj, "", out, set())
    return out


def load_pt(path: str) -> Dict[str, Array]:
    """Read a torch zip-format .pt checkpoint into {name: ndarray}."""
    with zipfile.ZipFile(path) as zf:
        pkl_names = [n for n in zf.namelist() if n.endswith("/data.pkl")]
        if not pkl_names:
            raise ValueError(f"{path}: not a torch zip checkpoint")
        prefix = pkl_names[0][: -len("/data.pkl")]
        with zf.open(pkl_names[0]) as f:
            obj = _TorchUnpickler(f, zf, prefix).load()
        out = _collect(obj)
        if not out:
            raise ValueError(f"{path}: no tensors found in checkpoint")
        return out
