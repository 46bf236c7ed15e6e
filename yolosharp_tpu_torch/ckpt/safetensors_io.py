"""HuggingFace safetensors reader and writer (header JSON + raw offsets), a
copy of yolosharp_tpu/ckpt/safetensors_io.py.

Byte-level parser mirroring ModelLoader/SafetensorsLoader.cs:9-108 — no
external safetensors dependency. BF16 tensors load as ``torch.bfloat16``
tensors (decoded by torch, no ml_dtypes), the rest as ndarrays.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

from .binio import Array, bf16_from_bits

_DTYPES = {
    "I8": np.int8, "I16": np.int16, "I32": np.int32, "I64": np.int64,
    "U8": np.uint8, "U16": np.uint16, "U32": np.uint32, "U64": np.uint64,
    "F16": np.float16, "F32": np.float32, "F64": np.float64, "BOOL": np.bool_,
}


def load_safetensors(path: str) -> Dict[str, Array]:
    with open(path, "rb") as f:
        header_size = struct.unpack("<q", f.read(8))[0]
        if header_size <= 0 or header_size > 100_000_000:
            raise ValueError(f"invalid safetensors header size {header_size}")
        header = json.loads(f.read(header_size).decode("utf-8"))
        body = f.tell()
        out: Dict[str, Array] = {}
        for name, info in header.items():
            if name == "__metadata__" or "data_offsets" not in info:
                continue
            start, end = info["data_offsets"]
            bf16 = info["dtype"] == "BF16"
            dtype = np.dtype(np.int16 if bf16 else _DTYPES[info["dtype"]])
            shape = tuple(info["shape"])
            f.seek(body + start)
            raw = f.read(end - start)
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
            out[name] = bf16_from_bits(arr) if bf16 else arr
        return out


def save_safetensors(path: str, state_dict: Dict[str, Array]) -> None:
    """Minimal writer (row-major, no metadata)."""
    codes = {np.dtype(v): k for k, v in _DTYPES.items()}
    header, offset, blobs = {}, 0, []
    for name, arr in state_dict.items():
        if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
            code = "BF16"
            arr = arr.detach().cpu().contiguous().view(torch.int16).numpy()
        else:
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            # not np.ascontiguousarray, which makes a 0-d tensor 1-d
            arr = np.asarray(arr, order="C")
            code = codes[arr.dtype]
        nbytes = arr.nbytes
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + nbytes]}
        blobs.append(arr.tobytes())
        offset += nbytes
    hjson = json.dumps(header).encode("utf-8")
    pad = (8 - len(hjson) % 8) % 8
    hjson += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
