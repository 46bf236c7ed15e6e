"""YoloSharp LEB128 `.bin` checkpoint format: byte-compatible reader/writer
(a copy of yolosharp_tpu/ckpt/binio.py, numpy parser only).

Format (write: Models/YoloBaseTaskModel.cs:470-559, read: Utils/Lib.cs:9-54):
  LEB128 tensor_count, then per tensor:
    C# BinaryWriter string (7-bit-encoded length prefix + UTF-8 name),
    LEB128 dtype (TorchSharp ScalarType enum),
    LEB128 rank, LEB128 dims..., raw little-endian bytes.

numpy has no bfloat16, so a bfloat16 tensor loads as a ``torch.bfloat16``
tensor (decoded by torch, no ml_dtypes) and every other one as an ndarray.
"""

from __future__ import annotations

import io
from typing import Dict, Union

import numpy as np
import torch

# TorchSharp ScalarType enum -> numpy dtype
_DTYPES = {
    0: np.uint8, 1: np.int8, 2: np.int16, 3: np.int32, 4: np.int64,
    5: np.float16, 6: np.float32, 7: np.float64, 11: np.bool_,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_BF16_CODE = 15

Array = Union[np.ndarray, torch.Tensor]


def _read_leb128(f) -> int:
    num, shift = 0, 0
    while True:
        b = f.read(1)[0]
        num += (b & 0x7F) << (shift * 7)
        if (b & 0x80) == 0:
            return num
        shift += 1


def _write_leb128(f, value: int) -> None:
    if value < 0:
        raise ValueError("LEB128 negative")
    while True:
        low = value & 0x7F
        value >>= 7
        if value == 0:
            f.write(bytes([low]))
            return
        f.write(bytes([low | 0x80]))


def _read_csharp_string(f) -> str:
    length, shift = 0, 0
    while True:
        b = f.read(1)[0]
        length |= (b & 0x7F) << shift
        if (b & 0x80) == 0:
            break
        shift += 7
    return f.read(length).decode("utf-8")


def _write_csharp_string(f, s: str) -> None:
    data = s.encode("utf-8")
    length = len(data)
    while True:
        low = length & 0x7F
        length >>= 7
        if length == 0:
            f.write(bytes([low]))
            break
        f.write(bytes([low | 0x80]))
    f.write(data)


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """int16 bit patterns -> the torch.bfloat16 tensor they encode (a
    copy: the bits may be a read-only view of a file buffer)."""
    return torch.from_numpy(np.array(bits, np.int16)).view(torch.bfloat16)


def load_bin(path: str) -> Dict[str, Array]:
    """Read a YoloSharp .bin into {name: ndarray} (native dtypes kept;
    bfloat16 as torch tensors)."""
    out: Dict[str, Array] = {}
    with open(path, "rb") as f:
        count = _read_leb128(f)
        for _ in range(count):
            name = _read_csharp_string(f)
            dtype_code = _read_leb128(f)
            rank = _read_leb128(f)
            shape = tuple(_read_leb128(f) for _ in range(rank))
            bf16 = dtype_code == _BF16_CODE
            dtype = np.dtype(np.int16 if bf16 else _DTYPES[dtype_code])
            n = int(np.prod(shape)) if shape else 1
            data = f.read(n * dtype.itemsize)
            arr = np.frombuffer(data, dtype=dtype).reshape(shape).copy()
            out[name] = bf16_from_bits(arr) if bf16 else arr
    return out


def save_bin(path: str, state_dict: Dict[str, Array]) -> None:
    """Write {name: ndarray or tensor} as a YoloSharp-readable .bin
    (torch.bfloat16 tensors as TorchSharp's BFloat16)."""
    buf = io.BytesIO()
    _write_leb128(buf, len(state_dict))
    for name, arr in state_dict.items():
        if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
            code = _BF16_CODE
            arr = arr.detach().cpu().contiguous().view(torch.int16).numpy()
        else:
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            # NB: np.ascontiguousarray would promote 0-d scalars to 1-d
            arr = np.asarray(arr, order="C")
            code = _DTYPE_CODES.get(arr.dtype)
            if code is None:
                raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
        _write_csharp_string(buf, name)
        _write_leb128(buf, code)
        _write_leb128(buf, arr.ndim)
        for d in arr.shape:
            _write_leb128(buf, d)
        buf.write(arr.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
