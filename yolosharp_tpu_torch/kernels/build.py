"""Build and load the hand-written CUDA kernels and the host C++ in
``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``), each ``csrc/<name>.cpp`` (host code, such as the JPEG
decoder) with ``$CXX`` or ``c++``, into a shared library with a plain C
interface, cached under ``yolosharp_tpu_torch/_build/`` by a hash of the
sources and flags, and loaded with ``ctypes``. A missing compiler or a
failed compile raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
# host code: integer arithmetic that must not round differently anywhere
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_libs: Dict[str, ctypes.CDLL] = {}
# one lock a library: loader threads may ask for one library at once, and
# build different libraries side by side
_build_locks: Dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()
_count_lock = threading.Lock()   # mesh threads launch on several cards
# compiler output of each build in this process (ptxas register / spill /
# shared-memory report), for chip_smoke.py to print
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda/bin."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in cands:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of yolosharp_tpu_torch are "
        "compiled from yolosharp_tpu_torch/csrc on first use and need the "
        "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the types of the tensor-core routes: one template on the element type in
# each .cu (both are 2 bytes: the same layouts, another MMA type suffix)
HALF_DTYPES = (torch.bfloat16, torch.float16)
SMEM_LIMIT = 232448   # shared memory one block may use on Hopper


def launch_args(name: str, *tensors, strided: bool = False):
    """Check what every CUDA kernel of the port takes (one CUDA device, one
    dtype of float32 / bfloat16 / float16, contiguous, 16-byte aligned) and return
    (dtype code, current stream handle). Raises on anything else.
    strided: the kernel takes element strides, so instead of contiguity it
    needs unit stride in the last dimension and 16-byte aligned rows."""
    x = tensors[0]
    if not x.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{x.device}")
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"{name}: takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: all tensors must be {x.dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if strided:
            if t.stride(-1) != 1 or any(s * t.element_size() % 16
                                        for s in t.stride()[:-1]):
                raise ValueError(f"{name}: tensors need unit stride in the "
                                 f"last dimension and 16-byte aligned rows "
                                 f"(shape {tuple(t.shape)}, "
                                 f"strides {t.stride()})")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous "
                             f"(shape {tuple(t.shape)}, "
                             f"strides {t.stride()})")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return code, torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the wrappers size
    their tiles so that a grid covers them."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_status(name: str, status: int) -> None:
    """Raise on the CUDA error code a kernel entry point returned."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {status}")


def find_cxx() -> str:
    """Path of the host C++ compiler: $CXX, then c++ / g++ / clang++ on
    $PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError(
        "no C++ compiler found: the host code of yolosharp_tpu_torch (the "
        "JPEG decoder) is compiled from yolosharp_tpu_torch/csrc on first "
        "use and needs one (set CXX or put c++ on PATH)")


def _load(name: str, suffix: str, flags, compiler, deps) -> ctypes.CDLL:
    """The library built from ``csrc/<name><suffix>`` with ``compiler()``
    and ``flags`` (built if no build of the same sources and flags is
    cached), loaded once a process."""
    with _locks_lock:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = SRC_DIR / f"{name}{suffix}"
        digest = hashlib.sha256(" ".join(flags).encode())
        for path in [src, *deps]:
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        if not out.exists():
            cc = compiler()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [cc, *flags, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cc)} failed to build {src.name} "
                    f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            build_logs[name] = proc.stdout + proc.stderr
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    return _load(name, ".cu", NVCC_FLAGS, find_nvcc,
                 sorted(SRC_DIR.glob("*.cuh")))


# the host C++ libraries of csrc/, one an image decoder (or its part)
HOST_LIBRARIES = ("png_unfilter", "jpeg_decode", "tiff_decode", "webp_decode",
                  "jp2_decode", "gif_decode", "hdr_decode")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library built from the host C++ ``csrc/<name>.cpp`` (built
    with the host compiler if needed; no nvcc involved)."""
    return _load(name, ".cpp", CXX_FLAGS, find_cxx, [])


def count_launch(wrapper, device: torch.device) -> None:
    """Add one launch to ``wrapper.launches`` and to its card's entry of
    ``wrapper.launches_by_device`` (mesh threads launch at once)."""
    with _count_lock:
        wrapper.launches += 1
        by = wrapper.launches_by_device
        by[device.index] = by.get(device.index, 0) + 1
