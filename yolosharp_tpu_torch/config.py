"""Config for the port: the JAX package's ``Config`` (numpy-only, reused by
import) plus the torch dtype map and device resolution.

``Config.compute_dtype`` imports jax.numpy, so the port never calls it and
maps ``Config.scalar_type`` itself. ``Config.pallas_conv`` is a TPU routing
knob: the port keeps the field and ignores it (on CUDA every layer its
kernels can compute goes through them)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from yolosharp_tpu.config import Config
from yolosharp_tpu.types import ScalarType


def torch_dtype(config: Config) -> torch.dtype:
    """float32 -> torch.float32; float16 / bfloat16 -> torch.bfloat16
    (torch.float16 when ``config.true_fp16``), as Config.compute_dtype."""
    if config.scalar_type == ScalarType.float32:
        return torch.float32
    return torch.float16 if config.true_fp16 else torch.bfloat16


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device to run on; None means ``cuda``. Asking for CUDA where
    there is none raises: there is no silent CPU fallback (pass
    ``device="cpu"`` to run on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the port on the CPU")
    return dev


__all__ = ["Config", "resolve_device", "torch_dtype"]
