"""Quotients by a constant, rounded the same way on every device.

The JAX package divides by constants inside ``jax.jit`` (``x / 255.0`` of
the predict input, ``max(absmax, eps) / 127.0`` of the int8 scales). XLA
rewrites such a float32 division into a multiply by the divisor's
reciprocal rounded to float32. PyTorch divides truly on the CPU but
multiplies by a reciprocal on CUDA when the divisor is a Python scalar, so
``x / 255.0`` rounds one way on the CPU and another on the card.
``divide_by_constant`` writes XLA's route out as a multiply by the float32
reciprocal, so the result is the same on both devices and equal to the
JAX reference's bit for bit (tests/test_torch_quotients.py). The
reciprocal is a Python float holding a float32 value: both devices take
it as that float32 exactly, with no tensor to copy to the device. The
predict input and the int8 scales take it.
"""

from __future__ import annotations

import numpy as np
import torch


def divide_by_constant(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x.astype(float32) / divisor`` as ``jax.jit`` computes it: x in
    float32 times 1 / divisor rounded to float32, on x's device."""
    return x.float() * float(np.float32(1) / np.float32(divisor))
