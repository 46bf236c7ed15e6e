"""Quotients by a constant, rounded the same way on every device.

The JAX package divides by constants inside ``jax.jit`` (``x / 255.0`` of
the predict input and of the train and eval normalisation,
``max(absmax, eps) / 127.0`` of the int8 scales). XLA rewrites such a
division into a multiply by the divisor's reciprocal: in float32 and
bfloat16 by the reciprocal rounded to float32 (bfloat16 rounds the float32
product), in float16 by the reciprocal rounded to float16. PyTorch divides
truly on the CPU but multiplies by a reciprocal on CUDA when the divisor is
a Python scalar, so ``x / 255.0`` rounds one way on the CPU and another on
the card. ``divide_by_constant`` writes XLA's route out as a multiply by
the rounded reciprocal, so the result is the same on both devices and equal
to the JAX reference's bit for bit (tests/test_torch_quotients.py). The
reciprocal is a Python float holding a value of the working type: both
devices take it exactly, with no tensor to copy to the device.
"""

from __future__ import annotations

import numpy as np
import torch


# the type XLA rounds the reciprocal to, by the working type
RECIPROCAL_TYPE = {torch.float32: np.float32, torch.bfloat16: np.float32,
                   torch.float16: np.float16}


def divide_by_constant(x: torch.Tensor, divisor: float,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x.astype(dtype) / divisor`` as ``jax.jit`` computes it, on x's
    device: x in ``dtype`` times 1 / divisor rounded to float32 (float32,
    bfloat16: PyTorch multiplies a bfloat16 tensor by a scalar in float32
    and rounds once) or to float16 (float16). float64, which the JAX
    package never computes in, divides."""
    kind = RECIPROCAL_TYPE.get(dtype)
    if kind is None:
        return x.to(dtype) / divisor
    return x.to(dtype) * float(kind(1) / kind(divisor))
