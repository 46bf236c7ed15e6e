"""Quotients by a constant, rounded the same way on every device; float32
that stays float32 on the card whatever the caller's TF32 flags.

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

PyTorch runs a float32 convolution through cuDNN in TF32 (about three
decimal digits) unless ``torch.backends.cudnn.allow_tf32`` is False, and
that flag is True by default. ``full_float32`` turns it off, and the float32
matmuls' TF32 with it, for the length of the port's own work: every entry
point that runs a network (predict, train and val steps, calibration)
enters it, so its float32 route sums in float32 end to end.
"""

from __future__ import annotations

import contextlib
import threading

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


# full_float32's scopes open in this process (threads of mesh predict and
# of the stream enter it at once; the flags are process-wide) and the
# caller's flags, saved by the first
_scope_lock = threading.Lock()
_scope_depth = 0
_scope_saved = None


@contextlib.contextmanager
def full_float32():
    """cuDNN's TF32 off (``torch.backends.cudnn.allow_tf32 = False``) and
    float32 matmuls at "highest" precision inside, the caller's values back
    when the last open scope of the process ends, also when it raises. The
    flags are process-wide, so the scopes are counted: threads of the port
    that enter at once keep them off until the last leaves. Usable as a
    decorator. The flags act on float32 only; the 16-bit routes are the
    same inside and out."""
    global _scope_depth, _scope_saved
    with _scope_lock:
        if _scope_depth == 0:
            _scope_saved = (torch.backends.cudnn.allow_tf32,
                            torch.get_float32_matmul_precision())
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        _scope_depth += 1
    try:
        yield
    finally:
        with _scope_lock:
            _scope_depth -= 1
            if _scope_depth == 0:
                torch.backends.cudnn.allow_tf32 = _scope_saved[0]
                torch.set_float32_matmul_precision(_scope_saved[1])
