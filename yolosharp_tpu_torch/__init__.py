"""yolosharp_tpu_torch: the PyTorch/CUDA port of yolosharp_tpu.

Same public surface as the JAX package, for v8 and v12 detection predict
so far:

    from yolosharp_tpu_torch import Config, YoloTask
    task = YoloTask(Config(...))            # device="cuda" by default
    results = task.image_predict(rgb_uint8_array)

It imports torch and never jax; it reuses the JAX package's numpy-only
modules (Config, result types, checkpoint file formats). The 3x3 conv,
fused C2f and attention layers run hand-written CUDA kernels (``kernels/``,
``csrc/``).
"""

from yolosharp_tpu.types import (ScalarType, TaskType, YoloResult, YoloSize,
                                 YoloType)

from .config import Config
from .tasks import Detector, YoloTask

__all__ = ["Config", "Detector", "ScalarType", "TaskType", "YoloResult",
           "YoloSize", "YoloTask", "YoloType"]
