"""yolosharp_tpu_torch: the PyTorch/CUDA port of yolosharp_tpu.

Same public surface as the JAX package, for v8 and v12 detection predict
so far:

    from yolosharp_tpu_torch import Config, YoloTask
    task = YoloTask(Config(...))            # device="cuda" by default
    results = task.image_predict(rgb_uint8_array)

It imports torch and nothing of jax or of the JAX package: the numpy-only
modules it shares with that package (Config, result types, checkpoint file
formats and name map) are copies under the same names. The 3x3 conv, fused
C2f and attention layers run hand-written CUDA kernels (``kernels/``,
``csrc/``).
"""

from .config import Config
from .tasks import Detector, YoloTask
from .types import ScalarType, TaskType, YoloResult, YoloSize, YoloType

__all__ = ["Config", "Detector", "ScalarType", "TaskType", "YoloResult",
           "YoloSize", "YoloTask", "YoloType"]
