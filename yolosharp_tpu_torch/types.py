"""Public result types and enums (a copy of yolosharp_tpu/types.py, kept
here so that the port imports nothing of the JAX package).

Parity targets: Types/YoloResult.cs, Types/KeyPoint.cs, Types/YoloTypes.cs,
Types/AutoAugment.cs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class YoloType(str, enum.Enum):
    v5u = "v5u"
    v8 = "v8"
    v11 = "v11"
    v12 = "v12"


class YoloSize(str, enum.Enum):
    n = "n"
    s = "s"
    m = "m"
    l = "l"
    x = "x"


class TaskType(str, enum.Enum):
    detect = "detect"
    segment = "segment"
    obb = "obb"
    pose = "pose"
    classify = "classify"


class ImageProcessType(str, enum.Enum):
    mosaic = "mosaic"
    letterbox = "letterbox"


class ScalarType(str, enum.Enum):
    float32 = "float32"
    bfloat16 = "bfloat16"
    # float16 accepted for config compatibility; TPU compute maps it to bf16
    float16 = "float16"


class AutoAugmentType(str, enum.Enum):
    autoaugment = "autoaugment"
    randaugment = "randaugment"
    augmix = "augmix"
    none = "none"


@dataclasses.dataclass
class KeyPoint:
    x: float
    y: float
    visibility: float = 1.0


@dataclasses.dataclass
class YoloResult:
    """One detection/classification result (Types/YoloResult.cs:3-17)."""

    class_id: int
    score: float
    center_x: float = 0.0
    center_y: float = 0.0
    width: float = 0.0
    height: float = 0.0
    radian: float = 0.0
    mask: Optional[np.ndarray] = None          # (H, W) bool
    keypoints: Optional[List[KeyPoint]] = None
