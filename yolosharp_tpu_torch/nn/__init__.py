from .common import (C2f, Bottleneck, Concat, ConvBN, SPPF, Upsample,
                     max_pool_same, upsample2x)
from .heads import Detect
from .model import STRIDES, ArchCfg, YoloNet, build_arch

__all__ = ["ArchCfg", "Bottleneck", "C2f", "Concat", "ConvBN", "Detect",
           "SPPF", "STRIDES", "Upsample", "YoloNet", "build_arch",
           "max_pool_same", "upsample2x"]
