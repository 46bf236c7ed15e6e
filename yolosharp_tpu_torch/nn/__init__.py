from .attention import A2C2f, AAttn, ABlock
from .common import (C2f, C3, C3k, C3k2, Bottleneck, Concat, Conv2d, ConvBN,
                     DWConv, SPPF, Upsample, max_pool_same, upsample2x)
from .heads import Detect
from .model import STRIDES, ArchCfg, YoloNet, build_arch

__all__ = ["A2C2f", "AAttn", "ABlock", "ArchCfg", "Bottleneck", "C2f", "C3",
           "C3k", "C3k2", "Concat", "Conv2d", "ConvBN", "DWConv", "Detect",
           "SPPF", "STRIDES", "Upsample", "YoloNet", "build_arch",
           "max_pool_same", "upsample2x"]
