from .attention import (A2C2f, AAttn, ABlock, AttentionPSA, C2PSA,
                        PSABlock)
from .common import (C2f, C3, C3k, C3k2, Bottleneck, Concat, Conv2d, ConvBN,
                     ConvTranspose2d, DWConv, Proto, SPPF, Upsample,
                     max_pool_same, upsample2x)
from .heads import Classify, Detect, Obb, Pose, Segment
from .model import STRIDES, ArchCfg, YoloNet, build_arch

__all__ = ["A2C2f", "AAttn", "ABlock", "ArchCfg", "AttentionPSA", "Bottleneck",
           "C2PSA", "C2f", "C3", "C3k", "C3k2", "Classify", "Concat",
           "Conv2d", "ConvBN", "ConvTranspose2d", "DWConv", "Detect", "Obb",
           "PSABlock", "Pose", "Proto", "SPPF", "STRIDES", "Segment",
           "Upsample", "YoloNet", "build_arch", "max_pool_same", "upsample2x"]
