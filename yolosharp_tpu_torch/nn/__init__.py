from .attention import (A2C2f, AAttn, ABlock, AttentionPSA, C2PSA, C3TR,
                        PSABlock, TransformerBlock, TransformerLayer)
from .common import (AGLU, C1, C2, C3, C2f, C2fCIB, C3Ghost, C3k, C3k2, C3x,
                     CBAM, CIB, SCDown, SPP, SPPF, Bottleneck,
                     ChannelAttention, Concat, Conv2, Conv2d, ConvBN,
                     ConvTranspose, ConvTranspose2d, DWConv,
                     DWConvTranspose2d, Focus, GhostBottleneck, GhostConv,
                     HGBlock, HGStem, Index, LightConv, Proto, RepC3,
                     RepConv, RepVGGDW, SpatialAttention, Upsample,
                     max_pool_same, upsample2x)
from .heads import Classify, Detect, Obb, Pose, Segment
from .model import STRIDES, ArchCfg, YoloNet, build_arch

__all__ = ["A2C2f", "AAttn", "ABlock", "AGLU", "ArchCfg", "AttentionPSA",
           "Bottleneck", "C1", "C2", "C2PSA", "C2f", "C2fCIB", "C3", "C3Ghost",
           "C3TR", "C3k", "C3k2", "C3x", "CBAM", "CIB", "ChannelAttention",
           "Classify", "Concat", "Conv2", "Conv2d", "ConvBN", "ConvTranspose",
           "ConvTranspose2d", "DWConv", "DWConvTranspose2d", "Detect",
           "Focus", "GhostBottleneck", "GhostConv", "HGBlock", "HGStem",
           "Index", "LightConv", "Obb", "PSABlock", "Pose", "Proto", "RepC3",
           "RepConv", "RepVGGDW", "SCDown", "SPP", "SPPF", "STRIDES",
           "Segment", "SpatialAttention", "TransformerBlock",
           "TransformerLayer", "Upsample", "YoloNet", "build_arch",
           "max_pool_same", "upsample2x"]
