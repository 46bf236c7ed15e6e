"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Every kernel counts its launches in ``<wrapper>.launches``, and
per card in ``<wrapper>.launches_by_device`` (``attention_bihd`` counts
into ``fused_attention``'s and ``int8_conv_stem`` into ``int8_conv``'s;
``fused_attention_bwd`` counts one a backward, its two kernels)."""

from .attention import (attention_bihd, attention_bwd_plain,
                        attention_grads_plain, attention_stats_plain,
                        attention_plain, fused_attention, fused_attention_bwd)
from .c2f import c2f_fused, c2f_plain, c2f_supported
from .conv3x3 import conv3x3_plain, conv3x3_silu, conv3x3s2_silu
from .int8_conv import (int8_conv, int8_conv_plain, int8_conv_stem,
                        int8_stem_plain, quantize_int8, quantize_plain)

KERNELS = (conv3x3_silu, conv3x3s2_silu, c2f_fused, fused_attention,
           fused_attention_bwd, quantize_int8, int8_conv)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def launch_counts_by_device() -> dict:
    """{wrapper name: {card index: launches since the last reset}}."""
    return {k.__name__: dict(k.launches_by_device) for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.launches_by_device = {}


__all__ = ["KERNELS", "attention_bihd", "attention_bwd_plain",
           "attention_grads_plain", "attention_stats_plain",
           "attention_plain", "c2f_fused",
           "c2f_plain", "c2f_supported", "conv3x3_plain", "conv3x3_silu",
           "conv3x3s2_silu", "fused_attention", "fused_attention_bwd",
           "int8_conv", "int8_conv_plain", "int8_conv_stem",
           "int8_stem_plain", "launch_counts",
           "launch_counts_by_device",
           "quantize_int8", "quantize_plain", "reset_launch_counts"]
