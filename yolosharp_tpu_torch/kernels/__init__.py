"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Every kernel counts its launches in ``<wrapper>.launches``
(``attention_bihd`` counts into ``fused_attention.launches``)."""

from .attention import (attention_bihd, attention_grads_plain, attention_plain,
                        fused_attention)
from .c2f import c2f_fused, c2f_plain, c2f_supported
from .conv3x3 import conv3x3_plain, conv3x3_silu, conv3x3s2_silu

KERNELS = (conv3x3_silu, conv3x3s2_silu, c2f_fused, fused_attention)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "attention_bihd", "attention_grads_plain",
           "attention_plain", "c2f_fused",
           "c2f_plain", "c2f_supported", "conv3x3_plain", "conv3x3_silu",
           "conv3x3s2_silu", "fused_attention", "launch_counts",
           "reset_launch_counts"]
