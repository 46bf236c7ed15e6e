"""The port's public names: everything the JAX package exports, the port
exports too (`from yolosharp_tpu_torch import ...` takes the same names)."""

import yolosharp_tpu
import yolosharp_tpu_torch


def test_port_exports_every_name_of_the_jax_package():
    missing = set(yolosharp_tpu.__all__) - set(yolosharp_tpu_torch.__all__)
    assert not missing, sorted(missing)
    for name in yolosharp_tpu_torch.__all__:
        assert getattr(yolosharp_tpu_torch, name) is not None, name


def test_enums_that_configure_training_are_importable():
    from yolosharp_tpu_torch import AutoAugmentType, ImageProcessType
    from yolosharp_tpu_torch.types import (AutoAugmentType as A,
                                           ImageProcessType as I)
    assert (AutoAugmentType, ImageProcessType) == (A, I)
    assert {m.value for m in ImageProcessType} == {
        m.value for m in yolosharp_tpu.ImageProcessType}
    assert {m.value for m in AutoAugmentType} == {
        m.value for m in yolosharp_tpu.AutoAugmentType}
