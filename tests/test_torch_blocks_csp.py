"""The library's CSP and backbone blocks no zoo model builds (the
reference's Block.cs in yolosharp_tpu_torch/nn/common.py: GhostBottleneck,
SPP, C1, C2, C3x, RepC3, C3Ghost, SCDown, RepVGGDW, CIB, C2fCIB, HGStem and
HGBlock) against the JAX modules on the same weights, by the checks of
tests/test_torch_blocks.py: train-mode forward, running statistics and
gradients, eval-BN and folded forwards, float32 ATOL = RTOL = 1e-4."""

import pytest

from test_torch_blocks import X, check_eval_and_folded, check_train, make_pair
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu.nn import common as jc
from yolosharp_tpu_torch.ckpt import fold_bn
from yolosharp_tpu_torch.kernels import c2f_supported
from yolosharp_tpu_torch.nn import (C1, C2, CIB, SCDown, SPP, C2f, C2fCIB,
                                    C3Ghost, C3x, GhostBottleneck, HGBlock,
                                    HGStem, RepC3, RepVGGDW)

# name: (JAX module, torch module, input (H, W, C)), as test_torch_blocks
BLOCKS = {
    "ghost_bottleneck": (lambda: jc.GhostBottleneck(16),
                         lambda: GhostBottleneck(16, 16), X),
    "ghost_bottleneck_s2": (lambda: jc.GhostBottleneck(32, 3, 2),
                            lambda: GhostBottleneck(16, 32, 3, 2), X),
    "spp": (lambda: jc.SPP(16, (3, 5, 7)), lambda: SPP(16, 16, (3, 5, 7)),
            X),
    "c1": (lambda: jc.C1(16, 3), lambda: C1(16, 16, 3), X),
    "c2": (lambda: jc.C2(16, 2), lambda: C2(16, 16, 2), X),
    "c3x": (lambda: jc.C3x(16, 1), lambda: C3x(16, 16, 1), X),
    "repc3": (lambda: jc.RepC3(16, 2), lambda: RepC3(16, 16, 2), X),
    "repc3_cv3": (lambda: jc.RepC3(16, 1, 0.5),
                  lambda: RepC3(16, 16, 1, 0.5), X),
    "c3ghost": (lambda: jc.C3Ghost(32, 1), lambda: C3Ghost(16, 32, 1), X),
    "scdown": (lambda: jc.SCDown(16, 3, 2), lambda: SCDown(16, 16, 3, 2), X),
    "repvggdw": (lambda: jc.RepVGGDW(16), lambda: RepVGGDW(16), X),
    "cib": (lambda: jc.CIB(16), lambda: CIB(16, 16), X),
    "cib_lk": (lambda: jc.CIB(16, True, 0.5, True),
               lambda: CIB(16, 16, True, 0.5, True), X),
    "c2fcib": (lambda: jc.C2fCIB(16, 1, True, True),
               lambda: C2fCIB(16, 16, 1, True, True), X),
    "hgstem": (lambda: jc.HGStem(16, 24), lambda: HGStem(3, 16, 24),
               (32, 32, 3)),
    "hgblock": (lambda: jc.HGBlock(8, 32, 3, 2),
                lambda: HGBlock(16, 8, 32, 3, 2), X),
    "hgblock_lightconv": (lambda: jc.HGBlock(8, 16, 5, 2, True, True),
                          lambda: HGBlock(16, 8, 16, 5, 2, True, True), X),
}


@pytest.fixture(scope="module", params=list(BLOCKS))
def pair(request):
    return make_pair(BLOCKS, request.param)


def test_train_forward_and_gradients_match_jax(pair):
    check_train(pair)


def test_eval_and_folded_forwards_match_jax(pair):
    check_eval_and_folded(pair)


def test_c2fcib_never_takes_the_c2f_kernel():
    """C2fCIB is not a C2f: folded, nothing in it is packed for the fused
    C2f kernel, whose predicate would take a C2f of its widths."""
    m = fold_bn(C2fCIB(64, 64, 1, True, True).eval())
    assert not any(isinstance(x, C2f) for x in m.modules())
    assert c2f_supported(1, True, 1, 64, 32, 64)
