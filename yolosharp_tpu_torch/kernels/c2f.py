"""One fused inference C2f block (n=1, shortcut): ``c2f_fused``.

Replaces the Pallas kernel ``yolosharp_tpu/kernels/c2f.py`` ``c2f_fused``
(``_kernel``) with the hand-written CUDA kernel ``csrc/c2f.cu``. Same
signature: x (B, H, W, Cin), w1 (Cin, 2c), wm1 / wm2 (3, 3, c, c), w2
(3c, C2), folded-BN biases; returns (B, H, W, C2).

What bounds it on the card: run as separate layers, the block writes and
re-reads four intermediates (cv1's 2c channels, the two bottleneck convs,
the 3c concat) through device memory; the two 3x3 convs are compute bound.
Design: a block owns a spatial tile with a 2-pixel halo and keeps cv1's
output, the bottleneck intermediates and the concat in shared memory, so
only the block output goes back to device memory. Shared memory (227 KB a
block) is what limits the tile: it holds about (tile+4)^2 * 2c float32
values, so the tile is 8x8 for c <= 64 and 4x4 above (the v8s layer-8
block has c = 256). The halo ring is recomputed by neighbouring tiles;
weights stream from L2. Unlike the TPU kernel there is no flat-row im2col
and no H % R limit.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .conv3x3 import conv3x3_plain

SMEM_LIMIT = 232448   # shared memory one block may use on Hopper
_CHUNK = 32           # input channels staged per chunk (kKC in csrc/c2f.cu)


def tile_for(c: int) -> int:
    """Output tile edge the kernel uses for hidden width c."""
    return 8 if c <= 64 else 4


def smem_bytes(tile: int, c: int) -> int:
    """Shared memory of one block (Geom::floats in csrc/c2f.cu, float32)."""
    r2, r1, r0 = (tile + 4) ** 2, (tile + 2) ** 2, tile ** 2
    return 4 * (r2 * _CHUNK + c * (r2 + r1 + 2 * r0))


def c2f_supported(n: int, shortcut: bool, g: int, cin: int, c: int,
                  c2: int) -> bool:
    """Static statement of what the kernel takes: a C2f with one shortcut
    bottleneck, no groups, hidden width and output width multiples of 4,
    and a tile that fits shared memory (c <= 424). Covers the v8 layers 2
    and 8 (v8s: c = 32 and c = 256)."""
    return (n == 1 and shortcut and g == 1 and cin > 0 and c > 0
            and c % 4 == 0 and c2 % 4 == 0
            and smem_bytes(tile_for(c), c) <= SMEM_LIMIT)


def c2f_plain(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2) -> torch.Tensor:
    """The plain PyTorch version: the C2f module's math on NHWC tensors."""
    c = wm1.shape[-1]
    a, bh = F.silu(x @ w1 + b1).split(c, dim=-1)
    t = conv3x3_plain(bh, wm1, bm1)
    z = bh + conv3x3_plain(t, wm2, bm2)
    return F.silu(torch.cat([a, bh, z], -1) @ w2 + b2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("c2f")
    fn = lib.ys_c2f
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return lib


def c2f_fused(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2) -> torch.Tensor:
    """Fused C2f(n=1, shortcut=True) forward (inference, folded BN)."""
    if x.device.type == "cpu":
        return c2f_plain(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2)
    if x.dim() != 4:
        raise ValueError(f"c2f_fused: x must be (B, H, W, Cin), got "
                         f"{tuple(x.shape)}")
    B, H, W, cin = x.shape
    c = wm1.shape[-1]
    C2 = w2.shape[-1]
    shapes = {"w1": (w1, (cin, 2 * c)), "b1": (b1, (2 * c,)),
              "wm1": (wm1, (3, 3, c, c)), "bm1": (bm1, (c,)),
              "wm2": (wm2, (3, 3, c, c)), "bm2": (bm2, (c,)),
              "w2": (w2, (3 * c, C2)), "b2": (b2, (C2,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"c2f_fused: {name} must be {want}, got "
                             f"{tuple(t.shape)}")
    if not c2f_supported(1, True, 1, cin, c, C2):
        raise ValueError(f"c2f_fused: the kernel does not take c={c}, "
                         f"C2={C2}")
    code, stream = build.launch_args("c2f_fused", x, w1, b1, wm1, bm1, wm2,
                                     bm2, w2, b2)
    y = torch.empty((B, H, W, C2), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, y)]
    with torch.cuda.device(x.device):
        status = _lib().ys_c2f(*ptrs, B, H, W, cin, c, C2, tile_for(c),
                               code, stream)
    build.check_status("c2f_fused", status)
    c2f_fused.launches += 1
    return y


c2f_fused.launches = 0
