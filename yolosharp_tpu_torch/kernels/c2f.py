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
only the block output goes back to device memory. The halo ring is
recomputed by neighbouring tiles; weights stream from L2.

- bfloat16 and float16 (one template on the element type): the five GEMMs (cv1 on the window, the two 3x3s through shifted
  ``ldmatrix`` rows, cv1's other half, cv2 over ``[a | bh | z]``) run on the
  tensor cores, with weight and input chunks double-buffered through
  ``cp.async``. The intermediates are 16-bit (as the plain chain rounds them),
  which halves their footprint: the tile is 16x16 for c <= 32 and 8x8 up to
  c = 256 (219,456 bytes of shared memory at c = 256, one block per SM),
  halved by ``launch_tile`` while the grid has fewer blocks than SMs (v8s
  layer 8 at batch 2: 18 blocks of 8x8, so 4x4). The tile's cost is the halo:
  8x8 at 20x20 computes 1.83x the block's FLOPs (the halo and the ragged
  third tile), 16x16 at 160x160 1.13x.
- float32: the CUDA-core kernel; its float32 intermediates make the tile
  8x8 for c <= 64 and 4x4 above.

Unlike the TPU kernel there is no flat-row im2col and no H % R limit.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .build import SMEM_LIMIT
from .conv3x3 import conv3x3_plain

# the 16-bit layout of csrc/c2f.cu (tc_bytes), which checks the tile it is given
_CHUNK = 32           # input channels staged per chunk (kKC)
_WPITCH = 256 + 8     # weight chunk row pitch of the 16-bit route (kWP)


def tile_for(c: int, half: bool = False) -> int:
    """Widest output tile edge for hidden width c: float32 8 for c <= 64 and
    4 above; the 16-bit route (half) 16 for c <= 32, then 8 while it fits
    shared memory, then 4."""
    if not half:
        return 8 if c <= 64 else 4
    if c <= 32:
        return 16
    return 8 if smem_bytes(8, c, True) <= SMEM_LIMIT else 4


def launch_tile(B: int, H: int, W: int, c: int, half: bool, sms: int) -> int:
    """The tile edge the kernel runs: ``tile_for``, and for the 16-bit route
    halved (down to 4) while the grid of tiles x B leaves some of the card's
    sms SMs without a block."""
    tile = tile_for(c, half)
    while half and tile >= 8 and -(-H // tile) * -(-W // tile) * B < sms:
        tile //= 2
    return tile


def smem_bytes(tile: int, c: int, half: bool = False) -> int:
    """Shared memory of one block: float32 Geom::floats, the 16-bit route
    tc_bytes (csrc/c2f.cu)."""
    r2, r1, r0 = (tile + 4) ** 2, (tile + 2) ** 2, tile ** 2
    if not half:
        return 4 * (r2 * _CHUNK + c * (r2 + r1 + 2 * r0))
    return (2 * (c + 8) * (r2 + r1 + r0) + 2 * r2 * (_CHUNK + 8) * 2
            + 2 * _CHUNK * _WPITCH * 2)


def c2f_supported(n: int, shortcut: bool, g: int, cin: int, c: int,
                  c2: int) -> bool:
    """Static statement of what the kernel takes, in both types: a C2f with
    one shortcut bottleneck, no groups, c % 16 == 0, C2 and Cin multiples of
    8 (16-byte rows for the 16-bit route's copies), and widest tiles of both
    routes that fit shared memory (c <= 424). Covers the v8n and v8s layers
    2 and 8 (c = 16, 32, 128, 256)."""
    if not (n == 1 and shortcut and g == 1 and cin > 0 and c > 0
            and c % 16 == 0 and c2 % 8 == 0 and cin % 8 == 0):
        return False
    return (smem_bytes(tile_for(c), c) <= SMEM_LIMIT
            and smem_bytes(tile_for(c, True), c, True) <= SMEM_LIMIT)


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
    code, stream = build.launch_args("c2f_fused", x, w1, b1, wm1, bm1, wm2,
                                     bm2, w2, b2)
    if not c2f_supported(1, True, 1, cin, c, C2):
        raise ValueError(f"c2f_fused: the kernel does not take Cin={cin}, "
                         f"c={c}, C2={C2}")
    tile = launch_tile(B, H, W, c, x.dtype in build.HALF_DTYPES,
                       build.sm_count(x.device.index))
    y = torch.empty((B, H, W, C2), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, y)]
    with torch.cuda.device(x.device):
        status = _lib().ys_c2f(*ptrs, B, H, W, cin, c, C2, tile, code, stream)
    build.check_status("c2f_fused", status)
    build.count_launch(c2f_fused, x.device)
    return y


c2f_fused.launches = 0
c2f_fused.launches_by_device = {}
