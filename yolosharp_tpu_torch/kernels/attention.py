"""Fused softmax attention: ``fused_attention`` over (B, H, N, D) and
``attention_bihd`` over (B, N, H, D), the layout the v12 area attention
(``nn.attention.AAttn``) hands it.

Replaces the Pallas kernel ``yolosharp_tpu/kernels/attention.py``
``fused_attention`` (``_attn_kernel``) with hand-written CUDA,
``csrc/attention.cu``. The functions keep the JAX signatures and compute
what the TPU kernel body computes: softmax(q*scale @ k^T) @ v with float32
scores and sums, the output rounded to q's type once. The kernels read q, k
and v as strided views (unit stride in D), so AAttn's qkv split costs no
copies; edges are masked, so there is no limit on N and none of the TPU
kernel's row padding.

What bounds it on an H100 (v12s at 640x640, batch 32, D = 32, N = 400):
the layer-6 call (512 sequences) reads its strided qkv and writes o, 52 MB
(15.6 us at 3.35 TB/s), for 10.5 GFLOP (10.6 us at 989 TFLOP/s in bf16) and
82 M exponentials (~22 us at 16 ex2 a clock per SM): bound by bytes, with
the exp unit the practical floor. The layer-8 call is half of that.

- bfloat16 and float16 (one template on the element type): a tensor-core
  kernel (``mma.sync`` m16n8k16, f32 sums). A block stages its sequence's K
  and V once in its 16-bit type in shared memory (cp.async,
  16-byte chunks XOR-swizzled for conflict-free ``ldmatrix``: 51 KB at
  N = 400, four blocks an SM) and its warps walk their 16-row query tiles
  against it, P held in registers as the A operand of P V, exponentials by
  ``ex2.approx`` with log2(e) folded into the scale. Sequences too long for
  one block's shared memory (``kv_keys``) are streamed in chunks.
  ``launch_geometry`` spreads each sequence's query tiles over ``splits``
  blocks so that small batches still fill the SMs, with 8 warps a block
  where a staged sequence takes a whole SM (N = 1600 at D = 32). P is rounded
  to the 16-bit type for P V, as the JAX package's off-TPU einsum path does.
- float32: the flash-style CUDA-core kernel (64 query rows a block, 64-key
  float32 tiles, online softmax); TF32 would break the float32 contract.

On a CPU tensor the wrappers run the plain PyTorch version (autograd runs
through it); on a CUDA tensor they launch the kernel or raise. Both count
launches in ``fused_attention.launches``.

Training: where grad mode is on and an input requires grad, the wrappers
run the kernel inside ``KernelAttention``, a ``torch.autograd.Function``
whose backward is plain PyTorch with the math of the JAX package's
``_pallas_attn_bwd`` (yolosharp_tpu/kernels/attention.py:100-113), which is
einsum code and not a Pallas kernel: S recomputed in float32 from q and k,
softmax, then dV, dP, dS, dQ and dK, each cast back to its input's type.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build
from .build import SMEM_LIMIT

HEAD_DIMS = (16, 32, 64, 128)
# the 16-bit kernel's layout (csrc/attention.cu), which checks what it gets
KEY_TILE = 64          # keys a softmax step (kKT)
SM_SMEM = 233472       # shared memory of an SM (each block also takes 1 KB)
STREAM_SMEM = 96 * 1024  # staged K and V of a sequence that does not fit
MAX_BLOCKS = 4         # resident blocks an SM that the splits aim at


def smem_bytes(keys: int, D: int) -> int:
    """Shared memory of one 16-bit block: K and V rows of D elements."""
    return 2 * keys * D * 2


def kv_keys(N: int, D: int) -> int:
    """Keys of K and V the 16-bit kernel stages at once: all N (rounded up to
    16) where they fit one block's shared memory, else chunks of a multiple
    of the key tile that fit ``STREAM_SMEM``."""
    whole = -(-N // 16) * 16
    if smem_bytes(whole, D) <= SMEM_LIMIT:
        return whole
    return STREAM_SMEM // smem_bytes(KEY_TILE, D) * KEY_TILE


def launch_geometry(BH: int, N: int, D: int,
                    sms: int) -> Tuple[int, int, int]:
    """(splits, staged keys, warps a block) of the 16-bit kernel for BH
    sequences of N rows on a card of sms SMs: each sequence's 16-row query
    tiles are spread over ``splits`` blocks so that the grid fills the
    blocks the SMs hold at once (by shared memory, at most MAX_BLOCKS an SM)
    without a second wave, one block per sequence where the batch alone does
    that, and never more blocks than tiles. A block has 4 warps, or 8 where
    its staged keys leave room for only one block an SM."""
    keys = kv_keys(N, D)
    per_sm = max(1, min(MAX_BLOCKS, SM_SMEM // (smem_bytes(keys, D) + 1024)))
    splits = max(1, min(-(-N // 16), sms * per_sm // BH))
    return splits, keys, 8 if per_sm == 1 else 4


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The plain PyTorch version over (B, H, N, D): float32 throughout,
    the output in q's type."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("attention")
    fn = lib.ys_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return lib


def _launch(name: str, q, k, v, o, scale: float) -> None:
    """Launch on (B, H, N, D) views q, k, v and the output o."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must share one 4-d shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, N, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} is not one of {HEAD_DIMS}")
    code, stream = build.launch_args(name, q, k, v, o, strided=True)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    geometry = (launch_geometry(B * H, N, D, build.sm_count(q.device.index))
                if q.dtype in build.HALF_DTYPES else (0, 0, 0))
    with torch.cuda.device(q.device):
        status = _lib().ys_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, N,
            D, *strides, float(scale), code, *geometry, stream)
    build.check_status(name, status)


def attention_grads_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          g: torch.Tensor, scale: float):
    """(dq, dk, dv) of softmax(q k^T scale) v over (B, N, H, D) tensors for
    the output gradient g, in float32, each cast to its input's type (the
    math of _pallas_attn_bwd)."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bihd,bjhd->bhij", qf * scale, kf)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhij,bihd->bjhd", p, gf)
    dp = torch.einsum("bihd,bjhd->bhij", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = scale * torch.einsum("bhij,bjhd->bihd", ds, kf)
    dk = scale * torch.einsum("bhij,bihd->bjhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_bihd(q, k, v, scale: float) -> torch.Tensor:
    """One launch over (B, N, H, D) views; a contiguous (B, N, H, D)
    output."""
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("fused_attention", q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), o.transpose(1, 2), scale)
    build.count_launch(fused_attention, q.device)
    return o


class KernelAttention(torch.autograd.Function):
    """The kernel's forward over (B, N, H, D) tensors with the plain
    backward ``attention_grads_plain``; q, k and v are kept for it (the
    backward recomputes the scores, as the JAX custom VJP does)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _kernel_bihd(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_grads_plain(q, k, v, g, ctx.scale), None)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v over (B, H, N, D) tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if _needs_grad(q, k, v):
        return KernelAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), scale).transpose(1, 2)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("fused_attention", q, k, v, o, scale)
    build.count_launch(fused_attention, q.device)
    return o


def attention_bihd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The same over (B, N, H, D) tensors; returns a contiguous
    (B, N, H, D) tensor on CUDA."""
    if q.device.type == "cpu":
        return attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale).transpose(1, 2)
    if _needs_grad(q, k, v):
        return KernelAttention.apply(q, k, v, scale)
    return _kernel_bihd(q, k, v, scale)


fused_attention.launches = 0
fused_attention.launches_by_device = {}
