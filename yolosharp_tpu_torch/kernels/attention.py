"""Fused softmax attention: ``fused_attention`` over (B, H, N, D) and
``attention_bihd`` over (B, N, H, D), the layout the v12 area attention
(``nn.attention.AAttn``) hands it.

Replaces the Pallas kernel ``yolosharp_tpu/kernels/attention.py``
``fused_attention`` (``_attn_kernel``) with one hand-written CUDA kernel,
``csrc/attention.cu``. The functions keep the JAX signatures and compute what
the TPU kernel body computes: q, k and v in float32, softmax(q*scale @ k^T)
@ v with float32 probabilities, the output rounded to q's type once.

What bounds it on the card: a sequence of N rows does 4*N*N*D operations on
3*N*D inputs (at N=400, D=32: ~20 MFLOP over ~77 KB of bf16), so it is
compute bound; the (N, N) scores are what a plain version pays for in device
memory. Design: a flash-style forward on the CUDA cores. A block owns 64
query rows of one sequence; each row keeps its running max, running sum and
float32 output in registers, key/value tiles of 64 are staged in shared
memory, and the scores never leave the block. Edges are masked, so there is
no limit on N and none of the TPU kernel's row padding. The kernel reads q,
k and v as strided views (unit stride in D), so the qkv split costs no
copies. Tensor cores (``mma.sync`` / ``wgmma``) are later work.

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA tensor
they launch the kernel or raise. Both count launches in
``fused_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)


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
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
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
    with torch.cuda.device(q.device):
        status = _lib().ys_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, N,
            D, *strides, float(scale), code, stream)
    build.check_status(name, status)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v over (B, H, N, D) tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("fused_attention", q, k, v, o, scale)
    fused_attention.launches += 1
    return o


def attention_bihd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The same over (B, N, H, D) tensors; returns a contiguous
    (B, N, H, D) tensor on CUDA."""
    if q.device.type == "cpu":
        return attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale).transpose(1, 2)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("fused_attention", q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), o.transpose(1, 2), scale)
    fused_attention.launches += 1
    return o


fused_attention.launches = 0
