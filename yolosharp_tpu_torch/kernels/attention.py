"""Fused softmax attention: ``fused_attention`` over (B, H, N, D) and
``attention_bihd`` over (B, N, H, D), the layout the v12 area attention
(``nn.attention.AAttn``) hands it, and ``fused_attention_bwd``, the
gradients of the 16-bit kernel's forward.

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
the exponentials the practical floor. The layer-8 call is half of that.

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
- float32: a flash-style CUDA-core kernel (float32 FMAs; TF32 would break
  the float32 contract) on register micro-tiles: a warp owns 32 query rows
  (16 at D >= 64), a lane 8 rows x 8 keys of S = Q K^T and 8 rows x D / 8
  columns of O, P through the warp's rows of shared memory; K and V staged
  once by ``cp.async`` where the sequence fits (``f32_geometry``), else
  streamed through two stages; exponentials by ``ex2.approx`` on scores
  pre-scaled to log2 units; where a block has fewer warp tiles than warps,
  groups of warps share a tile's key steps and merge their sums.

On a CPU tensor the wrappers run the plain PyTorch version (autograd runs
through it); on a CUDA tensor they launch the kernel or raise. Both count
launches in ``fused_attention.launches``.

Training: where grad mode is on and an input requires grad, the wrappers
run the kernel inside ``KernelAttention``, a ``torch.autograd.Function``
with the math of the JAX package's ``_pallas_attn_bwd``
(yolosharp_tpu/kernels/attention.py:100-113, einsum code and not a Pallas
kernel). In bfloat16 and float16 its forward also writes each row's
log2-sum-exp and float32 output (``lse`` and ``o32``, 4 (D + 1) bytes a
row; the inference forward is compiled without that epilogue), and its
backward is the kernel ``fused_attention_bwd`` (``csrc/attention_bwd.cu``:
two persistent, warp-specialised Hopper kernels on TMA-fed wgmma, their
grid and ring from ``attention_plan``: a dQ kernel that also writes D_i =
sum_j P_ij dP_ij = g_i . o_i, then a dK / dV kernel; f32 sums, no
atomics, each gradient rounded once); ``attention_stats_plain`` and
``attention_bwd_plain`` are its plain twins with the same interface. In
float32 the backward is the plain ``attention_grads_plain`` (S recomputed
from q and k, softmax, dV, dP, dS, dQ and dK), by the same static route
by type as the forward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import build
from .build import SMEM_LIMIT

HEAD_DIMS = (16, 32, 64, 128)
LOG2E = 1.4426950408889634
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
                    sms: int) -> tuple[int, int, int]:
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


# the float32 kernel's layout (csrc/attention.cu F32Attn), which checks what
# it gets: keys a softmax step, warps a block (by head dim)
F32_KEY_TILE = 64


def f32_layout(D: int) -> tuple:
    """(lanes a row group, query rows of a warp tile, floats of a warp's
    staged Q and P) of the float32 kernel at head dim D."""
    nx = 8 if D <= 32 else 16
    wr = 8 * 32 // nx
    return nx, wr, wr * ((D + 8) + (F32_KEY_TILE + nx))


def f32_smem_bytes(keys: int, stages: int, warps: int, D: int) -> int:
    """Shared memory of one float32 block: one or two stages of K and V
    rows of `keys` keys, and each warp's Q and P."""
    return stages * 2 * keys * D * 4 + warps * f32_layout(D)[2] * 4


def f32_geometry(BH: int, N: int, D: int,
                 sms: int) -> tuple[int, int, int, int]:
    """(splits, staged keys, warps a block, warps a warp tile) of the
    float32 kernel for BH sequences of N rows on a card of sms SMs. Blocks
    of 8 warps (4 at D >= 64, whose tiles are larger), one an SM; the whole
    sequence (N rounded up to 16) is staged once where it fits beside the
    warps' Q and P, else the largest multiple of the key tile that two
    stages hold; each sequence's warp tiles are spread over ``splits``
    blocks so that the grid covers the SMs without a second wave, one block
    per sequence where the batch alone does that; where a block has fewer
    warp tiles than warps, the warps go in groups (a power of two, at most
    the key steps) that share a tile's key steps."""
    if D not in HEAD_DIMS:
        raise ValueError(f"f32_geometry: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    warps = 8 if D <= 32 else 4
    whole = -(-N // 16) * 16
    if f32_smem_bytes(whole, 1, warps, D) <= SMEM_LIMIT:
        keys = whole
    else:
        free = SMEM_LIMIT - f32_smem_bytes(0, 2, warps, D)
        keys = free // (2 * 2 * D * 4) // F32_KEY_TILE * F32_KEY_TILE
    tiles = -(-N // f32_layout(D)[1])
    splits = max(1, min(tiles, sms // BH))
    ksplit = 1
    while (2 * ksplit * -(-tiles // splits) <= warps
           and 2 * ksplit <= -(-N // F32_KEY_TILE)):
        ksplit *= 2
    return splits, keys, warps, ksplit


# the backward's Hopper kernels (csrc/attention16.cuh Cfg), which check it
OWN_ROWS = 64          # rows of a consumer warpgroup
CONSUMERS = 2          # consumer warpgroups a block
UNIT_ROWS = OWN_ROWS * CONSUMERS   # rows of a work unit of one sequence
MAX_STAGES = 8         # ring stages of the stream
KINDS = ("dq", "dkdv")   # the backward's two kernels


class AttnPlan(NamedTuple):
    """A launch of one of the backward's kernels: ``grid`` persistent blocks
    (one an SM) over ``units`` units of UNIT_ROWS rows of a sequence, a
    ring of ``stages`` stream stages of ``tile`` rows (a sequence longer
    than the ring is recycled through it within a unit), ``smem`` bytes of
    shared memory a block."""
    kind: str
    grid: int
    stages: int
    tile: int
    units: int
    smem: int


def stream_tile(kind: str, D: int) -> int:
    """Rows of a stream stage: 64 keys (dQ) or query rows (dK / dV; 32 at
    D = 128, where four 64 x 128 accumulators would not fit)."""
    return 32 if kind == "dkdv" and D == 128 else 64


def stage_bytes(kind: str, D: int) -> int:
    """A ring stage: two tiles of the stream (K and V, or Q and g), the dK /
    dV kernel's f32 lse and D of its rows, on 1024-byte boundaries."""
    t = stream_tile(kind, D)
    raw = 2 * t * D * 2 + (2 * t * 4 if kind == "dkdv" else 0)
    return -(-raw // 1024) * 1024


def plan_smem(kind: str, D: int, stages: int) -> int:
    """Shared memory of one block: 1 KB of alignment, two units' own tiles
    (Q and g; K and V) for each consumer warpgroup, the ring, and the
    mbarriers."""
    return (1024 + 2 * CONSUMERS * 2 * OWN_ROWS * D * 2
            + stages * stage_bytes(kind, D)
            + 8 * (4 * CONSUMERS + 2 * MAX_STAGES))


def attention_plan(kind: str, S: int, N: int, D: int, sms: int) -> AttnPlan:
    """The launch of one of the backward's kernels (``kind`` in KINDS) over
    S sequences of N rows at head dim D on a card of ``sms`` SMs: one
    persistent block an SM (at most one a unit), and as many ring stages as
    the shared memory holds, up to MAX_STAGES."""
    if kind not in KINDS or D not in HEAD_DIMS:
        raise ValueError(f"attention_plan: no {kind} kernel at head dim {D}")
    tile = stream_tile(kind, D)
    units = S * -(-N // UNIT_ROWS)
    stages = min(MAX_STAGES,
                 (SMEM_LIMIT - plan_smem(kind, D, 0)) // stage_bytes(kind, D))
    return AttnPlan(kind, max(1, min(units, sms)), stages, tile, units,
                    plan_smem(kind, D, stages))


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
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("attention_bwd")
    fn = lib.ys_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _check_shapes(name: str, *ts) -> None:
    """One 4-d shape for every tensor, with a head dim the kernels take."""
    if ts[0].dim() != 4 or any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"{name}: the tensors must share one 4-d shape, got "
                         + ", ".join(str(tuple(t.shape)) for t in ts))
    if ts[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {ts[0].shape[-1]} is not one of "
                         f"{HEAD_DIMS}")


def lse_rows(N: int) -> int:
    """Row stride of the row-statistics buffers: N rounded up to 4 floats
    (TMA reads them in 16-byte units)."""
    return -(-N // 4) * 4


def _launch(name: str, q, k, v, o, scale: float, stats=None) -> None:
    """Launch on (B, H, N, D) views q, k, v and the output o; stats (16-bit
    only): the (lse, o32) buffers the forward fills for the backward, a
    (B H, lse_rows(N)) and a (B H, N, D) float32 tensor."""
    _check_shapes(name, q, k, v)
    B, H, N, D = q.shape
    code, stream = build.launch_args(name, q, k, v, o, strided=True)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    sms = build.sm_count(q.device.index)
    geometry = (launch_geometry(B * H, N, D, sms) + (1,)
                if q.dtype in build.HALF_DTYPES
                else f32_geometry(B * H, N, D, sms))
    lse, o32 = stats if stats is not None else (None, None)
    with torch.cuda.device(q.device):
        status = _lib().ys_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, N,
            D, *strides, float(scale), code, *geometry,
            None if lse is None else lse.data_ptr(),
            None if o32 is None else o32.data_ptr(), lse_rows(N), stream)
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


def attention_stats_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float):
    """The row statistics the 16-bit forward writes under autograd, over
    (B, N, H, D) tensors, in float32: lse, log2 of sum_j 2^(q_i k_j scale
    log2(e)), as a (B H, lse_rows(N)) tensor whose padding is 0, and o32,
    the output before its rounding, as a contiguous (B H, N, D) tensor."""
    B, N, H, D = q.shape
    s = torch.einsum("bihd,bjhd->bhij", q.float() * scale, k.float())
    lse = torch.zeros(B * H, lse_rows(N), dtype=torch.float32,
                      device=q.device)
    lse[:, :N] = (torch.logsumexp(s, dim=-1) * LOG2E).reshape(B * H, N)
    o32 = torch.matmul(torch.softmax(s, dim=-1), v.float().transpose(1, 2))
    return lse, o32.reshape(B * H, N, D).contiguous()


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, lse: torch.Tensor, o32: torch.Tensor,
                        scale: float):
    """The plain version of ``fused_attention_bwd``, with its interface:
    (dq, dk, dv) over (B, N, H, D) tensors from the forward's row
    statistics (``attention_stats_plain``): P = 2^(q k^T scale log2(e) -
    lse), D_i = g_i . o32_i, dS = P (dP - D), float32 sums, each gradient
    cast to its input's type."""
    B, N, H, D = q.shape
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bihd,bjhd->bhij", qf * scale, kf)
    p = torch.exp2(s * LOG2E - lse[:, :N].reshape(B, H, N, 1))
    dv = torch.einsum("bhij,bihd->bjhd", p, gf)
    dp = torch.einsum("bihd,bjhd->bhij", gf, vf)
    delta = (gf.transpose(1, 2) * o32.reshape(B, H, N, D)).sum(-1,
                                                               keepdim=True)
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bhij,bjhd->bihd", ds, kf)
    dk = scale * torch.einsum("bhij,bihd->bjhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tma_ready(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1]))


@functools.lru_cache(maxsize=256)
def _bwd_plan(S: int, N: int, D: int, sms: int):
    """The grid and ring of the dQ and dK / dV kernels, as ys_attention_bwd
    takes them."""
    plans = [attention_plan(kind, S, N, D, sms) for kind in KINDS]
    return (ctypes.c_int * 4)(*[x for p in plans for x in (p.grid, p.stages)])


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, lse: torch.Tensor, o32: torch.Tensor,
                        scale: float):
    """(dq, dk, dv), contiguous (B, N, H, D), of the 16-bit kernel's forward
    over (B, N, H, D) tensors for the output gradient g; lse and o32: the
    rows' log2-sum-exp ((B H, lse_rows(N)) float32) and float32 output
    ((B H, N, D)) the forward wrote. One launch of ``ys_attention_bwd`` (its
    dQ kernel, then its dK / dV kernel) on CUDA tensors, which raises on
    what it cannot take; the plain ``attention_bwd_plain`` on CPU
    tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, g, lse, o32, scale)
    name = "fused_attention_bwd"
    _check_shapes(name, q, k, v, g)
    if q.dtype not in build.HALF_DTYPES:
        raise TypeError(f"{name}: takes bfloat16 or float16, got {q.dtype} "
                        f"(the float32 backward is attention_grads_plain)")
    B, N, H, D = q.shape
    for t, want in ((lse, (B * H, lse_rows(N))), (o32, (B * H, N, D))):
        if (t.dtype != torch.float32 or t.device != q.device
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and o32 must be contiguous "
                             f"float32 tensors of {(B * H, lse_rows(N))} "
                             f"and {(B * H, N, D)} on {q.device}")
    if not _tma_ready(g):
        g = g.contiguous()   # autograd may hand over an expanded gradient
    code, stream = build.launch_args(name, q, k, v, g, strided=True)
    # dq, dk, dv: one contiguous allocation, each (B, N, H, D) 16-byte aligned
    grads = torch.empty((3, *q.shape), dtype=q.dtype, device=q.device)
    delta = torch.empty_like(lse)
    ts = (q, k, v, g, *grads)
    # (batch, head, row) strides of each (B, N, H, D) tensor
    strides = (ctypes.c_longlong * 21)(
        *[x for t in ts for x in (t.stride(0), t.stride(2), t.stride(1))])
    plan = _bwd_plan(B * H, N, D, build.sm_count(q.device.index))
    with torch.cuda.device(q.device):
        status = _bwd_lib().ys_attention_bwd(
            *[t.data_ptr() for t in ts], B, H, N, D, strides, float(scale),
            code, plan, lse.data_ptr(), o32.data_ptr(), delta.data_ptr(),
            lse_rows(N), stream)
    build.check_status(name, status)
    build.count_launch(fused_attention_bwd, q.device)
    return tuple(grads)


def _kernel_bihd(q, k, v, scale: float, stats=None) -> torch.Tensor:
    """One launch over (B, N, H, D) views; a contiguous (B, N, H, D)
    output."""
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("fused_attention", q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), o.transpose(1, 2), scale, stats)
    build.count_launch(fused_attention, q.device)
    return o


class KernelAttention(torch.autograd.Function):
    """The kernel's forward over (B, N, H, D) tensors. bfloat16 and
    float16: the forward also writes the rows' log2-sum-exp and float32
    output (4 (D + 1) bytes a row), and the backward is the kernel
    ``fused_attention_bwd``; float32: the plain backward
    ``attention_grads_plain``. q, k and v are kept for it (the backward
    recomputes the scores, as the JAX custom VJP does)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        stats = ()
        if q.dtype in build.HALF_DTYPES:
            B, N, H, D = q.shape
            stats = (torch.empty(B * H, lse_rows(N), dtype=torch.float32,
                                 device=q.device),
                     torch.empty(B * H, N, D, dtype=torch.float32,
                                 device=q.device))
        ctx.save_for_backward(q, k, v, *stats)
        ctx.scale = scale
        return _kernel_bihd(q, k, v, scale, stats or None)

    @staticmethod
    def backward(ctx, g):
        q, k, v, *stats = ctx.saved_tensors
        if stats:
            grads = fused_attention_bwd(q, k, v, g, *stats, ctx.scale)
        else:
            grads = attention_grads_plain(q, k, v, g, ctx.scale)
        return (*grads, None)


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
fused_attention_bwd.launches = 0
fused_attention_bwd.launches_by_device = {}
