"""FSDP / ZeRO sharding of the train state over the data-parallel ranks
(counterpart of yolosharp_tpu/parallel/fsdp.py:37-88).

``fsdp_spec`` is the JAX package's rule: a leaf is cut along its largest
dim that the rank count divides (ties to the trailing dim), and leaves
under ``DEFAULT_MIN_SIZE`` elements, scalars and indivisible leaves stay
replicated. A torch OIHW weight holds the JAX HWIO kernel's dims in
another order, so the two may cut another dim of a tie, never another
count of bytes.

The sharding is hand-written ZeRO (stage 2), not ``fully_shard``: FSDP2
shards every parameter (none stays replicated, so its per-rank bytes
cannot follow the rule) and averages gradients, where the port's loss
needs their sum. Here each rank keeps, for every parameter with a spec,
only its slice of the float32 master weight and of AdamW's two moments
(``ShardedParams``); the train step reduce-scatters (sums) the full
gradients into those slices, frees the full ones, updates the slices, and
all-gathers the new weights into the network the forward runs. Those
working weights stay whole on every rank between steps (``fully_shard``
would free them), so a rank holds the JAX package's sharded bytes of the
state (``state_bytes`` = ``sharded_param_bytes``) plus the working weights
(``working_bytes``), where a JAX FSDP device holds only the former.
Parameters without a spec and the BN statistics are replicated, as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import dist

# leaves below this element count stay replicated: gathering a tiny BN
# scale costs more than the bytes saved
DEFAULT_MIN_SIZE = 4096


def fsdp_spec(shape, axis_size: int, *,
              min_size: int = DEFAULT_MIN_SIZE) -> Optional[int]:
    """The dim of `shape` to shard over `axis_size` ranks, or None
    (replicated): the largest dim the axis divides, ties to the trailing
    one."""
    shape = tuple(shape)
    if not shape or int(np.prod(shape)) < min_size:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % axis_size == 0 and (best is None or d >= shape[best]):
            best = i
    return best


def sharded_param_bytes(leaves: Iterable, axis_size: int) -> int:
    """Per-rank bytes of the state `leaves` (tensors or arrays: anything
    with a shape and a dtype) under fsdp_spec: a sharded leaf's bytes over
    axis_size, a replicated leaf's whole."""
    total = 0
    for leaf in leaves:
        shape = tuple(leaf.shape)
        itemsize = (leaf.element_size() if isinstance(leaf, torch.Tensor)
                    else np.dtype(leaf.dtype).itemsize)
        nbytes = int(np.prod(shape)) * itemsize
        spec = fsdp_spec(shape, axis_size)
        total += nbytes // (axis_size if spec is not None else 1)
    return total


class ShardedParams:
    """The ZeRO shards of `net`'s trainable parameters on this rank.

    ``named_masters()`` gives (name, master) pairs for the optimizer: the
    rank's slice (a new float32 leaf) where the parameter has a spec, the
    network's own parameter where it is replicated."""

    def __init__(self, net: nn.Module):
        ctx = dist.active()
        self.rank, self.world = ctx.rank, ctx.world
        self.net = net
        self.entries: List[Tuple[str, nn.Parameter, Optional[int],
                                 torch.Tensor]] = []
        for name, p in net.named_parameters():
            if not p.requires_grad:
                continue
            dim = fsdp_spec(p.shape, self.world)
            if dim is None:
                master = p
            else:
                master = nn.Parameter(
                    p.detach().chunk(self.world, dim)[self.rank].clone())
            self.entries.append((name, p, dim, master))

    def named_masters(self):
        return [(name, m) for name, _, _, m in self.entries]

    def reduce_gradients(self, extra: torch.Tensor) -> torch.Tensor:
        """Sum the network's gradients over the ranks into the masters'
        ``.grad``: reduce-scatter into the slices, one all-reduce for the
        replicated ones with `extra` (flat float32, summed too) appended;
        returns the summed `extra`."""
        rep = []
        for _, p, dim, master in self.entries:
            if dim is None:
                rep.append(p.grad)
                continue
            g = p.grad.movedim(dim, 0)
            master.grad = dist.reduce_scatter(g).movedim(0, dim)
            p.grad = None
        return dist.all_reduce_flat(rep, extra)

    @torch.no_grad()
    def gather_weights(self) -> None:
        """The network's sharded parameters set to the masters, gathered."""
        for _, p, dim, master in self.entries:
            if dim is not None:
                full = dist.all_gather(master.detach().movedim(dim, 0))
                p.copy_(full.movedim(0, dim))

    def state_bytes(self, optimizer: torch.optim.Optimizer) -> int:
        """This rank's bytes of the sharded train state, read from the
        storage its tensors hold (a slice that kept its full tensor's
        storage would count whole): the masters (a slice, or the
        replicated parameter), their AdamW state, and the network's
        buffers. It leaves out the working weights (working_bytes)."""
        held = [m for _, m in self.named_masters()]
        for m in list(held):
            held += list(optimizer.state.get(m, {}).values())
        held += list(self.net.buffers())
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage()
                    for t in held}
        return sum(st.nbytes() for st in storages.values())

    def working_bytes(self) -> int:
        """This rank's bytes of the full working weights of the sharded
        parameters, which the forward runs and every rank keeps (ZeRO:
        the state is sharded, the network's weights are not)."""
        return sum(p.numel() * p.element_size()
                   for _, p, dim, _ in self.entries if dim is not None)

    def full_leaves(self, optimizer: torch.optim.Optimizer) -> List:
        """The unsharded shapes and dtypes of the same leaves as
        state_bytes (for sharded_param_bytes)."""
        leaves = []
        for _, p, dim, m in self.entries:
            leaves.append(p)
            for v in optimizer.state.get(m, {}).values():
                leaves.append(torch.empty(p.shape if v.dim() else (),
                                          dtype=v.dtype, device="meta"))
        leaves += list(self.net.buffers())
        return leaves

    def gather_state(self, optimizer: torch.optim.Optimizer
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every parameter's full AdamW state by name (a collective: every
        rank calls it)."""
        out = {}
        for name, p, dim, m in self.entries:
            st = optimizer.state.get(m, {})
            out[name] = {k: (dist.all_gather(v.movedim(dim, 0)).movedim(
                0, dim) if dim is not None and v.dim() else v.clone())
                for k, v in st.items()}
        return out


__all__ = ["DEFAULT_MIN_SIZE", "ShardedParams", "fsdp_spec",
           "sharded_param_bytes"]
