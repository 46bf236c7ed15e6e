"""The process-group layer of the port's data-parallel train and val.

The JAX package trains over a mesh with one SPMD program in one process
(yolosharp_tpu/parallel/mesh.py:1-8); its reductions (FastBN's batch
statistics, the loss normalisers, the finite check) run over the global
batch. The port runs one process a device instead, and this module gives
those processes what the SPMD program had:

- ``run_ranks``: the launcher. The caller's process is rank 0; ranks
  1..d-1 are spawned (the ``spawn`` start method: never ``fork`` after
  CUDA is initialised) after the kernels and the host libraries are built
  once, in the caller. Rendezvous goes through a ``FileStore`` in a
  temporary directory, so concurrent launches never share a port. A rank
  that fails makes ``run_ranks`` raise in the caller with that rank's
  traceback.
- the backend: NCCL where every rank has a CUDA device of its own, gloo
  otherwise (CPU ranks, or ranks sharing one card; gloo takes CUDA tensors
  for ``all_reduce`` and ``broadcast`` only, so ``reduce_scatter`` and
  ``all_gather`` are made of ``all_reduce`` there, exactly);
- ``allsum``: a sum over the ranks that autograd differentiates (forward
  all-reduces, backward all-reduces the gradient); the identity when no
  group is active, so that one device runs the code unchanged.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import multiprocessing.connection
import os
import queue
import shutil
import sys
import tempfile
import threading
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as tdist

# seconds a collective may wait for a peer before it fails
TIMEOUT_S = 600
# seconds the caller waits for the spawned ranks to import and report
READY_TIMEOUT_S = 300


@dataclass
class RankContext:
    """This process's place in the active group."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0


_ACTIVE: Optional[RankContext] = None


def active() -> Optional[RankContext]:
    """The active group of this process, or None (one device)."""
    return _ACTIVE


def pick_backend(devices: Sequence[torch.device]) -> str:
    """NCCL where every rank has a CUDA device of its own, else gloo."""
    devices = [torch.device(d) for d in devices]
    cuda = [d for d in devices if d.type == "cuda"]
    if (len(cuda) == len(devices) and len({d.index for d in cuda})
            == len(cuda) and tdist.is_nccl_available()):
        return "nccl"
    return "gloo"


def _native(t: torch.Tensor) -> bool:
    """Whether the backend has reduce_scatter / all_gather for `t`."""
    return _ACTIVE.backend == "nccl" or t.device.type == "cpu"


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place (no autograd); returns it."""
    if _ACTIVE is not None and _ACTIVE.world > 1:
        tdist.all_reduce(t)
    return t


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    extra: torch.Tensor) -> torch.Tensor:
    """Sum `tensors` over the ranks in place with one all-reduce of a flat
    float32 buffer that also carries `extra` (flat, summed too); returns
    the summed `extra`."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors]
                     + [extra.reshape(-1).float()])
    all_reduce_(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return flat[off:]


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `t` (world * k, ...), this rank's k rows."""
    ctx = _ACTIVE
    k = t.shape[0] // ctx.world
    if _native(t):
        out = t.new_empty((k,) + tuple(t.shape[1:]))
        scatter = (getattr(tdist, "reduce_scatter_single", None)
                   or tdist.reduce_scatter_tensor)
        scatter(out, t.contiguous())
        return out
    buf = t.clone()
    tdist.all_reduce(buf)
    return buf[ctx.rank * k:(ctx.rank + 1) * k].clone()


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (k, ...) concatenated on dim 0 in rank order."""
    ctx = _ACTIVE
    k = t.shape[0]
    if _native(t):
        out = t.new_empty((ctx.world * k,) + tuple(t.shape[1:]))
        # all_gather_into_tensor is deprecated for all_gather_single from
        # torch 2.13 on; older releases have only the former
        gather = (getattr(tdist, "all_gather_single", None)
                  or tdist.all_gather_into_tensor)
        gather(out, t.contiguous())
        return out
    buf = t.new_zeros((ctx.world * k,) + tuple(t.shape[1:]))
    buf[ctx.rank * k:(ctx.rank + 1) * k] = t
    tdist.all_reduce(buf)       # x + 0 is exact: a gather
    return buf


def all_gather_object(obj) -> List:
    """Every rank's picklable `obj`, in rank order."""
    out = [None] * _ACTIVE.world
    tdist.all_gather_object(out, obj)
    return out


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank."""
    box = [obj]
    tdist.broadcast_object_list(box, src)
    return box[0]


class _AllSum(torch.autograd.Function):
    """y = the sum of x over the ranks; dL/dx = the sum over the ranks of
    dL/dy (each rank's loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g)
        return g


def allsum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks of the active group, differentiable;
    `t` itself on one device."""
    if _ACTIVE is None or _ACTIVE.world == 1:
        return t
    return _AllSum.apply(t)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` set to rank `src`'s (in
    logical order: the ranks' memory formats may differ, channels-last on
    one and not on another)."""
    if _ACTIVE is None or _ACTIVE.world == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            buf = t.data.contiguous()
            tdist.broadcast(buf, src)
            if buf.data_ptr() != t.data_ptr():
                t.data.copy_(buf)


# ---------------------------------------------------------------- launcher
def _init(rank: int, world: int, init: str, backend: str,
          device) -> RankContext:
    global _ACTIVE
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    tdist.init_process_group(backend, init_method=init, rank=rank,
                             world_size=world,
                             timeout=timedelta(seconds=TIMEOUT_S), **kw)
    _ACTIVE = RankContext(rank, world, device, backend)
    return _ACTIVE


def _finish() -> None:
    global _ACTIVE
    _ACTIVE = None
    if tdist.is_initialized():
        tdist.destroy_process_group()


def _abort() -> None:
    """Abort the group so that a rank blocked in a collective on a dead
    peer raises (NCCL would wait out its timeout)."""
    fn = getattr(tdist.distributed_c10d, "_abort_process_group", None)
    if fn is not None and tdist.is_initialized():
        with contextlib.suppress(Exception):
            fn()


def numerics() -> dict:
    """This process's settings that change float results (TF32, cuDNN's
    algorithm choice), which every spawned rank takes over. A rank's train
    and val steps run under utils.numerics.full_float32 all the same, so
    its float32 convolutions skip TF32 whatever flags it was handed."""
    return {"cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}


def _set_numerics(flags: dict) -> None:
    torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
    torch.backends.cudnn.benchmark = flags["cudnn_benchmark"]
    torch.backends.cudnn.deterministic = flags["cudnn_deterministic"]


def _child_main(rank, world, init, backend, device, fn, args, errq,
                threads, flags):
    """A spawned rank: the caller's numerics, report ready, join the
    group, run fn(*args)."""
    try:
        torch.set_num_threads(threads)
        _set_numerics(flags)
        errq.put(("ready", rank, ""))
        _init(rank, world, init, backend, device)
        fn(*args)
        tdist.barrier()
        _finish()
    except BaseException:
        errq.put(("error", rank, traceback.format_exc()))
        errq.close()
        errq.join_thread()      # os._exit would drop the queued report
        sys.stderr.flush()
        os._exit(1)


def prebuild(devices) -> None:
    """Build, in the caller, what each rank would otherwise build at once:
    the host C++ libraries and, for CUDA devices, the kernels."""
    from ..kernels import build

    for name in ("png_unfilter", "jpeg_decode", "tiff_decode", "webp_decode"):
        with contextlib.suppress(RuntimeError):    # no host compiler
            build.load_host(name)
    if any(torch.device(d).type == "cuda" for d in devices):
        for name in ("conv3x3", "c2f", "attention"):
            build.load(name)


class RankFailure(RuntimeError):
    """A spawned rank failed; the message holds its traceback."""


def run_ranks(local_fn: Callable, remote_fn: Callable, remote_args: tuple,
              devices: Sequence) -> object:
    """Run rank 0 = ``local_fn()`` in this process and ranks r = 1..d-1 =
    ``remote_fn(*remote_args)`` in spawned processes, one a device of
    `devices`, all inside one process group (``active()`` in each), the
    spawned ranks with this process's intra-op thread count (divided over
    CPU ranks) and its numerics flags (``numerics()``). Returns
    ``local_fn``'s value. Raises RankFailure with the failed rank's
    traceback where a spawned rank fails first; where rank 0 fails first
    (the spawned ranks still alive), stops them and raises its own
    error."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("run_ranks: a process group is already active")
    devices = [torch.device(d) for d in devices]
    world = len(devices)
    backend = pick_backend(devices)
    prebuild(devices)
    tmp = tempfile.mkdtemp(prefix="ys_dist_")
    init = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    errq = ctx.Queue()
    threads = max(1, torch.get_num_threads() // (world if all(
        d.type == "cpu" for d in devices) else 1))
    procs = [ctx.Process(target=_child_main,
                         args=(r, world, init, backend, str(devices[r]),
                               remote_fn, remote_args, errq, threads,
                               numerics()),
                         daemon=True)
             for r in range(1, world)]
    errors: dict = {}
    stop = threading.Event()

    def note(kind, rank, text):
        if kind == "error":
            errors[rank] = text

    def drain(wait_s: float = 0.0):
        """Collect the spawned ranks' reports, waiting up to wait_s for
        the first one."""
        try:
            note(*errq.get(wait_s > 0, wait_s or None))
            while True:
                note(*errq.get(False))
        except queue.Empty:
            pass

    def dead(timeout: float) -> bool:
        return bool(multiprocessing.connection.wait(
            [p.sentinel for p in procs], timeout))

    def monitor():
        # a rank that dies makes NCCL peers wait out their timeout: abort
        # the group then (gloo peers see the closed connection)
        if backend != "nccl":
            return
        while not stop.is_set():
            if dead(0.5):
                _abort()
                return

    with _main_hidden():
        for p in procs:
            p.start()
    watcher = threading.Thread(target=monitor, daemon=True)
    own_failure = False
    try:
        ready, waited = 0, 0.0
        while ready < world - 1:
            try:
                kind, rank, text = errq.get(timeout=0.5)
            except queue.Empty:
                waited += 0.5
                if dead(0) or waited > READY_TIMEOUT_S:
                    drain()
                    raise RankFailure(_report(errors, procs) if errors else
                                      "a spawned rank did not start")
                continue
            if kind == "error":
                errors[rank] = text
                raise RankFailure(_report(errors, procs))
            ready += 1
        watcher.start()
        _init(0, world, init, backend, devices[0])
        try:
            result = local_fn()
            tdist.barrier()
        except BaseException:
            # a spawned rank that failed first is gone by now; alive, they
            # wait on this rank, which failed itself
            own_failure = not dead(1.0)
            raise
        finally:
            _finish()
        stop.set()
        watcher.join()
        for p in procs:
            p.join(TIMEOUT_S)
        drain()
        if any(p.exitcode != 0 for p in procs):
            raise RankFailure(_report(errors, procs))
        return result
    except BaseException as exc:
        _ACTIVE = None
        if own_failure or isinstance(exc, RankFailure):
            raise
        drain(5.0)
        raise RankFailure(_report(errors, procs)) from exc
    finally:
        stop.set()
        if watcher.is_alive():
            watcher.join()
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        errq.close()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def _main_hidden():
    """Spawn without re-running the caller's main script in the child (a
    script without a ``__main__`` guard would train again there): the
    remote functions live in this package, so the child needs no main."""
    main = sys.modules["__main__"]
    saved = {k: main.__dict__[k] for k in ("__spec__", "__file__")
             if k in main.__dict__}
    main.__dict__.pop("__file__", None)
    main.__dict__["__spec__"] = None
    try:
        yield
    finally:
        main.__dict__.pop("__spec__", None)
        main.__dict__.update(saved)


def _report(errors: dict, procs) -> str:
    lines = []
    for i, p in enumerate(procs, 1):
        if i in errors or (p.exitcode not in (0, None)):
            lines.append(f"rank {i} failed (exit code {p.exitcode}):\n"
                         f"{errors.get(i, '(no traceback)')}")
    return "\n".join(lines) or "a spawned rank failed"


__all__ = ["RankContext", "RankFailure", "active", "all_gather",
           "all_gather_object", "all_reduce_", "all_reduce_flat", "allsum",
           "broadcast_module", "broadcast_object", "pick_backend",
           "prebuild", "reduce_scatter", "run_ranks"]
