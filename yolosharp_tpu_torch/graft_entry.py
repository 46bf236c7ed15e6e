"""Entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``: ``entry`` :18-35, ``dryrun_multichip`` :38-250),
and the data-parallel train step they and the tests run over ranks.

entry() -> (fn, args): the v8s detect forward at 640 and its decode on the
card. It and every step below run under utils.numerics.full_float32
(cuDNN's TF32 off whatever the caller's flags).

dryrun_multichip(n): n gloo CPU ranks (spawned by parallel.dist.run_ranks)
take one data-parallel step each of detect, FSDP detect, pose (4 x 3
keypoints), segment, OBB End2End (o2m 0.8 / o2o 0.2) and classify, then a
mesh batch_predict of n + 1 images runs over an n-entry CPU mesh; prints
the JAX dryrun's line without its packed render (which the port does not
port).

run_step(config, state_dict, batch, ...) runs a train step of a task
from given weights on a global numpy batch over `devices` (one rank a
device, each taking its rows), and returns rank 0's loss, items, weights
after the step and summed gradients: the DP / FSDP step the tests and
chip_smoke hold against the single-device step and the JAX mesh step
(run_steps: several such in one launch of the ranks).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .parallel import (ShardedParams, create_mesh, dist,
                       sharded_param_bytes, visible_devices)
from .train import TrainState, make_optimizer, make_train_step
from .types import ScalarType, TaskType, YoloSize, YoloType
from .utils.numerics import full_float32


def entry():
    """(fn, (net, images)): fn(net, images) is the v8s detect net (nc 80,
    seeded weights, eval BN) at 640 on the card and decode_inference of its
    one2many branch."""
    from .nn import ArchCfg, YoloNet
    from .predict import decode_inference

    dev = torch.device("cuda")
    net = YoloNet(ArchCfg(version="v8", size="s", task="detect", nc=80,
                          end2end=False), torch.Generator().manual_seed(0))
    net = net.to(dev).to(memory_format=torch.channels_last).eval()
    x = torch.zeros((1, 3, 640, 640), device=dev).contiguous(
        memory_format=torch.channels_last)

    @full_float32()
    @torch.inference_mode()
    def fn(net, images):
        return decode_inference(net(images)["one2many"])

    return fn, (net, x)


@full_float32()
def _rank_step(config: Config, state_dict: Dict, batch: Dict,
               loss_kwargs: Optional[Dict] = None, fsdp: bool = False,
               steps: int = 1, save_dcp: Optional[str] = None,
               resume: Optional[str] = None, device="cuda") -> Dict:
    """`steps` train steps of config's task from `state_dict` (or the
    train state in `resume`) on this rank's rows of the global `batch`
    (all of it on `device` without a group); after the first, the state
    is saved to the directory `save_dcp` when given."""
    from .ckpt.resume import restore_train_state, save_train_state_dcp
    from .tasks import _TASKS

    ctx = dist.active()
    rank, world = (ctx.rank, ctx.world) if ctx is not None else (0, 1)
    device = ctx.device if ctx is not None else torch.device(device)
    task = _TASKS[config.task_type](config, device)
    net = task._ensure_variables()
    net.load_state_dict(state_dict, strict=True)
    net.to(memory_format=torch.channels_last)
    shards = ShardedParams(net) if fsdp and world > 1 else None
    opt, scheds = make_optimizer(
        net, nc=config.number_class, epochs=2, steps_per_epoch=1,
        named_params=shards.named_masters() if shards else None)
    state = TrainState(net, opt, scheds, shards=shards)
    if resume:
        restore_train_state(resume, state)
    step = make_train_step(task._loss_fns()[0], compute_dtype=task.dtype)
    per = next(iter(batch.values())).shape[0] // world
    rows = {k: torch.from_numpy(np.ascontiguousarray(
        v[rank * per:(rank + 1) * per])).to(device)
        for k, v in batch.items()}
    from .kernels import launch_counts

    before = launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"loss": None, "items": None, "step_s": []}
    for i in range(steps):
        t = time.perf_counter()
        loss, items = step(state, rows, loss_kwargs or {})
        out["step_s"].append(time.perf_counter() - t)
        out.update(loss=float(loss), items=items.float().cpu().numpy())
        if i == 0 and save_dcp:
            save_train_state_dcp(save_dcp, state, {"epoch": 1})
            out["saved"] = _snapshot(state)
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    out.update(launches_by_rank=(dist.all_gather_object(launched)
                                 if world > 1 else [launched]),
               peak_by_rank=(dist.all_gather_object(peak)
                             if world > 1 else [peak]))
    out.update(_snapshot(state), count=state.count, step=state.step)
    if shards is None:
        out["grads"] = {n: p.grad.detach().cpu().clone()
                        for n, p in net.named_parameters()
                        if p.grad is not None}
    else:
        out["state_bytes"] = shards.state_bytes(opt)
        out["sharded_param_bytes"] = sharded_param_bytes(
            shards.full_leaves(opt), world)
        out["working_bytes"] = shards.working_bytes()
    return out


def _snapshot(state: TrainState) -> Dict:
    """The state's network ("state_dict") and full AdamW state by name
    ("opt_state"), on the host (a collective under FSDP)."""
    opt = (state.shards.gather_state(state.optimizer)
           if state.shards is not None else
           {n: state.optimizer.state.get(p, {})
            for n, p in zip(state.param_names(), state.params)})
    return {"state_dict": {k: v.detach().cpu().clone()
                           for k, v in state.net.state_dict().items()},
            "opt_state": {n: {k: v.detach().cpu().clone()
                              for k, v in st.items()}
                          for n, st in opt.items()}}


def _rank_steps(specs: Sequence[Dict]) -> List[Dict]:
    return [_rank_step(**spec) for spec in specs]


def run_steps(specs: Sequence[Dict], devices: Optional[Sequence] = None
              ) -> List[Dict]:
    """run_step of each spec (a dict of its keyword arguments but
    `devices`), in one launch of the ranks; rank 0's results in order."""
    devices = list(visible_devices() if devices is None else devices)
    if not devices:
        raise RuntimeError("run_steps: no CUDA device is visible; pass "
                           "devices=['cpu', ...] to run on the CPU")
    if len(devices) == 1:
        return [_rank_step(**spec, device=devices[0]) for spec in specs]
    return dist.run_ranks(lambda: _rank_steps(specs), _rank_steps,
                          (list(specs),), devices)


def run_step(config: Config, state_dict: Dict, batch: Dict,
             loss_kwargs: Optional[Dict] = None, fsdp: bool = False,
             devices: Optional[Sequence] = None, steps: int = 1,
             save_dcp: Optional[str] = None,
             resume: Optional[str] = None) -> Dict:
    """`steps` train steps (make_train_step, AdamW of make_optimizer at
    epochs 2, one step an epoch) of config's task from `state_dict` on the
    numpy `batch` (the same batch each step), data-parallel over `devices`
    (default: every visible CUDA device; one rank a device, each taking its
    rows; a single device runs in this process): rank 0's {"loss",
    "items" of the last step, "state_dict" and "opt_state" (the network
    and the full AdamW state by name) after it,
    "grads" (summed; DP only), "count", "step", "step_s" (each step's
    seconds, ending in its host sync), "launches_by_rank" (each rank's
    kernel launches in the steps), "peak_by_rank" (each rank's peak CUDA
    bytes allocated over the steps, None on the CPU)} and, under FSDP, its
    "state_bytes" (ShardedParams.state_bytes), "sharded_param_bytes" and
    "working_bytes". save_dcp: the train state
    after the first step saved there (ckpt.resume.save_train_state_dcp),
    and its "state_dict" and "opt_state" under "saved"; resume: the steps
    start from that saved state, at this run's rank count."""
    return run_steps([dict(config=config, state_dict=state_dict,
                           batch=batch, loss_kwargs=loss_kwargs, fsdp=fsdp,
                           steps=steps, save_dcp=save_dcp, resume=resume)],
                     devices)[0]


def _dryrun_batch(rng, b: int, nc: int, **extra) -> Dict:
    batch = {"images": rng.uniform(0, 1, (b, 64, 64, 3)).astype(np.float32),
             "cls": rng.integers(0, nc, (b, 8)).astype(np.int32),
             "bboxes": rng.uniform(0.2, 0.6, (b, 8, 4)).astype(np.float32),
             "mask_gt": np.ones((b, 8), bool)}
    batch.update(extra)
    return batch


def _dryrun_body(n: int) -> Dict[str, float]:
    """The six steps of dryrun_multichip on every rank (same seeds, so the
    same global batches); their losses."""
    from .tasks import _TASKS

    rng = np.random.default_rng(0)
    b = max(n, 2)
    ctx = dist.active()
    world = ctx.world if ctx is not None else 1

    def cfg(task, **kw):
        return Config(task_type=task, yolo_type=YoloType.v8,
                      yolo_size=YoloSize.n, image_size=64, batch_size=b,
                      scalar_type=ScalarType.float32,
                      **{"number_class": 8, "end2end": False, **kw})

    def one(config, batch, fsdp=False, loss_kwargs=None):
        task = _TASKS[config.task_type](config, torch.device("cpu"))
        sd = task._ensure_variables().state_dict()
        out = _rank_step(config, sd, batch, loss_kwargs,
                         fsdp and world > 1, device="cpu")
        assert np.isfinite(out["loss"]), (config.task_type, out["loss"])
        return out["loss"]

    det = _dryrun_batch(rng, b, 8)
    losses = {"loss": one(cfg(TaskType.detect), det)}
    losses["fsdp_loss"] = one(cfg(TaskType.detect), det, fsdp=True)
    kpts = rng.uniform(0.2, 0.8, (b, 8, 4, 3)).astype(np.float32)
    kpts[..., 2] = 1.0
    losses["pose_loss"] = one(
        cfg(TaskType.pose, number_class=1, keypoint_num=4, keypoint_dim=3),
        _dryrun_batch(rng, b, 1, keypoints=kpts,
                      cls=np.zeros((b, 8), np.int32)))
    losses["seg_loss"] = one(
        cfg(TaskType.segment),
        _dryrun_batch(rng, b, 8, masks=rng.integers(
            0, 9, (b, 16, 16)).astype(np.float32)))
    obb_boxes = np.concatenate(
        [rng.uniform(0.2, 0.6, (b, 8, 4)),
         rng.uniform(-0.7, 0.7, (b, 8, 1))], -1).astype(np.float32)
    losses["obb_e2e_loss"] = one(
        cfg(TaskType.obb, end2end=True),
        _dryrun_batch(rng, b, 8, bboxes=obb_boxes),
        loss_kwargs={"o2m_gain": 0.8, "o2o_gain": 0.2})
    cls_batch = _dryrun_batch(rng, b, 8)
    cls_batch["cls"] = rng.integers(0, 8, (b,)).astype(np.int32)
    losses["cls_loss"] = one(cfg(TaskType.classify), cls_batch)
    return losses


def dryrun_multichip(n_devices: int) -> Dict[str, float]:
    """Validate the multi-device paths end to end on n_devices gloo CPU
    ranks (see the module docstring); prints one line, returns the
    losses. Raises where a rank fails or a loss is not finite."""
    from .tasks import Detector

    devices = ["cpu"] * int(n_devices)
    if n_devices > 1:
        losses = dist.run_ranks(functools.partial(_dryrun_body, n_devices),
                                _dryrun_body, (n_devices,), devices)
    else:
        losses = _dryrun_body(1)
    mesh = create_mesh(devices=devices)
    det = Detector(Config(yolo_type=YoloType.v8, yolo_size=YoloSize.n,
                          number_class=8, image_size=64, end2end=False,
                          scalar_type=ScalarType.float32), "cpu")
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 255, (64, 64, 3)).astype(np.uint8)
            for _ in range(n_devices + 1)]
    res = det.batch_predict(imgs, 0.5, 0.45, mesh=mesh)
    assert len(res) == n_devices + 1
    assert mesh.size == n_devices, mesh
    print(f"dryrun_multichip({n_devices}) OK: "
          + " ".join(f"{k}={v:.4f}" for k, v in losses.items())
          + f" sharded_predict=ok devices={mesh.size}")
    return losses


__all__ = ["dryrun_multichip", "entry", "run_step", "run_steps"]
