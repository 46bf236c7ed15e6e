"""Training machinery: AdamW in three parameter groups, the LR schedules
(warm-up into LambdaLR / OneCycle), the train and eval steps, the train
state (counterpart of yolosharp_tpu/train.py:30-134, :181-359).

Parity targets: Models/YoloBaseTaskModel.cs:116-356 (AdamW groups with
lr_fit = 0.002*5/(4+nc), per-step warm-up with the bias group starting at
warm_up_bias_lr, per-epoch LambdaLR / OneCycle) and Utils/Amp.cs (the fp16
dynamic loss scale and the skipped non-finite step).

The master network is float32; a bfloat16 forward casts the conv weights to
the activations' type (``nn.common.Conv2d``), keeps BatchNorm statistics in
float32 and applies them in bfloat16, and the loss runs in float32, as the
JAX package's numerics. ``torch.optim.AdamW`` with each group's learning
rate set before every update is optax's ``adamw`` (decoupled decay
``lr * wd * p``, bias-corrected moments, eps outside the root).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from .parallel import dist
from .utils.numerics import divide_by_constant


def lr_fit(nc: int) -> float:
    """lr0 fit equation (YoloBaseTaskModel.cs:142)."""
    return round(0.002 * 5 / (4 + nc), 6)


def linear_lambda(y1: float, y2: float, steps: int) -> Callable:
    """LrLambda (YoloBaseTaskModel.cs:504-512) of a float32 tensor epoch."""

    def fn(epoch: torch.Tensor) -> torch.Tensor:
        return torch.clamp(1 - epoch / steps, min=0) * (y1 - y2) + y2

    return fn


def one_cycle(y1: float, y2: float, steps: int) -> Callable:
    """OneCycle cosine (YoloBaseTaskModel.cs:492-502) of a float32 tensor
    epoch."""

    def fn(epoch: torch.Tensor) -> torch.Tensor:
        factor = torch.clamp((1 - torch.cos(epoch * math.pi / steps)) / 2,
                             min=0)
        return factor * (y2 - y1) + y1

    return fn


def make_lr_schedule(*, nc: int, epochs: int, steps_per_epoch: int,
                     warmup_epochs: int = 3, warmup_bias_lr: float = 0.1,
                     use_cos_lr: bool = False, lrf: float = 0.01,
                     bias_group: bool = False) -> Callable[[int], float]:
    """LR of update number `step` (0-based): during ni <= nw a linear ramp
    from (warmup_bias_lr for the bias group, else 0) to lr0 * lambda(epoch),
    afterwards the LambdaLR value (TrainEpoch's warm-up,
    YoloBaseTaskModel.cs:306-319). ni = i + nb * epoch with the 1-based
    epoch, the JAX package's index: the ramp starts one epoch in. Computed
    in float32 as the JAX schedule is: the bias group's ramp from 0.1 down
    to ~1e-3 cancels, so float64 would differ by ~1e-6 relative."""
    lr0 = lr_fit(nc)
    nb = steps_per_epoch
    nw = max(warmup_epochs * nb, 100)
    lam = (one_cycle(1.0, lrf, epochs) if use_cos_lr
           else linear_lambda(1.0, lrf, epochs))
    start = warmup_bias_lr if bias_group else 0.0

    def sched(step: int) -> float:
        s = torch.tensor(float(step), dtype=torch.float32)
        epoch = torch.floor(s / nb) + 1.0
        ni = s - (epoch - 1.0) * nb + nb * epoch
        if ni <= nw:
            # LambdaLR has stepped (epoch - 1) times; the ramp aims at the
            # value after this epoch's step
            return float(start + torch.clamp(ni / nw, 0.0, 1.0)
                         * (lr0 * lam(epoch) - start))
        return float(lr0 * lam(epoch - 1.0))

    return sched


def param_group(name: str) -> str:
    """bias | bn | weight for a parameter's state-dict name: every bias,
    then the BN scales, then the rest (conv weights, A2C2f's gamma); the
    disjoint split of the JAX package's param_group. The classify head's
    Linear bias is a flax leaf named "linear.bias", not "bias", so the JAX
    labeller puts it with the weights (decayed, no bias warm-up): so does
    this."""
    if name.endswith(".bias") and not name.endswith(".linear.bias"):
        return "bias"
    if name.endswith(".bn.weight"):
        return "bn"
    return "weight"


GROUPS = ("bias", "bn", "weight")
WEIGHT_DECAY = 5e-4         # the weight group's; the other two do not decay
# the fp16 dynamic loss scale (Amp.cs:94-135)
LOSS_SCALE_GROWTH_INTERVAL = 2000
MAX_LOSS_SCALE = 65536.0


def make_optimizer(net: nn.Module, *, nc: int, epochs: int,
                   steps_per_epoch: int, warmup_epochs: int = 3,
                   warmup_bias_lr: float = 0.1, use_cos_lr: bool = False,
                   lrf: float = 0.01, named_params=None):
    """(AdamW over the three groups of `net`'s trainable parameters, their
    LR schedules in GROUPS order). Only the weight group decays, by
    WEIGHT_DECAY. named_params: the (name, parameter) pairs to optimise
    instead of `net`'s (the FSDP shards, parallel.fsdp.ShardedParams)."""
    params: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
    if named_params is None:
        named_params = [(n, p) for n, p in net.named_parameters()
                        if p.requires_grad]
    for name, p in named_params:
        params[param_group(name)].append(p)
    opt = torch.optim.AdamW(
        [{"params": params[g], "name": g,
          "weight_decay": WEIGHT_DECAY if g == "weight" else 0.0}
         for g in GROUPS],
        lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    common = dict(nc=nc, epochs=epochs, steps_per_epoch=steps_per_epoch,
                  warmup_epochs=warmup_epochs, warmup_bias_lr=warmup_bias_lr,
                  use_cos_lr=use_cos_lr, lrf=lrf)
    scheds = [make_lr_schedule(bias_group=g == "bias", **common)
              for g in GROUPS]
    return opt, scheds


def normalize_images(images: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> (B, 3, H, W) channels-last in `dtype`, /255 on
    the device (4x less host-to-device traffic than floats); float batches
    are taken as normalised."""
    x = images.permute(0, 3, 1, 2)
    if images.dtype == torch.uint8:
        return divide_by_constant(x, 255.0, dtype)
    return x.to(dtype)


def resolve_batch_images(batch: Dict, dtype):
    """(the step's network input (B, 3, H, W) channels-last in `dtype`, the
    batch the loss reads): the batch's host-made ``images``
    (normalize_images) and the batch itself, or, for a planned batch (an
    ``aug_pool`` in it), the device render of ``data.device_augment``
    (float32 in [0, 255], unrounded) cast to `dtype`, then /255, and the
    batch with its ``masks`` rendered from ``aug_mask_pool`` where it has
    one, as the JAX package's resolve_batch_images."""
    if "aug_pool" not in batch:
        return normalize_images(batch["images"], dtype), batch
    from .data.device_augment import render_batch, render_masks

    images = divide_by_constant(render_batch(batch).permute(0, 3, 1, 2),
                                255.0, dtype)
    if "aug_mask_pool" in batch:
        batch = {**batch, "masks": render_masks(batch)}
    return images, batch


class TrainState:
    """What a step changes: the float32 master network (parameters and BN
    statistics), the optimizer (moments and per-parameter update counts),
    `count` (updates applied: the LR schedules' step, which a skipped step
    keeps, as optax's count), `step` (steps taken), and the fp16 dynamic
    loss scale and its count of finite steps. Under FSDP `shards`
    (parallel.fsdp.ShardedParams) holds the rank's slices the optimizer
    updates."""

    def __init__(self, net: nn.Module, optimizer: torch.optim.Optimizer,
                 schedules, init_scale: float = 1.0, shards=None):
        self.net = net
        self.optimizer = optimizer
        self.schedules = list(schedules)
        self.step = 0
        self.count = 0
        self.loss_scale = float(init_scale)
        self.grow_count = 0
        self.shards = shards

    @property
    def params(self) -> List[nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def param_names(self) -> List[str]:
        """The optimizer's parameters' names, in its order."""
        if self.shards is not None:
            names = {id(m): n for n, m in self.shards.named_masters()}
        else:
            names = {id(p): n for n, p in self.net.named_parameters()}
        return [names[id(p)] for p in self.params]


def next_loss_scale(scale: float, grow_count: int, finite: bool):
    """(scale, grow_count) after a step (Amp.cs:94-135): halved (at least 1)
    after a non-finite step, doubled (at most MAX_LOSS_SCALE) after
    LOSS_SCALE_GROWTH_INTERVAL finite steps in a row."""
    if not finite:
        return max(scale * 0.5, 1.0), 0
    grown = grow_count + 1
    if grown >= LOSS_SCALE_GROWTH_INTERVAL:
        return min(scale * 2.0, MAX_LOSS_SCALE), 0
    return scale, grown


def all_finite(tensors) -> bool:
    """Whether every tensor is finite, in one host sync: the norm of x * 0
    is 0 for a finite tensor and NaN for one with a NaN or an infinity."""
    zeros = torch._foreach_mul(tensors, 0.0)
    return bool(torch.stack(torch._foreach_norm(zeros)).isfinite().all())


def make_train_step(loss_fn, *, compute_dtype=torch.float32,
                    dynamic_loss_scale: bool = False):
    """step(state, batch, loss_kwargs) -> (loss, items), on the device.

    loss_fn(preds, batch, **loss_kwargs) -> (scalar loss, items). The
    network runs in train mode (BN on batch statistics, running statistics
    updated). Where a gradient is not finite the optimizer does not step, so parameters, moments and the schedules' count stay as
    they were (Amp.cs:350-361); the BN statistics of the step stay updated,
    as in the JAX step. dynamic_loss_scale: backward on loss * scale, the
    gradients unscaled before the check and the update, the scale moved by
    next_loss_scale. One host sync a step (the finite check).

    Under an active process group (parallel.dist) each rank runs its rows
    of the global batch: BN statistics and loss normalisers are global
    (batch_norm_train, the losses' dist.allsum), so the sum of the ranks'
    losses is the single-device loss of the global batch and its gradient
    the sum of theirs. The gradients, loss and items are summed over the
    ranks before the finite check, so every rank takes or skips the same
    steps: one flat all-reduce after backward (dist.all_reduce_flat; under
    FSDP the shards' reduce-scatter). Not DDP: DDP averages, where the
    global loss's gradient is the sum of the ranks' (their losses already
    carry the global normalisers), and the overlap of its hooks with
    backward is left out."""

    def step_fn(state: TrainState, batch: Dict, loss_kwargs: Dict):
        net, opt = state.net, state.optimizer
        ctx = dist.active()
        multi = ctx is not None and ctx.world > 1
        net.train()
        scale = state.loss_scale if dynamic_loss_scale else 1.0
        opt.zero_grad(set_to_none=True)
        images, batch = resolve_batch_images(batch, compute_dtype)
        preds = net(images)
        loss, items = loss_fn(preds, batch, **loss_kwargs)
        (loss * scale).backward()
        for p in net.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)    # unused this step: zero
        if multi:
            extra = torch.cat([loss.detach().reshape(1),
                               items.detach().reshape(-1)])
            if state.shards is not None:
                total = state.shards.reduce_gradients(extra)
            else:
                total = dist.all_reduce_flat(
                    [p.grad for p in state.params], extra)
            loss, items = total[0], total[1:].to(items.dtype)
        grads = [p.grad for p in state.params]
        if dynamic_loss_scale:
            torch._foreach_div_(grads, scale)
        if multi and state.shards is not None:
            # each rank holds other slices: agree on the check
            bad = torch.tensor([0.0 if all_finite(grads) else 1.0],
                               device=grads[0].device)
            finite = float(dist.all_reduce_(bad)) == 0.0
        else:
            finite = all_finite(grads)
        if finite:
            for group, sched in zip(opt.param_groups, state.schedules):
                group["lr"] = sched(state.count)
            opt.step()
            if state.shards is not None:
                state.shards.gather_weights()
            state.count += 1
        if dynamic_loss_scale:
            state.loss_scale, state.grow_count = next_loss_scale(
                state.loss_scale, state.grow_count, finite)
        state.step += 1
        return loss.detach(), items.detach()

    return step_fn


def make_eval_step(loss_fn, decode_fn, *, compute_dtype=torch.float32):
    """step(net, batch, loss_kwargs) -> (loss items, decoded inference):
    the eval-mode (running BN statistics, unfolded) network, no gradient."""

    @torch.no_grad()
    def step_fn(net: nn.Module, batch: Dict, loss_kwargs: Dict):
        net.eval()
        preds = net(normalize_images(batch["images"], compute_dtype))
        _, items = loss_fn(preds, batch, **loss_kwargs)
        return items, decode_fn(preds)

    return step_fn
