"""Detection losses and the End2End pair (counterpart of
yolosharp_tpu/loss/losses.py:42-166 and :470-491; parity target
YoloSharp/Utils/Loss.cs:94-484 and 1094-1176).

Losses are functions over padded batches on the device:
  batch = {"cls": (B, M) int, "bboxes": (B, M, 4) normalised xywh,
           "mask_gt": (B, M) bool}
and the head's raw maps [(B, C, H, W)] x 3 levels. They run in float32
whatever the network's type, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..ops.anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from ..ops.boxes import xywh2xyxy
from ..ops.iou import bbox_iou
from .tal import assign

STRIDES = (8, 16, 32)


def flatten_levels(maps) -> torch.Tensor:
    """[(B, C, H, W)] x levels -> (B, A, C), anchors in row-major order
    per level (a view per level when the maps are channels-last)."""
    b = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, m.shape[1])
                      for m in maps], dim=1)


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _dfl_loss(pred_dist_logits: torch.Tensor, target: torch.Tensor,
              reg_max: int) -> torch.Tensor:
    """Distribution focal loss per anchor (Loss.cs:94-120):
    pred_dist_logits (..., 4, reg_max), target (..., 4) distances ->
    (...,) mean over the four sides."""
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist_logits.float(), dim=-1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(0, reg_max - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1)


def take_gt(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, M, ...), idx (B, A) -> (B, A, ...): each anchor's
    assigned ground truth."""
    rows = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[rows, idx]


class DetOut(NamedTuple):
    """The three detection losses and the assignment byproducts that the
    segment and pose losses build on."""

    loss_box: torch.Tensor
    loss_cls: torch.Tensor
    loss_dfl: torch.Tensor
    fg_mask: torch.Tensor        # (B, A)
    target_gt_idx: torch.Tensor  # (B, A)
    target_bboxes: torch.Tensor  # (B, A, 4) image units (xyxy)
    anchor_points: torch.Tensor  # (A, 2) grid units
    stride_tensor: torch.Tensor  # (A, 1)
    target_scores_sum: torch.Tensor


def _imgsz(preds) -> Tuple[int, int]:
    h, w = preds["box"][0].shape[2:4]
    return h * STRIDES[0], w * STRIDES[0]


def _det_core(preds: Dict, batch: Dict, *, nc: int, reg_max: int = 16,
              tal_topk: int = 10, tal_topk2: int | None = None) -> DetOut:
    """Shared detection path (Loss.cs
    get_assigned_targets_and_loss:411-468)."""
    pred_distri = flatten_levels(preds["box"]).float()   # (B, A, 4*reg_max)
    pred_scores = flatten_levels(preds["cls"]).float()   # (B, A, nc) logits
    dev = pred_scores.device
    feat_shapes = [tuple(m.shape[2:4]) for m in preds["box"]]
    anchor_points, stride_tensor = make_anchors(feat_shapes, STRIDES,
                                                device=dev)
    ih, iw = _imgsz(preds)
    b, a, _ = pred_scores.shape

    scale = torch.tensor([iw, ih, iw, ih], dtype=torch.float32, device=dev)
    gt_bboxes = xywh2xyxy(batch["bboxes"][..., :4].float() * scale)
    mask_gt = batch["mask_gt"].bool() & (gt_bboxes.sum(-1) > 0)

    pred_bboxes = dist2bbox(dfl_decode(pred_distri, reg_max), anchor_points,
                            xywh=False)                  # (B, A, 4) grid

    res = assign(pred_scores.detach().sigmoid(),
                 pred_bboxes.detach() * stride_tensor,
                 anchor_points * stride_tensor, batch["cls"], gt_bboxes,
                 mask_gt, topk=tal_topk, topk2=tal_topk2, num_classes=nc)

    tss = res.target_scores.sum().clamp(min=1.0)
    loss_cls = bce_logits(pred_scores, res.target_scores).sum() / tss

    weight = res.target_scores.sum(-1) * res.fg_mask      # (B, A)
    tgt_strided = res.target_bboxes / stride_tensor
    iou = bbox_iou(pred_bboxes, tgt_strided, xywh=False, CIoU=True)[..., 0]
    loss_box = ((1.0 - iou) * weight).sum() / tss

    target_ltrb = bbox2dist(anchor_points, tgt_strided, reg_max - 1)
    dfl = _dfl_loss(pred_distri.reshape(b, a, 4, reg_max), target_ltrb,
                    reg_max)
    loss_dfl = (dfl * weight).sum() / tss

    return DetOut(loss_box, loss_cls, loss_dfl, res.fg_mask,
                  res.target_gt_idx, res.target_bboxes, anchor_points,
                  stride_tensor, tss)


def detection_loss(preds: Dict, batch: Dict, *, nc: int, reg_max: int = 16,
                   tal_topk: int = 10, tal_topk2: int | None = None,
                   hyp_box: float = 7.5, hyp_cls: float = 0.5,
                   hyp_dfl: float = 1.5):
    """v8DetectionLoss (Loss.cs:328-484) on one branch's maps. Returns
    (loss, items (3,) = box, cls, dfl)."""
    b = preds["box"][0].shape[0]
    out = _det_core(preds, batch, nc=nc, reg_max=reg_max, tal_topk=tal_topk,
                    tal_topk2=tal_topk2)
    items = torch.stack([out.loss_box * hyp_box, out.loss_cls * hyp_cls,
                         out.loss_dfl * hyp_dfl])
    return items.sum() * b, items


def e2e_wrap(loss_fn_many, loss_fn_one):
    """End2End dual loss: one2many + one2one, weighted by the o2m / o2o
    gains (E2EDetectLoss, Loss.cs:1094-1295)."""

    def fn(preds, batch, o2m_gain=1.0, o2o_gain=1.0):
        l_many, i_many = loss_fn_many(preds["one2many"], batch)
        l_one, i_one = loss_fn_one(preds["one2one"], batch)
        return (l_many * o2m_gain + l_one * o2o_gain,
                i_many * o2m_gain + i_one * o2o_gain)

    return fn


def e2e_gain_schedule(epoch: int, epochs: int, init_o2m: float = 0.8,
                      final_o2m: float = 0.1) -> Tuple[float, float]:
    """o2m / o2o gain decay over epochs (Loss.cs:1166-1176)."""
    x = float(epoch)
    o2m = (max(1 - x / max(epochs - 1, 1), 0) * (init_o2m - final_o2m)
           + final_o2m)
    return o2m, max(1.0 - o2m, 0.0)
