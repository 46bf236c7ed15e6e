"""Task-aligned assigner over padded batches, axis-aligned or rotated boxes
(counterpart of yolosharp_tpu/loss/tal.py: ``assign``; parity target
YoloSharp/Utils/Tal.cs:13-310, RotatedTaskAlignedAssigner included: rotated
boxes take the point-in-rotated-rectangle candidates and probiou).

Ground truths are padded to M slots with a validity mask; the reference's
"anchor matched to several ground truths" branch applies to every anchor
through where-masks, as in the JAX version. The top-k membership breaks ties
by the smallest anchor index (a stable descending sort), as ``lax.top_k``
and the JAX package's iterative argmax do; the gathers are plain indexing.
Everything runs without gradient (Tal.cs:52 wraps it in torch.no_grad).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.boxes import xywh2xyxy, xywhr2xyxyxyxy, xyxy2xywh
from ..ops.iou import bbox_iou, probiou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor   # (B, A) int64
    target_bboxes: torch.Tensor   # (B, A, 4|5)
    target_scores: torch.Tensor   # (B, A, nc)
    fg_mask: torch.Tensor         # (B, A) bool
    target_gt_idx: torch.Tensor   # (B, A) int64


def _select_candidates_in_gts(anc_points, gt_bboxes, mask_gt, min_stride,
                              stride_val, eps=1e-9):
    """Anchor-centre-in-box test with tiny-gt inflation (Tal.cs:202-223):
    (B, M, A) bool."""
    xywh = xyxy2xywh(gt_bboxes)
    wh = xywh[..., 2:4]
    small = (wh < min_stride) & mask_gt[..., None]
    wh = torch.where(small, torch.full_like(wh, stride_val), wh)
    boxes = xywh2xyxy(torch.cat([xywh[..., :2], wh], -1))
    lt = boxes[..., None, :2]     # (B, M, 1, 2)
    rb = boxes[..., None, 2:4]
    pts = anc_points[None, None]  # (1, 1, A, 2)
    deltas = torch.cat([pts - lt, rb - pts], dim=-1)
    return deltas.amin(-1) > eps


def _select_candidates_in_rotated_gts(anc_points, gt_bboxes, mask_gt,
                                      min_stride, stride_val):
    """Anchor-centre-in-rotated-rectangle test with tiny-gt inflation
    (Tal.cs:279-308): (B, M, A) bool, for xywhr gts (B, M, 5)."""
    wh = gt_bboxes[..., 2:4]
    small = (wh < min_stride) & mask_gt[..., None]
    wh = torch.where(small, torch.full_like(wh, stride_val), wh)
    corners = xywhr2xyxyxyxy(torch.cat([gt_bboxes[..., :2], wh,
                                        gt_bboxes[..., 4:5]], -1))
    a, b, d = corners[..., 0, :], corners[..., 1, :], corners[..., 3, :]
    ab, ad = b - a, d - a                                     # (B, M, 2)
    ap = anc_points[None, None] - a[..., None, :]             # (B, M, A, 2)
    norm_ab = (ab * ab).sum(-1)[..., None]
    norm_ad = (ad * ad).sum(-1)[..., None]
    ap_ab = (ap * ab[..., None, :]).sum(-1)
    ap_ad = (ap * ad[..., None, :]).sum(-1)
    return ((ap_ab >= 0) & (ap_ab <= norm_ab)
            & (ap_ad >= 0) & (ap_ad <= norm_ad))


def topk_mask(metrics: torch.Tensor, topk: int) -> torch.Tensor:
    """0/1 membership of the top-k entries along the last axis, ties to the
    smallest index."""
    idx = torch.sort(metrics, dim=-1, descending=True,
                     stable=True).indices[..., :topk]
    return torch.zeros_like(metrics).scatter_(-1, idx, 1.0)


@torch.no_grad()
def assign(pd_scores: torch.Tensor,     # (B, A, nc) sigmoided
           pd_bboxes: torch.Tensor,     # (B, A, 4) xyxy | (B, A, 5) xywhr
           anc_points: torch.Tensor,    # (A, 2) image units
           gt_labels: torch.Tensor,     # (B, M) int
           gt_bboxes: torch.Tensor,     # (B, M, 4) xyxy | (B, M, 5) xywhr
           mask_gt: torch.Tensor,       # (B, M) bool
           *, topk: int = 10, topk2: Optional[int] = None,
           num_classes: int = 80, alpha: float = 0.5, beta: float = 6.0,
           rotated: bool = False, min_stride: int = 8, stride_val: int = 16,
           eps: float = 1e-9) -> AssignResult:
    """Task-aligned assignment: align = score^alpha * IoU^beta, the IoU a
    CIoU of xyxy boxes, or with `rotated` the probiou of xywhr boxes (image
    units)."""
    topk2 = topk if topk2 is None else topk2
    b, a, nc = pd_scores.shape
    m = gt_labels.shape[1]
    mask_gt = mask_gt.bool()
    gt_labels = gt_labels.long()

    select = (_select_candidates_in_rotated_gts if rotated
              else _select_candidates_in_gts)
    mask_in_gts = select(anc_points, gt_bboxes, mask_gt, min_stride,
                         stride_val)

    # --- box metrics (Tal.cs:114-137) ---
    labels = gt_labels.clamp(0, nc - 1)
    bbox_scores = pd_scores.transpose(1, 2).gather(
        1, labels[..., None].expand(b, m, a))                 # (B, M, A)
    valid = mask_in_gts & mask_gt[..., None]
    bbox_scores = torch.where(valid, bbox_scores, 0.0)
    gt_exp, pd_exp = gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]
    iou = (probiou(gt_exp, pd_exp) if rotated
           else bbox_iou(gt_exp, pd_exp, xywh=False, CIoU=True))[..., 0]
    overlaps = torch.where(valid, iou.clamp(min=0.0), 0.0)
    align_metric = bbox_scores ** alpha * overlaps ** beta

    # --- top-k + positive mask (Tal.cs:92-102); invalid gt rows zeroed,
    # the reference's scatter-dedup quirk (Tal.cs:155-165) ---
    mask_topk = topk_mask(align_metric, topk) * mask_gt[..., None]
    mask_pos = mask_topk * mask_in_gts * mask_gt[..., None]

    # --- anchors matched to several gts keep the best-overlap one
    # (Tal.cs:225-241) ---
    multi = mask_pos.sum(-2, keepdim=True) > 1                # (B, 1, A)
    is_max = torch.zeros_like(mask_pos).scatter_(
        1, overlaps.argmax(1, keepdim=True), 1.0)             # (B, M, A)
    mask_pos = torch.where(multi, is_max, mask_pos)

    # --- secondary top-k filter (Tal.cs:242-250) ---
    if topk2 != topk:
        mask_pos = mask_pos * topk_mask(align_metric * mask_pos, topk2)

    fg_mask = mask_pos.sum(-2) > 0
    target_gt_idx = mask_pos.argmax(-2)                       # (B, A)

    # --- gather targets (Tal.cs:170-199) ---
    target_labels = gt_labels.gather(1, target_gt_idx).clamp(min=0)
    target_bboxes = gt_bboxes.gather(
        1, target_gt_idx[..., None].expand(b, a, gt_bboxes.shape[-1]))
    classes = torch.arange(num_classes, device=pd_scores.device)
    target_scores = ((target_labels[..., None] == classes).to(pd_scores.dtype)
                     * fg_mask[..., None])

    # --- normalise by each gt's best align / overlap (Tal.cs:82-87) ---
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)           # (B, M, 1)
    pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlaps / (pos_align + eps)).amax(-2)
    target_scores = target_scores * norm[..., None]

    return AssignResult(target_labels, target_bboxes, target_scores,
                        fg_mask, target_gt_idx)
