"""IoU of boxes: pairwise ``box_iou`` and elementwise ``bbox_iou`` with
CIoU / DIoU / GIoU; of rotated boxes, the Gaussian ``probiou`` and the
pairwise ``batch_probiou``; of masks, ``mask_iou``; and of keypoints, the
OKS ``kpt_iou`` (counterpart of yolosharp_tpu/ops/iou.py)."""

from __future__ import annotations

import math

import torch


def box_iou(box1: torch.Tensor, box2: torch.Tensor,
            eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M).
    Leading dimensions broadcast (the NMS passes a batch of images)."""
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:4]
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:4]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0)
    inter = inter.prod(-1)
    area1 = (a2 - a1).prod(-1)
    area2 = (b2 - b1).prod(-1)
    return inter / (area1 + area2 - inter + eps)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
             GIoU: bool = False, DIoU: bool = False, CIoU: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of broadcast boxes (..., 4) -> (..., 1). CIoU's alpha
    is computed without gradient, as the JAX version's stop_gradient and
    the Ultralytics formula's torch.no_grad."""
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, -1)
        x2, y2, w2, h2 = box2.chunk(4, -1)
        b1_x1, b1_x2 = x1 - w1 / 2, x1 + w1 / 2
        b1_y1, b1_y2 = y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2 = x2 - w2 / 2, x2 + w2 / 2
        b2_y1, b2_y2 = y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, -1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, -1)
        w1, h1 = b1_x2 - b1_x1, (b1_y2 - b1_y1).clamp(min=eps)
        w2, h2 = b2_x2 - b2_x1, (b2_y2 - b2_y1).clamp(min=eps)

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1))
             .clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1))
             .clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if CIoU or DIoU or GIoU:
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
        if CIoU or DIoU:
            c2 = cw ** 2 + ch ** 2 + eps
            rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                    + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
            if CIoU:
                v = 4 / math.pi ** 2 * (torch.atan(w2 / h2)
                                        - torch.atan(w1 / h1)) ** 2
                with torch.no_grad():
                    alpha = v / (v - iou + (1 + eps))
                return iou - (rho2 / c2 + v * alpha)
            return iou - rho2 / c2
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    return iou


def mask_iou(mask1: torch.Tensor, mask2: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """(N, HW) x (M, HW) binary masks (as floats) -> (N, M) IoU, the
    intersections as one product."""
    inter = (mask1 @ mask2.T).clamp(min=0)
    union = mask1.sum(1)[:, None] + mask2.sum(1)[None, :] - inter
    return inter / (union + eps)


def _covariance(obb: torch.Tensor):
    """Gaussian covariance terms (a, b, c) of xywhr boxes (..., 5), each
    (..., 1)."""
    a = obb[..., 2:3] ** 2 / 12.0
    b = obb[..., 3:4] ** 2 / 12.0
    r = obb[..., 4:5]
    cos, sin = torch.cos(r), torch.sin(r)
    cos2, sin2 = cos ** 2, sin ** 2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def _probiou_terms(x1, y1, a1, b1, c1, x2, y2, a2, b2, c2, eps):
    """1 - the Hellinger distance of two Gaussians from their
    Bhattacharyya distance, clamped to [eps, 100] (the JAX package's
    formula, so that its gradient, and where it is not finite, agree)."""
    t1 = (((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2)
          / ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps)) * 0.25
    t2 = (((c1 + c2) * (x2 - x1) * (y1 - y2))
          / ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps)) * 0.5
    t3 = torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
                   / (4 * torch.sqrt((a1 * b1 - c1 ** 2).clamp(min=0)
                                     * (a2 * b2 - c2 ** 2).clamp(min=0))
                      + eps) + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1.0 - hd


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, CIoU: bool = False,
            eps: float = 1e-7) -> torch.Tensor:
    """Elementwise probabilistic IoU of broadcast xywhr boxes (..., 5) ->
    (..., 1) (https://arxiv.org/abs/2106.06072); with CIoU the aspect term
    of CIoU, its alpha without gradient."""
    a1, b1, c1 = _covariance(obb1)
    a2, b2, c2 = _covariance(obb2)
    iou = _probiou_terms(obb1[..., 0:1], obb1[..., 1:2], a1, b1, c1,
                         obb2[..., 0:1], obb2[..., 1:2], a2, b2, c2, eps)
    if CIoU:
        w1, h1 = obb1[..., 2:3], obb1[..., 3:4]
        w2, h2 = obb2[..., 2:3], obb2[..., 3:4]
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2)
                                  - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - v * alpha
    return iou


def batch_probiou(obb1: torch.Tensor, obb2: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """Pairwise probiou: (..., N, 5) x (..., M, 5) -> (..., N, M); leading
    dimensions broadcast (the rotated NMS passes a batch of images)."""
    a1, b1, c1 = _covariance(obb1)                      # (..., N, 1)
    a2, b2, c2 = (t[..., 0][..., None, :] for t in _covariance(obb2))
    return _probiou_terms(obb1[..., 0:1], obb1[..., 1:2], a1, b1, c1,
                          obb2[..., 0][..., None, :],
                          obb2[..., 1][..., None, :], a2, b2, c2, eps)


def kpt_iou(kpt1: torch.Tensor, kpt2: torch.Tensor, area: torch.Tensor,
            sigma: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Object Keypoint Similarity: ground truths (N, K, 3) with their
    areas (N,) against predictions (M, K, 2|3) -> (N, M), over the ground
    truth's keypoints with a visibility other than 0."""
    d = ((kpt1[:, None, :, 0] - kpt2[None, :, :, 0]) ** 2
         + (kpt1[:, None, :, 1] - kpt2[None, :, :, 1]) ** 2)   # (N, M, K)
    sigma = torch.as_tensor(sigma, dtype=kpt1.dtype, device=kpt1.device)
    kpt_mask = (kpt1[..., 2] != 0).to(kpt1.dtype)              # (N, K)
    e = d / ((2 * sigma) ** 2 * (area[:, None, None] + eps) * 2)
    return ((torch.exp(-e) * kpt_mask[:, None]).sum(-1)
            / (kpt_mask.sum(-1)[:, None] + eps))
