"""Detection, OBB, segmentation, pose and classification losses, the
End2End pair, and the focal and BCE-blur losses no task uses (counterpart
of yolosharp_tpu/loss/losses.py; parity target YoloSharp/Utils/Loss.cs).

Losses are functions over padded batches on the device:
  batch = {"cls": (B, M) int, "bboxes": (B, M, 4) normalised xywh (OBB:
           (B, M, 5), the angle in radians last),
           "mask_gt": (B, M) bool,
           "masks": (B, mh, mw) segment only: overlap ids (instance + 1),
           "keypoints": (B, M, K, kd) pose only: normalised x, y
                        (+ visibility)}
and the head's raw maps [(B, C, H, W)] x 3 levels (and a segment branch's
"proto" (B, nm, mh, mw)); a classify batch is {"cls": (B,) int} against
the head's {"cls": (B, nc)} logits. They run in float32 whatever the
network's type, as in the JAX package.

Every normaliser over the batch (the target-score sum, the foreground
count, the batch size, a mean over the images) is summed over the
data-parallel ranks of an active group (``parallel.dist.allsum``, the
identity on one device), so that each rank's loss is its share of the
global batch's and their sum the single-device loss. The assigner's and
the mask loss's work is per image and stays per rank.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.anchors import (bbox2dist, dfl_decode, dist2bbox, dist2rbox,
                           make_anchors, rbox2dist)
from ..ops.boxes import xywh2xyxy, xyxy2xywh
from ..ops.iou import bbox_iou, probiou
from ..ops.masks import crop_mask
from ..parallel import dist
from .tal import assign

STRIDES = (8, 16, 32)

# the COCO keypoints' OKS sigmas (Loss.cs KeypointLoss, Metrics OKS_SIGMA)
OKS_SIGMA = torch.tensor([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62,
                          .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0


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


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 1.5, alpha: float = 0.25) -> torch.Tensor:
    """Focal loss over BCE with logits, mean over every element
    (Loss.cs:55-92)."""
    prob = torch.sigmoid(logits)
    p_t = targets * prob + (1 - targets) * (1 - prob)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return (bce_logits(logits, targets) * alpha_factor
            * (1.0 - p_t) ** gamma).mean()


def bce_blur_loss(logits: torch.Tensor, targets: torch.Tensor,
                  alpha: float = 0.05) -> torch.Tensor:
    """BCE with logits, damped where the prediction exceeds a missing label,
    mean over every element (Loss.cs:29-53)."""
    dx = torch.sigmoid(logits) - targets
    alpha_factor = 1 - torch.exp((dx - 1) / (alpha + 1e-4))
    return (bce_logits(logits, targets) * alpha_factor).mean()


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


def global_sums(*values: torch.Tensor) -> torch.Tensor:
    """The float32 scalars `values` summed over the ranks (one collective
    for all of them; themselves on one device)."""
    return dist.allsum(torch.stack([v.float().reshape(()) for v in values]))


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
    fg_count: torch.Tensor       # the foreground anchors, at least 1
    batch: torch.Tensor          # the images


def _imgsz(preds) -> Tuple[int, int]:
    h, w = preds["box"][0].shape[2:4]
    return h * STRIDES[0], w * STRIDES[0]


def _det_core(preds: Dict, batch: Dict, *, nc: int, reg_max: int = 16,
              tal_topk: int = 10, tal_topk2: int | None = None) -> DetOut:
    """Shared detection path (Loss.cs
    get_assigned_targets_and_loss:411-468); the target-score sum, the
    foreground count and the batch size are the global batch's."""
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

    sums = global_sums(res.target_scores.sum(),
                       res.fg_mask.float().sum(), pred_scores.new_tensor(b))
    tss = sums[0].clamp(min=1.0)
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
                  stride_tensor, tss, sums[1].clamp(min=1.0), sums[2])


def detection_loss(preds: Dict, batch: Dict, *, nc: int, reg_max: int = 16,
                   tal_topk: int = 10, tal_topk2: int | None = None,
                   hyp_box: float = 7.5, hyp_cls: float = 0.5,
                   hyp_dfl: float = 1.5):
    """v8DetectionLoss (Loss.cs:328-484) on one branch's maps. Returns
    (loss, items (3,) = box, cls, dfl)."""
    out = _det_core(preds, batch, nc=nc, reg_max=reg_max, tal_topk=tal_topk,
                    tal_topk2=tal_topk2)
    items = torch.stack([out.loss_box * hyp_box, out.loss_cls * hyp_cls,
                         out.loss_dfl * hyp_dfl])
    return items.sum() * out.batch, items


def obb_loss(preds: Dict, batch: Dict, *, nc: int, reg_max: int = 16,
             tal_topk: int = 10, tal_topk2: int | None = None,
             hyp_box: float = 7.5, hyp_cls: float = 0.5, hyp_dfl: float = 1.5,
             hyp_angle: float = 1.0, lambda_val: float = 3.0):
    """v8OBBLoss (Loss.cs:486-683) on one branch's maps, in float32.
    Returns (loss, items (4,) = box, cls, dfl, angle).

    Ground truths under 2 px on a side are dropped (Loss.cs:559-561); the
    assigner is the rotated one (probiou); the box loss is 1 - probiou in
    grid units, the DFL targets rbox2dist's; the angle term is the
    aspect-weighted sin^2(2 dtheta), dtheta folded into a half turn, with
    the weight exp(-log(w / h)^2 / lambda^2) (Loss.cs:657-677)."""
    pred_distri = flatten_levels(preds["box"]).float()
    pred_scores = flatten_levels(preds["cls"]).float()
    pred_angle = flatten_levels(preds["angle"]).float()        # (B, A, 1)
    dev = pred_scores.device
    feat_shapes = [tuple(m.shape[2:4]) for m in preds["box"]]
    anchor_points, stride_tensor = make_anchors(feat_shapes, STRIDES,
                                                device=dev)
    ih, iw = _imgsz(preds)
    b, a, _ = pred_scores.shape

    bb = batch["bboxes"].float()                               # (B, M, 5)
    scale = torch.tensor([iw, ih, iw, ih], dtype=torch.float32, device=dev)
    gt_xywh = bb[..., :4] * scale
    gt_bboxes = torch.cat([gt_xywh, bb[..., 4:5]], -1)
    mask_gt = (batch["mask_gt"].bool() & (gt_xywh[..., 2] >= 2)
               & (gt_xywh[..., 3] >= 2))

    rbox = dist2rbox(dfl_decode(pred_distri, reg_max), pred_angle,
                     anchor_points)                            # grid units
    pred_bboxes = torch.cat([rbox, pred_angle], -1)
    res = assign(pred_scores.detach().sigmoid(),
                 torch.cat([rbox.detach() * stride_tensor,
                            pred_angle.detach()], -1),
                 anchor_points * stride_tensor, batch["cls"], gt_bboxes,
                 mask_gt, topk=tal_topk, topk2=tal_topk2, num_classes=nc,
                 rotated=True)

    sums = global_sums(res.target_scores.sum(),
                       pred_scores.new_tensor(b))
    tss = sums[0].clamp(min=1.0)
    loss_cls = bce_logits(pred_scores, res.target_scores).sum() / tss

    weight = res.target_scores.sum(-1) * res.fg_mask           # (B, A)
    tgt = torch.cat([res.target_bboxes[..., :4] / stride_tensor,
                     res.target_bboxes[..., 4:5]], -1)
    iou = probiou(pred_bboxes, tgt)[..., 0]
    loss_box = ((1.0 - iou) * weight).sum() / tss

    target_ltrb = rbox2dist(tgt[..., :4], anchor_points, tgt[..., 4:5],
                            reg_max=reg_max - 1)
    dfl = _dfl_loss(pred_distri.reshape(b, a, 4, reg_max), target_ltrb,
                    reg_max)
    loss_dfl = (dfl * weight).sum() / tss

    w_gt, h_gt = tgt[..., 2], tgt[..., 3]
    log_ar = torch.log((w_gt + 1e-9) / (h_gt + 1e-9))
    scale_w = torch.exp(-(log_ar ** 2) / (lambda_val ** 2))
    dtheta = pred_bboxes[..., 4] - tgt[..., 4]
    dtheta = dtheta - torch.round(dtheta / math.pi) * math.pi
    loss_angle = ((torch.sin(2 * dtheta) ** 2 * scale_w * weight).sum()
                  / tss)

    items = torch.stack([loss_box * hyp_box, loss_cls * hyp_cls,
                         loss_dfl * hyp_dfl, loss_angle * hyp_angle])
    return items.sum() * sums[1], items


# mask-loss slots per checkpointed chunk (the JAX package's scan chunk)
MASK_CHUNK = 256
# the semantic-seg branch's BCE and Dice weights (Loss.cs:283-325)
WEIGHT_BCE = WEIGHT_DICE = 0.5


def resize_nearest_centres(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) -> (B, h, w) nearest with half-pixel centres, as
    jax.image.resize(..., "nearest"): source floor((i + 0.5) * H / h) in
    float32 (F.interpolate's "nearest-exact" rule, in JAX's operation
    order)."""
    def index(n, size):
        return torch.floor((torch.arange(n, dtype=torch.float32,
                                         device=x.device) + 0.5)
                           * size / n).long()

    return x[:, index(h, x.shape[1])][:, :, index(w, x.shape[2])]


def _mask_chunk(proto, masks, coeff, gt_idx, mxyxy, marea, valid):
    """One chunk of the mask loss: the sum over its slots of the cropped
    per-pixel BCE's mean over the proto grid, over the box's normalised
    area. proto (B, nm, mh, mw) f32, masks (B, mh, mw) ids, the rest (B,
    CH, ...)."""
    b, ch = coeff.shape[:2]
    pm = torch.einsum("bfc,bchw->bfhw", coeff.float(), proto)
    gt = (masks[:, None] == (gt_idx[..., None, None] + 1).float()).float()
    loss = bce_logits(pm, gt)
    loss = crop_mask(loss.flatten(0, 1), mxyxy.flatten(0, 1)).view_as(loss)
    loss = loss.mean((2, 3)) / marea.clamp(min=1e-7)
    return (loss * valid).sum()


def segmentation_loss(preds: Dict, batch: Dict, *, nc: int,
                      reg_max: int = 16, tal_topk: int = 10,
                      tal_topk2: int | None = None, hyp_box: float = 7.5,
                      hyp_cls: float = 0.5, hyp_dfl: float = 1.5):
    """v8SegmentationLoss (Loss.cs:688-863) on one branch's maps, overlap
    masks. Returns (loss, items (5,) = box, seg, cls, dfl, semseg).

    The foreground anchors go to F = max(tal_topk, tal_topk2) * M fixed
    slots (TAL keeps at most top-k anchors per ground truth, so none is
    lost), taken by a top-k over the 0/1
    foreground mask (the order of tied slots is free; the loss is a sum
    over them). The masks are resized to the proto grid when they differ
    (nearest with half-pixel centres, as the JAX package does). The
    (B, CH, mh, mw) intermediates are made in chunks of MASK_CHUNK slots,
    each under a non-reentrant checkpoint, so backward recomputes a chunk
    rather than keeping it. The semseg slot computes the BCE + Dice branch
    (Loss.cs:745-770) when preds has "semseg" logits (B, nc, h, w) and the
    batch "sem_masks" class ids, else 0."""
    out = _det_core(preds, batch, nc=nc, reg_max=reg_max, tal_topk=tal_topk,
                    tal_topk2=tal_topk2)
    proto = preds["proto"].float()                   # (B, nm, mh, mw)
    pred_masks = flatten_levels(preds["mask"])       # (B, A, nm)
    b, nm, mh, mw = proto.shape
    ih, iw = _imgsz(preds)
    dev = proto.device

    masks = batch["masks"].float()                   # (B, mh', mw') ids
    if tuple(masks.shape[1:]) != (mh, mw):
        masks = resize_nearest_centres(masks, mh, mw)

    max_fg = max(tal_topk, tal_topk2 or 0) * batch["cls"].shape[1]
    fg = out.fg_mask.float()
    score, idx = fg.topk(min(max_fg, fg.shape[-1]), dim=-1)      # (B, F)
    valid = (score > 0.0).float()

    def take(t):
        return t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))

    coeff = take(pred_masks)                                   # (B, F, nm)
    gt_idx = out.target_gt_idx.gather(1, idx).float()          # (B, F)
    boxes_n = take(out.target_bboxes) / torch.tensor(
        [iw, ih, iw, ih], dtype=torch.float32, device=dev)
    marea = xyxy2xywh(boxes_n)[..., 2:4].prod(-1)              # (B, F)
    mxyxy = boxes_n * torch.tensor([mw, mh, mw, mh], dtype=torch.float32,
                                   device=dev)
    total = torch.zeros((), device=dev)
    ch = min(MASK_CHUNK, max_fg)
    for s in range(0, coeff.shape[1], ch):
        part = slice(s, s + ch)
        total = total + checkpoint(
            _mask_chunk, proto, masks, coeff[:, part], gt_idx[:, part],
            mxyxy[:, part], marea[:, part], valid[:, part],
            use_reentrant=False)
    loss_seg = total / out.fg_count

    loss_semseg = torch.zeros((), device=dev)
    if "semseg" in preds and "sem_masks" in batch:
        sem_gt = F.one_hot(batch["sem_masks"].long(), nc).float()
        sem_gt = sem_gt * (batch["masks"] > 0)[..., None].float()
        semseg = bce_dice_loss(preds["semseg"].float(),
                               sem_gt.permute(0, 3, 1, 2)) * hyp_box
        any_fg = global_sums(fg.sum())[0] > 0
        loss_semseg = torch.where(any_fg, semseg, 0.0)

    items = torch.stack([out.loss_box * hyp_box, loss_seg * hyp_box,
                         out.loss_cls * hyp_cls, out.loss_dfl * hyp_dfl,
                         loss_semseg])
    return items.sum() * out.batch, items


def pose_loss(preds: Dict, batch: Dict, *, nc: int, kpt_num: int = 17,
              kpt_dim: int = 3, reg_max: int = 16, tal_topk: int = 10,
              tal_topk2: int | None = 10, hyp_box: float = 7.5,
              hyp_cls: float = 0.5, hyp_dfl: float = 1.5,
              hyp_pose: float = 12.0, hyp_kobj: float = 1.0):
    """v8PoseLoss (Loss.cs:870-1070) on one branch's maps. Returns (loss,
    items (5,) = box, pose, kobj, cls, dfl).

    Each foreground anchor's keypoints decode as (raw * 2 + anchor - 0.5)
    in grid units against its assigned ground truth's, scaled to the
    anchor's grid; the OKS-style loss takes the COCO sigmas when K = 17
    and kd = 3, else 1 / K, over the keypoints with a visibility other than
    0 (all of them when kd = 2), and kobj is the BCE of the visibility
    logit against that mask (0 when kd = 2)."""
    out = _det_core(preds, batch, nc=nc, reg_max=reg_max, tal_topk=tal_topk,
                    tal_topk2=tal_topk2)
    b, a = out.fg_mask.shape
    ih, iw = _imgsz(preds)
    dev = out.fg_mask.device

    raw = flatten_levels(preds["kpt"]).float().reshape(b, a, kpt_num,
                                                       kpt_dim)
    # kpts_decode (Loss.cs:977-984), grid units; the visibility stays raw
    xy = raw[..., :2] * 2.0 + (out.anchor_points[None, :, None] - 0.5)
    pred_kpts = torch.cat([xy, raw[..., 2:]], -1)

    # ground truths to pixels, then to each anchor's grid
    gt = batch["keypoints"].float()                       # (B, M, K, kd)
    scale = torch.tensor([iw, ih], dtype=torch.float32, device=dev)
    gt = torch.cat([gt[..., :2] * scale, gt[..., 2:]], -1)
    sel = take_gt(gt, out.target_gt_idx)                  # (B, A, K, kd)
    sel = torch.cat([sel[..., :2] / out.stride_tensor[None, :, :, None],
                     sel[..., 2:]], -1)

    fg = out.fg_mask.float()                              # (B, A)
    area = xyxy2xywh(out.target_bboxes / out.stride_tensor)[..., 2:4] \
        .prod(-1)                                         # (B, A)
    kpt_mask = ((sel[..., 2] != 0).float() if kpt_dim == 3
                else torch.ones(sel.shape[:-1], device=dev))
    d = ((pred_kpts[..., 0] - sel[..., 0]) ** 2
         + (pred_kpts[..., 1] - sel[..., 1]) ** 2)        # (B, A, K)
    sigmas = (OKS_SIGMA.to(dev) if (kpt_num == 17 and kpt_dim == 3)
              else torch.ones(kpt_num, device=dev) / kpt_num)
    e = d / ((2 * sigmas) ** 2 * (area[..., None] + 1e-9) * 2)
    factor = kpt_num / (kpt_mask.sum(-1) + 1e-6)          # (B, A)
    per_anchor = (factor[..., None] * (1 - torch.exp(-e)) * kpt_mask).mean(-1)
    n_fg = out.fg_count
    loss_pose = (per_anchor * fg).sum() / n_fg

    if kpt_dim == 3:
        kobj = bce_logits(pred_kpts[..., 2], kpt_mask).mean(-1)
        loss_kobj = (kobj * fg).sum() / n_fg
    else:
        loss_kobj = torch.zeros((), device=dev)

    items = torch.stack([out.loss_box * hyp_box, loss_pose * hyp_pose,
                         loss_kobj * hyp_kobj, out.loss_cls * hyp_cls,
                         out.loss_dfl * hyp_dfl])
    return items.sum() * out.batch, items


def multi_channel_dice_loss(pred_logits: torch.Tensor, target: torch.Tensor,
                            smooth: float = 1e-6) -> torch.Tensor:
    """Multi-channel Dice on (B, C, H, W) maps (Loss.cs:233-278): per
    (image, channel) dice over the pixels, the channel mean, then the batch
    mean."""
    pred = pred_logits.sigmoid()
    inter = (pred * target).sum((2, 3))                 # (B, C)
    union = pred.sum((2, 3)) + target.sum((2, 3))
    dice = (2.0 * inter + smooth) / (union + smooth)
    per_image = (1.0 - dice).mean(-1)
    return per_image.sum() / global_sums(
        per_image.new_tensor(per_image.shape[0]))[0]


def bce_dice_loss(pred_logits: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    """BCE + Dice of a semantic-seg head (Loss.cs:283-325) on (B, C, H, W)
    maps; the target is resized to the logits' size when they differ with
    torch's "nearest" rule, source floor(i * (H / h)) in float32
    (Loss.cs:317-321). The Dice term is built with smooth = 1
    (Loss.cs:301)."""
    h, w = pred_logits.shape[2:]
    H, W = target.shape[2:]
    if (H, W) != (h, w):
        def index(n, size):
            return torch.floor(torch.arange(n, dtype=torch.float32,
                                            device=target.device)
                               * (size / n)).long()

        target = target[:, :, index(h, H)][:, :, :, index(w, W)]
    bce = bce_logits(pred_logits, target)
    bce = bce.sum() / global_sums(bce.new_tensor(bce.numel()))[0]
    return (WEIGHT_BCE * bce
            + WEIGHT_DICE * multi_channel_dice_loss(
                pred_logits, target, smooth=1.0))


def classification_loss(preds: Dict, batch: Dict):
    """v8ClassificationLoss (Loss.cs:1073-1091, the JAX
    classification_loss): the mean cross-entropy of the float32 logits
    against the (B,) class ids over the global batch; returns (loss,
    stack([loss]))."""
    logits = preds["cls"].float()
    labels = batch["cls"].reshape(-1).long()
    n = global_sums(logits.new_tensor(labels.shape[0]))[0]
    loss = F.cross_entropy(logits, labels, reduction="sum") / n
    return loss, loss[None]


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
