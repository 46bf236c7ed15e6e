"""Batched, fixed-output-shape NMS (counterpart of
yolosharp_tpu/ops/nms.py: non_max_suppression, nms_rotated).

Same contract as the JAX function: candidates above ``conf_thres`` are
pre-selected by top-k (``pre_topk=None`` keeps every anchor), suppressed
using class-offset boxes, and returned as a fixed (max_det, ...) block with
a validity mask and a ``truncated`` flag. PyTorch runs eagerly, so the
suppression works on the valid candidates only (the JAX version carries all
K). Axis-aligned boxes take exact greedy (torchvision) semantics: the
keep-set is the fixed point of the same antitone iteration as
``_greedy_suppress``. Rotated boxes (xywh + the angle, the last extra) take
the reference's fast triangular suppression over probiou (Ops.cs:373-401),
in which a suppressed box still suppresses, with the class offset on the
centre only; the probiou blocks are tiled over images and rows, since val's
untruncated pool can be every anchor of an image.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .boxes import xywh2xyxy
from .iou import batch_probiou, box_iou

# images per suppression chunk are capped so the (chunk, K, K) IoU block
# stays under this many elements
_IOU_ELEMS = 1 << 24


class NMSOutput(NamedTuple):
    """Fixed-shape NMS result; rows beyond `valid` are zero-padding."""

    boxes: torch.Tensor      # (B, max_det, 4) xyxy, or 5 xywhr rotated
    scores: torch.Tensor     # (B, max_det)
    classes: torch.Tensor    # (B, max_det) int32
    extras: torch.Tensor     # (B, max_det, E)
    valid: torch.Tensor      # (B, max_det) bool
    truncated: torch.Tensor  # (B,) bool: above-conf candidates exceeded pre_topk


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                iou_thres: float) -> torch.Tensor:
    """Exact greedy NMS keep mask for score-sorted boxes (B, K, 4) with
    validity (B, K): keep[j] = valid[j] and no kept i < j overlaps j by more
    than iou_thres. Iterated to its fixed point from keep = valid."""
    k = boxes.shape[1]
    tri = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    over = ((box_iou(boxes, boxes) > iou_thres) & tri
            & valid[:, :, None] & valid[:, None, :])
    keep = valid
    for _ in range(k + 1):
        new = valid & ~(over & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def fast_keep(boxes: torch.Tensor, valid: torch.Tensor,
              iou_thres: float) -> torch.Tensor:
    """Fast-NMS keep mask for score-sorted xywhr boxes (B, K, 5) with
    validity (B, K): keep[j] = valid[j] and no valid i < j, kept or not,
    has probiou(i, j) > iou_thres. The (rows, K) probiou blocks are at
    most _IOU_ELEMS elements."""
    b, k = valid.shape
    idx = torch.arange(k, device=boxes.device)
    rows = max(1, _IOU_ELEMS // (b * k))
    suppressed = torch.zeros_like(valid)
    for r0 in range(0, k, rows):
        r1 = min(r0 + rows, k)
        over = ((batch_probiou(boxes[:, r0:r1], boxes) > iou_thres)
                & (idx[r0:r1, None] < idx[None, :])
                & valid[:, r0:r1, None])
        suppressed |= over.any(1)
    return valid & ~suppressed


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor,
                threshold: float = 0.45) -> torch.Tensor:
    """Keep mask, in the input order, of the fast rotated NMS of xywhr
    boxes (N, 5) by descending score (Ops.cs:373-401)."""
    order = torch.argsort(-scores, stable=True)
    keep = fast_keep(boxes[order][None], torch.ones_like(order[None],
                                                        dtype=torch.bool),
                     threshold)[0]
    return torch.zeros_like(keep).scatter_(0, order, keep)


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, *, max_det: int = 300,
                        nc: int = 0, pre_topk: Optional[int] = None,
                        agnostic: bool = False, rotated: bool = False,
                        max_wh: float = 7680.0) -> NMSOutput:
    """prediction: (B, 4+nc+E, A) with xywh boxes and sigmoided class
    scores (channel-first, as the head decode emits); when rotated, the
    last extra is the angle and the boxes come back xywhr. nc=0 infers
    nc=C-4."""
    bs, ch, na = prediction.shape
    nc = nc or ch - 4
    pred = prediction.transpose(-1, -2)
    boxes_xywh = pred[..., :4]
    cls_scores = pred[..., 4:4 + nc]
    extras = pred[..., 4 + nc:]

    conf = cls_scores.amax(-1)
    cls_id = cls_scores.argmax(-1).to(torch.int32)
    conf = torch.where(conf > conf_thres, conf, torch.zeros_like(conf))

    k = na if pre_topk is None else min(pre_topk, na)
    top_conf, top_idx = conf.topk(k, dim=-1)
    if k < na:
        truncated = (conf > 0.0).sum(-1) > k
    else:
        truncated = torch.zeros(bs, dtype=torch.bool, device=conf.device)
    # score-sorted: the valid candidates lead every row
    kv = max(int((top_conf > 0.0).sum(-1).max()), 1)
    top_conf, top_idx = top_conf[:, :kv], top_idx[:, :kv]
    valid = top_conf > 0.0

    def take(t):
        return t.gather(1, top_idx[..., None].expand(-1, -1, t.shape[-1]))

    box = take(boxes_xywh)
    cls = cls_id.gather(1, top_idx)
    ext = take(extras)
    offset = (torch.zeros_like(top_conf) if agnostic
              else cls.to(box.dtype) * max_wh)[..., None]
    if rotated:
        out_box = torch.cat([box, ext[..., -1:]], -1)
        nms_box = torch.cat([box[..., :2] + offset, out_box[..., 2:]], -1)
        keep_fn, elems = fast_keep, kv
    else:
        out_box = xywh2xyxy(box)
        nms_box = out_box + offset
        keep_fn, elems = greedy_keep, kv * kv
    chunk = max(1, _IOU_ELEMS // elems)
    keep = torch.cat([keep_fn(nms_box[i:i + chunk], valid[i:i + chunk],
                              iou_thres)
                      for i in range(0, bs, chunk)])

    # compact kept rows to the front, cap at max_det, zero the padding
    keep_scores = torch.where(keep, top_conf, torch.full_like(top_conf, -1.0))
    k_out = min(max_det, kv)
    sel_scores, sel = keep_scores.topk(k_out, dim=-1)
    if k_out < max_det:
        pad = max_det - k_out
        sel_scores = torch.nn.functional.pad(sel_scores, (0, pad), value=-1.0)
        sel = torch.nn.functional.pad(sel, (0, pad))
    ok = sel_scores > 0.0
    z = ok.to(out_box.dtype)

    def pick(t):
        return t.gather(1, sel[..., None].expand(-1, -1, t.shape[-1]))

    return NMSOutput(pick(out_box) * z[..., None], sel_scores * z,
                     cls.gather(1, sel) * ok.to(torch.int32),
                     pick(ext) * z[..., None], ok, truncated)
