"""Head-output decoding: DFL + anchors + sigmoid, select-then-decode top-k,
and the End2End top-k postprocess (counterpart of
yolosharp_tpu/predict.py: detect, segment, pose and OBB). Decoding runs in
float32 whatever the network's dtype, as in the JAX package. An OBB branch
(an "angle" map) decodes its boxes by dist2rbox to centre-form xywh, in
NMS and End2End alike, with the angle as the last extra channel."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .loss.losses import flatten_levels
from .nn.model import STRIDES
from .ops.anchors import dfl_decode, dist2bbox, dist2rbox, make_anchors


def _anchors(branch: Dict):
    shapes = [tuple(m.shape[2:4]) for m in branch["box"]]
    return make_anchors(shapes, STRIDES, device=branch["box"][0].device)


def decode_keypoints(raw: torch.Tensor, anchors: torch.Tensor,
                     strides: torch.Tensor, kpt_num: int,
                     kpt_dim: int) -> torch.Tensor:
    """Raw keypoint channels (B, N, K kd) of N anchors (anchors (N, 2) or
    (B, N, 2) in grid units, strides alike) -> (B, N, K kd) image pixels:
    x, y = (raw * 2 + anchor - 0.5) * stride, and the visibility's sigmoid
    when kd = 3 (Head.cs:546-563), in float32."""
    b, n, _ = raw.shape
    kpts = raw.float().reshape(b, n, kpt_num, kpt_dim)
    xy = (kpts[..., :2] * 2.0 + (anchors[..., None, :] - 0.5)) \
        * strides[..., None, :]
    if kpt_dim == 3:
        xy = torch.cat([xy, kpts[..., 2:3].sigmoid()], -1)
    return xy.reshape(b, n, kpt_num * kpt_dim)


def _boxes(dist: torch.Tensor, angle_raw, anchors, strides, xywh: bool):
    """(boxes in image pixels, the angle (..., 1) float32 or None) of DFL
    distances: rotated centre-form xywh when there is an angle."""
    if angle_raw is None:
        return dist2bbox(dist, anchors, xywh=xywh) * strides, None
    angle = angle_raw.float()
    return dist2rbox(dist, angle, anchors) * strides, angle


def decode_inference(branch: Dict, *, reg_max: int = 16,
                     end2end: bool = False, kpt_num: int = 17,
                     kpt_dim: int = 3) -> torch.Tensor:
    """Raw head maps -> (B, 4 + nc [+ nm | + K kd | + 1], A): boxes (xywh,
    or xyxy when e2e; rotated xywh for OBB) in image pixels, sigmoided class
    scores [and a segment branch's mask coefficients, or a pose branch's
    decoded keypoints, or an OBB branch's angle]."""
    anchors, strides = _anchors(branch)
    dist = dfl_decode(flatten_levels(branch["box"]), reg_max)
    dbox, angle = _boxes(dist, flatten_levels(branch["angle"])
                         if "angle" in branch else None,
                         anchors, strides, not end2end)
    parts = [dbox, flatten_levels(branch["cls"]).float().sigmoid()]
    if "mask" in branch:
        parts.append(flatten_levels(branch["mask"]).float())
    if "kpt" in branch:
        parts.append(decode_keypoints(flatten_levels(branch["kpt"]), anchors,
                                      strides, kpt_num, kpt_dim))
    if angle is not None:
        parts.append(angle)
    return torch.cat(parts, -1).transpose(-1, -2)


def decode_inference_topk(branch: Dict, *, conf_thres: float, k: int,
                          reg_max: int = 16, kpt_num: int = 17,
                          kpt_dim: int = 3
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select-then-decode: top-k on the RAW class logits, then the DFL,
    anchor and keypoint decode of the K selected anchors only (exact:
    sigmoid is monotone). Returns (pred (B, 4 + nc [+ nm | + K kd], K),
    truncated (B,)),
    truncated flagging images with more than K above-threshold
    candidates."""
    cls_l = flatten_levels(branch["cls"])                  # (B, A, nc)
    conf_l = cls_l.amax(-1).float()                        # (B, A)
    k = min(k, conf_l.shape[-1])
    _, top_idx = conf_l.topk(k, dim=-1)                    # (B, K)
    ct = torch.tensor(conf_thres, dtype=torch.float32)
    thr_logit = (torch.log(ct) - torch.log1p(-ct)).to(conf_l.device)
    truncated = (conf_l > thr_logit).sum(-1) > k

    anchors, strides = _anchors(branch)
    anc_k, str_k = anchors[top_idx], strides[top_idx]      # (B, K, 2|1)

    def gather(levels):
        flat = flatten_levels(levels)
        return flat.gather(1, top_idx[..., None].expand(-1, -1, flat.shape[-1]))

    dist = dfl_decode(gather(branch["box"]), reg_max)      # (B, K, 4)
    dbox, angle = _boxes(dist, gather(branch["angle"]) if "angle" in branch
                         else None, anc_k, str_k, True)
    parts = [dbox, gather(branch["cls"]).float().sigmoid()]
    if "mask" in branch:
        parts.append(gather(branch["mask"]).float())
    if "kpt" in branch:
        parts.append(decode_keypoints(gather(branch["kpt"]), anc_k, str_k,
                                      kpt_num, kpt_dim))
    if angle is not None:
        parts.append(angle)
    return torch.cat(parts, -1).transpose(-1, -2), truncated


def e2e_postprocess(pred: torch.Tensor, *, nc: int,
                    max_det: int = 300) -> torch.Tensor:
    """NMS-free top-k select (Head.cs postprocess/get_topk_index:117-196).
    pred: (B, A, 4 + nc + E) with xyxy boxes (an OBB branch's xywh) and E
    extra channels (a segment branch's mask coefficients, a pose branch's
    keypoints, an OBB branch's angle).
    Returns (B, min(max_det, A), 6 + E): [x1, y1, x2, y2, score, cls,
    extras of the row's anchor]."""
    boxes, scores = pred[..., :4], pred[..., 4:4 + nc]
    extras = pred[..., 4 + nc:]
    b, a, _ = scores.shape
    k = min(max_det, a)
    _, ori_index = scores.amax(-1).topk(k, dim=-1)                # (B, K)
    sel = scores.gather(1, ori_index[..., None].expand(-1, -1, nc))
    flat_scores, flat_idx = sel.reshape(b, -1).topk(k, dim=-1)
    anchor_of = ori_index.gather(1, flat_idx // nc)
    cls_of = (flat_idx % nc).to(pred.dtype)

    def take(t):
        return t.gather(1, anchor_of[..., None].expand(-1, -1, t.shape[-1]))

    return torch.cat([take(boxes), flat_scores[..., None], cls_of[..., None],
                      take(extras)], -1)


def pad_to_multiple(img: torch.Tensor, multiple: int = 32,
                    value: float = 114.0) -> torch.Tensor:
    """Bottom/right pad (B, H, W, C) to a stride multiple (Detector.cs:35-41)."""
    h, w = img.shape[1:3]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        img = F.pad(img, (0, 0, 0, pw, 0, ph), value=value)
    return img
