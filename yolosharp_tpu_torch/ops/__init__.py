from .anchors import (bbox2dist, dfl_decode, dist2bbox, dist2rbox,
                      make_anchors, rbox2dist)
from .boxes import (clip_boxes, clip_keypoints, clip_obb_corners,
                    cxcywhr2xyxyxyxy, sort_obb_corners, xywh2xyxy,
                    xywhn2xyxy, xywhr2xyxyxyxy, xyxy2xywh, xyxy2xywhn,
                    xyxyxyxy2xywhr)
from .iou import batch_probiou, bbox_iou, box_iou, kpt_iou, mask_iou, probiou
from .masks import crop_mask, process_mask
from .nms import NMSOutput, nms_rotated, non_max_suppression
from .rect import min_area_rect

__all__ = ["NMSOutput", "batch_probiou", "bbox2dist", "bbox_iou", "box_iou",
           "clip_boxes", "clip_keypoints", "clip_obb_corners", "crop_mask",
           "cxcywhr2xyxyxyxy", "dfl_decode", "dist2bbox", "dist2rbox",
           "kpt_iou", "make_anchors", "mask_iou", "min_area_rect",
           "nms_rotated", "non_max_suppression", "probiou", "process_mask",
           "rbox2dist", "sort_obb_corners", "xywh2xyxy", "xywhn2xyxy",
           "xywhr2xyxyxyxy", "xyxy2xywh", "xyxy2xywhn", "xyxyxyxy2xywhr"]
