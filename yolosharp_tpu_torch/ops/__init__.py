from .anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from .boxes import clip_keypoints, xywh2xyxy, xyxy2xywh
from .iou import bbox_iou, box_iou, kpt_iou, mask_iou
from .masks import crop_mask, process_mask
from .nms import NMSOutput, non_max_suppression

__all__ = ["NMSOutput", "bbox2dist", "bbox_iou", "box_iou", "clip_keypoints",
           "crop_mask", "dfl_decode", "dist2bbox", "kpt_iou", "make_anchors",
           "mask_iou", "non_max_suppression", "process_mask", "xywh2xyxy",
           "xyxy2xywh"]
