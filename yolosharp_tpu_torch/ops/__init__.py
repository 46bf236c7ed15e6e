from .anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from .boxes import xywh2xyxy, xyxy2xywh
from .iou import bbox_iou, box_iou
from .nms import NMSOutput, non_max_suppression

__all__ = ["NMSOutput", "bbox2dist", "bbox_iou", "box_iou", "dfl_decode",
           "dist2bbox", "make_anchors", "non_max_suppression", "xywh2xyxy",
           "xyxy2xywh"]
