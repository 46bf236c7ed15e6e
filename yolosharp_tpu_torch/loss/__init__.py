from .losses import (OKS_SIGMA, DetOut, bce_blur_loss, bce_dice_loss,
                     bce_logits, classification_loss, detection_loss,
                     e2e_gain_schedule, e2e_wrap, flatten_levels, focal_loss,
                     multi_channel_dice_loss, obb_loss, pose_loss,
                     segmentation_loss, take_gt)
from .tal import AssignResult, assign

__all__ = ["AssignResult", "DetOut", "OKS_SIGMA", "assign", "bce_blur_loss",
           "bce_dice_loss", "bce_logits", "classification_loss",
           "detection_loss", "e2e_gain_schedule", "e2e_wrap",
           "flatten_levels", "focal_loss",
           "multi_channel_dice_loss", "obb_loss", "pose_loss",
           "segmentation_loss", "take_gt"]
