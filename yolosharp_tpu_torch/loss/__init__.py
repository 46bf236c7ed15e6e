from .losses import (DetOut, bce_logits, detection_loss, e2e_gain_schedule,
                     e2e_wrap, flatten_levels, take_gt)
from .tal import AssignResult, assign

__all__ = ["AssignResult", "DetOut", "assign", "bce_logits", "detection_loss",
           "e2e_gain_schedule", "e2e_wrap", "flatten_levels", "take_gt"]
