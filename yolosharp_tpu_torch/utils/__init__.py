from .metrics import ap_per_class, match_predictions, summarize
from .training import EarlyStopping, StepTrace, TrainLogger

__all__ = ["EarlyStopping", "StepTrace", "TrainLogger", "ap_per_class",
           "match_predictions", "summarize"]
