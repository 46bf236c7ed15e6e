from .metrics import ap_per_class, match_predictions, summarize
from .training import EarlyStopping, TrainLogger

__all__ = ["EarlyStopping", "TrainLogger", "ap_per_class",
           "match_predictions", "summarize"]
