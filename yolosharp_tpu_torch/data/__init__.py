from .dataset import ClassificationDataset, YoloDataset
from .labels import LabelRecord, load_labels
from .loader import DataLoader, device_prefetch, to_device

__all__ = ["ClassificationDataset", "DataLoader", "LabelRecord",
           "YoloDataset", "device_prefetch", "load_labels", "to_device"]
