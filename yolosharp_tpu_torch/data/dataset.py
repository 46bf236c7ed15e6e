"""Detection dataset: per-index transforms and padded batch collation (a copy
of yolosharp_tpu/data/dataset.py:23-104 and :170-212, detect task).

Parity targets: Data/YoloDataset.cs:57-99 (transform composition,
CloseMosaic) and Data/YoloDataLoader.cs:18-44 (collation, here to padded
fixed shapes). The train transform is letterbox -> flips -> HSV; an image
that would take the mosaic (``image_process_type == mosaic`` before
``close_mosaic``) raises, as mosaic4 and random_perspective are not ported
yet. ``Config.device_augment`` is ignored, as on the JAX letterbox path.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..config import Config
from ..types import ImageProcessType
from . import augment as A
from .labels import LabelRecord, load_labels

MOSAIC_TODO = ("the mosaic augmentation (host mosaic4 + random_perspective, "
               "then the device render) is not ported to the torch port yet "
               "(ROADMAP queue 1 item 7); use ImageProcessType.letterbox, "
               "close_mosaic = 0 or mosaic = 0")


class YoloDataset:
    """Detection dataset with the reference's letterbox augment pipeline."""

    def __init__(self, config: Config, is_val: bool = False,
                 use_rectangle: bool = False, seed: int = 0):
        self.config = config
        self.is_val = is_val
        self.records = load_labels(config, is_val=is_val,
                                   use_rectangle=use_rectangle)
        self.rng = np.random.default_rng(seed)
        self.mosaic_closed = False

    def __len__(self) -> int:
        return len(self.records)

    @property
    def max_label_count(self) -> int:
        base = max((len(r.cls) for r in self.records), default=1)
        mult = (4 if (not self.is_val and not self.mosaic_closed
                      and self.config.image_process_type
                      == ImageProcessType.mosaic) else 1)
        n = max(base * mult, 8)
        return int(math.ceil(n / 8) * 8)

    def close_mosaic(self, closed: bool = True) -> None:
        self.mosaic_closed = closed

    def get(self, index: int) -> LabelRecord:
        cfg = self.config
        rec = self.records[index].copy()
        if self.is_val:
            return A.rectangle(rec)

        use_mosaic = (cfg.image_process_type == ImageProcessType.mosaic
                      and not self.mosaic_closed)
        if use_mosaic and self.rng.uniform() <= cfg.mosaic:
            raise NotImplementedError(MOSAIC_TODO)
        rec = A.letterbox(rec, cfg.image_size, cfg.image_size)
        if cfg.flip_lr > 0 and self.rng.uniform() <= cfg.flip_lr:
            rec = A.flip_lr(rec)
        if cfg.flip_ud > 0 and self.rng.uniform() <= cfg.flip_ud:
            rec = A.flip_ud(rec)
        return A.random_hsv(rec, cfg.hsv_h, cfg.hsv_s, cfg.hsv_v, self.rng)

    def collate(self, recs: List[LabelRecord], max_labels: int
                ) -> Dict[str, np.ndarray]:
        """Stack transformed records into one padded batch dict: uint8
        images (normalised on the device) and the padded labels."""
        # pad to the batch max (bottom/right, gray) if shapes differ; labels
        # stay valid since every transform pads anchored top-left
        h = max(r.img.shape[0] for r in recs)
        w = max(r.img.shape[1] for r in recs)

        def pad_to(img):
            if img.shape[:2] == (h, w):
                return img
            out = np.full((h, w) + img.shape[2:], 114, img.dtype)
            out[:img.shape[0], :img.shape[1]] = img
            return out

        out = {"images": np.stack([pad_to(r.img) for r in recs])}
        out.update(self._label_arrays(recs, max_labels, h, w))
        return out

    def _label_arrays(self, recs: List[LabelRecord], max_labels: int,
                      h: int, w: int) -> Dict[str, np.ndarray]:
        """Padded, normalised label tensors for a batch (canvas h x w)."""
        b = len(recs)
        cls = np.zeros((b, max_labels), np.int32)
        bboxes = np.zeros((b, max_labels, 4), np.float32)
        mask_gt = np.zeros((b, max_labels), bool)
        for i, r in enumerate(recs):
            n = min(len(r.cls), max_labels)
            if n == 0:
                continue
            cls[i, :n] = r.cls[:n].astype(np.int32)
            mask_gt[i, :n] = True
            bb = r.bboxes[:n]
            cxy = (bb[:, :2] + bb[:, 2:]) / 2
            wh = bb[:, 2:] - bb[:, :2]
            bboxes[i, :n, :2] = cxy / [w, h]
            bboxes[i, :n, 2:4] = wh / [w, h]
        return {"cls": cls, "bboxes": bboxes, "mask_gt": mask_gt}
