"""Detect, segment, pose and OBB dataset: per-index transforms, padded
batch collation and the planned batches of the device render (a copy of
yolosharp_tpu/data/dataset.py:23-212, the detect, segment, pose and OBB
tasks), and the classify task's folder-per-class ClassificationDataset
(:214-308).

Parity targets: Data/YoloDataset.cs:57-99 (transform composition,
CloseMosaic) and Data/YoloDataLoader.cs:18-44 (collation, here to padded
fixed shapes). The train transform of an image is mosaic4 ->
random_perspective (while the mosaic is open, with probability
``Config.mosaic``) or letterbox, then flips -> HSV. With
``Config.device_augment`` and ``mosaic >= 1`` the loader takes whole
planned batches instead (``device_batch``): labels planned on the host,
pixels rendered on the device (``device_augment``). A segment batch also
carries ``masks`` (B, h/r, w/r) float32 overlap ids, or, planned, the
tile-local id pool ``aug_mask_pool`` and the plan's ``aug_mask_lut``, from
which the train step renders ``masks``. A pose batch, collated or planned,
carries ``keypoints`` (B, M, K, kd) float32, x and y normalised by the
canvas. An OBB batch's ``bboxes`` are (B, M, 5): each label's corners
through the cv2-free minimum-area rectangle (``ops.boxes.xyxyxyxy2xywhr``,
OpenCV 5.0's convention), centre and size normalised by the canvas, the
angle in radians.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np

from ..config import Config
from ..types import ImageProcessType, TaskType
from ..ops.boxes import xyxyxyxy2xywhr
from . import augment as A
from . import classify_augment as CA
from .image_ops import read_image_rgb, resize_linear
from .labels import LabelRecord, get_img_files, load_labels


class YoloDataset:
    """Detect / segment / pose / OBB dataset with the reference's augment
    pipeline (the mosaic while it is open, letterbox after)."""

    def __init__(self, config: Config, is_val: bool = False,
                 use_rectangle: bool = False, seed: int = 0):
        self.config = config
        self.is_val = is_val
        self.segment = config.task_type == TaskType.segment
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
            return A.rectangle(rec, cfg.mask_ratio)

        use_mosaic = (cfg.image_process_type == ImageProcessType.mosaic
                      and not self.mosaic_closed)
        if use_mosaic and self.rng.uniform() <= cfg.mosaic:
            picks = [self.records[int(i)] for i in
                     self.rng.integers(0, len(self.records) - 1, 3)]
            rec = A.mosaic4(rec, picks, cfg.image_size, self.rng)
            rec = A.random_perspective(rec, cfg.degrees, cfg.translate,
                                       cfg.scale, cfg.shear, cfg.perspective,
                                       self.rng)
        else:
            rec = A.letterbox(rec, cfg.image_size, cfg.image_size,
                              cfg.mask_ratio)
        if cfg.flip_lr > 0 and self.rng.uniform() <= cfg.flip_lr:
            rec = A.flip_lr(rec)
        if cfg.flip_ud > 0 and self.rng.uniform() <= cfg.flip_ud:
            rec = A.flip_ud(rec)
        return A.random_hsv(rec, cfg.hsv_h, cfg.hsv_s, cfg.hsv_v, self.rng)

    def collate(self, recs: List[LabelRecord], max_labels: int
                ) -> Dict[str, np.ndarray]:
        """Stack transformed records into one padded batch dict: uint8
        images (normalised on the device), the padded labels and, for the
        segment task, the masks (float32 ids, 0 padding)."""
        # pad to the batch max (bottom/right, gray) if shapes differ; labels
        # stay valid since every transform pads anchored top-left
        h = max(r.img.shape[0] for r in recs)
        w = max(r.img.shape[1] for r in recs)

        def pad_to(img, th, tw, fill):
            if img.shape[:2] == (th, tw):
                return img
            out = np.full((th, tw) + img.shape[2:], fill, img.dtype)
            out[:img.shape[0], :img.shape[1]] = img
            return out

        out = {"images": np.stack([pad_to(r.img, h, w, 114) for r in recs])}
        out.update(self._label_arrays(recs, max_labels, h, w))
        if self.segment:
            mh, mw = h // self.config.mask_ratio, w // self.config.mask_ratio
            out["masks"] = np.stack([
                pad_to(r.mask, mh, mw, 0) if r.mask is not None
                else np.zeros((mh, mw), np.uint8)
                for r in recs]).astype(np.float32)
        return out

    def use_device_augment(self) -> bool:
        """Whether this dataset's train batches are planned on the host and
        rendered on the device (``device_batch``)."""
        cfg = self.config
        return (bool(cfg.device_augment) and not self.is_val
                and not self.mosaic_closed
                and cfg.image_process_type == ImageProcessType.mosaic
                and cfg.mosaic >= 1.0)

    def device_batch(self, idx, max_labels: int, partner_group: int = 0
                     ) -> Dict[str, np.ndarray]:
        """A planned batch: the padded labels of the planned samples, the
        uint8 source pool (each record's resized image top-left on a
        114-filled s x s page) as ``aug_pool``, and the plan arrays as
        ``aug_src_idx`` ... ``aug_hsv`` (``device_augment.PLAN_KEYS``); for
        the segment task each record's mask top-left on a zero s/r x s/r
        page as ``aug_mask_pool`` and the plan's ``aug_mask_lut``.
        Mosaic partners come from groups of ``partner_group`` rows of
        `idx` (0: the whole of it), as the JAX package's: a data-parallel
        rank plans its own rows only, so its partners stay inside them;
        ``Config.mosaic_partner_pool = E`` appends E records drawn from the
        whole dataset to the pool (the reference's dataset-wide partners),
        E a group."""
        from . import device_augment as DA

        cfg = self.config
        recs = [self.records[int(i)] for i in idx]
        b = len(recs)
        gs = partner_group if 0 < partner_group and b % partner_group == 0 \
            else b
        extras = int(cfg.mosaic_partner_pool or 0)
        pool_recs = []
        for g in range(b // gs):
            pool_recs += recs[g * gs:(g + 1) * gs]
            if extras > 0:
                ex = self.rng.integers(0, len(self.records), extras)
                pool_recs += [self.records[int(t)] for t in ex]
        plan, labels = DA.plan_mosaic_batch(pool_recs, cfg, self.rng,
                                            group=gs,
                                            extras_per_group=extras)
        s = cfg.image_size
        pool = np.full((len(pool_recs), s, s, 3), 114, np.uint8)
        for k, r in enumerate(pool_recs):
            h, w = r.resized_shape
            pool[k, :h, :w] = r.img
        out = self._label_arrays(labels, max_labels, s, s)
        out.update(aug_pool=pool, aug_src_idx=plan.src_idx,
                   aug_rects=plan.rects, aug_pads=plan.pads,
                   aug_minv=plan.minv, aug_persp=plan.persp,
                   aug_flips=plan.flips, aug_hsv=plan.hsv)
        if self.segment:
            sm = s // cfg.mask_ratio
            mpool = np.zeros((len(pool_recs), sm, sm), np.uint8)
            for k, r in enumerate(pool_recs):
                if r.mask is not None:
                    mh, mw = r.mask.shape[:2]
                    mpool[k, :min(mh, sm), :min(mw, sm)] = r.mask[:sm, :sm]
            out.update(aug_mask_pool=mpool, aug_mask_lut=plan.mask_lut)
        return out

    def _label_arrays(self, recs: List[LabelRecord], max_labels: int,
                      h: int, w: int) -> Dict[str, np.ndarray]:
        """Padded, normalised label tensors for a batch (canvas h x w)."""
        cfg = self.config
        b = len(recs)
        obb = cfg.task_type == TaskType.obb
        cls = np.zeros((b, max_labels), np.int32)
        bboxes = np.zeros((b, max_labels, 5 if obb else 4), np.float32)
        mask_gt = np.zeros((b, max_labels), bool)
        out = {"cls": cls, "bboxes": bboxes, "mask_gt": mask_gt}
        pose = cfg.task_type == TaskType.pose
        if pose:
            out["keypoints"] = np.zeros(
                (b, max_labels, cfg.keypoint_num, cfg.keypoint_dim),
                np.float32)
        for i, r in enumerate(recs):
            n = min(len(r.cls), max_labels)
            if n == 0:
                continue
            cls[i, :n] = r.cls[:n].astype(np.int32)
            mask_gt[i, :n] = True
            if obb:
                bboxes[i, :n] = (xyxyxyxy2xywhr(r.obb_corners[:n])
                                 / np.float32([w, h, w, h, 1]))
                continue
            bb = r.bboxes[:n]
            cxy = (bb[:, :2] + bb[:, 2:]) / 2
            wh = bb[:, 2:] - bb[:, :2]
            bboxes[i, :n, :2] = cxy / [w, h]
            bboxes[i, :n, 2:4] = wh / [w, h]
            if pose and r.keypoints is not None:
                k = r.keypoints[:n].copy()
                k[..., 0] /= w
                k[..., 1] /= h
                out["keypoints"][i, :n] = k
        return out


class ClassificationDataset:
    """Folder-per-class classification dataset (a copy of
    yolosharp_tpu/data/dataset.py:214-308, ClassificationDataset.cs): the
    class of an image is the name of its folder. Train: RandomResizedCrop
    (10 tries, else the whole image) to s x s, the flips, the
    Config.auto_augment policy and random erasing (``classify_augment``);
    val: the short side resized to s, then the centre s x s crop. Images
    are read by ``image_ops.read_image_rgb`` (PNG, JPEG of every kind
    cv2.imread reads, arithmetic-coded, cut short and without DHT
    segments included; BMP; TIFF with CCITT, JPEG, YCbCr and CMYK; PNM /
    PAM; WebP; JPEG 2000; GIF; Sun raster; PFM; Radiance HDR) and resized
    by ``image_ops.resize_linear`` (cv2's INTER_LINEAR, bit for bit).

    ``get`` draws from one generator in a fixed order; the DataLoader calls
    it from ``workers`` threads that share that generator, as the JAX
    package's does, so which draws an image takes varies with the threads'
    timing there."""

    def __init__(self, config: Config, is_val: bool = False, seed: int = 0):
        self.config = config
        self.is_val = is_val
        split = config.val_data_path if is_val else config.train_data_path
        root = os.path.abspath(os.path.join(config.root_path, split))
        if not os.path.isdir(root) and not os.path.isfile(root):
            # a quiet fallback would make train and val the SAME data
            print(f"WARNING: classification split '{split}' not found under "
                  f"{config.root_path}; falling back to the root folder — "
                  f"train and val will see identical data.")
            root = os.path.abspath(config.root_path)
        files = get_img_files(root)
        self.classes = sorted({os.path.basename(os.path.dirname(p))
                               for p in files})
        cindex = {c: i for i, c in enumerate(self.classes)}
        self.samples = [(p, cindex[os.path.basename(os.path.dirname(p))])
                        for p in files]
        if not self.samples:
            raise FileNotFoundError(f"no classification data in {root}")
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def close_mosaic(self, closed: bool = True) -> None:
        pass

    @property
    def max_label_count(self) -> int:
        return 1

    def use_device_augment(self) -> bool:
        """Classify batches are made on the host."""
        return False

    def get(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        path, ci = self.samples[index]
        img = read_image_rgb(path)
        s = cfg.image_size
        if self.is_val:
            img = center_crop(img, s)
        else:
            # RandomResizedCrop (ClassificationDataset.cs:90-131)
            h, w = img.shape[:2]
            area = h * w
            for _ in range(10):
                ta = area * self.rng.uniform(cfg.classify_scale_min,
                                             cfg.classify_scale_max)
                ar = math.exp(self.rng.uniform(
                    math.log(cfg.classify_ratio_min),
                    math.log(cfg.classify_ratio_max)))
                cw = int(round(math.sqrt(ta * ar)))
                chh = int(round(math.sqrt(ta / ar)))
                if 0 < cw <= w and 0 < chh <= h:
                    left = int(self.rng.integers(0, w - cw + 1))
                    top = int(self.rng.integers(0, h - chh + 1))
                    img = img[top:top + chh, left:left + cw]
                    break
            img = resize_linear(img, s, s)
            if cfg.flip_lr > 0 and self.rng.uniform() < cfg.flip_lr:
                img = np.ascontiguousarray(img[:, ::-1])
            if cfg.flip_ud > 0 and self.rng.uniform() < cfg.flip_ud:
                img = np.ascontiguousarray(img[::-1])
            aat = cfg.auto_augment
            if aat.value == "autoaugment":
                img = CA.auto_augment(img, self.rng)
            elif aat.value == "randaugment":
                img = CA.rand_augment(img, self.rng)
            elif aat.value == "augmix":
                img = CA.augmix(img, self.rng)
            if cfg.erasing > 0:
                img = CA.random_erasing(img, self.rng, p=cfg.erasing)
        return {"image": np.ascontiguousarray(img), "cls": ci}

    def collate(self, items, max_labels: int) -> Dict[str, np.ndarray]:
        images = np.stack([it["image"] for it in items])
        cls = np.asarray([it["cls"] for it in items], np.int32)
        return {"images": images, "cls": cls}


def center_crop(img: np.ndarray, s: int) -> np.ndarray:
    """The short side of a uint8 image resized to s (cv2's INTER_LINEAR),
    then its centre s x s: classify's eval transform (val and
    predict_stream)."""
    h, w = img.shape[:2]
    r = s / min(h, w)
    img = resize_linear(img, max(s, int(h * r)), max(s, int(w * r)))
    h, w = img.shape[:2]
    top, left = (h - s) // 2, (w - s) // 2
    return img[top:top + s, left:left + s]
