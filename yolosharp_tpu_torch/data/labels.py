"""Dataset scanning and YOLO-txt label parsing for the detect, segment,
pose and OBB tasks (a copy of yolosharp_tpu/data/labels.py; images are
read (PNG, JPEG, BMP, TIFF, PNM / PAM, WebP, JPEG 2000, GIF, Sun raster,
PFM, HDR) and resized through ``image_ops`` without cv2, and polygons
filled by ``image_ops.fill_poly``).

Parity targets: Data/Base.cs:51-136 (image scanning / txt-list
resolution), Data/YoloDataset.cs:153-376 (label parsing, eager resize,
polygon -> overlap-id mask, rectangle-batch shapes), Data/Struct.cs
(LabelRecord).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from ..types import TaskType
from .image_ops import fill_poly, read_image_rgb, resize_linear

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}


@dataclasses.dataclass
class LabelRecord:
    """One image and its boxes (pixel units of `img`); for the segment task
    its overlap-id mask (instance i + 1 per pixel, at 1 / mask_ratio), for
    the pose task its keypoints, for the OBB task its 4 corners."""

    im_file: str
    img: Optional[np.ndarray] = None          # (H, W, 3) uint8, resized
    cls: np.ndarray = None                    # (n,)
    bboxes: np.ndarray = None                 # (n, 4) xyxy pixels
    org_shape: Tuple[int, int] = (0, 0)       # (h, w)
    resized_shape: Tuple[int, int] = (0, 0)
    rectangle_shape: Optional[Tuple[int, int]] = None
    keypoints: Optional[np.ndarray] = None    # (n, K, kd) pixels
    obb_corners: Optional[np.ndarray] = None  # (n, 4, 2) pixels
    mask: Optional[np.ndarray] = None         # (mh, mw) uint8 overlap ids
    mask_ratio: int = 4
    mosaic_border: Tuple[int, int] = (0, 0)   # set by mosaic4

    def copy(self) -> "LabelRecord":
        return dataclasses.replace(
            self,
            cls=None if self.cls is None else self.cls.copy(),
            bboxes=None if self.bboxes is None else self.bboxes.copy(),
            keypoints=None if self.keypoints is None else self.keypoints.copy(),
            obb_corners=(None if self.obb_corners is None
                         else self.obb_corners.copy()),
            mask=None if self.mask is None else self.mask.copy())


def get_img_files(img_path: str) -> List[str]:
    """Resolve a directory or txt list into sorted image paths
    (Base.cs:65-136)."""
    files: List[str] = []
    if os.path.isdir(img_path):
        for root, _dirs, names in os.walk(img_path):
            files.extend(os.path.join(root, n) for n in names)
    elif os.path.isfile(img_path):
        parent = os.path.dirname(img_path)
        with open(img_path, encoding="utf-8-sig") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                files.append(os.path.join(parent, line[2:])
                             if line.startswith("./") else line)
    else:
        raise FileNotFoundError(f"{img_path} does not exist")
    files = sorted(os.path.abspath(p) for p in files
                   if os.path.splitext(p)[1].lower() in IMG_EXTS)
    if not files:
        raise FileNotFoundError(f"no images found in {img_path}")
    return files


def img2label_paths(im_files: List[str]) -> List[str]:
    """images/ -> labels/, .ext -> .txt (Ultralytics convention)."""
    out = []
    sa = os.sep + "images" + os.sep
    sb = os.sep + "labels" + os.sep
    for p in im_files:
        stem = os.path.splitext(p)[0]
        if sa in p:
            stem = os.path.splitext(sb.join(p.rsplit(sa, 1)))[0]
        out.append(stem + ".txt")
    return out


def load_labels(config, is_val: bool = False, use_rectangle: bool = False,
                ) -> List[LabelRecord]:
    """Scan, parse and eagerly resize a detect, segment, pose or OBB split
    (YoloDataset.cs:153-367). A segment row is a class and a polygon: its
    box spans the polygon's extremes, and the polygon, scaled to the mask
    (ceil(size / mask_ratio)) and truncated to int32, is filled with its
    row's id + 1, later rows over earlier ones. A pose row is a class, a
    box (columns 1-4) and K kd keypoint values from column 5 on, their
    coordinates scaled to resized pixels. An OBB row is a class and 4
    normalised corners: its box spans the corners' extremes, and the
    corners are scaled to resized pixels."""
    task = config.task_type
    if task not in (TaskType.detect, TaskType.segment, TaskType.pose,
                    TaskType.obb):
        raise NotImplementedError(
            f"load_labels reads detect, segment, pose and OBB splits, not "
            f"{task.value}: a classify split is read by "
            f"data.dataset.ClassificationDataset")
    nkpt, ndim = config.keypoint_num, config.keypoint_dim
    imgsz = config.image_size
    mask_ratio = config.mask_ratio
    scan = config.val_data_path if is_val else config.train_data_path
    img_path = os.path.abspath(os.path.join(config.root_path, scan))

    im_files = get_img_files(img_path)
    label_files = img2label_paths(im_files)
    records: List[LabelRecord] = []

    for im_file, label_file in zip(im_files, label_files):
        img = read_image_rgb(im_file)
        org_h, org_w = img.shape[:2]
        ratio = min(imgsz / org_h, imgsz / org_w)
        rh, rw = int(ratio * org_h), int(ratio * org_w)
        img = resize_linear(img, rh, rw)

        rec = LabelRecord(im_file=im_file, img=img, org_shape=(org_h, org_w),
                          resized_shape=(rh, rw), mask_ratio=mask_ratio)
        rows = []
        if os.path.exists(label_file):
            with open(label_file) as f:
                rows = [line.split() for line in f.read().splitlines() if line]

        n = len(rows)
        cls = np.zeros(n, np.float32)
        bboxes = np.zeros((n, 4), np.float32)   # normalized xywh while parsing
        mask = (np.zeros((math.ceil(rh / mask_ratio),
                          math.ceil(rw / mask_ratio)), np.uint8)
                if task == TaskType.segment else None)
        kpts = (np.zeros((n, nkpt, ndim), np.float32)
                if task == TaskType.pose else None)
        corners = (np.zeros((n, 4, 2), np.float32)
                   if task == TaskType.obb else None)
        for i, parts in enumerate(rows):
            vals = [float(v) for v in parts]
            cls[i] = vals[0]
            if kpts is not None:
                kpts[i] = np.asarray(vals[5:5 + nkpt * ndim],
                                     np.float32).reshape(nkpt, ndim)
            if mask is None and corners is None:
                bboxes[i] = vals[1:5]
                continue
            pts = np.asarray(vals[1:9] if corners is not None else vals[1:],
                             np.float32).reshape(-1, 2)
            lo, hi = pts.min(0), pts.max(0)
            bboxes[i] = [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2,
                         hi[0] - lo[0], hi[1] - lo[1]]
            if corners is not None:
                corners[i] = pts
                continue
            poly = np.stack([pts[:, 0] * rw / mask_ratio,
                             pts[:, 1] * rh / mask_ratio], -1)
            fill_poly(mask, poly.astype(np.int32), i + 1)

        # denormalize to resized-image pixels and convert to xyxy
        cxy = bboxes[:, :2] * [rw, rh]
        wh = bboxes[:, 2:] * [rw, rh]
        rec.bboxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
        rec.cls = cls
        if kpts is not None:
            kpts[..., 0] *= rw
            kpts[..., 1] *= rh
            rec.keypoints = kpts
        if corners is not None:
            corners[..., 0] *= rw
            corners[..., 1] *= rh
            rec.obb_corners = corners
        rec.mask = mask
        records.append(rec)

    if use_rectangle or is_val:
        records.sort(key=lambda r: r.resized_shape[0] / r.resized_shape[1])
        bs, stride, pad = config.batch_size, 32, 0.5
        batches, shapes = [], []
        for start in range(0, len(records), bs):
            batch = records[start:start + bs]
            max_w = max(r.resized_shape[1] for r in batch)
            max_h = max(r.resized_shape[0] for r in batch)
            w = int(math.ceil(max_w / stride + pad)) * stride
            h = int(math.ceil(max_h / stride + pad)) * stride
            batches.append(batch)
            shapes.append((h, w))
        shapes = bucket_shapes(shapes,
                               getattr(config, "val_shape_buckets", 4))
        for batch, (h, w) in zip(batches, shapes):
            for r in batch:
                r.rectangle_shape = (h, w)
    return records


def bucket_shapes(shapes, max_buckets: int):
    """Quantize per-batch rectangle shapes to <= max_buckets distinct
    values (elementwise max over contiguous runs of the aspect-sorted batch
    order, so every image still fits), minimising the total padded area by
    dynamic programming over the distinct shapes. 0/None = unchanged. The
    JAX package buckets to bound its compiles; the port keeps it so that
    val sees the same batches."""
    if not max_buckets or len(set(shapes)) <= max_buckets:
        return shapes
    # distinct shapes in order, with batch counts
    distinct, counts = [], []
    for s in shapes:
        if distinct and s == distinct[-1]:
            counts[-1] += 1
        else:
            distinct.append(s)
            counts.append(1)
    n, k = len(distinct), max_buckets

    def seg_cost(i, j):
        """Padded-area cost of merging distinct[i..j] into one bucket."""
        h = max(d[0] for d in distinct[i:j + 1])
        w = max(d[1] for d in distinct[i:j + 1])
        return sum(c * (h * w - d[0] * d[1])
                   for d, c in zip(distinct[i:j + 1], counts[i:j + 1]))

    INF = float("inf")
    best = [[INF] * (k + 1) for _ in range(n + 1)]   # best[i][b]: first i
    back = [[0] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for i in range(1, n + 1):
        for b in range(1, min(i, k) + 1):
            for j in range(b - 1, i):                # last bucket = [j, i)
                c = best[j][b - 1]
                if c < INF:
                    c += seg_cost(j, i - 1)
                    if c < best[i][b]:
                        best[i][b] = c
                        back[i][b] = j
    nb = min(k, n)
    cuts, i = [], n
    for b in range(nb, 0, -1):
        j = back[i][b]
        cuts.append((j, i))
        i = j
    cuts.reverse()
    # emit by distinct-run position, not by shape value: the same (h, w)
    # can appear in two runs assigned to different buckets
    out = []
    for j, i in cuts:
        h = max(d[0] for d in distinct[j:i])
        w = max(d[1] for d in distinct[j:i])
        out.extend([(h, w)] * sum(counts[j:i]))
    return out
