"""The mosaic train augmentation as one batched render: the host plans,
the device renders (a copy of yolosharp_tpu/data/device_augment.py: the
numpy planner verbatim, the gather render in torch).

The host only draws the random parameters and runs the label geometry, the
numpy formulas of ``augment.py`` (mosaic4, random_perspective, the flips):
``plan_mosaic_batch`` draws in the same order from the same
``np.random.Generator`` as the JAX package and returns equal arrays. The
pixels are rendered on the device, batched over the images:

  out[p] = HSV( sample( src[tile(q)], q - pad[tile(q)] ) ),
  q = M^-1 @ flip(p)

the mosaic canvas compose (Augment.cs:147-275) fused with the
RandomPerspective warp (Augment.cs:395-538) and the flips into a single
bilinear gather with a 114 border. Against the host path (mosaic4 +
random_perspective) the pixels differ only on 1-px tile seams, where cv2's
warp blends across tiles and this render clamps into the border.

Partner sampling: by default mosaic partners are drawn from the current
batch (the reference draws dataset-wide, YoloDataset.cs:65);
``Config.mosaic_partner_pool = E`` ships E extra images drawn from the
whole dataset and draws partners from the enlarged pool
(``plan_mosaic_batch``'s extras_per_group).

The render is plain PyTorch on the pool's device (the JAX package's is jnp
code, not a Pallas kernel): every op runs on (B, s*s) tensors, with int64
flat gather offsets. The segment masks render the same way at 1 /
mask_ratio (``mosaic_perspective_masks``): each mask pixel maps through the
same flip and M^-1 at full-resolution canvas coordinates, picks its tile
by the same strict comparisons, samples its tile's id pool nearest
(rounded half to even) and remaps the tile-local id through the plan's
``mask_lut`` to the sample's final 1..n id. The packed and separable
renders of the JAX package are TPU layout variants and are not ported.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from .labels import LabelRecord

# the batch keys of a planned batch (YoloDataset.device_batch) in the
# order mosaic_perspective_images takes them
PLAN_KEYS = ("aug_src_idx", "aug_rects", "aug_pads", "aug_minv",
             "aug_persp", "aug_flips", "aug_hsv")
FILL = 114.0


class MosaicPlan(NamedTuple):
    """Per-batch device augmentation parameters (all numpy, batch-leading)."""

    src_idx: np.ndarray    # (B, 4) int32 — batch positions of the 4 tiles
    rects: np.ndarray      # (B, 4, 4) f32 — canvas [x1a, y1a, x2a, y2a]
    pads: np.ndarray       # (B, 4, 2) f32 — (padw, padh) canvas->src shift
    minv: np.ndarray       # (B, 3, 3) f32 — inverse perspective matrix
    persp: np.ndarray      # (B,) f32 — 1.0 when perspective division needed
    flips: np.ndarray      # (B, 2) f32 — (fliplr, flipud) 0/1
    hsv: np.ndarray        # (B, 3) f32 — (brightness, saturation, hue) gains
    mask_lut: np.ndarray   # (B, 4, 256) int32 — per-tile instance-id remap


def _area(b: np.ndarray) -> np.ndarray:
    return (np.clip(b[:, 2] - b[:, 0], 0, None)
            * np.clip(b[:, 3] - b[:, 1], 0, None))


def _mosaic_rects(xc: int, yc: int, shapes: Sequence, s: int):
    """The 4 tile placements of Augment.cs:158-199 / augment.py:mosaic4."""
    out = []
    for i, (h, w) in enumerate(shapes):
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:
            x1a, y1a = xc, max(yc - h, 0)
            x2a, y2a = min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:
            x1a, y1a = max(xc - w, 0), yc
            x2a, y2a = xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
        out.append((x1a, y1a, x2a, y2a, x1a - x1b, y1a - y1b))
    return out


def _perspective_matrix(img_h: int, img_w: int, out_w: int, out_h: int,
                        cfg, rng) -> tuple:
    """The C/P/R/S/T chain of augment.py:random_perspective (same rng
    draw order so host and device paths are statistically identical)."""
    C = np.eye(3, dtype=np.float32)
    C[0, 2] = -img_w / 2
    C[1, 2] = -img_h / 2
    P = np.eye(3, dtype=np.float32)
    P[2, 0] = rng.uniform(-1, 1) * cfg.perspective
    P[2, 1] = rng.uniform(-1, 1) * cfg.perspective
    R = np.eye(3, dtype=np.float32)
    a = rng.uniform(-1, 1) * cfg.degrees
    sc = 1 + rng.uniform(-1, 1) * cfg.scale
    rad = math.radians(a)
    alpha, beta = math.cos(rad) * sc, math.sin(rad) * sc
    R[:2] = [[alpha, beta, 0], [-beta, alpha, 0]]
    S = np.eye(3, dtype=np.float32)
    S[0, 1] = math.tan(rng.uniform(-1, 1) * cfg.shear * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-1, 1) * cfg.shear * math.pi / 180)
    T = np.eye(3, dtype=np.float32)
    T[0, 2] = (0.5 + rng.uniform(-1, 1) * cfg.translate) * out_w
    T[1, 2] = (0.5 + rng.uniform(-1, 1) * cfg.translate) * out_h
    return T @ S @ R @ P @ C, cfg.perspective > 0


def plan_mosaic_batch(records: List[LabelRecord], cfg, rng,
                      group: int = 0, extras_per_group: int = 0) -> tuple:
    """Host planning: random draws + exact label geometry for one batch.

    records: the batch's (already decoded+resized) records. group > 0
    keeps each sample's mosaic partners inside its own group of that size
    (data-parallel shards must not gather tiles across devices). Returns
    (MosaicPlan, labels) where labels is a list of per-sample label-only
    LabelRecords (img/mask set to None — pixels come from the device).

    extras_per_group > 0 enables DATASET-WIDE partner sampling (the
    reference's distribution, YoloDataset.cs:65): records must then be in
    per-group block layout — n_groups blocks of (group + extras) records,
    where each block's first `group` entries are the output samples and
    the rest are partner-only extras drawn from the whole dataset by the
    caller. Partners are drawn uniformly from the sample's full block.
    """
    E = extras_per_group
    s = cfg.image_size
    border = -s // 2
    out_w = out_h = s  # 2s + 2*border

    if E > 0:
        gs = group if group and group > 0 else len(records) - E
        block = gs + E
        assert len(records) % block == 0, (len(records), gs, E)
        b = (len(records) // block) * gs          # output samples
    else:
        b = len(records)
        gs = group if group and group > 0 else b

    src_idx = np.zeros((b, 4), np.int32)
    rects = np.zeros((b, 4, 4), np.float32)
    pads = np.zeros((b, 4, 2), np.float32)
    minv = np.zeros((b, 3, 3), np.float32)
    persp = np.zeros((b,), np.float32)
    flips = np.zeros((b, 2), np.float32)
    hsv = np.zeros((b, 3), np.float32)
    mask_lut = np.zeros((b, 4, 256), np.int32)
    labels: List[LabelRecord] = []

    for i in range(b):
        if E > 0:
            g, j = divmod(i, gs)
            base = g * (gs + E)
            mpos = base + j
            picks = base + rng.integers(0, gs + E, 3)
        else:
            mpos = i
            g0 = (i // gs) * gs
            picks = g0 + rng.integers(0, min(gs, len(records) - g0), 3)
        main = records[mpos]
        idx4 = np.array([mpos, *picks], np.int32)
        src_idx[i] = idx4
        yc = int(rng.integers(-border, 2 * s + border))
        xc = int(rng.integers(-border, 2 * s + border))
        tiles = [records[j] for j in idx4]
        placements = _mosaic_rects(xc, yc,
                                   [t.resized_shape for t in tiles], s)

        # ---- mosaic label pass (augment.py:mosaic4 labels)
        cls_l, box_l, kpt_l, cor_l = [], [], [], []
        tile_of, local_of = [], []   # per-gt provenance for the mask LUT
        for k, (rec, (x1a, y1a, x2a, y2a, padw, padh)) in enumerate(
                zip(tiles, placements)):
            rects[i, k] = (x1a, y1a, x2a, y2a)
            pads[i, k] = (padw, padh)
            n = 0 if rec.cls is None else len(rec.cls)
            if n == 0:
                continue
            cls_l.append(rec.cls)
            box_l.append(rec.bboxes + [padw, padh, padw, padh])
            if rec.keypoints is not None:
                kk = rec.keypoints.copy()
                kk[..., 0] += padw
                kk[..., 1] += padh
                kpt_l.append(kk)
            if rec.obb_corners is not None:
                cc = rec.obb_corners.copy()
                cc[..., 0] += padw
                cc[..., 1] += padh
                cor_l.append(cc)
            tile_of.extend([k] * n)
            local_of.extend(range(1, n + 1))

        cls = np.concatenate(cls_l) if cls_l else np.zeros(0, np.float32)
        boxes = (np.concatenate(box_l) if box_l
                 else np.zeros((0, 4), np.float32))
        org_areas = _area(boxes)
        boxes = np.clip(boxes, 0, 2 * s)
        good1 = (_area(boxes) > 0) & (_area(boxes) > 0.7 * org_areas)
        kpts = np.concatenate(kpt_l) if kpt_l else None
        cors = np.concatenate(cor_l) if cor_l else None
        tile_of = np.asarray(tile_of, np.int32)
        local_of = np.asarray(local_of, np.int32)

        cls, boxes = cls[good1], boxes[good1]
        kpts = kpts[good1] if kpts is not None else None
        cors = cors[good1] if cors is not None else None
        tile_of, local_of = tile_of[good1], local_of[good1]

        # ---- perspective (augment.py:random_perspective labels)
        M, has_p = _perspective_matrix(2 * s, 2 * s, out_w, out_h, cfg, rng)
        minv[i] = np.linalg.inv(M)
        persp[i] = float(has_p)
        n = len(cls)
        if n:
            corner_idx = [0, 1, 2, 3, 0, 3, 2, 1]
            pts = boxes[:, corner_idx].reshape(-1, 2)
            ones = np.ones((pts.shape[0], 1), np.float32)
            xy = np.concatenate([pts, ones], 1) @ M.T
            xy = (xy[:, :2] / xy[:, 2:3]) if has_p else xy[:, :2]
            xy = xy.reshape(n, 4, 2)
            nb = np.concatenate([xy.min(1), xy.max(1)], 1)
            nb[:, [0, 2]] = nb[:, [0, 2]].clip(0, out_w)
            nb[:, [1, 3]] = nb[:, [1, 3]].clip(0, out_h)
            good2 = _area(nb) > 0

            if kpts is not None:
                nk = kpts.shape[1]
                pts = kpts[..., :2].reshape(-1, 2)
                xy = np.concatenate(
                    [pts, np.ones((pts.shape[0], 1), np.float32)], 1) @ M.T
                xy = xy[:, :2] / xy[:, 2:3]
                vis = (kpts[..., 2].reshape(-1).copy()
                       if kpts.shape[-1] == 3 else np.ones(len(xy)))
                oob = ((xy[:, 0] < 0) | (xy[:, 1] < 0)
                       | (xy[:, 0] > out_w) | (xy[:, 1] > out_h))
                vis[oob] = 0
                kt = np.concatenate([xy, vis[:, None]], 1).reshape(n, nk, 3)
                kt[..., 0] = kt[..., 0].clip(0, out_w)
                kt[..., 1] = kt[..., 1].clip(0, out_h)
                kpts = kt[..., :kpts.shape[-1]]
            if cors is not None:
                c2 = cors.reshape(-1, 2)
                xy = np.concatenate(
                    [c2, np.ones((c2.shape[0], 1), np.float32)], 1) @ M.T
                xy = (xy[:, :2] / xy[:, 2:3]) if has_p else xy[:, :2]
                ct = xy.reshape(n, 4, 2)
                ct[..., 0] = ct[..., 0].clip(0, out_w)
                ct[..., 1] = ct[..., 1].clip(0, out_h)
                cors = ct

            cls, boxes = cls[good2], nb[good2]
            kpts = kpts[good2] if kpts is not None else None
            cors = cors[good2] if cors is not None else None
            tile_of, local_of = tile_of[good2], local_of[good2]

        # composed instance-id LUT: tile-local id -> final 1..n id
        for j, (tk, lk) in enumerate(zip(tile_of, local_of)):
            mask_lut[i, tk, lk] = j + 1

        # ---- flips + HSV draws (label flips mirror augment.py:flip_*)
        do_lr = cfg.flip_lr > 0 and rng.uniform() <= cfg.flip_lr
        do_ud = cfg.flip_ud > 0 and rng.uniform() <= cfg.flip_ud
        flips[i] = (float(do_lr), float(do_ud))
        if do_lr and len(boxes):
            x1 = out_w - boxes[:, 2].copy()
            x2 = out_w - boxes[:, 0].copy()
            boxes[:, 0], boxes[:, 2] = x1, x2
            if kpts is not None:
                kpts[..., 0] = out_w - kpts[..., 0]
            if cors is not None:
                cors[..., 0] = out_w - cors[..., 0]
        if do_ud and len(boxes):
            y1 = out_h - boxes[:, 3].copy()
            y2 = out_h - boxes[:, 1].copy()
            boxes[:, 1], boxes[:, 3] = y1, y2
            if kpts is not None:
                kpts[..., 1] = out_h - kpts[..., 1]
            if cors is not None:
                cors[..., 1] = out_h - cors[..., 1]
        hsv[i] = (rng.uniform(max(0, 1 - cfg.hsv_v), 1 + cfg.hsv_v),
                  rng.uniform(max(0, 1 - cfg.hsv_s), 1 + cfg.hsv_s),
                  rng.uniform(-cfg.hsv_h, cfg.hsv_h))

        lab = LabelRecord(im_file=main.im_file, img=None,
                          org_shape=main.org_shape,
                          resized_shape=(out_h, out_w),
                          mask_ratio=main.mask_ratio)
        lab.cls = cls
        lab.bboxes = boxes
        lab.keypoints = kpts
        lab.obb_corners = cors
        lab.mask = None       # device-sampled
        labels.append(lab)

    return MosaicPlan(src_idx, rects, pads, minv, persp, flips, hsv,
                      mask_lut), labels


# ---------------------------------------------------------------------------
# device side (torch, batched over the images)


def _rgb_planes_to_hsv(r, g, b):
    """cv2-convention float HSV of [0, 255] RGB planes: H in [0, 180), S and
    V in [0, 255]."""
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    safe = torch.where(diff > 0, diff, 1.0)
    h = torch.where(mx == r, (g - b) / safe * 30.0,
                    torch.where(mx == g, 60.0 + (b - r) / safe * 30.0,
                                120.0 + (r - g) / safe * 30.0))
    # jnp % is floor-mod: torch.remainder, not torch.fmod
    h = torch.where(diff > 0, torch.remainder(h, 180.0), 0.0)
    s = torch.where(mx > 0, diff / torch.where(mx > 0, mx, 1.0) * 255.0, 0.0)
    return h, s, mx


# which of (v, q, p, t) each of r, g, b takes in hue sector 0..5
_SECTOR_PICK = ((0, 1, 2, 2, 3, 0), (3, 0, 0, 1, 2, 2), (2, 2, 3, 0, 0, 1))


def _hsv_to_rgb_planes(h, s, v):
    h = torch.remainder(h, 180.0) / 30.0          # sector in [0, 6)
    i = torch.floor(h)
    f = h - i
    s = s / 255.0
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    sector = torch.remainder(i.to(torch.int64), 6)
    cands = torch.stack([v, q, p, t])
    pick = torch.tensor(_SECTOR_PICK, device=h.device)
    return tuple(torch.gather(cands, 0, pick[c][sector][None])[0]
                 for c in range(3))


def apply_hsv(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """ColorJitter-style jitter (augment.random_hsv's semantics) on float
    [0, 255] RGB images (B, ..., 3); gains (B, 3) = (brightness,
    saturation, hue) per image."""
    g = gains.view(gains.shape[0], *([1] * (img.dim() - 2)), 3)
    h, s, v = _rgb_planes_to_hsv(img[..., 0], img[..., 1], img[..., 2])
    v = torch.clamp(v * g[..., 0], 0, 255)
    s = torch.clamp(s * g[..., 1], 0, 255)
    h = torch.remainder(h + g[..., 2] * 180.0, 180.0)
    return torch.clamp(torch.stack(_hsv_to_rgb_planes(h, s, v), -1), 0, 255)


def _sample_bilinear(pool_flat, page, sy, sx, s: int, fill: float):
    """Bilinear samples at (sy, sx) of pages ``page`` of pool_flat
    ((P*s*s, C) uint8): (..., C) float32, corners outside the page taking
    ``fill`` (cv2's constant border)."""
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    base = page.to(torch.int64) * s

    def corner(iy, ix):
        ok = (ix >= 0) & (ix < s) & (iy >= 0) & (iy < s)
        flat = (base + iy.clamp(0, s - 1)) * s + ix.clamp(0, s - 1)
        vals = pool_flat[flat].to(torch.float32)
        return torch.where(ok[..., None], vals, fill)

    v00 = corner(y0i, x0i)
    v01 = corner(y0i, x0i + 1)
    v10 = corner(y0i + 1, x0i)
    v11 = corner(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _canvas_points(src_idx, rects, pads, minv, persp, flips, n: int,
                   scale: float):
    """For every point p of an n x n grid (row-major) of every image: its
    tile (0..3, or 4 outside all rects), the pool page it reads and its
    source coordinate in that page, canvas (B, n*n) tensors. The grid maps
    to the full-resolution canvas at ``scale`` (the mask ratio; 1 for the
    images): flip (array-index mirror) -> scale -> M^-1 -> tile select
    (the first rect that holds the point, strict < at the far edges) ->
    minus the tile's pad, in JAX's operation order."""
    dev = minv.device
    ar = torch.arange(n, dtype=torch.float32, device=dev)
    xs = ar.repeat(n)                    # grid point p = y * n + x
    ys = ar.repeat_interleave(n)
    col = lambda t: t[:, None]          # noqa: E731  (B,) -> (B, 1)
    px = torch.where(col(flips[:, 0]) > 0, (n - 1) - xs, xs) * scale
    py = torch.where(col(flips[:, 1]) > 0, (n - 1) - ys, ys) * scale
    mi = [[col(minv[:, r, c]) for c in range(3)] for r in range(3)]
    qx = mi[0][0] * px + mi[0][1] * py + mi[0][2]
    qy = mi[1][0] * px + mi[1][1] * py + mi[1][2]
    qz = mi[2][0] * px + mi[2][1] * py + mi[2][2]
    z = torch.where(col(persp) > 0, qz, 1.0)
    qx = qx / z
    qy = qy / z
    tile = torch.full_like(qx, 4, dtype=torch.int64)
    for k in reversed(range(4)):
        inr = ((qx >= col(rects[:, k, 0])) & (qx < col(rects[:, k, 2]))
               & (qy >= col(rects[:, k, 1])) & (qy < col(rects[:, k, 3])))
        tile = torch.where(inr, k, tile)
    tile_c = tile.clamp(0, 3)
    page = torch.gather(src_idx.to(torch.int64), 1, tile_c)
    sx = qx - torch.gather(pads[:, :, 0], 1, tile_c)
    sy = qy - torch.gather(pads[:, :, 1], 1, tile_c)
    return tile, page, sx, sy


def mosaic_perspective_images(pool: torch.Tensor, plan_arrays,
                              imgsz: int) -> torch.Tensor:
    """(P, s, s, 3) uint8 source pool + the plan's tensors (PLAN_KEYS order,
    on the pool's device) -> (B, s, s, 3) float32 images in [0, 255],
    unrounded: flip -> M^-1 -> tile select -> bilinear gather -> HSV, for
    every image of the batch at once."""
    s = imgsz
    *geometry, hsv = plan_arrays
    tile, page, sx, sy = _canvas_points(*geometry, s, 1.0)
    vals = _sample_bilinear(pool.reshape(-1, pool.shape[-1]), page, sy, sx,
                            s, FILL)
    img = torch.where((tile < 4)[..., None], vals, FILL)
    return apply_hsv(img, hsv).reshape(-1, s, s, pool.shape[-1])


def mosaic_perspective_masks(mask_pool: torch.Tensor, plan_arrays,
                             imgsz: int, mask_ratio: int) -> torch.Tensor:
    """(P, s/r, s/r) uint8 pool of tile-local instance ids + the plan's
    tensors (PLAN_KEYS order with ``aug_mask_lut`` for ``aug_hsv``) ->
    (B, s/r, s/r) float32 overlap ids of the rendered samples: nearest
    sampling (0 outside the page or every tile), then the per-tile LUT."""
    r = mask_ratio
    sm = imgsz // r
    *geometry, lut = plan_arrays
    tile, page, sx, sy = _canvas_points(*geometry, sm, float(r))
    ix = torch.round(sx / r).to(torch.int64)
    iy = torch.round(sy / r).to(torch.int64)
    ok = (tile < 4) & (ix >= 0) & (ix < sm) & (iy >= 0) & (iy < sm)
    flat = (page * sm + iy.clamp(0, sm - 1)) * sm + ix.clamp(0, sm - 1)
    ids = torch.where(ok, mask_pool.reshape(-1)[flat].to(torch.int64), 0)
    b = ids.shape[0]
    rows = torch.arange(b, device=ids.device)[:, None]
    out = lut.to(torch.int64)[rows, tile.clamp(0, 3), ids.clamp(0, 255)]
    return out.reshape(b, sm, sm).to(torch.float32)


def render_batch(batch) -> torch.Tensor:
    """The planned batch's images (B, s, s, 3) float32 in [0, 255], on the
    device of its ``aug_pool``."""
    pool = batch["aug_pool"]
    return mosaic_perspective_images(
        pool, tuple(batch[k] for k in PLAN_KEYS), pool.shape[1])


def render_masks(batch) -> torch.Tensor:
    """The planned batch's overlap-id masks (B, s/r, s/r) float32, from its
    ``aug_mask_pool`` and ``aug_mask_lut``."""
    pool = batch["aug_mask_pool"]
    s = batch["aug_pool"].shape[1]
    keys = PLAN_KEYS[:-1] + ("aug_mask_lut",)
    return mosaic_perspective_masks(pool, tuple(batch[k] for k in keys), s,
                                    s // pool.shape[1])
