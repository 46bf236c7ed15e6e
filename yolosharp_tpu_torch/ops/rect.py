"""The minimum-area rectangle of small point sets, without cv2: the OBB
labels' corner -> (cx, cy, w, h, angle) conversion (the JAX package's
``ops/boxes.py::xyxyxyxy2xywhr`` calls ``cv2.minAreaRect``, which the card's
machine lacks).

``min_area_rect`` reproduces OpenCV 5.0's ``minAreaRect`` over (N, P, 2)
float32 point sets, vectorised over N (the loops run over the P points and
the hull's edges, never over the N sets): the same convex hull (Sklansky's
scan over the points sorted by x then y, the chains counter-clockwise in
y-up axes, then the cyclic shift that makes the hull's input indices ascend
or descend where they can), the same rotating calipers in float32 (the last
of equal areas wins), and the same conversion to a centre, a size and an
angle in degrees, normalised into [-90, 0) by steps of 90 degrees that swap
the width and the height. Which side is the width follows OpenCV, so the
DFL targets, which depend on it, follow it too: an axis-aligned 10 x 5 box
gives (5, 10) at -90 degrees.

It agrees with OpenCV 5.0 on the hull and on the chosen edge of point sets
in general position (exact area ties included), of integer sets with
duplicate and exactly collinear points, and of squares and axis-aligned
boxes. Two kinds of set are left out of that: a nearly rectangular set whose
edges' areas tie to within float rounding, where OpenCV's own rounding picks
the edge (about 2 % of rotated rectangles with integer-rounded corners get
an edge whose angle is up to 1 degree apart), and a set that is collinear to
within rounding, whose hull may differ.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def _sign(x: np.ndarray) -> np.ndarray:
    return (x > 0).astype(np.int64) - (x < 0).astype(np.int64)


def _take(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """a (N, P, ...) at per-row indices idx (N,) (clipped into range)."""
    idx = np.clip(idx, 0, a.shape[1] - 1)
    return a[np.arange(a.shape[0]), idx]


def _sklansky(sp: np.ndarray, start: np.ndarray, end: np.ndarray,
              nsign: int, sign2: int):
    """One chain of Sklansky's scan over sorted points sp (N, P, 2) from
    start to end (per row): (stack (N, P + 3) of sorted indices, count)."""
    n, p = sp.shape[:2]
    rows = np.arange(n)
    incr = np.where(end > start, 1, -1)
    pprev, pcur = start.copy(), start + incr
    pnext = pcur + incr
    size = np.full(n, 3)
    stack = np.zeros((n, p + 3), np.int64)
    stack[:, 0], stack[:, 1], stack[:, 2] = pprev, pcur, pnext
    trivial = (start == end) | (_take(sp, start) == _take(sp, end)).all(-1)
    stop = end + incr
    active = ~trivial & (pnext != stop)
    while active.any():
        a, c, nx = _take(sp, pprev), _take(sp, pcur), _take(sp, pnext)
        by = nx[:, 1] - c[:, 1]
        ax, bx, ay = c[:, 0] - a[:, 0], nx[:, 0] - c[:, 0], c[:, 1] - a[:, 1]
        convexity = (ay.astype(np.float64) * bx
                     - ax.astype(np.float64) * by)
        turn = active & (_sign(by) != nsign)
        convex = turn & (_sign(convexity) == sign2) & ((ax != 0) | (ay != 0))
        first = turn & ~convex & (pprev == start)
        back = turn & ~convex & (pprev != start)
        skip = active & ~turn
        # convex: push
        r = rows[convex]
        pprev[r], pcur[r], pnext[r] = pcur[r], pnext[r], pnext[r] + incr[r]
        stack[r, size[r]] = pnext[r]
        size[r] += 1
        # concave at the start: drop the middle point
        r = rows[first]
        pcur[r] = pnext[r]
        stack[r, 1] = pcur[r]
        pnext[r] += incr[r]
        stack[r, 2] = pnext[r]
        # concave: pop
        r = rows[back]
        stack[r, size[r] - 2] = pnext[r]
        pcur[r] = pprev[r]
        pprev[r] = stack[r, size[r] - 4]
        size[r] -= 1
        # no turn possible on this side: skip the point
        r = rows[skip]
        pnext[r] += incr[r]
        stack[r, size[r] - 1] = pnext[r]
        active &= pnext != stop
    stack[trivial, 0] = start[trivial]
    return stack, np.where(trivial, 1, size - 1)


def convex_hull_indices(pts: np.ndarray):
    """OpenCV's convexHull(clockwise=False) of each point set (N, P, 2)
    float32, as minAreaRect takes it (counter-clockwise in y-up axes):
    (hull (N, K) input indices, the first `count` of each row valid;
    count (N,))."""
    n, p = pts.shape[:2]
    rows = np.arange(n)
    order = np.lexsort((pts[..., 1], pts[..., 0]), axis=-1)     # stable
    sp = pts[rows[:, None], order]
    miny = sp[..., 1].argmin(-1)
    maxy = sp[..., 1].argmax(-1)
    zero, last = np.zeros(n, np.int64), np.full(n, p - 1)
    hull = np.zeros((n, 2 * p + 4), np.int64)
    nout = np.zeros(n, np.int64)

    def emit(vals, mask):
        hull[rows[mask], nout[mask]] = order[rows[mask], vals[mask]]
        nout[mask] += 1

    def chains(left, lcount, right, rcount, keep):
        for i in range(p + 2):
            emit(left[:, min(i, left.shape[1] - 1)], keep & (i < lcount - 1))
        for i in range(p + 2, 0, -1):
            emit(right[:, min(i, right.shape[1] - 1)],
                 keep & (i <= rcount - 1))

    same = (sp[:, 0] == sp[:, p - 1]).all(-1)
    emit(zero, same)
    # counter-clockwise: the upper chain from the right end first
    tr, trc = _sklansky(sp, zero, maxy, -1, 1)
    tl, tlc = _sklansky(sp, last, maxy, -1, -1)
    chains(tl, tlc, tr, trc, ~same)
    stop_idx = np.where(trc > 2, tr[:, 1],
                        np.where(tlc > 2, _take(tl[..., None],
                                                tlc - 2)[:, 0], -1))
    bl, blc = _sklansky(sp, zero, miny, 1, -1)
    br, brc = _sklansky(sp, last, miny, 1, 1)
    check = np.where(blc > 2, bl[:, 1],
                     np.where(blc + brc > 2,
                              _take(br[..., None], 2 - blc)[:, 0], -1))
    mirrored = (stop_idx >= 0) & (
        (check == stop_idx)
        | ((check >= 0) & (_take(sp, check) == _take(sp, stop_idx)).all(-1)))
    blc = np.where(mirrored, np.minimum(blc, 2), blc)
    brc = np.where(mirrored, np.minimum(brc, 2), brc)
    chains(bl, blc, br, brc, ~same)
    return _ascending_shift(hull[:, :max(int(nout.max()), 1)], nout), nout


def _ascending_shift(hull: np.ndarray, nout: np.ndarray) -> np.ndarray:
    """OpenCV's cyclic shift of a hull (N, K) of input indices (its first
    nout valid) that makes the indices ascend or descend where a shift
    can."""
    n, k = hull.shape
    rows = np.arange(n)
    if k < 3:
        return hull
    min_i = np.zeros(n, np.int64)
    max_i = np.zeros(n, np.int64)
    lt = np.zeros(n, np.int64)
    alive = nout >= 3
    for i in range(1, k):
        go = alive & (i < nout)
        idx = hull[:, i]
        lt += go & (hull[:, i - 1] < idx)
        alive &= ~(go & (lt > 1) & (lt <= i - 2))
        go &= alive
        min_i = np.where(go & (idx < hull[rows, min_i]), i, min_i)
        max_i = np.where(go & (idx > hull[rows, max_i]), i, max_i)
    dist = np.abs(max_i - min_i)
    ok = ((nout >= 3) & ((dist == 1) | (dist == nout - 1))
          & ((lt <= 1) | (lt >= nout - 2)))
    asc = (max_i + 1) % np.maximum(nout, 1) == min_i
    i0 = np.where(asc, min_i, max_i)
    ok &= i0 > 0
    out = np.zeros_like(hull)
    j = i0.copy()
    good = ok.copy()
    for i in range(k):
        go = good & (i < nout)
        cur = hull[rows, j]
        out[go, i] = cur[go]
        nj = np.where(j + 1 < nout, j + 1, 0)
        nxt = hull[rows, nj]
        good &= ~(go & (i < nout - 1) & (asc != (cur < nxt)))
        j = np.where(go, nj, j)
    return np.where(good[:, None], out, hull)


def _calipers(pts: np.ndarray):
    """OpenCV's rotatingCalipers(CALIPERS_MINAREARECT) over convex hulls
    pts (N, n, 2) float32, n >= 3: the corner, the width vector and the
    height vector of each minimum-area rectangle, float32 (N, 2) each."""
    m, n = pts.shape[:2]
    rows = np.arange(m)
    nxt = np.roll(pts, -1, axis=1)
    d = nxt - pts                                   # float32 differences
    d64 = d.astype(np.float64)
    inv_len = (1.0 / np.sqrt(d64[..., 0] ** 2 + d64[..., 1] ** 2)).astype(_F)
    # the first extremes, scanning from point 0 with strict comparisons
    x, y = pts[..., 0], pts[..., 1]
    left, right = x.argmin(-1), x.argmax(-1)
    top, bottom = y.argmax(-1), y.argmin(-1)
    # hull orientation: the first non-zero cross product of successive edges
    prev = np.roll(d64, 1, axis=1)
    cross = prev[..., 0] * d64[..., 1] - prev[..., 1] * d64[..., 0]
    first = (cross != 0).argmax(-1)
    orient = np.where(cross[rows, first] > 0, _F(1), _F(-1))
    base_a, base_b = orient.astype(_F), np.zeros(m, _F)
    seq = np.stack([bottom, right, top, left], -1)
    min_area = np.full(m, np.finfo(_F).max, _F)
    best = np.zeros((m, 4), _F)                    # a, width, b, height
    best_left = np.zeros(m, np.int64)
    best_bottom = np.zeros(m, np.int64)
    for _ in range(n):
        vx = [d[rows, seq[:, i], 0] for i in range(4)]
        vy = [d[rows, seq[:, i], 1] for i in range(4)]
        dp = [base_a * vx[0] + base_b * vy[0],
              -base_b * vx[1] + base_a * vy[1],
              -base_a * vx[2] - base_b * vy[2],
              base_b * vx[3] - base_a * vy[3]]
        main = np.zeros(m, np.int64)
        maxcos = dp[0] * inv_len[rows, seq[:, 0]]
        for i in range(1, 4):
            cos = dp[i] * inv_len[rows, seq[:, i]]
            better = cos > maxcos
            main = np.where(better, i, main)
            maxcos = np.where(better, cos, maxcos)
        pidx = seq[rows, main]
        lead_x = d[rows, pidx, 0] * inv_len[rows, pidx]
        lead_y = d[rows, pidx, 1] * inv_len[rows, pidx]
        base_a = np.select([main == 0, main == 1, main == 2],
                           [lead_x, lead_y, -lead_x], -lead_y).astype(_F)
        base_b = np.select([main == 0, main == 1, main == 2],
                           [lead_y, -lead_x, -lead_y], lead_x).astype(_F)
        seq[rows, main] = (seq[rows, main] + 1) % n
        p0, p1, p2, p3 = (pts[rows, seq[:, i]] for i in range(4))
        dx, dy = p1[:, 0] - p3[:, 0], p1[:, 1] - p3[:, 1]
        width = dx * base_a + dy * base_b
        dx, dy = p2[:, 0] - p0[:, 0], p2[:, 1] - p0[:, 1]
        height = -dx * base_b + dy * base_a
        area = width * height
        take = area <= min_area
        min_area = np.where(take, area, min_area)
        best_left = np.where(take, seq[:, 3], best_left)
        best_bottom = np.where(take, seq[:, 0], best_bottom)
        best = np.where(take[:, None],
                        np.stack([base_a, width, base_b, height], -1), best)
    a1, width, b1, height = best[:, 0], best[:, 1], best[:, 2], best[:, 3]
    a2, b2 = -b1, a1
    pl, pb = pts[rows, best_left], pts[rows, best_bottom]
    c1 = a1 * pl[:, 0] + pl[:, 1] * b1
    c2 = a2 * pb[:, 0] + pb[:, 1] * b2
    idet = _F(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (np.stack([px, py], -1), np.stack([a1 * width, b1 * width], -1),
            np.stack([a2 * height, b2 * height], -1))


def min_area_rect(points) -> np.ndarray:
    """OpenCV 5.0's minAreaRect of each point set (N, P, 2) (cast to
    float32): (N, 5) float32 (cx, cy, w, h, angle in degrees in [-90, 0))."""
    pts = np.asarray(points, _F)
    n = pts.shape[0]
    out = np.zeros((n, 5), _F)
    if n == 0:
        return out
    hull, count = convex_hull_indices(pts)
    hp = pts[np.arange(n)[:, None], hull]           # (N, K, 2)
    ang = np.zeros(n, _F)                           # radians, as float
    for k in np.unique(count):
        r = np.flatnonzero(count == k)
        h = hp[r, :k]
        if k > 2:
            o0, o1, o2 = _calipers(h)
            out[r, 0] = o0[:, 0] + (o1[:, 0] + o2[:, 0]) * _F(0.5)
            out[r, 1] = o0[:, 1] + (o1[:, 1] + o2[:, 1]) * _F(0.5)
            v1, v2 = o1.astype(np.float64), o2.astype(np.float64)
            out[r, 2] = np.sqrt(v1[:, 0] ** 2 + v1[:, 1] ** 2)
            out[r, 3] = np.sqrt(v2[:, 0] ** 2 + v2[:, 1] ** 2)
            ang[r] = np.arctan2(v1[:, 1], v1[:, 0])
        elif k == 2:
            out[r, :2] = (h[:, 0] + h[:, 1]) * _F(0.5)
            dd = (h[:, 1] - h[:, 0]).astype(np.float64)
            out[r, 2] = np.sqrt(dd[:, 0] ** 2 + dd[:, 1] ** 2)
            ang[r] = np.arctan2(dd[:, 1], dd[:, 0])
        else:
            out[r, :2] = h[:, 0]
    deg = (ang.astype(np.float64) * 180 / np.pi).astype(_F)
    # into [-90, 0), each step of 90 degrees swapping the sides
    for _ in range(4):
        up = deg >= 0
        down = deg < -90
        flip = up | down
        deg = np.where(up, deg - _F(90), np.where(down, deg + _F(90), deg))
        out[flip, 2], out[flip, 3] = out[flip, 3], out[flip, 2].copy()
    out[:, 4] = deg
    return out
