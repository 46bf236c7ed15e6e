"""Validation metrics: TP matching at 10 IoU thresholds + mAP (ap_per_class).
A copy of yolosharp_tpu/utils/metrics.py (numpy only).

Functional parity targets: Models/YoloBaseTaskModel.cs:377-446
(match_predictions incl. greedy unique matching) and Utils/Metrics.cs:308-486
(ap_per_class, compute_ap 101-pt COCO interp, interp, smooth). Host-side
numpy: inputs are the small post-NMS tensors (<=300 rows/image), where the
reference's per-element torch loops (GetUniqueByColumn) were the bottleneck.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# float32 like the reference's torch.linspace (YoloBaseTaskModel.cs:382):
# the >= threshold comparison at exact boundary IoUs (e.g. 0.9) flips if
# the thresholds are float64 (0.9f = 0.89999998 < 0.9)
IOUV = np.linspace(0.5, 0.95, 10).astype(np.float32)
# numpy < 2 names it trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def match_predictions(pred_classes: np.ndarray, true_classes: np.ndarray,
                      iou: np.ndarray) -> np.ndarray:
    """TP matrix (N_pred, 10) over IoU thresholds 0.50:0.95.

    iou: (M_gt, N_pred) pairwise IoU. Greedy unique matching: candidate pairs
    sorted by IoU desc, deduplicated first by prediction then by gt (first
    occurrence kept), per threshold.
    """
    n = pred_classes.shape[0]
    correct = np.zeros((n, IOUV.size), bool)
    if n == 0 or true_classes.shape[0] == 0:
        return correct
    iou = iou * (true_classes[:, None] == pred_classes[None, :])
    for ti, thr in enumerate(IOUV):
        gt_i, pred_i = np.nonzero(iou >= thr)
        if gt_i.size == 0:
            continue
        order = np.argsort(-iou[gt_i, pred_i], kind="stable")
        gt_i, pred_i = gt_i[order], pred_i[order]
        # GetUniqueByColumn (YoloBaseTaskModel.cs:423-445): keep the first
        # occurrence of each unique column value, REORDERING rows to
        # unique-value-ascending order (index_select over firstOccurrence).
        # Consequence: the pred dedup keeps the highest-IoU gt per pred,
        # but the subsequent gt dedup — acting on the pred-ascending
        # reordered rows — keeps the LOWEST-INDEX pred per gt, not the
        # highest-IoU one. np.unique(return_index) has exactly these
        # semantics (first occurrence, unique-sorted arrangement).
        _, first = np.unique(pred_i, return_index=True)
        gt_i, pred_i = gt_i[first], pred_i[first]
        _, first = np.unique(gt_i, return_index=True)
        pred_i = pred_i[first]
        correct[pred_i, ti] = True
    return correct


def interp(x: np.ndarray, xp: np.ndarray, fp: np.ndarray,
           left: float = 0.0) -> np.ndarray:
    """Linear interpolation with the reference's boundary semantics
    (Metrics.cs:425-470): x >= xp[-1] -> fp[-1], then x <= xp[0] -> left
    (left fill wins on overlap, and — unlike np.interp — applies at
    x == xp[0] exactly; compute_ap relies on this at recall sentinel 0)."""
    order = np.argsort(xp, kind="stable")
    xs, fs = xp[order], fp[order]
    # interior exactly as the reference: searchsorted(left) - 1, clamped.
    # NOT np.interp — they differ at x values equal to a DUPLICATED xp
    # entry (recall plateaus hit the 101-pt grid): the reference lands
    # t=1 on the FIRST duplicate's fp, np.interp returns the last's.
    idx = np.clip(np.searchsorted(xs, x, side="left") - 1, 0, len(xs) - 2)
    x0, x1 = xs[idx], xs[idx + 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(x1 > x0, (x - x0) / np.where(x1 > x0, x1 - x0, 1.0), 1.0)
    res = fs[idx] + t * (fs[idx + 1] - fs[idx])
    res = np.where(x >= xs[-1], fs[-1], res)
    return np.where(x <= xs[0], left, res)


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box filter of fraction f (Metrics.cs:475-486; note the reference
    TRUNCATES len*f*2 before the odd-width fixup)."""
    nf = int(len(y) * f * 2) // 2 * 2 + 1
    p = np.ones(nf // 2) * y[0]
    yp = np.concatenate([p, y, p])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray
               ) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point COCO-interp AP (Metrics.cs:396-422)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    # reference integrand uses its own interp with left=0 (Metrics.cs:417):
    # the x=0 sample reads the left fill (0), NOT the precision envelope
    ap = float(_trapezoid(interp(x, mrec, mpre, left=0.0), x))
    return ap, mpre, mrec


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, eps: float = 1e-16):
    """Per-class PR curves + AP over the 10 IoU thresholds
    (Metrics.cs:308-384). Returns dict of results.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    prec_values = []
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l, n_p = nt[ci], int(i.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (~tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = interp(-x, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = interp(-x, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                prec_values.append(interp(x, mrec, mpre, left=0.0))
    if not prec_values:
        prec_values = [np.zeros(1000)]

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i_max = int(smooth(f1_curve.mean(0), 0.1).argmax())
    p, r, f1 = p_curve[:, i_max], r_curve[:, i_max], f1_curve[:, i_max]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return {
        "tp": tp_count, "fp": fp_count, "p": p, "r": r, "f1": f1, "ap": ap,
        "unique_classes": unique_classes.astype(int), "p_curve": p_curve,
        "r_curve": r_curve, "f1_curve": f1_curve, "x": x,
        "prec_values": np.stack(prec_values),
    }


def summarize(results) -> Tuple[float, float, float, float]:
    """(P, R, mAP50, mAP50-95) headline numbers (Detector.cs:138-141)."""
    ap = results["ap"]
    if ap.size == 0:
        return 0.0, 0.0, 0.0, 0.0
    return (float(results["p"].mean()), float(results["r"].mean()),
            float(ap[:, 0].mean()), float(ap[:, 1:].mean()))
