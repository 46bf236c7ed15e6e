"""The 16-bit conv3x3 kernel's tile plans against the card (the source of
``kernels/conv3x3.py``'s ``COST_*`` clocks).

For every 16-bit 3x3 shape of every chip_smoke.py path (640x640 and the
classify models' 224x224, Ci >= 8) at B=32 and B=2, bfloat16: the cost
model's 10 best plans and the largest tile of each N tile, timed on the
card (CUDA-graph replay, chip_smoke.time_calls); then the per-tile clocks
fitted to those times (non-negative least squares on the relative error)
and the sum over the shapes of the plan the model picks, of the plan the
fitted clocks would pick, and of the fastest plan timed.

    python3 chip_conv_plans.py [out.json]

Needs one CUDA card; writes the times to out.json
(chiprun_out/conv_plans.json by default).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from yolosharp_tpu_torch.kernels import build
from yolosharp_tpu_torch.kernels import conv3x3 as kc

BATCHES = (32, 2)
CANDIDATES = 10
# the clocks to ms: the H100's boost clock
CLOCK_HZ = 1.83e9


def path_shapes():
    """{(stride, (H, W, Ci, Co))} of the 16-bit kernel over every path."""
    shapes = set()
    for v in cs.PATHS:
        for cv, kinds in cs.record_shapes(v).items():
            if cv not in (cs.CONV_CANVAS, cs.CLS_CANVAS):
                continue
            for k in ("s1", "s2"):
                shapes |= {(int(k[1]), s) for s in kinds[k] if s[2] > 7}
    return sorted(shapes, key=lambda t: (t[0], -t[1][0], t[1]))


def candidates(B, H, W, ci, co, stride, sms):
    """The model's best plans and the largest tile of each N tile."""
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    plans = []
    for bn in ((64, 128) if co > 64 else (64,)):
        for splits in range(1, min(wo, 16) + 1):
            wt = -(-wo // splits)
            p = wt + 3 - stride
            if p > kc.TC_ROWS or (splits > 1 and wt == -(-wo // (splits - 1))):
                continue
            for rows in sorted({-(-ho // n) for n in range(1, ho + 1)}):
                if rows * p <= kc.TC_ROWS and kc.tc_smem(
                        stride, rows, wt, bn) <= build.SMEM_LIMIT:
                    plan = kc.ConvPlan(bn, rows, wt)
                    plans.append((kc.plan_cost(B, ho, wo, ci, co, stride, sms,
                                               plan), plan))
    plans.sort()
    pick = [p for _, p in plans[:CANDIDATES]]
    for bn in (64, 128):
        tiles = [p for _, p in plans if p.bn == bn]
        if tiles:
            big = max(tiles, key=lambda p: p.rows * p.wt)
            if big not in pick:
                pick.append(big)
    return pick


def fit(records, sms):
    """The COST_* clocks fitted to the records' times."""
    from scipy.optimize import nnls

    feats, clocks = [], []
    for r in records:
        B, stride = r["B"], r["stride"]
        H, W, ci, co = r["shape"]
        ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        for plan, ms in r["times"]:
            rounds, mma, steps, kb, out = kc.plan_features(
                B, ho, wo, ci, co, stride, sms, kc.ConvPlan(*plan))
            feats.append([rounds * mma, rounds * steps, rounds * kb,
                          rounds * out, rounds, 1.0])
            clocks.append(ms * 1e-3 * CLOCK_HZ)
    a, y = np.array(feats), np.array(clocks)
    coef, _ = nnls(a / y[:, None], np.ones_like(y))
    return coef, a


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/conv_plans.json"
    if not torch.cuda.is_available():
        raise SystemExit("chip_conv_plans.py needs a CUDA card")
    start = time.time()
    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    sms = build.sm_count(0)
    g = torch.Generator(device=dev).manual_seed(0)
    records = []
    for B in BATCHES:
        for stride, (H, W, ci, co) in path_shapes():
            cip, cop = kc.padded(ci), kc.padded(co)
            x = torch.randn(B, H, W, cip, generator=g, device=dev).bfloat16()
            w = (torch.randn(3, 3, cip, cop, generator=g, device=dev)
                 * (9 * cip) ** -0.5).bfloat16()
            b = (torch.randn(cop, generator=g, device=dev) * 0.1).bfloat16()
            plans = candidates(B, H, W, cip, cop, stride, sms)
            fns = {p: (lambda p=p: kc._launch("conv3x3", x, w, b, "silu",
                                              stride, p)) for p in plans}
            times, _ = cs.time_calls(fns, iters=5)
            chosen = kc.conv_plan(B, H, W, cip, cop, stride, sms)
            records.append({"B": B, "stride": stride,
                            "shape": [H, W, cip, cop],
                            "chosen": list(chosen),
                            "times": [[list(p), t] for p, t in times.items()]})
            best = min(times, key=times.get)
            print(f"s{stride} B={B} {H}x{W} {ci}->{co}: model {tuple(chosen)} "
                  f"{times.get(chosen, float('nan')):.4f} ms, fastest "
                  f"{tuple(best)} {times[best]:.4f} ms", flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(records, f)
    coef, feats = fit(records, sms)
    print("fitted clocks: COST_MMA, COST_STEP, COST_TILE_KB, COST_OUT, "
          "COST_ROUND, COST_LAUNCH = "
          + ", ".join(f"{c:.4g}" for c in coef), flush=True)
    pred = iter(feats @ coef)
    for B in BATCHES:
        model = fitted = fastest = 0.0
        for r in (r for r in records if r["B"] == B):
            times = {tuple(p): t for p, t in r["times"]}
            scored = [(next(pred), tuple(p)) for p, _ in r["times"]]
            model += times.get(tuple(r["chosen"]), float("nan"))
            fitted += times[min(scored)[1]]
            fastest += min(times.values())
        print(f"B={B} sums (ms): the model's plans {model:.3f}, the fitted "
              f"clocks' {fitted:.3f}, the fastest timed {fastest:.3f}",
              flush=True)
    print(f"done in {time.time() - start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
