"""The 16-bit C2f kernel's plans against the card (the source of
``kernels/c2f.py``'s ``COST`` clocks).

For every C2f shape of every chip_smoke.py path (v8s at 640x640, v8s-cls
at 224x224) at B=32, 2 and 1, bfloat16: the cost model's 16 best plans
and, for each N tile and subtile count, the plan of the most output
pixels a 3x3 tile, timed on the card (CUDA-graph replay,
chip_smoke.time_calls); then the clocks fitted to those times
(non-negative least squares on the relative error) and the sum over the
shapes of the plan the model picks, of the plan the fitted clocks would
pick, and of the fastest plan timed.

    python3 chip_c2f_plans.py [out.json]

Needs one CUDA card; writes the times to out.json
(chiprun_out/c2f_plans.json by default).
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
from yolosharp_tpu_torch.kernels import c2f as kc

BATCHES = (32, 2, 1)
CANDIDATES = 16
# the clocks to ms: the H100's boost clock
CLOCK_HZ = 1.83e9


def path_shapes():
    """[(H, W, Cin, c, C2)] of the C2f kernel over every path."""
    shapes = set()
    for v in cs.PATHS:
        for cv, kinds in cs.record_shapes(v).items():
            if cv in (cs.CONV_CANVAS, cs.CLS_CANVAS):
                shapes |= kinds["c2f"]
    return sorted(shapes, key=lambda s: (-s[0], s))


def candidates(B, shape, sms):
    """The model's best plans and, for each (N tile, subtiles), the plan of
    the most output pixels a 3x3 tile."""
    plans = sorted(kc.plan_space(B, *shape[:2], *shape[3:]),
                   key=lambda p: kc.plan_cost(B, *shape, sms, p))
    pick = plans[:CANDIDATES]
    for key in {(p.bn, p.ms) for p in plans}:
        big = max((p for p in plans if (p.bn, p.ms) == key),
                  key=lambda p: (p.rows * p.wt, p.wt))
        if big not in pick:
            pick.append(big)
    return pick


def fit(records, sms):
    """The COST clocks fitted to the records' times."""
    from scipy.optimize import nnls

    feats, clocks = [], []
    for r in records:
        for plan, ms in r["times"]:
            f = kc.plan_features(r["B"], *r["shape"], sms, kc.C2fPlan(*plan))
            feats.append([*f, 1.0])
            clocks.append(ms * 1e-3 * CLOCK_HZ)
    a, y = np.array(feats), np.array(clocks)
    coef, _ = nnls(a / y[:, None], np.ones_like(y))
    return coef, a


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/c2f_plans.json"
    if not torch.cuda.is_available():
        raise SystemExit("chip_c2f_plans.py needs a CUDA card")
    start = time.time()
    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    sms = build.sm_count(0)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).bfloat16()

    records = []
    for B in BATCHES:
        for shape in path_shapes():
            H, W, cin, c, c2 = shape
            args = [randn(B, H, W, cin), randn(cin, 2 * c, scale=cin ** -0.5),
                    randn(2 * c, scale=0.1),
                    randn(3, 3, c, c, scale=(9 * c) ** -0.5),
                    randn(c, scale=0.1),
                    randn(3, 3, c, c, scale=(9 * c) ** -0.5),
                    randn(c, scale=0.1),
                    randn(3 * c, c2, scale=(3 * c) ** -0.5),
                    randn(c2, scale=0.1)]
            plans = candidates(B, shape, sms)
            fns = {p: (lambda p=p: kc.c2f_fused(*args, plan=p))
                   for p in plans}
            times, _ = cs.time_calls(fns, iters=5)
            chosen = kc.c2f_plan(B, *shape, sms)
            records.append({"B": B, "shape": list(shape),
                            "chosen": list(chosen),
                            "times": [[list(p), t] for p, t in times.items()]})
            best = min(times, key=times.get)
            print(f"B={B} {H}x{W} {cin}/{c}/{c2}: model {tuple(chosen)} "
                  f"{times.get(chosen, float('nan')):.4f} ms, fastest "
                  f"{tuple(best)} {times[best]:.4f} ms", flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(records, f)
    coef, feats = fit(records, sms)
    print("fitted clocks: COST = (" + ", ".join(f"{c:.4g}" for c in coef)
          + ")", flush=True)
    pred = iter(feats @ coef)
    for B in BATCHES:
        model = fitted = fastest = 0.0
        for r in (r for r in records if r["B"] == B):
            times = {tuple(p): t for p, t in r["times"]}
            scored = [(next(pred), tuple(p)) for p, _ in r["times"]]
            model += times.get(tuple(r["chosen"]), float("nan"))
            fitted += times[min(scored)[1]]
            fastest += min(times.values())
        print(f"B={B} sums (ms): the model's plans {model:.4f}, the fitted "
              f"clocks' {fitted:.4f}, the fastest timed {fastest:.4f}",
              flush=True)
    print(f"done in {time.time() - start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
