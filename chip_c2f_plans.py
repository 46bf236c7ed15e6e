"""The C2f kernel's plans against the card (the source of
``kernels/c2f.py``'s ``COST`` clocks and, with ``--f32``, its
``F32_COST`` clocks).

For every C2f shape of every chip_smoke.py path (v8s at 640x640, v8s-cls
at 224x224) at B=32, 2 and 1, bfloat16: the cost model's 16 best plans
and, for each N tile and subtile count, the plan of the most output
pixels a 3x3 tile, timed on the card (CUDA-graph replay,
chip_smoke.time_calls); then the clocks fitted to those times
(non-negative least squares on the relative error) and the sum over the
shapes of the plan the model picks, of the plan the fitted clocks would
pick, and of the fastest plan timed.

    python3 chip_c2f_plans.py [out.json]

With ``--f32``, the float32 kernel at the same shapes and batches: the
planner's plan, the model's best F32_CANDIDATES choices of the 3x3s with
the 1x1s as planned, and for each 1x1 tile width the best few cv1 and cv2
choices of that width, timed in float32; then F32_COST fitted to those
times in the same way, and the same three sums.

    python3 chip_c2f_plans.py --f32 [out.json]

Needs one CUDA card; writes the times to out.json
(chiprun_out/c2f_plans.json, or c2f_f32_plans.json, by default).
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
F32_CANDIDATES = 8
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


def f32_candidates(B, shape, sms):
    """The float32 plan; the 3x3s' F32_CANDIDATES best choices with the 1x1s
    as planned; and for each 1x1 tile width (cv1 and cv2 share it), the
    best cv1 and cv2 of that width and the next two of each."""
    base = kc.f32_c2f_plan(B, *shape, sms)
    pick = [base]

    def add(plan):
        if plan not in pick:
            pick.append(plan)

    for g in kc.f32_options("m", B, *shape, sms)[:F32_CANDIDATES]:
        add(base._replace(m=g))
    cv1 = kc.f32_options("cv1", B, *shape, sms)
    cv2 = kc.f32_options("cv2", B, *shape, sms)
    for tn in kc.F32_TN1:
        a = [g for g in cv1 if g.tn == tn][:3]
        b = [g for g in cv2 if g.tn == tn][:3]
        for x in a:
            add(base._replace(cv1=x, cv2=b[0]))
        for y in b[1:]:
            add(base._replace(cv1=a[0], cv2=y))
    return pick


def f32_plan(ints):
    """A C2fF32Plan from its eight ints."""
    G = kc.F32Gemm
    return kc.C2fF32Plan(G(*ints[:2]), G(ints[2], ints[5], ints[3], ints[4]),
                         G(*ints[6:]))


def features(r, plan, sms, f32):
    if f32:
        return list(kc.f32_plan_features(r["B"], *r["shape"], sms,
                                         f32_plan(plan)))
    return [*kc.plan_features(r["B"], *r["shape"], sms, kc.C2fPlan(*plan)),
            1.0]


def fit(records, sms, f32=False):
    """The COST (or F32_COST) clocks fitted to the records' times."""
    from scipy.optimize import nnls

    feats, clocks = [], []
    for r in records:
        for plan, ms in r["times"]:
            feats.append(features(r, plan, sms, f32))
            clocks.append(ms * 1e-3 * CLOCK_HZ)
    a, y = np.array(feats), np.array(clocks)
    coef, _ = nnls(a / y[:, None], np.ones_like(y))
    return coef, a


def main():
    args = sys.argv[1:]
    f32 = "--f32" in args
    args = [a for a in args if a != "--f32"]
    out = args[0] if args else ("chiprun_out/c2f_f32_plans.json" if f32
                                else "chiprun_out/c2f_plans.json")
    if not torch.cuda.is_available():
        raise SystemExit("chip_c2f_plans.py needs a CUDA card")
    start = time.time()
    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    sms = build.sm_count(0)
    g = torch.Generator(device=dev).manual_seed(0)

    dtype = torch.float32 if f32 else torch.bfloat16

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

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
            plans = (f32_candidates if f32 else candidates)(B, shape, sms)
            fns = {p: (lambda p=p: kc.c2f_fused(*args, plan=p))
                   for p in plans}
            times, _ = cs.time_calls(fns, iters=5)
            chosen = (kc.f32_c2f_plan if f32 else kc.c2f_plan)(B, *shape, sms)
            key = (lambda p: list(p.ints())) if f32 else list
            records.append({"B": B, "shape": list(shape),
                            "chosen": key(chosen),
                            "times": [[key(p), t] for p, t in times.items()]})
            best = min(times, key=times.get)
            print(f"B={B} {H}x{W} {cin}/{c}/{c2}: model {tuple(key(chosen))} "
                  f"{times.get(chosen, float('nan')):.4f} ms, fastest "
                  f"{tuple(key(best))} {times[best]:.4f} ms", flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(records, f)
    coef, feats = fit(records, sms, f32)
    print(f"fitted clocks: {'F32_COST' if f32 else 'COST'} = ("
          + ", ".join(f"{c:.4g}" for c in coef) + ")", flush=True)
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
