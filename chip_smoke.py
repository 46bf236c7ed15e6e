"""Chip smoke test of the PyTorch/CUDA port (yolosharp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Two serving paths: v8s detection (kernels conv3x3 s1/s2 and the fused C2f)
and v12s detection (conv3x3 s1/s2 and the fused attention).

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit; build every CUDA kernel from the
     sources in yolosharp_tpu_torch/csrc (one nvcc per source, in parallel).
  2. each kernel against its plain PyTorch version at every shape either
     path gives it (recorded with forward hooks on the folded v8s and v12s
     nets: 640x640 for the convs; 640x640, 480x640, 500x375 and 1280x1280
     for the attention), B=2, in float32 (TF32 off for cuDNN and matmul)
     and bfloat16, with device times (CUDA events around a CUDA graph of 10
     calls, in turns plain / kernel / library / library / kernel / plain),
     the eager times of the same calls made from Python (host launch cost
     included), and the TFLOP/s each reaches (convs
     2*Ho*Wo*9*Ci*Co*B; the C2f block's four GEMMs; attention's two
     products). Beside them each shape's bound, max(FLOP / peak, bytes /
     3.35 TB/s) with each input read once and the output written once
     (peaks 989 TFLOP/s bf16, 67 TFLOP/s f32), and the library time: one
     PyTorch call computing the same function, timed and never used by the
     port (F.conv2d with bias and without the activation for the convs,
     F.scaled_dot_product_attention for the attention, none for the C2f
     block). bfloat16 takes the tensor-core kernels, float32 the CUDA-core
     kernels. Then the 640x640
     shapes again at B=32 in bfloat16, timed, and at last every kernel
     variant the served requests of phases 3 and 4 take (the bf16 conv's N
     tile or stem, the C2f block's tile, the attention's route and splits;
     they depend on the batch) that was not checked yet, at the first request
     that takes it. Each check prints the variant it ran.
  3. the v8s slice: a v8s nc=80 YoloTask on cuda with seeded weights times
     its bf16 batch-32 640x640 network forward (CUDA events), counts the
     kernel launches of one such forward, and answers image_predict and
     batch_predict requests, with end2end False and True; conv3x3 s1/s2 and
     c2f_fused must have launched during them.
  3b. the v12s slice, the same way; conv3x3 s1/s2 and fused_attention must
     have launched during it.
  4. / 4b. each path's float32 predict of one image on the card against the
     CPU's float32 predict through the plain versions.

The run fails if jax, flax or the JAX package yolosharp_tpu was imported.
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 2
CANDIDATES = 300    # above-threshold anchors per image in phase 3 (bench.py:8-13)
CONV_CANVAS = (640, 640)
# the request canvases of phase 3 (500x375 pads to 512x384) and, for the
# attention only, v12s at 1280
CANVASES = ((640, 640), (480, 640), (512, 384), (1280, 1280))
# the batches and canvases of the served requests: phase 3 in bfloat16,
# phase 4 one 640x640 image in float32
SERVED_BATCH = 32
SERVED = {torch.bfloat16: ((SERVED_BATCH, 640, 640), (1, 640, 640),
                           (1, 480, 640), (1, 512, 384)),
          torch.float32: ((1, 640, 640),)}
KINDS = ("s2", "s1", "c2f", "attn")
# float32: the conv kernels sum 9*Ci <= 4608 products in another order than
# cuDNN; the attention kernel as tests/test_pallas_attention.py. bfloat16:
# the JAX package's own bf16 criterion (max error / max |reference| < 1e-2,
# tests/test_pallas_conv.py), doubled for the C2f block, whose four layers
# round to bf16 at different points in the two versions.
TOL_F32 = {"conv": (1e-4, 1e-4), "c2f": (1e-4, 1e-4), "attn": (2e-5, 2e-4)}
# the roofline of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor
# cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES = 3.35e12
TOL_BF16 = {"conv": 1e-2, "c2f": 2e-2, "attn": 1e-2}
SOURCES = {
    "conv3x3_silu": ("yolosharp_tpu_torch/csrc/conv3x3.cu",
                     "yolosharp_tpu/kernels/conv3x3.py:112"),
    "conv3x3s2_silu": ("yolosharp_tpu_torch/csrc/conv3x3.cu",
                       "yolosharp_tpu/kernels/conv3x3.py:198"),
    "c2f_fused": ("yolosharp_tpu_torch/csrc/c2f.cu",
                  "yolosharp_tpu/kernels/c2f.py:138"),
    "fused_attention": ("yolosharp_tpu_torch/csrc/attention.cu",
                        "yolosharp_tpu/kernels/attention.py:57"),
}
# the kernels each path must launch
PATHS = {"v8": ("conv3x3_silu", "conv3x3s2_silu", "c2f_fused"),
         "v12": ("conv3x3_silu", "conv3x3s2_silu", "fused_attention")}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def time_calls(fns: dict, iters: int = 10):
    """({name: device ms per call}, {name: eager ms per call}), CUDA events
    around iters calls, in turns forward then backward (plain / kernel /
    library / library / kernel / plain). Device: the iters calls replayed
    as one CUDA graph, so the time is the device's alone. Eager: the calls
    made from Python, where at small shapes the host's launch cost (the
    wrappers' checks and ctypes, ~50-90 us a call) is what is measured."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    graphs = {}
    for name, fn in fns.items():
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(iters):
                fn()
    out = []
    for run in ((lambda n: graphs[n].replay()),
                (lambda n: [fns[n]() for _ in range(iters)])):
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(name)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
        out.append({name: float(np.mean(t)) for name, t in times.items()})
    del graphs
    return out[0], out[1]


def bound(flop: int, nbytes: int, dtype):
    """(ms, 'bytes' or 'operations'): the least time the card could take."""
    ops = flop / PEAK_FLOPS[dtype] * 1e3
    mem = nbytes / HBM_BYTES * 1e3
    return max(ops, mem), ("bytes" if mem >= ops else "operations")


def compare(name, got, want, dtype, kind):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_abs = float(err.max())
    rel = max_abs / (float(want.abs().max()) + 1e-6)
    if dtype == torch.float32:
        atol, rtol = TOL_F32[kind]
        bad = int((err > atol + rtol * want.abs()).sum())
        ok = bad == 0 and bool(torch.isfinite(got).all())
        rule = f"|k-p| <= {atol} + {rtol}|p| ({bad} outside)"
    else:
        ok = rel < TOL_BF16[kind] and bool(torch.isfinite(got).all())
        rule = f"max|k-p|/max|p| = {rel:.3e} < {TOL_BF16[kind]}"
    print(f"  {name}: max_abs_err {max_abs:.3e} max_rel {rel:.3e} {rule} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return max_abs


def f64_errors(got, want, ref64):
    """Both float32 versions against a float64 evaluation of the plain
    version: each should be off by float32 rounding only."""
    k = float((got.double() - ref64).abs().max())
    p = float((want.double() - ref64).abs().max())
    print(f"    vs float64: kernel {k:.3e}, plain {p:.3e}", flush=True)


@torch.no_grad()
def record_shapes(version: str) -> dict:
    """The shapes each kernel of one path takes on each canvas, from forward
    hooks on the folded v{version}s net run at B=1 on the CPU (the routing
    is the same as on the card; the CPU runs the plain versions and launches
    nothing): {(h, w): {"s1" / "s2": {(H, W, Ci, Co)},
    "c2f": {(H, W, Cin, c, C2)}, "attn": {(areas, heads, N, D)}}}."""
    from yolosharp_tpu_torch.ckpt import fold_bn
    from yolosharp_tpu_torch.nn import AAttn, ArchCfg, C2f, ConvBN, YoloNet

    net = fold_bn(YoloNet(ArchCfg(version=version, size="s", nc=80)).eval())
    shapes = {}

    def conv_hook(m, inp, out):
        _, ci, h, w = inp[0].shape
        shapes[f"s{m.s}"].add((h, w, ci, m.conv.out_channels))

    def c2f_hook(m, inp, out):
        _, cin, h, w = inp[0].shape
        shapes["c2f"].add((h, w, cin, m.c, m.cv2.conv.out_channels))

    def attn_hook(m, inp, out):
        _, _, h, w = inp[0].shape
        shapes["attn"].add((m.area, m.num_heads, h * w // m.area,
                            m.head_dim))

    for m in net.modules():
        if isinstance(m, ConvBN) and m.kernel_route:
            m.register_forward_hook(conv_hook)
        elif isinstance(m, C2f) and m.fused_weights:
            m.register_forward_hook(c2f_hook)
        elif isinstance(m, AAttn):
            m.register_forward_hook(attn_hook)
    by_canvas = {}
    for h, w in CANVASES if version == "v12" else CANVASES[:-1]:
        # the hooks fill this canvas's sets
        shapes = by_canvas[(h, w)] = {k: set() for k in KINDS}
        net(torch.zeros(1, 3, h, w).contiguous(
            memory_format=torch.channels_last))
    return by_canvas


def variant(kind, dtype, batch, shape, sms) -> str:
    """What the launch picks for one call, as the wrappers pick it for a
    card of sms SMs: the bf16 conv's N tile (or its stem kernel), the C2f
    block's tile, the attention's route by type and its bf16 splits,
    staged keys and warps; '' where the kernel is the same for every
    call."""
    from yolosharp_tpu_torch.kernels.attention import launch_geometry
    from yolosharp_tpu_torch.kernels.c2f import launch_tile
    from yolosharp_tpu_torch.kernels.conv3x3 import n_tile

    bf16 = dtype == torch.bfloat16
    if kind in ("s1", "s2") and bf16:
        H, W, ci, co = shape
        bn = n_tile(batch, H, W, ci, co, int(kind[1]), sms)
        return f"BN {bn}" if bn else "stem"
    if kind == "c2f":
        H, W, _, c, _ = shape
        return f"c={c} tile {launch_tile(batch, H, W, c, bf16, sms)}"
    if kind == "attn":
        if not bf16:
            return "CUDA cores"
        areas, nh, n, d = shape
        splits, keys, warps = launch_geometry(batch * areas * nh, n, d, sms)
        return f"mma.sync splits {splits} keys {keys} warps {warps}"
    return ""


def phase_kernels(dev):
    from yolosharp_tpu_torch.kernels import (attention_bihd, attention_plain,
                                             c2f_fused, c2f_plain,
                                             conv3x3_plain, conv3x3_silu,
                                             conv3x3s2_silu, fused_attention)

    print(f"phase 2: kernels against their plain versions: every shape at "
          f"B={BATCH} in float32 and bfloat16, the batch-32 shapes in "
          f"bfloat16, then any tile the served requests take that was not "
          f"checked yet", flush=True)
    print("  torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False", flush=True)
    recorded = {v: record_shapes(v) for v in PATHS}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def union(kind, canvases):
        """[(shape, [paths])] that kind takes on these canvases."""
        tagged = {}
        for v, by_canvas in recorded.items():
            for cv in canvases:
                for s in by_canvas.get(cv, {}).get(kind, ()):
                    tagged.setdefault(s, []).append(v)
        return sorted(((s, sorted(set(vs), key=list(PATHS).index))
                       for s, vs in tagged.items()),
                      key=lambda t: (-t[0][0], t[0]))

    # the convs and the C2f block at 640x640; the attention on every canvas
    shapes = {k: union(k, CANVASES if k == "attn" else [CONV_CANVAS])
              for k in KINDS}
    for kind in KINDS:
        print(f"  {kind} shapes recorded: " + ", ".join(
            f"{s} {'+'.join(vs)}" for s, vs in shapes[kind]), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    stats = {}
    for name in SOURCES:
        s = stats[name] = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0,
                           "shapes": 0}
        for suffix in ("", "_f32", "_b32"):
            s.update({"ms" + suffix: 0.0, "plain_ms" + suffix: 0.0,
                      "ms_eager" + suffix: 0.0, "bound_ms" + suffix: 0.0,
                      "library_ms" + suffix: None if name == "c2f_fused"
                      else 0.0})
    # per kernel and sum: the bound ms that bytes / operations set
    bound_parts = {}
    checked = set()     # (kind, dtype, variant) held against the plain version

    def check(kind, dtype, batch, shape, vs, timed=True):
        """One kernel against its plain version at one shape: its error,
        the variant it ran and (timed) its, the plain version's and the
        library call's times, TFLOP/s and its bound."""
        dt = str(dtype)[6:]
        var = variant(kind, dtype, batch, shape, sms)
        extra = library = None
        size = torch.finfo(dtype).bits // 8
        if kind in ("s1", "s2"):
            stride = int(kind[1])
            wrapper = conv3x3_silu if stride == 1 else conv3x3s2_silu
            H, W, ci, co = shape
            x = randn(batch, H, W, ci).to(dtype)
            w = randn(3, 3, ci, co, scale=(9 * ci) ** -0.5).to(dtype)
            b = randn(co, scale=0.1).to(dtype)
            name, tol, desc = wrapper.__name__, "conv", f"{H}x{W} {ci}->{co}"
            kernel = lambda: wrapper(x, w, b)  # noqa: E731
            plain = lambda: conv3x3_plain(x, w, b, "silu", stride)  # noqa: E731
            ref64 = lambda: conv3x3_plain(  # noqa: E731
                x.double(), w.double(), b.double(), "silu", stride)
            ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
            flop = 2 * batch * ho * wo * 9 * ci * co
            nbytes = size * (x.numel() + w.numel() + co + batch * ho * wo * co)
            # cuDNN on the channels-last NCHW view: conv + bias, no SiLU
            xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            library = lambda: F.conv2d(xc, wc, b, stride=stride,  # noqa: E731
                                       padding=1)
        elif kind == "c2f":
            H, W, cin, c, c2 = shape
            args = [randn(batch, H, W, cin),
                    randn(cin, 2 * c, scale=cin ** -0.5),
                    randn(2 * c, scale=0.1),
                    randn(3, 3, c, c, scale=(9 * c) ** -0.5),
                    randn(c, scale=0.1),
                    randn(3, 3, c, c, scale=(9 * c) ** -0.5),
                    randn(c, scale=0.1),
                    randn(3 * c, c2, scale=(3 * c) ** -0.5),
                    randn(c2, scale=0.1)]
            args = [a.to(dtype) for a in args]
            name, tol, desc = "c2f_fused", "c2f", f"{H}x{W} {cin}/{c}/{c2}"
            kernel = lambda: c2f_fused(*args)  # noqa: E731
            plain = lambda: c2f_plain(*args)  # noqa: E731
            ref64 = lambda: c2f_plain(*[a.double() for a in args])  # noqa
            # the block's GEMMs: cv1, the two 3x3s, cv2 over the concat
            flop = 2 * batch * H * W * (cin * 2 * c + 18 * c * c + 3 * c * c2)
            nbytes = size * (sum(a.numel() for a in args) + batch * H * W * c2)
        else:
            # as AAttn hands them over: strided q, k, v of one (B, N, H, 3D)
            # qkv tensor, B = batch images x areas
            areas, nh, n, d = shape
            qkv = randn(batch * areas, n, nh, 3 * d).to(dtype)
            q, k, v = qkv.split(d, dim=-1)
            bhnd = [t.transpose(1, 2) for t in (q, k, v)]
            scale = d ** -0.5
            name, tol = "fused_attention", "attn"
            desc = f"({batch * areas}, {nh}, {n}, {d})"
            kernel = lambda: attention_bihd(q, k, v, scale)  # noqa: E731
            plain = lambda: attention_plain(  # noqa: E731
                *bhnd, scale).transpose(1, 2)
            ref64 = lambda: attention_plain(  # noqa: E731
                *[t.double() for t in bhnd], scale).transpose(1, 2)
            extra = fused_attention(*[t.contiguous() for t in bhnd], scale)
            flop = 4 * batch * areas * nh * n * n * d   # q k^T and p v
            nbytes = size * (qkv.numel() + qkv.numel() // 3)   # qkv and o
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *bhnd, scale=scale)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        tag = (f"{name} {dt} B={batch} {desc}" + (f" [{var}]" if var else "")
               + f" [{'+'.join(vs)}]")
        err = compare(tag, got, want, dtype, tol)
        if extra is not None:
            compare(tag + " contiguous (B, H, N, D)", extra,
                    want.transpose(1, 2), dtype, tol)
        if dtype == torch.float32:
            f64_errors(got, want, ref64())
        checked.add((kind, dt, var))
        s = stats[name]
        key = "max_abs_err" if dtype == torch.float32 else "max_abs_err_bf16"
        s[key] = max(s[key], err)
        if not timed:
            return
        fns = {"plain": plain, "kernel": kernel}
        if library is not None:
            fns["library"] = library
        t, eager = time_calls(fns)
        ms, plain_ms = t["kernel"], t["plain"]
        bound_ms, by = bound(flop, nbytes, dtype)
        lib = (f"{t['library']:.4f} ms library"
               if library is not None else "no library call")
        print(f"    device (CUDA graph): {ms:.4f} ms kernel, {plain_ms:.4f} ms "
              f"plain, {lib}; bound {bound_ms:.4f} ms by {by} "
              f"({nbytes / 1e6:.2f} MB, {flop / 1e9:.3f} GFLOP), "
              f"{bound_ms / ms:.3f} of it; {flop / ms / 1e9:.1f} / "
              f"{flop / plain_ms / 1e9:.1f} TFLOP/s", flush=True)
        print("    eager: " + ", ".join(f"{v:.4f} ms {k}"
                                        for k, v in eager.items()),
              flush=True)
        suffix = ("_b32" if batch == SERVED_BATCH else
                  "_f32" if dtype == torch.float32 else "")
        s["ms" + suffix] += ms
        s["plain_ms" + suffix] += plain_ms
        s["ms_eager" + suffix] += eager["kernel"]
        s["bound_ms" + suffix] += bound_ms
        if library is not None:
            s["library_ms" + suffix] += t["library"]
        part = bound_parts.setdefault((name, suffix), {})
        part[by] = part.get(by, 0.0) + bound_ms
        if suffix == "":
            s["shapes"] += 1

    for dtype in (torch.float32, torch.bfloat16):
        for kind in KINDS:
            for shape, vs in shapes[kind]:
                check(kind, dtype, BATCH, shape, vs)
    print(f"  bfloat16 at B={SERVED_BATCH}, the shapes of the served "
          f"batch_predict", flush=True)
    for kind in KINDS:
        for shape, vs in union(kind, [CONV_CANVAS]):
            check(kind, torch.bfloat16, SERVED_BATCH, shape, vs)
    # every (kind, dtype, variant) the served requests take, at the first
    # request that takes it
    served = {}
    for dtype, requests in SERVED.items():
        for batch, h, w in requests:
            for kind in KINDS:
                for shape, vs in union(kind, [(h, w)]):
                    served.setdefault(
                        (kind, str(dtype)[6:],
                         variant(kind, dtype, batch, shape, sms)),
                        (dtype, batch, shape, vs))
    missing = [key for key in served if key not in checked]
    print(f"  variants the served requests take: {len(served)}, not yet "
          f"checked: {len(missing)}", flush=True)
    for key in missing:
        check(key[0], *served[key], timed=False)
    if any(key not in checked for key in served):
        raise SystemExit("a variant of the served path was not checked")
    # what bounds each sum: the larger share of its bound
    for (name, suffix), part in bound_parts.items():
        stats[name]["bound_by" + suffix] = max(part, key=part.get)
    return stats


def synthetic_images(n, h, w, seed):
    """Smooth blobs plus noise, uint8 RGB, made from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        low = rng.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        img = np.kron(low, np.ones((16, 16, 1), np.float32))[:h, :w]
        img += rng.normal(0, 20, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@torch.no_grad()
def seed_weights(net, seed: int = 3):
    """Random weights that give NMS-visible detections, the recipe of
    tests/test_golden_bus_predict.py:115-137: ConvBN kernels x2.5, the
    head's final convs re-drawn from U(-0.3, 0.3), and BN statistics (and
    the conv biases of biased ConvBNs) jittered so that folding does real
    work."""
    from yolosharp_tpu_torch.ckpt import clone_one2one
    from yolosharp_tpu_torch.nn import ConvBN

    rng = np.random.default_rng(seed)

    def noise(t, fn):
        return torch.from_numpy(fn(t.shape).astype(np.float32)).to(t)

    for m in net.modules():
        if isinstance(m, ConvBN):
            m.conv.weight.mul_(2.5)
            if m.conv.bias is not None:
                m.conv.bias.add_(noise(m.conv.bias,
                                       lambda s: rng.normal(0, 0.1, s)))
            m.bn.running_mean.add_(noise(m.bn.running_mean,
                                         lambda s: rng.normal(0, 0.05, s)))
            m.bn.running_var.mul_(noise(m.bn.running_var,
                                        lambda s: rng.uniform(0.8, 1.5, s))
                                  ).add_(0.02)
    head = net.model[-1]
    for tower in (head.cv2, head.cv3):
        for branch in tower:
            for p in (branch[2].weight, branch[2].bias):
                p.copy_(noise(p, lambda s: rng.uniform(-0.3, 0.3, s)))
    clone_one2one(net)


def match(got, want):
    """Rows (boxes, scores, classes) of got against want: counts within 2
    (threshold-edge flips), each wanted row within 0.5 px and 1e-3 score.
    Returns (n_want, n_got, unmatched)."""
    gb, gs, gc = got
    wb, ws, wc = want
    used = np.zeros(len(gb), bool)
    unmatched = 0
    for b, s, c in zip(wb, ws, wc):
        if not len(gb):
            unmatched += 1
            continue
        d = np.abs(gb - b).max(1) + 1e3 * (gc != c)
        j = int(np.argmin(d + 1e6 * used))
        if d[j] < 0.5 and abs(gs[j] - s) < 1e-3:
            used[j] = True
        else:
            unmatched += 1
    return len(wb), len(gb), unmatched


def rows_of(out, end2end, conf, i=0):
    if end2end:
        r = out[i]
        r = r[r[:, 4] > conf]
        return r[:, :4], r[:, 4], r[:, 5].astype(int)
    v = out.valid[i]
    return out.boxes[i][v], out.scores[i][v], out.classes[i][v]


def build_tasks(dev, version, state, **cfg):
    from yolosharp_tpu_torch import Config, YoloSize, YoloTask, YoloType

    tasks = {}
    for e2e in (False, True):
        task = YoloTask(Config(yolo_type=YoloType(version),
                               yolo_size=YoloSize.s, number_class=80,
                               end2end=e2e, nms_pre_topk=512, **cfg),
                        device=dev)
        net = task.task._ensure_variables()
        net.load_state_dict({k: v for k, v in state.items()
                             if e2e or "one2one" not in k}, strict=True)
        tasks[e2e] = task
    return tasks


def phase_slice(dev, version):
    """{version}s-640, nc=80, bf16 (the Config default), seeded weights: a
    few image_predict and batch_predict requests in both End2End modes.
    Returns (launches of the path's kernels, their launches in one b32
    forward, state dict, conf)."""
    from yolosharp_tpu_torch import Config, YoloSize, YoloTask, YoloType
    from yolosharp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from yolosharp_tpu_torch.loss import flatten_levels

    phase = "3" if version == "v8" else "3b"
    print(f"phase {phase}: {version}s-640 nc=80 YoloTask on cuda, bf16, "
          f"seeded weights", flush=True)
    master = YoloTask(Config(yolo_type=YoloType(version),
                             yolo_size=YoloSize.s, number_class=80,
                             end2end=True), device=dev)
    net = master.task._ensure_variables()
    seed_weights(net)
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    tasks = build_tasks(dev, version, state)

    singles = [synthetic_images(1, 640, 640, 10)[0],
               synthetic_images(1, 480, 640, 11)[0],
               synthetic_images(1, 500, 375, 12)[0]]    # not a multiple of 32
    batch = synthetic_images(SERVED_BATCH, 640, 640, 20)

    # conf: every image of the batch has at most CANDIDATES above it
    det = tasks[False].task
    x = torch.from_numpy(np.stack(batch)).to(dev).permute(0, 3, 1, 2)
    x = (x.float() / 255.0).to(det.dtype).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        preds = det._predict_variables()(x)
    flat = flatten_levels(preds["one2many"]["cls"]).float().sigmoid()
    flat = flat.amax(-1).cpu().numpy()
    a = flat.shape[1]
    conf = float(np.quantile(flat, 1 - CANDIDATES / a, axis=1).max())
    counts = (flat > conf).sum(1)
    print(f"  conf {conf:.6f}: candidates per image min {counts.min()} mean "
          f"{counts.mean():.1f} max {counts.max()} of {a} anchors", flush=True)
    # the network forward alone, bf16, batch 32 at 640x640
    fwd = det._predict_variables()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        reset_launch_counts()
        fwd(x)
        per_forward = launch_counts()
        print(f"  [{version}] kernel launches of one b32 forward: "
              f"{per_forward}", flush=True)
        start.record()
        for _ in range(5):
            fwd(x)
        end.record()
    torch.cuda.synchronize()
    print(f"  [{version}] network forward bf16 batch 32 640x640: "
          f"{start.elapsed_time(end) / 5:.2f} ms (CUDA events, mean of 5)",
          flush=True)
    del preds, x

    launches = {}
    for e2e, task in tasks.items():
        mode = f"{version} {'end2end' if e2e else 'nms'}"
        task.image_predict(singles[0], conf)        # fold + warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        for img in singles:
            t0 = time.perf_counter()
            res = task.image_predict(img, conf)
            ms = (time.perf_counter() - t0) * 1e3
            print(f"  [{mode}] image_predict {img.shape[0]}x{img.shape[1]}: "
                  f"{len(res)} detections, {ms:.2f} ms", flush=True)
            if not res:
                raise SystemExit(f"[{mode}] image_predict found nothing")
        for rep in range(3):
            t0 = time.perf_counter()
            res = task.batch_predict(batch, conf)
            s = time.perf_counter() - t0
            n = [len(r) for r in res]
            print(f"  [{mode}] batch_predict {len(batch)}x640x640 #{rep}: "
                  f"detections per image min {min(n)} mean {np.mean(n):.1f} "
                  f"max {max(n)}, {s * 1e3:.2f} ms, {len(batch) / s:.1f} "
                  f"img/s", flush=True)
            if len(res) != len(batch) or min(n) == 0 or not all(
                    np.isfinite([r.score, r.center_x, r.center_y, r.width,
                                 r.height]).all() for rs in res for r in rs):
                raise SystemExit(f"[{mode}] batch_predict results are wrong")
        counts = launch_counts()
        print(f"  [{mode}] kernel launches: {counts}", flush=True)
        for name in PATHS[version]:
            if counts[name] <= 0:
                raise SystemExit(f"{name} was not launched in {mode} predict")
            launches[name] = launches.get(name, 0) + counts[name]
    # truncation is checked per request: the NMS pool (512) held every
    # candidate
    out = tasks[False].task._predict_fn(
        tasks[False].task._predict_variables(),
        torch.from_numpy(np.stack(batch)).to(dev), conf, 0.7)
    if bool(out.truncated.any()):
        raise SystemExit("NMS candidate pool truncated")
    print(f"  truncated: False for all {len(batch)} images", flush=True)
    return launches, per_forward, state, conf


def phase_cpu_match(dev, version, state, conf):
    """The same model, float32, one 640x640 image: the card against the
    CPU's plain versions."""
    from yolosharp_tpu_torch import ScalarType
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from yolosharp_tpu_torch.tasks import _to_host

    phase = "4" if version == "v8" else "4b"
    print(f"phase {phase}: {version}s float32 on the card against float32 on "
          f"the CPU (plain versions)", flush=True)
    img = torch.from_numpy(synthetic_images(1, 640, 640, 30)[0][None])
    cuda = build_tasks(dev, version, state, scalar_type=ScalarType.float32)
    cpu = build_tasks("cpu", version, {k: v.cpu() for k, v in state.items()},
                      scalar_type=ScalarType.float32)
    for e2e in (False, True):
        c = 0.0 if e2e else conf
        reset_launch_counts()
        got = _to_host(cuda[e2e].task._predict_fn(
            cuda[e2e].task._predict_variables(), img.to(dev), c, 0.7))
        used = launch_counts()
        want = _to_host(cpu[e2e].task._predict_fn(
            cpu[e2e].task._predict_variables(), img, c, 0.7))
        n_want, n_got, unmatched = match(rows_of(got, e2e, conf),
                                         rows_of(want, e2e, conf))
        mode = f"{version} {'end2end' if e2e else 'nms'}"
        print(f"  [{mode}] cpu {n_want} detections, card {n_got}, unmatched "
              f"{unmatched} (kernel launches on the card: {used})",
              flush=True)
        if n_want < 5 or abs(n_got - n_want) > 2 or unmatched > 2:
            raise SystemExit(f"[{mode}] card and CPU disagree")
        if any(used[name] <= 0 for name in PATHS[version]):
            raise SystemExit(f"[{mode}] a kernel did not run in float32")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from yolosharp_tpu_torch.kernels import build

    t0 = time.perf_counter()
    names = ("conv3x3", "c2f", "attention")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.load, names))
    print(f"phase 1: built kernels {names} from {build.SRC_DIR} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        print(f"  nvcc {name}:\n" + "\n".join(
            "    " + ln for ln in log.strip().splitlines()), flush=True)

    stats = phase_kernels(dev)
    launches, per_forward = {}, {}
    for version in PATHS:
        path_launches, forward, state, conf = phase_slice(dev, version)
        phase_cpu_match(dev, version, state, conf)
        for name, n in path_launches.items():
            launches[name] = launches.get(name, 0) + n
            per_forward.setdefault(name, {})[version] = forward[name]

    foreign = sorted(m for m in sys.modules
                     if m in ("jax", "flax", "yolosharp_tpu")
                     or m.startswith(("jax.", "flax.", "yolosharp_tpu.")))
    if foreign:
        raise SystemExit(f"the run imported JAX or the JAX package: {foreign}")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name],
                 "launches_per_b32_forward": per_forward[name]}
        entry.update(stats[name])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
