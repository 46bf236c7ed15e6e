"""Where the time goes (PERF.md section 5): v8s / v12s-640 bf16 batch_predict
of 32 on one GPU, with chip_smoke.py's seeded weights, images and conf, or
their bf16 train step at batch 16, and v11s's on the mosaic.

    python3 chip_profile.py [v8] [v12] [train]

For each path and End2End mode: 5 unprofiled walls, the network forward
alone (CUDA events), and a torch.profiler trace of 3 calls: the device's
busy time and idle share of the traced window, and device time by kernel
family and by kernel name. `train`: for v8s and v12s (End2End, the Config
default), the train step of train.py on one in-memory batch of 16 640x640
images with 1-32 boxes each in 32 label slots (no loader): 5 unprofiled
steps (each ends in its host sync), then a trace of 3 steps, reported the
same way; then v11s's step on one planned batch of the mosaic (a
YoloDataset.device_batch of 16 images that chip_smoke.write_dataset
writes), whose device render runs inside the step, traced the same way,
and beside it a trace of the render alone, so that the render's kernels
can be told by name among the step's. Exits non-zero without a CUDA
device.
"""
import tempfile
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from yolosharp_tpu_torch import Config, YoloSize, YoloTask, YoloType
from yolosharp_tpu_torch.loss import flatten_levels

if not torch.cuda.is_available():
    sys.exit("chip_profile: no CUDA device")
dev = torch.device("cuda", 0)
print(cs.card(), flush=True)


def family(name):
    if "conv_stem_kernel" in name or "conv_f32_kernel" in name \
            or "conv_wg_kernel" in name:
        return "conv3x3"
    if "c2f" in name:
        return "c2f"
    if "attention" in name:
        return "attention"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "memcpy/memset"
    return "other"


def report(mode, prof, window, calls):
    """Device busy time and idle share of the traced window, device time
    by kernel family and the largest kernels by name."""
    # device events, without the GPU spans of record_function ranges such
    # as "Optimizer.step#AdamW.step", which cover kernels and the gaps
    # between them
    kern = [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy /= 1e3
    print(f"[{mode}] profiled window {window:.2f} ms for {calls} calls; "
          f"device busy {busy:.2f} ms ({busy / calls:.2f} per call); idle "
          f"share {1 - busy / window:.3f}", flush=True)
    fam, names = {}, {}
    for ev in kern:
        d = (ev.time_range.end - ev.time_range.start) / 1e3
        fam[family(ev.name)] = fam.get(family(ev.name), 0.0) + d
        k = names.setdefault(ev.name, [0.0, 0])
        k[0] += d
        k[1] += 1
    tot = sum(fam.values())
    for f, d in sorted(fam.items(), key=lambda t: -t[1]):
        print(f"    {f}: {d / calls:.3f} ms per call, {d / tot:.3f} of "
              f"kernel time", flush=True)
    for n, (d, c) in sorted(names.items(), key=lambda t: -t[1][0])[:14]:
        print(f"        {d / calls:8.3f} ms/call  x{c // calls:<4d} "
              f"{n[:110]}", flush=True)


def trace(mode, fn, unprofiled=True):
    """2 warm-up calls of fn, 5 unprofiled walls (each call ends in a host
    sync), then a torch.profiler trace of 3 calls, reported."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if unprofiled:
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[{mode}] unprofiled calls ms: {[round(w, 2) for w in walls]}",
              flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    report(mode, prof, window, 3)


def profile_train(version, batch=None):
    """The train step of {version}s on `batch` (a device batch; default one
    in-memory letterbox batch)."""
    from yolosharp_tpu_torch.data import to_device
    from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                           make_train_step)

    det = YoloTask(Config(yolo_type=YoloType(version), yolo_size=YoloSize.s,
                          number_class=80), device=dev).task
    net = det._ensure_variables().to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=80, epochs=1, steps_per_epoch=10)
    state = TrainState(net, opt, scheds)
    step = make_train_step(det._loss_fns()[0], compute_dtype=det.dtype)
    mosaic = batch is not None
    if not mosaic:
        batch = to_device(cs.train_batch(cs.TRAIN_BATCH, cs.TRAIN_SIZE, 60,
                                         slots=32), dev)
    mode = (f"{version}s train b{cs.TRAIN_BATCH} {cs.TRAIN_SIZE}"
            + (" mosaic (device render in the step)" if mosaic else ""))
    trace(mode, lambda: step(state, batch, {}))


def profile_mosaic_train():
    """v11s's step on one planned batch of the device render, and the
    render alone."""
    from yolosharp_tpu_torch.data import YoloDataset, to_device
    from yolosharp_tpu_torch.data.device_augment import render_batch

    with tempfile.TemporaryDirectory() as root:
        cs.write_dataset(root, cs.TRAIN_BATCH, 2)
        ds = YoloDataset(cs._train_config(root, "v11"))
        batch = to_device(ds.device_batch(np.arange(cs.TRAIN_BATCH),
                                          ds.max_label_count), dev)
    profile_train("v11", batch)
    trace(f"render alone b{cs.TRAIN_BATCH} {cs.TRAIN_SIZE}",
          lambda: render_batch(batch))


versions = sys.argv[1:] or ["v8", "v12"]
for version in versions:
    if version == "train":
        for v in ("v8", "v12"):
            profile_train(v)
        profile_mosaic_train()
        continue
    master = YoloTask(Config(yolo_type=YoloType(version),
                             yolo_size=YoloSize.s, number_class=80,
                             end2end=True), device=dev)
    net = master.task._ensure_variables()
    cs.seed_weights(net)
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    tasks = cs.build_tasks(dev, version, state)
    batch = cs.synthetic_images(cs.SERVED_BATCH, 640, 640, 20)
    det = tasks[False].task
    x = torch.from_numpy(np.stack(batch)).to(dev).permute(0, 3, 1, 2)
    x = (x.float() / 255.0).to(det.dtype).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        preds = det._predict_variables()(x)
    flat = flatten_levels(preds["one2many"]["cls"]).float().sigmoid()
    flat = flat.amax(-1).cpu().numpy()
    conf = float(np.quantile(flat, 1 - cs.CANDIDATES / flat.shape[1],
                             axis=1).max())
    for e2e, task in tasks.items():
        mode = f"{version} {'end2end' if e2e else 'nms'}"
        for _ in range(2):
            task.batch_predict(batch, conf)
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            task.batch_predict(batch, conf)
            walls.append((time.perf_counter() - t0) * 1e3)
        fwd = task.task._predict_variables()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            fwd(x)
            s.record()
            for _ in range(5):
                fwd(x)
            e.record()
        torch.cuda.synchronize()
        print(f"[{mode}] batch_predict {len(batch)}x640 unprofiled walls ms: "
              f"{[round(w, 2) for w in walls]}", flush=True)
        print(f"[{mode}] network forward alone (CUDA events, 5 calls): "
              f"{s.elapsed_time(e) / 5:.3f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                task.batch_predict(batch, conf)
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3
        report(mode, prof, window, 3)
