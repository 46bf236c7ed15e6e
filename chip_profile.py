"""Where the time goes (PERF.md section 5): the 640 bf16 batch_predict of
32 on one GPU of a chip_smoke.py path (v8s, v12s, v11s, v5us, v11m-seg,
v11m-pose, v12x-obb), with its seeded weights, images and conf, or v8s's
and v12s's bf16 train step at batch 16 and v11s's on the mosaic
(`train`), or v11m-seg's at batch 8 on a planned mosaic batch with masks
(`seg-train`), or v11m-pose's on one with keypoints (`pose-train`), or
v12x-obb's on one with rotated boxes (`obb-train`), or the 224 bf16
batch_predict of 32 of v8s-cls (`v8s-cls`).

    python3 chip_profile.py [v8] [v12] [v11m-seg] [v11m-pose] [v12x-obb]
                            [train] [seg-train] [pose-train] [obb-train]
                            [v8s-cls] [cls-train]

For each path and End2End mode: 5 unprofiled walls, the host time of
building one call's results from its rows (the YoloResults, a pose
row's KeyPoints and a segment row's mask copy), the network forward
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
can be told by name among the step's. `seg-train`: the same for
v11m-seg on one planned batch of 8 (chip_smoke.write_seg_dataset), whose
images and masks render inside the step, and beside it the mask render
alone. `pose-train`: v11m-pose's step on one planned batch of 8
(chip_smoke.write_pose_dataset), whose images render inside the step and
whose keypoints the planner moved. `obb-train`: v12x-obb's End2End step
on one planned batch of 8 (chip_smoke.write_obb_dataset). In every train
mode each attention backward (KernelAttention's: in bf16 the kernel
fused_attention_bwd, in float32 the plain one) runs inside a
record_function range, "attention_backward", whose device time is
reported beside the step's.
`v8s-cls`: chip_smoke's seeded v8s-cls (nc = 1000) serving 32 images of
224x224 and of 480x640 a call: the host's squash of the 32 images to
224x224 (resize_linear) alone, the network forward alone (CUDA events),
5 unprofiled walls and a trace of 3 calls, reported as above.
`cls-train`: v8s-cls's (nc = 10) bf16 train step on one in-memory batch
of 32 224x224 images (no loader), as `train`.
Exits non-zero without a CUDA device.
"""
import tempfile
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke as cs
from yolosharp_tpu_torch import YoloTask
from yolosharp_tpu_torch.loss import flatten_levels

if not torch.cuda.is_available():
    sys.exit("chip_profile: no CUDA device")
dev = torch.device("cuda", 0)
print(cs.card(), flush=True)


def family(name):
    if "conv_stem_kernel" in name or "conv_f32_kernel" in name \
            or "conv_tc_kernel" in name:
        return "conv3x3"
    if "c2f" in name:
        return "c2f"
    if "attention" in name or "attn16_kernel" in name:
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
    # the attention backward's ranges (obb-train): their device spans
    # (kernels and the gaps between them) and the kernels inside them
    ranges = sorted((ev.time_range.start, ev.time_range.end)
                    for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and getattr(ev, "is_user_annotation", False)
                    and ev.name == "attention_backward")
    if ranges:
        span = sum(b - a for a, b in ranges) / 1e3
        inside = sum(e - s for s, e in spans
                     if any(a <= s < b for a, b in ranges)) / 1e3
        print(f"    attention backward ranges: {len(ranges) // calls} a "
              f"call; device span {span / calls:.3f} ms per call, kernels "
              f"inside them {inside / calls:.3f} ms per call, "
              f"{inside / busy:.3f} of device busy", flush=True)
    tot = sum(fam.values())
    for f, d in sorted(fam.items(), key=lambda t: -t[1]):
        print(f"    {f}: {d / calls:.3f} ms per call, {d / tot:.3f} of "
              f"kernel time", flush=True)
    for n, (d, c) in sorted(names.items(), key=lambda t: -t[1][0])[:14]:
        print(f"        {d / calls:8.3f} ms/call  x{c // calls:<4d} "
              f"{n[:110]}", flush=True)


def trace(mode, fn, unprofiled=True):
    """2 warm-up calls of fn, 5 unprofiled walls (each call ends in a host
    sync; with the peak device memory they allocate), then a
    torch.profiler trace of 3 calls, reported."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if unprofiled:
        walls = []
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[{mode}] unprofiled calls ms: {[round(w, 2) for w in walls]}"
              f"; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB",
              flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    report(mode, prof, window, 3)


def profile_train(path, batch=None):
    """The train step of a chip_smoke path's model on `batch` (a device
    batch; default one in-memory letterbox batch of 16)."""
    from yolosharp_tpu_torch.data import to_device
    from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                           make_train_step)

    det = YoloTask(cs.path_config(path), device=dev).task
    net = det._ensure_variables().to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=cs.PATH_NC.get(path, 80), epochs=1,
                                 steps_per_epoch=10)
    state = TrainState(net, opt, scheds)
    step = make_train_step(det._loss_fns()[0], compute_dtype=det.dtype)
    mosaic = batch is not None
    if not mosaic:
        batch = to_device(cs.train_batch(cs.TRAIN_BATCH, cs.TRAIN_SIZE, 60,
                                         slots=32), dev)
    mode = (f"{path} train b{batch['cls'].shape[0]} {cs.TRAIN_SIZE}"
            + (" mosaic (device render in the step)" if mosaic else ""))
    from yolosharp_tpu_torch.kernels.attention import KernelAttention

    real = KernelAttention.backward

    def backward(ctx, g):
        with record_function("attention_backward"):
            return real(ctx, g)

    KernelAttention.backward = staticmethod(backward)
    try:
        trace(mode, lambda: step(state, batch, {}))
    finally:
        KernelAttention.backward = staticmethod(real)


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


def profile_seg_train():
    """v11m-seg's step on one planned batch of 8 (images and masks render
    inside the step), and the mask render alone."""
    from yolosharp_tpu_torch.data import YoloDataset, to_device
    from yolosharp_tpu_torch.data.device_augment import render_masks

    with tempfile.TemporaryDirectory() as root:
        cs.write_seg_dataset(root, cs.SEG_BATCH, 2)
        ds = YoloDataset(cs._seg_train_config(root))
        batch = to_device(ds.device_batch(np.arange(cs.SEG_BATCH),
                                          ds.max_label_count), dev)
    profile_train(cs.SEG, batch)
    trace(f"mask render alone b{cs.SEG_BATCH} {cs.TRAIN_SIZE}",
          lambda: render_masks(batch))


def profile_pose_train():
    """v11m-pose's step on one planned batch of 8 (the images render inside
    the step; the keypoints come planned)."""
    from yolosharp_tpu_torch.data import YoloDataset, to_device

    with tempfile.TemporaryDirectory() as root:
        cs.write_pose_dataset(root, cs.POSE_BATCH, 2)
        ds = YoloDataset(cs._pose_train_config(root))
        batch = to_device(ds.device_batch(np.arange(cs.POSE_BATCH),
                                          ds.max_label_count), dev)
    profile_train(cs.POSE, batch)


def profile_obb_train():
    """v12x-obb's End2End step on one planned batch of 8 (the images render
    inside the step; the planner moved the corners)."""
    from yolosharp_tpu_torch.data import YoloDataset, to_device

    b = cs.OBB_BATCHES[-1]
    with tempfile.TemporaryDirectory() as root:
        cs.write_obb_dataset(root, b, 2)
        ds = YoloDataset(cs.path_config(
            cs.OBB, root_path=root, train_data_path="images/train",
            val_data_path="images/val", image_size=cs.TRAIN_SIZE,
            batch_size=b))
        batch = to_device(ds.device_batch(np.arange(b), ds.max_label_count),
                          dev)
    profile_train(cs.OBB, batch)


def profile_cls():
    """v8s-cls b32 batch_predict at 224 from 224x224 and from 480x640
    images: where a call's time goes, host resize against device."""
    from yolosharp_tpu_torch.data.image_ops import resize_linear

    task = cs.cls_task(dev, cs.CLS)
    cs.seed_weights(task.task._ensure_variables(), scale=cs.CLS_SEED_SCALE)
    for h, w in (cs.CLS_CANVAS, (480, 640)):
        mode = f"{cs.CLS} b{cs.SERVED_BATCH} from {h}x{w}"
        batch = cs.synthetic_images(cs.SERVED_BATCH, h, w, 90)
        t0 = time.perf_counter()
        squashed = [resize_linear(im, *cs.CLS_CANVAS) for im in batch]
        print(f"[{mode}] the host's squash of {len(batch)} images to "
              f"224x224: {(time.perf_counter() - t0) * 1e3:.2f} ms",
              flush=True)
        x = cs.cls_input(dev, squashed, task.task.dtype)
        fwd = task.task._predict_variables()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            fwd(x)
            s.record()
            for _ in range(10):
                fwd(x)
            e.record()
        torch.cuda.synchronize()
        print(f"[{mode}] network forward alone (CUDA events, 10 calls): "
              f"{s.elapsed_time(e) / 10:.3f} ms", flush=True)
        trace(mode, lambda: task.batch_predict(batch))


def profile_cls_train():
    """v8s-cls's bf16 train step at b32 224 on one in-memory batch (no
    loader), nc = 10 as chip_smoke's phase 12c."""
    from yolosharp_tpu_torch.data import to_device
    from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                           make_train_step)

    task = cs.cls_task(dev, cs.CLS, number_class=cs.CLS_CLASSES).task
    net = task._ensure_variables().to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=cs.CLS_CLASSES, epochs=1,
                                 steps_per_epoch=10)
    state = TrainState(net, opt, scheds)
    step = make_train_step(task._loss_fns()[0], compute_dtype=task.dtype)
    rng = np.random.default_rng(61)
    batch = to_device({"images": np.stack(cs.synthetic_images(
        cs.CLS_TRAIN_BATCH, *cs.CLS_CANVAS, 61)),
        "cls": rng.integers(0, cs.CLS_CLASSES, cs.CLS_TRAIN_BATCH).astype(
            np.int32)}, dev)
    trace(f"{cs.CLS} train b{cs.CLS_TRAIN_BATCH} 224",
          lambda: step(state, batch, {}))


versions = sys.argv[1:] or ["v8", "v12"]
for version in versions:
    if version == cs.CLS:
        profile_cls()
        continue
    if version == "cls-train":
        profile_cls_train()
        continue
    if version == "train":
        for v in ("v8", "v12"):
            profile_train(v)
        profile_mosaic_train()
        continue
    if version == "seg-train":
        profile_seg_train()
        continue
    if version == "pose-train":
        profile_pose_train()
        continue
    if version == "obb-train":
        profile_obb_train()
        continue
    master = YoloTask(cs.path_config(version, end2end=True), device=dev)
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
        # the host's share: one call's result objects built from its rows
        t = task.task
        canvas = torch.from_numpy(np.stack(batch))
        out = t._host(t._predict_fn(t._predict_variables(), canvas.to(dev),
                                    0.0 if e2e else conf,
                                    t.config.iou_threshold))
        t0 = time.perf_counter()
        rows = t._results(out, conf, tuple(canvas.shape[1:3]),
                          [im.shape[:2] for im in batch])
        print(f"[{mode}] the results of one call built on the host from its "
              f"rows: {(time.perf_counter() - t0) * 1e3:.2f} ms "
              f"({sum(map(len, rows))} results)", flush=True)
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
