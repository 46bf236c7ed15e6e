"""The task layer for detect, segment, pose, OBB and classify and the
YoloTask facade (counterpart of yolosharp_tpu/tasks.py: BaseTask /
Detector / Segmenter / PoseDetector / Obber / Classifier / YoloTask):
train, val, predict, predict_stream, load and save.

Predict: requests arrive as uint8 HWC RGB numpy arrays, are padded with 114
to a multiple of 32 on the host, shipped as uint8 and normalised (/255) on
the device. Results come back in one bulk transfer as YoloResults in canvas
pixels. With End2End the NMS-free top-k runs with conf 0 and rows are
filtered on the host. Predict runs a BN-folded copy of the master network
in the compute dtype, refolded whenever a master parameter or buffer has
changed (training bumps their versions). Segment predict decodes each
image's masks on the device from the proto and the kept rows' coefficients
(process_mask, upsampled to the canvas) and copies them to the host once
an image, as bool. Pose rows carry their K keypoints, decoded to canvas
pixels on the device, as KeyPoints. OBB rows carry a rotated box: centre,
size and ``radian``, from the rotated NMS (fast suppression over probiou)
or the End2End top-k. Classify squashes each image to s x s
(image_predict / batch_predict) and returns its top-5 classes and their
float32 softmax scores. With Config.int8_predict and calibration stats
(calibrate_int8 / load_calibration, the JAX package's npz), every predict
route runs the eligible convs in int8 (kernels/int8_conv.py).

predict_stream (every family): images letterboxed to s x s (classify: the
short side to s, then the centre crop) on a pool of host threads, batched
(a partial last batch padded with repeats, dropped again), copied pinned
to the device on a transfer thread, and run in a depth-2 pipeline: batch N
is dispatched before batch N-1's results are fetched and unpacked. Rows
come back in the original image's pixels; a segment row's mask as float32
(the canvas mask's content region resized back by resize_linear_f32, as
the JAX package's cv2.resize).

Train: the float32 master network in train mode, batches from data/
copied to the device ahead of the step (while the mosaic is open, planned
batches that the step renders on the device, or host mosaic4 +
random_perspective samples; letterbox after close_mosaic; classify: the
RandomResizedCrop / AutoAugment stack of ClassificationDataset), the
train step of train.py, then val on the unfolded eval-mode master, which
matches each batch's predictions to its ground truths in one device call
(classify: top1 / top5 of the float32 softmax), and the outputs of the JAX
package: config.txt, log.csv, weights/best.bin, weights/last.bin and
weights/last_state.npz (weights/last_state.dcp, a
torch.distributed.checkpoint directory, with resume_format="orbax"). The
master stays in eval mode outside train().

Several devices (parallel/): train() and val() run data-parallel over the
largest count of the visible CUDA devices that divides the batch
(_make_mesh, as the JAX package's), one process a device under a process
group (parallel.dist.run_ranks: the caller is rank 0), BN statistics and
loss normalisers over the global batch, so that a step equals the
single-device step at the same batch; Config.fsdp shards the train state
(parallel.fsdp). batch_predict and predict_stream take a ``mesh``
(parallel.create_mesh): in one process, the folded net replicated on each
of its devices, the rows split (padded to a multiple of its data axis)
and each device run from a host thread of its own; results in order.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import glob
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .ckpt import (bias_init, clone_one2one, export_state_dict, fold_bn,
                   load_state_dict_file, load_state_dict_into, save_bin,
                   skip_patterns_for_nc_mismatch)
from .ckpt.fuse import calibration_stats, start_calibration
from .ckpt.resume import (restore_train_state, save_train_state,
                          save_train_state_dcp)
from .config import Config, resolve_device, torch_dtype
from .data import (ClassificationDataset, DataLoader, YoloDataset,
                   device_prefetch, to_device)
from .data.augment import _resize_pad
from .data.dataset import center_crop
from .data.image_ops import (nearest_indices, read_image_rgb, resize_linear,
                             resize_linear_f32)
from .loss import (OKS_SIGMA, classification_loss, detection_loss,
                   e2e_gain_schedule, e2e_wrap, obb_loss, pose_loss,
                   segmentation_loss)
from .nn import ArchCfg, YoloNet
from .ops.boxes import xywh2xyxy
from .ops.iou import batch_probiou, box_iou, kpt_iou, mask_iou
from .ops.masks import process_mask
from .ops.nms import NMSOutput, non_max_suppression
from .parallel import (DATA_AXIS, Mesh, ShardedParams, create_mesh, dist,
                       replicate_tree, shard_batch, visible_devices)
from .predict import (decode_inference, decode_inference_topk,
                      e2e_postprocess, pad_to_multiple)
from .train import (MAX_LOSS_SCALE, TrainState, make_eval_step,
                    make_optimizer, make_train_step)
from .types import KeyPoint, TaskType, YoloResult
from .utils import (EarlyStopping, StepTrace, TrainLogger, ap_per_class,
                    match_predictions, summarize)
from .utils.numerics import divide_by_constant, full_float32


def _warn_if_truncated(nms_out, state: Optional[Dict] = None) -> None:
    """Surface NMS candidate-pool truncation (see Config.nms_pre_topk). With
    a stream's `state` dict it prints once a stream, and the stream's end
    prints how many batches were truncated."""
    if not np.asarray(nms_out.truncated).any():
        return
    suffix = ""
    if state is not None:
        state["truncated_batches"] = state.get("truncated_batches", 0) + 1
        if state["truncated_batches"] > 1:
            return
        suffix = " (warning once per stream)"
    print("WARNING: above-threshold NMS candidates exceeded "
          "Config.nms_pre_topk; low-score boxes may be missing. "
          "Raise nms_pre_topk or set it to None for exact NMS." + suffix)


def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    """Dotted keys -> the nested dict they name (the JAX package's tree of
    calibration stats)."""
    tree: Dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _rank_main(cls, config: Config, kind: str, args: tuple) -> None:
    """A spawned rank of BaseTask._run_ranks: the same task on the rank's
    device, its part of `kind` ("train" or "val")."""
    cls(config, dist.active().device)._rank_entry(kind, args)


def _on_device(dev: torch.device, fn, *args):
    """fn(*args) with `dev` the current CUDA device (a mesh thread's)."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return fn(*args)
    return fn(*args)


def _merge_val(acc, part) -> None:
    """Add a val accumulator `part` to `acc` (lists extend, counts add)."""
    for k, v in part.items():
        if isinstance(v, list):
            acc[k].extend(v)
        else:
            acc[k] += v


def _mesh_batch(batch_size: int, mesh: Optional[Mesh]) -> int:
    """A stream's batch size rounded up to a multiple of the mesh's data
    axis, as the JAX package's (yolosharp_tpu/tasks.py:888-892)."""
    if mesh is None:
        return batch_size
    dp = mesh.shape[DATA_AXIS]
    return -(-batch_size // dp) * dp


def _to_host(out):
    if isinstance(out, NMSOutput):
        return NMSOutput(*(t.cpu().numpy() for t in out))
    return out.cpu().numpy()


def _image_gts(batch, i, scale):
    """(classes, xywh pixels, xyxy pixels, valid mask) of image i's ground
    truths in a host batch; `scale` is [w, h, w, h] of its canvas."""
    gmask = batch["mask_gt"][i]
    gxywh = batch["bboxes"][i][gmask][:, :4] * scale
    gxyxy = np.concatenate([gxywh[:, :2] - gxywh[:, 2:] / 2,
                            gxywh[:, :2] + gxywh[:, 2:] / 2], -1)
    return batch["cls"][i][gmask].astype(float), gxywh, gxyxy, gmask


def _unletterbox(boxes: np.ndarray, meta) -> list:
    """Canvas boxes' corners (n, 4) xyxy in the original image's pixels,
    as Python floats: the letterbox undone and clipped to the image (meta
    = (ratio, pad left, pad up, image h, image w)); the JAX package's
    float32 arithmetic, one array op for all rows."""
    ratio, pl, pu, ih, iw = meta
    x = np.clip((boxes[:, 0::2] - pl) / ratio, 0, iw)
    y = np.clip((boxes[:, 1::2] - pu) / ratio, 0, ih)
    return np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], -1).tolist()


@contextlib.contextmanager
def _gc_paused():
    """The cyclic garbage collector paused while many small result objects
    are built (a pose row holds K KeyPoints): the collections their
    allocations trigger would walk the whole heap, most of a b32 pose
    call's host time."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class BaseTask:
    """What every task family shares (the JAX package's BaseTask): the
    device and compute type, the float32 master network and its folded
    predict copy, load and save, the train loop and val, whose per-task
    parts are the hooks _loss_fns, _dataset, _decode_for_val,
    _new_val_accumulator, _accumulate_val and _finalize_val."""

    loss_names: Tuple[str, ...] = ()
    metric_names: Tuple[str, ...] = ()

    def __init__(self, config: Config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = torch_dtype(config)
        self.arch = ArchCfg(
            version=config.yolo_type.value, size=config.yolo_size.value,
            task=config.task_type.value, nc=config.number_class,
            kpt_num=config.keypoint_num, kpt_dim=config.keypoint_dim,
            end2end=config.end2end and config.task_type != TaskType.classify)
        self.net: Optional[YoloNet] = None
        self._fused: Optional[Tuple[tuple, YoloNet]] = None
        # int8 calibration stats {flax path + ".absmax": float32} and a
        # count of their changes (the predict copy's cache key)
        self._quant_stats: Optional[Dict[str, np.ndarray]] = None
        self._quant_version = 0
        # per epoch of the last train(): each step's wall seconds (each
        # ends in the step's host sync) and seconds waiting on the loader
        # before it, the seconds of the step loop and of val, and on CUDA
        # the peak device memory of the step loop (bytes)
        self.epoch_stats: List[Dict] = []
        # the Chrome trace the last train() wrote (Config.profile_dir)
        self.trace_path: Optional[str] = None

    # ------------------------------------------------------------- setup
    def _init_head(self, net: YoloNet) -> None:
        """The head's prior, applied to a new or partly loaded network."""

    def _ensure_variables(self) -> YoloNet:
        """The float32 master network, built on first use from a seeded
        generator, with the head's prior (_init_head)."""
        if self.net is None:
            net = YoloNet(self.arch, torch.Generator().manual_seed(0))
            self._init_head(net)
            self.net = net.to(self.device).eval()
        return self.net

    def _cast_predict(self, net: YoloNet) -> YoloNet:
        """The predict copy in the compute dtype."""
        return net.to(self.dtype)

    def _predict_variables(self) -> YoloNet:
        """The network predict runs: a copy of the master in the compute
        dtype, BN-folded when Config.fuse_inference (folded in float32 once,
        then cast); with Config.int8_predict and calibration stats, its
        eligible convs quantised from the float32 fold (int8, as the JAX
        package's _apply_eval; without stats it predicts in float, as JAX
        does). Cached until a master parameter or buffer, or the stats,
        change."""
        net = self._ensure_variables()
        stats = self._quant_stats if self.config.int8_predict else None
        key = (id(net), tuple(t._version for t in itertools.chain(
            net.parameters(), net.buffers())),
            None if stats is None else self._quant_version)
        if self._fused is None or self._fused[0] != key:
            pred = copy.deepcopy(net)
            if self.config.fuse_inference:
                fold_bn(pred, stats)
            self._fused = (key, self._cast_predict(pred).eval())
        return self._fused[1]

    # -------------------------------------------------------------- int8
    @full_float32()
    def calibrate_int8(self, images=None, n_images: int = 16,
                       batch_size: int = 8) -> Dict:
        """Post-training int8 activation calibration (the JAX package's
        calibrate_int8): eval forwards of the BN-folded float32 master
        (both End2End branches; JAX runs its folded float32 tree on float32
        images whatever the compute dtype), each int8-eligible conv
        recording the max |x| of its input, running over the batches and
        over earlier calibrations. `images`: file paths (read as
        cv2.imread reads them, BGR, which the JAX package keeps) or HxWx3
        uint8 arrays (used as given); None takes the sorted jpg / jpeg /
        png / bmp files under Config.root_path. The first n_images, each
        squashed to image_size x image_size (resize_linear, cv2's
        INTER_LINEAR) and divided by 255, in chunks of batch_size. Predict
        then runs those convs in int8 when Config.int8_predict is set.
        Returns the stats as the JAX package's nested tree."""
        cfg = self.config
        if images is None:
            found = []
            for ext in ("jpg", "jpeg", "png", "bmp"):
                found += glob.glob(os.path.join(cfg.root_path or ".", "**",
                                                f"*.{ext}"), recursive=True)
            if not found:
                raise FileNotFoundError(
                    f"calibrate_int8: no images under {cfg.root_path!r}; "
                    f"pass images= explicitly")
            images = sorted(found)[:n_images]
        s = cfg.image_size
        arrs = []
        for im in list(images)[:n_images]:
            if isinstance(im, (str, os.PathLike)):
                im = read_image_rgb(str(im))[..., ::-1]
            im = resize_linear(np.ascontiguousarray(im, np.uint8), s, s)
            arrs.append(np.asarray(im, np.float32) / 255.0)
        if not arrs:
            raise ValueError("calibrate_int8: empty image list")
        net = copy.deepcopy(self._ensure_variables())
        fold_bn(start_calibration(net)).eval()
        with torch.inference_mode():
            for i in range(0, len(arrs), batch_size):
                x = torch.from_numpy(np.stack(arrs[i:i + batch_size]))
                net(x.to(self.device).permute(0, 3, 1, 2).contiguous(
                    memory_format=torch.channels_last))
        stats = calibration_stats(net)
        for k, v in (self._quant_stats or {}).items():
            stats[k] = np.maximum(stats[k], v) if k in stats else v
        self._set_quant_stats(stats)
        print(f"int8 calibration: {len(stats)} convs calibrated over "
              f"{len(arrs)} images")
        return _nest(stats)

    def save_calibration(self, path: str) -> None:
        """The int8 calibration stats as the JAX package's npz: one float32
        scalar a conv, under its dotted flax path + ".absmax"."""
        if self._quant_stats is None:
            raise ValueError("no calibration stats: run calibrate_int8 first")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **self._quant_stats)

    def load_calibration(self, path: str) -> Dict:
        """Load stats saved by save_calibration (of either package);
        returns them as a nested tree."""
        with np.load(path) as z:
            stats = {k: z[k] for k in z.files}
        self._set_quant_stats(stats)
        return _nest(stats)

    def _set_quant_stats(self, stats: Dict[str, np.ndarray]) -> None:
        self._quant_stats = stats
        self._quant_version += 1

    def _stream(self, images, batch_size: int, prep_one, workers: int,
                dispatch, unpack, mesh: Optional[Mesh] = None):
        """The predict_stream pipeline: prep_one(image) -> (uint8 (s, s, 3),
        meta) on a pool of `workers` host threads, batches of batch_size (a
        partial last batch padded with repeats of its last image; its metas
        name only the real ones), each copied to the device on a transfer
        thread (device_prefetch, pinned on CUDA), then depth 2: batch N is
        dispatched (dispatch(net, uint8 batch on the net's device) ->
        output) before unpack(output of batch N-1, its metas) yields its
        images' results, in order. With a `mesh` (batch_size a multiple of
        its data axis) each batch's rows are split over its devices, each
        slice dispatched from a host thread of its own to the device's
        replica of the predict net, and unpacked in order."""
        nets, devices = self._replicas(mesh)
        per = batch_size // len(nets)
        pool = self._mesh_pool(len(nets)) if len(nets) > 1 else None

        def host_batches():
            with ThreadPoolExecutor(max(1, workers)) as pool:
                buf, metas = [], []
                for out, meta in pool.map(prep_one, images):
                    buf.append(out)
                    metas.append(meta)
                    if len(buf) == batch_size:
                        yield np.stack(buf), metas
                        buf, metas = [], []
                if buf:
                    buf += [buf[-1]] * (batch_size - len(buf))
                    yield np.stack(buf), metas

        def put(item):
            batch, metas = item
            return [to_device({"images": batch[i * per:(i + 1) * per]},
                              dev)["images"]
                    for i, dev in enumerate(devices)], metas

        def launch(xbs):
            if pool is None:
                return [dispatch(nets[0], xbs[0])]
            return [pool.submit(_on_device, dev, dispatch, net, xb)
                    for dev, net, xb in zip(devices, nets, xbs)]

        def finish(outs, metas):
            for i, out in enumerate(outs):
                out = out if pool is None else out.result()
                yield from unpack(out, metas[i * per:(i + 1) * per])

        pending = []
        for xbs, metas in device_prefetch(host_batches(), put):
            pending.append((launch(xbs), metas))
            if len(pending) >= 2:
                yield from finish(*pending.pop(0))
        while pending:
            yield from finish(*pending.pop(0))

    # --------------------------------------------------------------- mesh
    def _visible_devices(self) -> List[torch.device]:
        """The devices train() may use: every visible CUDA device when the
        task's device is "cuda" without an index, else the task's own."""
        if self.device.type == "cuda" and self.device.index is None:
            return visible_devices("cuda")
        return [self.device]

    def _make_mesh(self, batch_size: int) -> Optional[Mesh]:
        """Data-parallel mesh over the largest count of the visible devices
        that divides the batch, cached per batch size (the JAX package's
        _make_mesh, yolosharp_tpu/tasks.py:333-365: no silent single-device
        fallback; fewer devices than visible, or one, is reported). None
        for one device."""
        cache = self.__dict__.setdefault("_mesh_cache", {})
        if batch_size in cache:
            return cache[batch_size]
        devices = self._visible_devices()
        n_dev = len(devices)
        d = max((k for k in range(1, n_dev + 1) if batch_size % k == 0),
                default=1)
        if d <= 1:
            cache[batch_size] = None
            if n_dev > 1:
                print(f"WARNING: batch_size={batch_size} shares no divisor "
                      f"with the {n_dev} visible devices; training runs "
                      f"single-device. Pick a batch size divisible by "
                      f"{n_dev} to use all chips.")
            return None
        if d < n_dev:
            print(f"WARNING: batch_size={batch_size} is not divisible by "
                  f"{n_dev} devices; using a {d}-device data mesh. Pick a "
                  f"batch size divisible by {n_dev} to use all chips.")
        for m in cache.values():
            if m is not None and m.size == d:
                cache[batch_size] = m
                return m
        cache[batch_size] = create_mesh(devices=devices[:d])
        return cache[batch_size]

    def _replicas(self, mesh: Optional[Mesh]):
        """(the predict net on each of `mesh`'s data_devices, those): the
        folded predict copy replicated, cached per (mesh, predict copy) as
        the JAX package's _replicated_vars; ([the predict net], [the
        task's device]) without a mesh."""
        net = self._predict_variables()
        if mesh is None:
            return [net], [self.device]
        key = (tuple(str(d) for d in mesh.data_devices), self._fused[0])
        cached = self.__dict__.get("_mesh_nets")
        if cached is None or cached[0] != key:
            self._mesh_nets = cached = (key, replicate_tree(net, mesh))
        return cached[1], list(mesh.data_devices)

    def _mesh_outputs(self, batch: torch.Tensor, mesh: Optional[Mesh], run):
        """[(run(net, rows on the net's device), first row, end row)]: the
        uint8 canvas `batch` whole through the predict net, or its rows
        padded to a multiple of `mesh`'s data axis (parallel.shard_batch)
        and split over its devices, each slice run from a host thread of
        its own (NMS syncs with the host) on that device's replica;
        (first, end) name the slice's real rows."""
        nets, devices = self._replicas(mesh)
        if mesh is None:
            return [(run(nets[0], batch.to(self.device)), 0,
                     batch.shape[0])]
        parts, n = shard_batch(batch.numpy(), mesh)
        per = parts[0].shape[0]

        def one(i):
            x = torch.from_numpy(parts[i]).to(devices[i])
            return _on_device(devices[i], run, nets[i], x)

        if len(parts) == 1:
            outs = [one(0)]
        else:
            outs = list(self._mesh_pool(len(parts)).map(one,
                                                        range(len(parts))))
        return [(out, min(i * per, n), min((i + 1) * per, n))
                for i, out in enumerate(outs)]

    def _mesh_pool(self, n: int) -> ThreadPoolExecutor:
        """The task's host threads of mesh predict, one a card, kept
        between calls (a thread's first CUDA call on a card sets up its
        library handles)."""
        size, pool = self.__dict__.get("_mesh_threads", (0, None))
        if size != n:
            if pool is not None:
                pool.shutdown(wait=False)
            pool = ThreadPoolExecutor(n, thread_name_prefix="mesh")
            self._mesh_threads = (n, pool)
        return pool

    def _run_ranks(self, mesh: Mesh, kind: str, args: tuple):
        """`kind` ("train" or "val") data-parallel over the data_devices of
        `mesh`: this process is rank 0 on the first, one spawned process a
        further device (parallel.dist.run_ranks); rank 0's return value."""
        self._ensure_variables()
        return dist.run_ranks(
            lambda: self._rank_entry(kind, args), _rank_main,
            (type(self), self.config, kind, args), mesh.data_devices)

    def _rank_entry(self, kind: str, args: tuple):
        """A rank's part of `kind`: the master network broadcast from rank 0
        (the caller's, with whatever it loaded), then train or val."""
        dist.broadcast_module(self._ensure_variables())
        if kind == "train":
            return self._train(*args)
        return self._val(None, *args)

    # -------------------------------------------------------- checkpoint
    def load_model(self, path: str, skip_nc_not_equal_layers: bool = False):
        """LoadModel semantics (YoloBaseTaskModel.cs:27-114): .bin,
        .safetensors or .pt by name; nc-mismatched head layers skipped on
        request (a classify net's linear; a pose net's cv4 towers by K kd),
        then given the head's prior; End2End towers cloned from one2many."""
        net = self._ensure_variables()
        sd = load_state_dict_file(path)
        skip: Tuple[str, ...] = ()
        if skip_nc_not_equal_layers:
            skip = skip_patterns_for_nc_mismatch(
                self.arch.task, len(net.model) - 1, sd,
                self.config.number_class,
                self.arch.kpt_num * self.arch.kpt_dim)
        report = load_state_dict_into(net, sd, skip)
        if self.arch.end2end:
            clone_one2one(net)
        if report.skipped:
            self._init_head(net)
        print(f"Model loaded: {report}")
        return report

    def save_weight(self, path: str, dtype=np.float32) -> None:
        """SaveWeight: LEB128 .bin, one2one excluded
        (YoloBaseTaskModel.cs:470)."""
        sd = export_state_dict(self._ensure_variables(), dtype=dtype)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_bin(path, sd)

    # -------------------------------------------------------------- losses
    def _loss_fns(self):
        """(train loss, eval loss): fn(preds, batch, **loss_kwargs) ->
        (scalar loss, items)."""
        raise NotImplementedError

    def _loss_kwargs(self, epoch: int) -> Dict:
        return {}

    # --------------------------------------------------------------- train
    def _dataset(self, is_val: bool):
        raise NotImplementedError

    def _make_datasets(self):
        return self._dataset(False), self._dataset(True)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict:
        return to_device(batch, self.device)

    def train(self, resume_from: Optional[str] = None,
              mesh: Optional[Mesh] = None) -> TrainState:
        """Train for Config.epochs (YoloBaseTaskModel.cs Train/TrainEpoch);
        resume_from: a last_state.npz or last_state.dcp, continued at its
        epoch + 1. With Config.profile_dir, steps 2-5 of the first epoch are
        traced (utils.training.StepTrace). Data-parallel over `mesh`
        (default: _make_mesh of the batch size; a rank each of its
        data_devices) where it has more than one; rank 0 (this process)
        writes the outputs and returns its TrainState."""
        cfg = self.config
        cfg.output_path = cfg.output_path or os.path.join(
            "result", self.arch.task,
            datetime.now().strftime("%y%m%d%H%M%S"))
        if dist.active() is None:
            mesh = mesh if mesh is not None else self._make_mesh(
                cfg.batch_size)
            ranks = mesh.data_devices if mesh is not None else []
            if len(ranks) > 1:
                if cfg.batch_size % len(ranks):
                    raise ValueError(f"batch_size={cfg.batch_size} does not "
                                     f"split over {len(ranks)} devices")
                print(f"Data-parallel train over {len(ranks)} devices: "
                      f"{[str(d) for d in ranks]}")
                return self._run_ranks(mesh, "train", (resume_from,))
        return self._train(resume_from)

    @full_float32()
    def _train(self, resume_from: Optional[str]) -> TrainState:
        """train()'s loop on this process's device; under an active group
        this rank's rows of each global batch (rank 0 writes the outputs,
        decides early stopping and broadcasts it)."""
        cfg = self.config
        ctx = dist.active()
        rank, world = (ctx.rank, ctx.world) if ctx is not None else (0, 1)
        main = rank == 0
        if main:
            print("Start Training:")
            print(cfg.describe())
        out_dir = cfg.output_path
        logger = TrainLogger(out_dir, self._log_headers()) if main else None
        if main:
            logger.write_config(cfg)

        train_ds, val_ds = self._make_datasets()
        if len(train_ds) == 0 or len(val_ds) == 0:
            raise FileNotFoundError(f"No data found in {cfg.root_path}")
        if world > 1:
            # each rank draws its own augmentation
            train_ds.rng = np.random.default_rng([0, rank])
        max_labels = cfg.max_labels or train_ds.max_label_count
        train_dl = DataLoader(train_ds, cfg.batch_size, shuffle=True,
                              workers=cfg.workers, max_labels=max_labels,
                              rank=rank, world=world)
        val_dl = DataLoader(val_ds, cfg.batch_size, shuffle=False,
                            workers=cfg.workers, max_labels=max_labels,
                            rank=rank, world=world)
        nb = len(train_dl)

        net = self._ensure_variables().to(memory_format=torch.channels_last)
        shards = ShardedParams(net) if cfg.fsdp and world > 1 else None
        opt, scheds = make_optimizer(
            net, nc=cfg.number_class, epochs=cfg.epochs, steps_per_epoch=nb,
            warmup_epochs=cfg.warm_up_epochs,
            warmup_bias_lr=cfg.warm_up_bias_lr, use_cos_lr=cfg.use_cos_lr,
            lrf=cfg.lrf,
            named_params=shards.named_masters() if shards else None)
        state = TrainState(
            net, opt, scheds,
            init_scale=MAX_LOSS_SCALE if cfg.true_fp16 else 1.0,
            shards=shards)
        if shards is not None and main:
            print(f"FSDP: train state sharded over {world} ranks "
                  f"(~{shards.local_bytes(opt) / 2**20:.1f} MiB/rank).")
        start_epoch = 1
        if resume_from:
            meta = restore_train_state(resume_from, state)
            start_epoch = int(meta.get("epoch", 0)) + 1
            if main:
                print(f"Resumed full train state from {resume_from} "
                      f"(continuing at epoch {start_epoch}).")
        train_loss_fn, _ = self._loss_fns()
        step_fn = make_train_step(train_loss_fn, compute_dtype=self.dtype,
                                  dynamic_loss_scale=cfg.true_fp16)

        stopper = EarlyStopping(cfg.patience)
        best_fitness = -float("inf")
        weights_dir = os.path.join(out_dir, "weights")
        os.makedirs(weights_dir, exist_ok=True)
        self.epoch_stats = []
        try:
            for epoch in range(start_epoch, cfg.epochs + 1):
                t0 = time.time()
                train_ds.close_mosaic(epoch > cfg.close_mosaic)
                loss_kwargs = self._loss_kwargs(epoch)
                items_sum = None
                stats = {"epoch": epoch, "step_s": [], "wait_s": []}
                if self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                trace = (StepTrace(cfg.profile_dir, self.device)
                         if cfg.profile_dir and epoch == start_epoch and main
                         else None)
                t_loop = t_prev = time.perf_counter()
                for batch in device_prefetch(train_dl, self._to_device):
                    t_got = time.perf_counter()
                    stats["wait_s"].append(t_got - t_prev)
                    if trace is not None:
                        trace.before_step(len(stats["step_s"]) + 1)
                    _, items = step_fn(state, batch, loss_kwargs)
                    items_sum = (items if items_sum is None
                                 else items_sum + items)
                    t_prev = time.perf_counter()
                    stats["step_s"].append(t_prev - t_got)
                    if trace is not None:
                        trace.after_step(len(stats["step_s"]))
                        t_prev = time.perf_counter()
                if trace is not None:   # a short epoch: close it cleanly
                    trace.close()
                    self.trace_path = trace.path
                stats["loop_s"] = t_prev - t_loop
                if self.device.type == "cuda":
                    stats["peak_bytes"] = torch.cuda.max_memory_allocated(
                        self.device)
                if world > 1:
                    # every rank's step loop, for rank 0's report
                    stats["ranks"] = dist.all_gather_object(
                        {k: stats.get(k) for k in ("step_s", "wait_s",
                                                   "loop_s", "peak_bytes")})
                # the reference's items: per-batch means summed over the
                # epoch, divided by the dataset size in the log
                train_items = (items_sum.cpu().numpy() if items_sum is not None
                               else np.zeros(len(self.loss_names)))

                t_val = time.perf_counter()
                val_items, metrics = self.val(val_dl, epoch)
                stats["val_s"] = time.perf_counter() - t_val
                self.epoch_stats.append(stats)
                fitness = -float(np.sum(val_items))
                if fitness > best_fitness:
                    best_fitness = fitness
                    if main:
                        self.save_weight(os.path.join(weights_dir,
                                                      "best.bin"))
                stop = stopper.should_stop(fitness, epoch)
                if world > 1:
                    stop = dist.broadcast_object(stop)
                if stop:
                    break
                if main:
                    self.save_weight(os.path.join(weights_dir, "last.bin"))
                if cfg.resume_format == "orbax":
                    save_train_state_dcp(
                        os.path.join(weights_dir, "last_state.dcp"), state,
                        {"epoch": epoch})
                else:
                    save_train_state(
                        os.path.join(weights_dir, "last_state.npz"), state,
                        {"epoch": epoch})
                dt = time.time() - t0
                if not main:
                    continue
                loss_str = " ".join(
                    f"{n}={v / max(len(train_ds), 1):.3f}"
                    for n, v in zip(self.loss_names, train_items))
                met_str = " ".join(f"{v:.3f}" for v in metrics)
                print(f"epoch {epoch}/{cfg.epochs} {dt:.1f}s {loss_str} "
                      f"| val metrics: {met_str}")
                logger.log_epoch(epoch, dt, list(train_items),
                                 list(val_items), list(metrics),
                                 len(train_ds), len(val_ds))
        finally:
            net.eval()
        if main:
            logger.draw_curves()
            print("Train Done.")
        return state

    def _log_headers(self) -> str:
        train_cols = ", ".join(f"train/{n}" for n in self.loss_names)
        val_cols = ", ".join(f"val/{n}" for n in self.loss_names)
        met_cols = ", ".join(f"metrics/{n}" for n in self.metric_names)
        return (f"Epoch, Time, {train_cols}, {val_cols}, {met_cols}, "
                f"train/loss, val/loss")

    # ----------------------------------------------------------------- val
    def val(self, val_dl: Optional[DataLoader] = None, epoch: int = 0,
            mesh: Optional[Mesh] = None):
        """(loss items summed over the batches, metric_names' values) of
        the unfolded eval-mode master network on `val_dl` (default: the
        configured val split, data-parallel over `mesh` or _make_mesh's
        devices where there are several, as the JAX eval step is sharded:
        loss items summed over the ranks, the metrics' statistics gathered
        to rank 0; the values equal one device's)."""
        if val_dl is None and dist.active() is None:
            mesh = mesh if mesh is not None else self._make_mesh(
                self.config.batch_size)
            if mesh is not None and len(mesh.data_devices) > 1:
                return self._run_ranks(mesh, "val", (epoch,))
        return self._val(val_dl, epoch)

    @full_float32()
    def _val(self, val_dl: Optional[DataLoader], epoch: int):
        """val() on this process's device: under an active group this
        rank's rows of each batch, each batch's statistics gathered to
        rank 0 in rank order (the single-device order), the metrics
        broadcast from it."""
        cfg = self.config
        ctx = dist.active()
        rank, world = (ctx.rank, ctx.world) if ctx is not None else (0, 1)
        if val_dl is None:
            ds = self._dataset(True)
            val_dl = DataLoader(ds, cfg.batch_size, shuffle=False,
                                workers=cfg.workers,
                                max_labels=cfg.max_labels
                                or ds.max_label_count,
                                rank=rank, world=world)
        net = self._ensure_variables()
        _, eval_loss_fn = self._loss_fns()
        eval_step = make_eval_step(eval_loss_fn, self._decode_for_val,
                                   compute_dtype=self.dtype)
        loss_kwargs = self._loss_kwargs(epoch)
        acc = self._new_val_accumulator()
        items_sum = None
        count = 0
        for batch, dbatch in device_prefetch(
                val_dl, lambda b: (b, self._to_device(b))):
            items, decoded = eval_step(net, dbatch, loss_kwargs)
            items_sum = items if items_sum is None else items_sum + items
            part = self._new_val_accumulator()
            self._accumulate_val(part, batch, dbatch, decoded)
            for p in (dist.all_gather_object(part) if world > 1
                      else [part]):
                _merge_val(acc, p)
            count += batch["images"].shape[0] * world
        if world > 1 and items_sum is not None:
            dist.all_reduce_(items_sum)
        val_items = (items_sum.cpu().numpy() if items_sum is not None
                     else np.zeros(len(self.loss_names)))
        if world == 1:
            return val_items, self._finalize_val(acc, count)
        metrics = self._finalize_val(acc, count) if rank == 0 else None
        return val_items, dist.broadcast_object(metrics)

    def _decode_for_val(self, preds):
        """The eval network's preds -> what _accumulate_val reads."""
        raise NotImplementedError

    def _new_val_accumulator(self):
        raise NotImplementedError

    def _accumulate_val(self, acc, batch, dbatch, decoded) -> None:
        """Add one val batch (host `batch`, device `dbatch`) to `acc`."""
        raise NotImplementedError

    def _finalize_val(self, acc, count) -> List[float]:
        """metric_names' values of the accumulated val set."""
        raise NotImplementedError


class Detector(BaseTask):
    """v5u / v8 / v11 / v12 detection: train, val, predict, predict_stream,
    load and save (YoloTask's detect task); the base of the segment, pose
    and OBB tasks."""

    loss_names: Tuple[str, ...] = ("box_loss", "cls_loss", "dfl_loss")
    metric_names: Tuple[str, ...] = ("precision(B)", "recall(B)", "mAP50(B)",
                                     "mAP50-95(B)")
    val_conf: float = 0.1
    # the accumulator key and the print label of val's second match (the
    # masks' or the keypoints'), which the last four metrics summarise
    extra_match: Optional[Tuple[str, str]] = None
    # whether the NMS suppresses rotated boxes (the angle the last extra)
    rotated: bool = False

    def _init_head(self, net: YoloNet) -> None:
        """The detection bias prior (ckpt.fuse.bias_init)."""
        bias_init(net, self.config.number_class)

    def _dataset(self, is_val: bool):
        return YoloDataset(self.config, is_val=is_val)

    # ------------------------------------------------------------ decode
    @property
    def _kpt_shape(self) -> Dict[str, int]:
        """The keypoint arguments of the decodes (used by a pose branch)."""
        return {"kpt_num": self.arch.kpt_num, "kpt_dim": self.arch.kpt_dim}

    def _decode_branch(self, preds):
        branch = preds["one2one"] if self.arch.end2end else preds["one2many"]
        dec = decode_inference(branch, end2end=self.arch.end2end,
                               **self._kpt_shape)
        if self.arch.end2end:
            dec = e2e_postprocess(dec.transpose(-1, -2),
                                  nc=self.config.number_class)
        return dec

    @full_float32()
    @torch.inference_mode()
    def _predict_fn(self, net: YoloNet, img: torch.Tensor, conf: float,
                    iou: float):
        """uint8 canvas (B, H, W, 3) on the device -> NMSOutput, or the
        (B, max_det, 6) End2End rows (_predict_output of them). `net` comes
        from _predict_variables; End2End runs only the one2one towers
        (Head.cs:117-127)."""
        nc = self.config.number_class
        x = divide_by_constant(img.permute(0, 3, 1, 2), 255.0)  # channels-last
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        preds = net(x, skip_one2many=self.arch.end2end)
        branch = preds["one2one" if self.arch.end2end else "one2many"]
        if self.arch.end2end:
            out = self._decode_branch(preds)
        elif self.config.nms_pre_topk:
            # select-then-decode: exact, decodes only the top-k anchors
            dec, trunc = decode_inference_topk(
                branch, conf_thres=conf, k=self.config.nms_pre_topk,
                **self._kpt_shape)
            out = non_max_suppression(dec, conf, iou, nc=nc,
                                      rotated=self.rotated)
            out = out._replace(truncated=out.truncated | trunc)
        else:
            out = non_max_suppression(self._decode_branch(preds), conf, iou,
                                      nc=nc, rotated=self.rotated)
        return self._predict_output(out, branch)

    def _predict_output(self, out, branch):
        """What a predict or val decode returns for its rows `out`."""
        return out

    def _host(self, out):
        """The host copy of a predict output that _batch_results reads."""
        return _to_host(out)

    def _nms_of(self, out):
        """The NMSOutput inside a host predict output (None when e2e)."""
        return None if self.arch.end2end else out

    # ----------------------------------------------------------- predict
    def _thresholds(self, predict_threshold, iou_threshold):
        conf = (self.config.predict_threshold if predict_threshold is None
                else predict_threshold)
        iou = (self.config.iou_threshold if iou_threshold is None
               else iou_threshold)
        return conf, iou

    def _serve(self, batch: torch.Tensor, shapes, conf, iou,
               mesh: Optional[Mesh] = None) -> List[List[YoloResult]]:
        """Result lists of the images (original sizes `shapes`) on the
        uint8 canvas `batch` (B, H, W, 3); with a `mesh`, its rows split
        over the mesh's devices (_mesh_outputs)."""
        hw = tuple(batch.shape[1:3])
        nms_conf = 0.0 if self.arch.end2end else conf
        results = []
        for out, lo, hi in self._mesh_outputs(
                batch, mesh, lambda net, x: self._host(
                    self._predict_fn(net, x, nms_conf, iou))):
            nms = self._nms_of(out)
            if nms is not None:
                _warn_if_truncated(nms)
            results += self._results(out, conf, hw, shapes[lo:hi])
        return results

    def _results(self, out, conf, hw, shapes) -> List[List[YoloResult]]:
        """The result lists of a host predict output's images (their own
        (h, w) `shapes`, canvas hw), built with the garbage collector
        paused and under full_float32 (a segment result's masks are a
        float32 matmul on the device)."""
        with full_float32(), _gc_paused():
            return [self._batch_results(out, i, conf, hw, shape)
                    for i, shape in enumerate(shapes)]

    def image_predict(self, image, predict_threshold=None,
                      iou_threshold=None) -> List[YoloResult]:
        conf, iou = self._thresholds(predict_threshold, iou_threshold)
        # a copy: views such as img[..., ::-1] have negative strides
        img = torch.from_numpy(np.ascontiguousarray(image, np.uint8))
        return self._serve(pad_to_multiple(img[None]), [img.shape[:2]],
                           conf, iou)[0]

    def batch_predict(self, images, predict_threshold=None,
                      iou_threshold=None, mesh: Optional[Mesh] = None
                      ) -> List[List[YoloResult]]:
        """N images -> N result lists in one forward. Mixed sizes are padded
        to a common 32-multiple canvas with 114; boxes are in canvas
        pixels, as image_predict's. mesh (parallel.create_mesh): the rows
        split over its devices, padded to a multiple of its data axis, one
        forward a device, results in order."""
        conf, iou = self._thresholds(predict_threshold, iou_threshold)
        arrs = [np.asarray(im, np.uint8) for im in images]
        H = -(-max(a.shape[0] for a in arrs) // 32) * 32
        W = -(-max(a.shape[1] for a in arrs) // 32) * 32
        batch = np.full((len(arrs), H, W, 3), 114, np.uint8)
        for i, a in enumerate(arrs):
            batch[i, :a.shape[0], :a.shape[1]] = a
        return self._serve(torch.from_numpy(batch),
                           [a.shape[:2] for a in arrs], conf, iou, mesh)

    def _keep(self, out, i, conf) -> np.ndarray:
        """Which rows of image i of a host predict or val output are kept:
        End2End's above conf, NMS's valid ones."""
        return out[i][:, 4] > conf if self.arch.end2end else out.valid[i]

    def _rows(self, out, i, conf):
        """(boxes xyxy, scores, classes, extras) host arrays of the kept
        rows of image i of a host predict or val output."""
        keep = self._keep(out, i, conf)
        if self.arch.end2end:
            rows = out[i][keep]
            return rows[:, :4], rows[:, 4], rows[:, 5].astype(int), rows[:, 6:]
        return out.boxes[i][keep], out.scores[i][keep], \
            out.classes[i][keep], out.extras[i][keep]

    def _batch_results(self, out, i, conf, hw, orig_shape
                       ) -> List[YoloResult]:
        """Image i of a host predict output as YoloResults (canvas pixels;
        hw the canvas, orig_shape the image's own (h, w))."""
        boxes, scores, classes, _ = self._rows(out, i, conf)
        return [self._result_from_box(*b, s, c)
                for b, s, c in zip(boxes, scores, classes)]

    @staticmethod
    def _result_from_box(x1, y1, x2, y2, score, cls) -> YoloResult:
        # integer truncation mirrors Detector.cs:52-68
        x, y = int(x1), int(y1)
        w, h = int(x2) - x, int(y2) - y
        return YoloResult(class_id=int(cls), score=float(score),
                          center_x=x + w // 2, center_y=y + h // 2,
                          width=w, height=h)

    # ------------------------------------------------------------ stream
    def predict_stream(self, images, batch_size: int = 16,
                       imgsz: Optional[int] = None, predict_threshold=None,
                       iou_threshold=None, workers: int = 4,
                       mesh: Optional[Mesh] = None):
        """Pipelined streaming inference (the JAX package's predict_stream):
        a generator over an iterable of uint8 RGB images that yields one
        List[YoloResult] per image, in order, in the ORIGINAL image's
        pixels. Each image is letterboxed to s x s (s = imgsz or
        Config.image_size, rounded up to a multiple of 32) on a pool of
        `workers` host threads; batches of batch_size run through _stream's
        transfer thread and depth-2 pipeline (with a `mesh`, batch_size is
        rounded up to a multiple of its data axis and each batch split over
        its devices). NMS truncation is reported once a stream, and counted
        at its end."""
        conf, iou = self._thresholds(predict_threshold, iou_threshold)
        batch_size = _mesh_batch(batch_size, mesh)
        s = -(-(imgsz or self.config.image_size) // 32) * 32
        e2e = self.arch.end2end

        def pack_one(im):
            im = np.asarray(im, np.uint8)
            ih, iw = im.shape[:2]
            pl, pu, out = _resize_pad(im, s, s, s, s, 114)
            return out, (min(s / iw, s / ih), pl, pu, ih, iw)

        def dispatch(net, xb):
            return self._predict_fn(net, xb, 0.0 if e2e else conf, iou)

        tstate: Dict = {}

        def unpack(out, metas):
            out = self._host(out)
            nms = self._nms_of(out)
            if nms is not None:
                _warn_if_truncated(nms, tstate)
            with full_float32(), _gc_paused():
                results = [self._stream_results(out, i, conf, meta)
                           for i, meta in enumerate(metas)]
            yield from results

        yield from self._stream(images, batch_size, pack_one, workers,
                                dispatch, unpack, mesh)
        if tstate.get("truncated_batches", 0) > 1:
            print(f"NOTE: NMS candidate truncation occurred in "
                  f"{tstate['truncated_batches']} batches of this stream.")

    def _stream_results(self, out, i, conf, meta) -> List[YoloResult]:
        """Image i of a host stream output as YoloResults in the original
        image's pixels (meta: ratio, pad left, pad up, h, w)."""
        boxes, scores, classes, _ = self._rows(out, i, conf)
        return [self._result_from_box(*b, sc, c) for b, sc, c in
                zip(_unletterbox(boxes, meta), scores, classes)]

    # -------------------------------------------------------------- losses
    def _task_loss(self):
        """(the task's loss on one branch, the one2one branch's TAL
        arguments under End2End)."""
        return (partial(detection_loss, nc=self.config.number_class),
                {"tal_topk": 1})

    def _loss_fns(self):
        """(train loss, eval loss). End2End sums one2many (TAL top-k 10)
        and one2one (_task_loss's top-k)."""
        base, one2one = self._task_loss()
        if self.arch.end2end:
            fn = e2e_wrap(partial(base, tal_topk=10), partial(base, **one2one))
        else:
            def fn(preds, batch, **kw):
                return base(preds["one2many"], batch)
        return fn, fn

    def _loss_kwargs(self, epoch: int) -> Dict:
        """The End2End o2m / o2o gain schedule, for tasks other than detect:
        End2End detection sums both branches at gain 1.0, as the JAX package
        does (yolosharp_tpu/tasks.py:326-330)."""
        if self.arch.end2end and self.arch.task != "detect":
            o2m, o2o = e2e_gain_schedule(epoch - 1, self.config.epochs)
            return {"o2m_gain": o2m, "o2o_gain": o2o}
        return {}

    def _decode_for_val(self, preds):
        dec = self._decode_branch(preds)
        if not self.arch.end2end:
            dec = non_max_suppression(dec, self.val_conf, 0.7,
                                      nc=self.config.number_class,
                                      rotated=self.rotated)
        return self._predict_output(
            dec, preds["one2one" if self.arch.end2end else "one2many"])

    def _new_val_accumulator(self) -> Dict[str, list]:
        acc = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        if self.extra_match:
            acc[self.extra_match[0]] = []
        return acc

    def _accumulate_val(self, acc, batch, dbatch, decoded) -> None:
        """Match one batch's predictions to its ground truths: the IoU of
        every (gt, prediction) pair of the batch in one device call, then
        match_predictions per image on the host."""
        iou = self._val_iou(batch, dbatch, decoded).cpu().numpy()  # (B, M, K)
        decoded = _to_host(decoded)
        for i in range(batch["images"].shape[0]):
            keep = self._keep(decoded, i, self.val_conf)
            _, scores, classes, _ = self._rows(decoded, i, self.val_conf)
            gmask = batch["mask_gt"][i]
            gcls = batch["cls"][i][gmask].astype(float)
            tp = match_predictions(classes.astype(float), gcls,
                                   iou[i][gmask][:, keep])
            acc["tp"].append(tp)
            acc["conf"].append(scores)
            acc["pred_cls"].append(classes.astype(float))
            acc["target_cls"].append(gcls)

    def _val_iou(self, batch, dbatch, decoded) -> torch.Tensor:
        """The IoU (B, M, K) of every (ground truth, prediction) pair of a
        batch, on the device."""
        h, w = batch["images"].shape[1:3]
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=self.device)
        gt = xywh2xyxy(dbatch["bboxes"][..., :4] * scale)     # (B, M, 4)
        pred = decoded[..., :4] if self.arch.end2end else decoded.boxes
        return box_iou(gt, pred.float())

    def _finalize_val(self, acc, count) -> List[float]:
        """P, R, mAP50 and mAP50-95 of the boxes, then of extra_match's."""
        if not acc["tp"]:
            return [0.0] * len(self.metric_names)
        conf, pred_cls, target_cls = (np.concatenate(acc[k]) for k in
                                      ("conf", "pred_cls", "target_cls"))
        keys = ["tp"] + ([self.extra_match[0]] if self.extra_match else [])
        res = [summarize(ap_per_class(np.concatenate(acc[k]), conf,
                                      pred_cls, target_cls)) for k in keys]
        if self.extra_match is None:
            p, r, m50, m5095 = res[0]
            print(f"{'All':>10}{count:>10}{len(target_cls):>10}"
                  f"{p:>10.3f}{r:>10.3f}{m50:>10.3f}{m5095:>10.3f}")
        else:
            box, ext = res
            print(f"{'All':>10}{count:>10}{len(target_cls):>10} "
                  f"Box P/R/mAP50/mAP50-95: "
                  f"{box[0]:.3f}/{box[1]:.3f}/{box[2]:.3f}/{box[3]:.3f} "
                  f"{self.extra_match[1]}: "
                  f"{ext[0]:.3f}/{ext[1]:.3f}/{ext[2]:.3f}/{ext[3]:.3f}")
        return [float(v) for m in res for v in m]


class Segmenter(Detector):
    """v5u / v8 / v11 / v12 instance segmentation (YoloTask's segment task,
    the JAX package's Segmenter): the detect rows carry 32 mask
    coefficients, decoded against the proto into masks."""

    loss_names = ("box_loss", "seg_loss", "cls_loss", "dfl_loss", "semseg")
    metric_names = ("precision(B)", "recall(B)", "mAP50(B)", "mAP50-95(B)",
                    "precision(M)", "recall(M)", "mAP50(M)", "mAP50-95(M)")
    val_conf = 0.01
    extra_match = ("tp_m", "Mask")

    def _task_loss(self):
        """End2End's one2one branch assigns at top-k 7, then 1."""
        return (partial(segmentation_loss, nc=self.config.number_class),
                {"tal_topk": 7, "tal_topk2": 1})

    @property
    def _rows_key(self) -> str:
        """The key of a predict output's rows: End2End top-k or NMS."""
        return "rows" if self.arch.end2end else "nms"

    def _predict_output(self, out, branch):
        return {self._rows_key: out, "proto": branch["proto"]}

    def _host(self, out):
        # the rows to the host; the proto stays on the device for the masks
        return {k: v if k == "proto" else _to_host(v) for k, v in out.items()}

    def _nms_of(self, out):
        return None if self.arch.end2end else out["nms"]

    def _masks(self, proto, coeffs, boxes, hw, upsample):
        """process_mask on the proto's device for host rows."""
        dev = proto.device
        return process_mask(proto, torch.from_numpy(coeffs).to(dev),
                            torch.from_numpy(boxes).float().to(dev), hw,
                            upsample=upsample)

    def _batch_results(self, out, i, conf, hw, orig_shape
                       ) -> List[YoloResult]:
        """Image i's rows as YoloResults, each with its mask: (oh, ow) bool
        of the image's own pixels (the canvas mask, upsampled from the
        proto, cut to the image)."""
        boxes, scores, classes, coeffs = self._rows(out[self._rows_key], i,
                                                    conf)
        if not len(boxes):
            return []
        oh, ow = orig_shape
        masks = self._masks(out["proto"][i], coeffs, boxes, hw,
                            True)[:, :oh, :ow].cpu().numpy()
        results = []
        for j in range(len(boxes)):
            r = self._result_from_box(*boxes[j], scores[j], classes[j])
            r.mask = masks[j]
            results.append(r)
        return results

    def _stream_results(self, out, i, conf, meta) -> List[YoloResult]:
        """Image i's rows in the original image's pixels, each mask as the
        JAX package returns it: the canvas mask's content region, float32,
        resized back to the image (h, w) by resize_linear_f32 (cv2's
        INTER_LINEAR), on the device."""
        ratio, pl, pu, ih, iw = meta
        boxes, scores, classes, coeffs = self._rows(out[self._rows_key], i,
                                                    conf)
        if not len(boxes):
            return []
        s = out["proto"].shape[-1] * 4      # the proto is canvas / 4
        masks = self._masks(out["proto"][i], coeffs, boxes, (s, s), True)
        nw, nh = int(iw * ratio), int(ih * ratio)
        # the content region of every row's canvas mask, resized back on the
        # proto's device, copied to the host once
        masks = resize_linear_f32(masks[:, pu:pu + nh, pl:pl + nw], ih,
                                  iw).cpu().numpy()
        results = []
        for j, b in enumerate(_unletterbox(boxes, meta)):
            r = self._result_from_box(*b, scores[j], classes[j])
            r.mask = masks[j]
            results.append(r)
        return results

    def _accumulate_val(self, acc, batch, dbatch, decoded) -> None:
        """Per image: box IoU and mask IoU of every (gt, prediction) pair,
        the predicted masks at proto resolution against the ground truth's
        overlap ids (resized nearest, as cv2 INTER_NEAREST, where their
        grids differ), then match_predictions for both."""
        h, w = batch["images"].shape[1:3]
        scale = np.array([w, h, w, h], np.float32)
        rows = _to_host(decoded[self._rows_key])
        for i in range(batch["images"].shape[0]):
            boxes, scores, classes, coeffs = self._rows(rows, i,
                                                        self.val_conf)
            gcls, _, gxyxy, _ = _image_gts(batch, i, scale)
            nl, n = len(gxyxy), len(boxes)
            iou = miou = np.zeros((nl, n))
            if n and nl:
                iou = box_iou(torch.from_numpy(gxyxy),
                              torch.from_numpy(boxes).float()).numpy()
                pmask = self._masks(decoded["proto"][i], coeffs, boxes,
                                    (h, w), False)
                gm = dbatch["masks"][i]
                ids = torch.arange(1, nl + 1, dtype=gm.dtype,
                                   device=gm.device)
                gt_masks = gm[None] == ids[:, None, None]
                if gt_masks.shape[1:] != pmask.shape[1:]:
                    ry, rx = (torch.from_numpy(nearest_indices(a, b)).to(
                        gm.device) for a, b in zip(gt_masks.shape[1:],
                                                   pmask.shape[1:]))
                    gt_masks = gt_masks[:, ry][:, :, rx]
                miou = mask_iou(gt_masks.reshape(nl, -1).float(),
                                pmask.reshape(n, -1).float()).cpu().numpy()
            cls_f = classes.astype(float)
            acc["tp"].append(match_predictions(cls_f, gcls, iou))
            acc["tp_m"].append(match_predictions(cls_f, gcls, miou))
            acc["conf"].append(scores)
            acc["pred_cls"].append(cls_f)
            acc["target_cls"].append(gcls)


class PoseDetector(Detector):
    """v5u / v8 / v11 / v12 pose estimation (YoloTask's pose task, the JAX
    package's PoseDetector): the detect rows carry Config.keypoint_num
    keypoints of keypoint_dim values (x, y [, visibility]) in canvas
    pixels; val matches boxes and, by OKS, keypoints."""

    loss_names = ("box_loss", "pose_loss", "kobj_loss", "cls_loss",
                  "dfl_loss")
    metric_names = ("precision(B)", "recall(B)", "mAP50(B)", "mAP50-95(B)",
                    "precision(P)", "recall(P)", "mAP50(P)", "mAP50-95(P)")
    val_conf = 0.01
    extra_match = ("tp_p", "Pose")

    def _task_loss(self):
        """End2End's one2one branch assigns at top-k 7, then 1."""
        return (partial(pose_loss, nc=self.config.number_class,
                        **self._kpt_shape),
                {"tal_topk": 7, "tal_topk2": 1})

    def _batch_results(self, out, i, conf, hw, orig_shape
                       ) -> List[YoloResult]:
        """Image i's rows as YoloResults, each with its K KeyPoints (canvas
        pixels; visibility 1.0 when keypoint_dim is 2)."""
        boxes, scores, classes, kpts = self._rows(out, i, conf)
        K, kd = self.arch.kpt_num, self.arch.kpt_dim
        # Python floats in one conversion: the rows' K KeyPoints are most
        # of a pose request's host time
        pts = kpts.reshape(len(boxes), K, kd).tolist()
        results = []
        for j in range(len(boxes)):
            r = self._result_from_box(*boxes[j], scores[j], classes[j])
            r.keypoints = [KeyPoint(p[0], p[1], p[2] if kd == 3 else 1.0)
                           for p in pts[j]]
            results.append(r)
        return results

    def _stream_results(self, out, i, conf, meta) -> List[YoloResult]:
        """Image i's rows in the original image's pixels, each keypoint's
        x and y un-letterboxed and clipped to the image."""
        ratio, pl, pu, ih, iw = meta
        boxes, scores, classes, kpts = self._rows(out, i, conf)
        K, kd = self.arch.kpt_num, self.arch.kpt_dim
        pts = kpts.reshape(len(boxes), K, kd)
        # Python floats in one conversion each, as _batch_results
        xs = np.clip((pts[..., 0] - pl) / ratio, 0, iw).tolist()
        ys = np.clip((pts[..., 1] - pu) / ratio, 0, ih).tolist()
        vis = (pts[..., 2].tolist() if kd == 3
               else np.ones((len(boxes), K)).tolist())
        results = []
        for j, b in enumerate(_unletterbox(boxes, meta)):
            r = self._result_from_box(*b, scores[j], classes[j])
            r.keypoints = [KeyPoint(x, y, v)
                           for x, y, v in zip(xs[j], ys[j], vis[j])]
            results.append(r)
        return results

    def _accumulate_val(self, acc, batch, dbatch, decoded) -> None:
        """Per image: the box IoU and the OKS of every (gt, prediction)
        pair, the OKS over the gt's area x 0.53 with the COCO sigmas when
        K = 17 (any kd; a kd = 2 gt counts every keypoint visible), else
        1 / K, then match_predictions for both."""
        h, w = batch["images"].shape[1:3]
        scale = np.array([w, h, w, h], np.float32)
        K, kd = self.arch.kpt_num, self.arch.kpt_dim
        sigmas = OKS_SIGMA if K == 17 else torch.ones(K) / K
        rows = _to_host(decoded)
        for i in range(batch["images"].shape[0]):
            boxes, scores, classes, kpts = self._rows(rows, i, self.val_conf)
            gcls, gxywh, gxyxy, gmask = _image_gts(batch, i, scale)
            gkpt = batch["keypoints"][i][gmask].copy()
            if kd == 2:
                gkpt = np.concatenate(
                    [gkpt, np.ones(gkpt.shape[:-1] + (1,), np.float32)], -1)
            gkpt[..., 0] *= w
            gkpt[..., 1] *= h
            nl, n = len(gxyxy), len(boxes)
            iou = piou = np.zeros((nl, n))
            if n and nl:
                iou = box_iou(torch.from_numpy(gxyxy),
                              torch.from_numpy(boxes).float()).numpy()
                area = (gxywh[:, 2] * gxywh[:, 3]) * 0.53
                pk = torch.from_numpy(kpts.reshape(n, K, kd)).float()
                piou = kpt_iou(torch.from_numpy(gkpt), pk,
                               torch.from_numpy(area), sigmas).numpy()
            cls_f = classes.astype(float)
            acc["tp"].append(match_predictions(cls_f, gcls, iou))
            acc["tp_p"].append(match_predictions(cls_f, gcls, piou))
            acc["conf"].append(scores)
            acc["pred_cls"].append(cls_f)
            acc["target_cls"].append(gcls)


class Obber(Detector):
    """v5u / v8 / v11 / v12 oriented boxes (YoloTask's obb task, the JAX
    package's Obber): rows carry xywh + the angle, the NMS is the rotated
    fast NMS, and val matches by probiou."""

    loss_names = ("box_loss", "cls_loss", "dfl_loss", "angle_loss")
    val_conf = 0.01
    rotated = True

    def _task_loss(self):
        """End2End's one2one branch assigns at top-k 7, then 1."""
        return (partial(obb_loss, nc=self.config.number_class),
                {"tal_topk": 7, "tal_topk2": 1})

    def _rboxes(self, out, i, conf):
        """(xywhr (n, 5), scores, classes) of image i's kept rows of a host
        predict or val output (End2End rows: x, y, w, h, score, class,
        angle)."""
        boxes, scores, classes, ext = self._rows(out, i, conf)
        if self.arch.end2end:
            boxes = np.concatenate([boxes, ext[:, -1:]], -1)
        return boxes, scores, classes

    def _batch_results(self, out, i, conf, hw, orig_shape
                       ) -> List[YoloResult]:
        """Image i's rows as YoloResults: the int-truncated centre and size
        (canvas pixels) and the angle in radians."""
        boxes, scores, classes = self._rboxes(out, i, conf)
        return [YoloResult(class_id=int(c), score=float(sc),
                           center_x=int(b[0]), center_y=int(b[1]),
                           width=int(b[2]), height=int(b[3]),
                           radian=float(b[4]))
                for b, sc, c in zip(boxes, scores, classes)]

    def _stream_results(self, out, i, conf, meta) -> List[YoloResult]:
        """Image i's rotated rows in the original image's pixels: centre and
        size scale by 1 / ratio after the pad (not clipped), the angle is
        unchanged."""
        ratio, pl, pu, _, _ = meta
        boxes, scores, classes = self._rboxes(out, i, conf)
        xywh = np.stack([(boxes[:, 0] - pl) / ratio,
                         (boxes[:, 1] - pu) / ratio,
                         boxes[:, 2] / ratio, boxes[:, 3] / ratio], -1)
        return [YoloResult(class_id=int(c), score=float(sc),
                           center_x=int(b[0]), center_y=int(b[1]),
                           width=int(b[2]), height=int(b[3]), radian=float(r))
                for b, r, sc, c in zip(xywh.tolist(), boxes[:, 4].tolist(),
                                       scores, classes)]

    def _val_iou(self, batch, dbatch, decoded) -> torch.Tensor:
        """The probiou (B, M, K) of every (ground truth, prediction) pair:
        the ground truths' normalised xywh scaled to the canvas, their angle
        as it is."""
        h, w = batch["images"].shape[1:3]
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=self.device)
        bb = dbatch["bboxes"].float()
        gt = torch.cat([bb[..., :4] * scale, bb[..., 4:5]], -1)
        pred = (torch.cat([decoded[..., :4], decoded[..., 6:7]], -1)
                if self.arch.end2end else decoded.boxes)
        return batch_probiou(gt, pred.float())


class Classifier(BaseTask):
    """v5u / v8 / v11 / v12 classification (YoloTask's classify task, the
    JAX package's Classifier): the detect trunk cut before its neck (v12
    takes v11's) and the Classify head; cross-entropy training on
    ClassificationDataset, val's top1 / top5 of the float32 softmax, and
    each request's top-5 classes with their scores. End2End does not
    apply; the thresholds are taken and unused."""

    loss_names = ("cls_loss",)
    metric_names = ("top1", "top5")

    def _cast_predict(self, net: YoloNet) -> YoloNet:
        """The predict copy in the compute dtype but for the head's Linear,
        which stays float32 (the JAX head multiplies by its float32
        kernel)."""
        net = net.to(self.dtype)
        net.model[-1].linear.float()
        return net

    def _loss_fns(self):
        def fn(preds, batch, **kw):
            return classification_loss(preds, batch)
        return fn, fn

    def _dataset(self, is_val: bool):
        return ClassificationDataset(self.config, is_val=is_val)

    # ----------------------------------------------------------------- val
    def _decode_for_val(self, preds):
        return torch.softmax(preds["cls"].float(), -1)

    def _new_val_accumulator(self):
        return {"top1": 0, "top5": 0, "n": 0}

    def _accumulate_val(self, acc, batch, dbatch, decoded) -> None:
        probs = decoded.cpu().numpy()
        labels = np.asarray(batch["cls"]).reshape(-1)
        top5 = np.argsort(-probs, -1)[:, :5]
        acc["top1"] += int((top5[:, 0] == labels).sum())
        acc["top5"] += int((top5 == labels[:, None]).any(-1).sum())
        acc["n"] += len(labels)

    def _finalize_val(self, acc, count) -> List[float]:
        n = max(acc["n"], 1)
        top1, top5 = acc["top1"] / n, acc["top5"] / n
        print(f"{'All':>10}{count:>10}{top1:>10.3f}{top5:>10.3f}")
        return [top1, top5]

    # ------------------------------------------------------------- predict
    @full_float32()
    @torch.inference_mode()
    def _probs(self, net: YoloNet, img: torch.Tensor) -> torch.Tensor:
        """uint8 (B, s, s, 3) on the device -> (B, nc) float32 softmax."""
        x = divide_by_constant(img.permute(0, 3, 1, 2), 255.0)  # channels-last
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return torch.softmax(net(x)["cls"].float(), -1)

    @staticmethod
    def _top5(p: np.ndarray) -> List[YoloResult]:
        order = np.argsort(-p)
        return [YoloResult(class_id=int(i), score=float(p[i]))
                for i in order[:5]]

    def _classify(self, batch: np.ndarray, mesh: Optional[Mesh] = None
                  ) -> List[List[YoloResult]]:
        out = []
        for probs, lo, hi in self._mesh_outputs(
                torch.from_numpy(batch), mesh,
                lambda net, x: self._probs(net, x).cpu().numpy()):
            out += [self._top5(p) for p in probs[:hi - lo]]
        return out

    def image_predict(self, image, predict_threshold=None,
                      iou_threshold=None) -> List[YoloResult]:
        """The image squashed to s x s (resize_linear, as the JAX package's
        cv2.resize), its top 5."""
        s = self.config.image_size
        return self._classify(
            resize_linear(np.asarray(image, np.uint8), s, s)[None])[0]

    def batch_predict(self, images, predict_threshold=None,
                      iou_threshold=None, mesh: Optional[Mesh] = None
                      ) -> List[List[YoloResult]]:
        """N images, each squashed to s x s, -> N top-5 lists in one
        forward (with a `mesh`: one a device, as Detector.batch_predict)."""
        s = self.config.image_size
        return self._classify(np.stack(
            [resize_linear(np.asarray(im, np.uint8), s, s) for im in images]),
            mesh)

    def predict_stream(self, images, batch_size: int = 16,
                       imgsz: Optional[int] = None, predict_threshold=None,
                       iou_threshold=None, workers: int = 4,
                       mesh: Optional[Mesh] = None):
        """Pipelined streaming classification: one top-5 List[YoloResult]
        per image, in order. Each image takes the val transform (the short
        side to s, then the centre crop: dataset.center_crop) on the host
        pool, then _stream's transfer thread and depth-2 pipeline (over a
        `mesh` as Detector.predict_stream)."""
        batch_size = _mesh_batch(batch_size, mesh)
        s = imgsz or self.config.image_size

        def prep_one(im):
            return center_crop(np.asarray(im, np.uint8), s), None

        def unpack(probs, metas):
            for p in probs.cpu().numpy()[:len(metas)]:
                yield self._top5(p)

        yield from self._stream(images, batch_size, prep_one, workers,
                                self._probs, unpack, mesh)


_TASKS = {TaskType.detect: Detector, TaskType.segment: Segmenter,
          TaskType.pose: PoseDetector, TaskType.obb: Obber,
          TaskType.classify: Classifier}


class YoloTask:
    """Public facade (Models/YoloTask.cs:10-107): train, val, predict,
    predict_stream, load and save, for the detect, segment, pose, obb and
    classify tasks. device: None means cuda (raises where there is none);
    pass "cpu" to run the plain versions on the CPU."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.task = _TASKS[config.task_type](config, device)

    def load_model(self, path: str, skip_nc_not_equal_layers: bool = False):
        return self.task.load_model(path, skip_nc_not_equal_layers)

    def save_weight(self, path: str):
        return self.task.save_weight(path)

    def train(self, resume_from: Optional[str] = None,
              mesh: Optional[Mesh] = None) -> TrainState:
        return self.task.train(resume_from=resume_from, mesh=mesh)

    def val(self, val_dl: Optional[DataLoader] = None, epoch: int = 0,
            mesh: Optional[Mesh] = None):
        return self.task.val(val_dl, epoch, mesh)

    def image_predict(self, image, predict_threshold: Optional[float] = None,
                      iou_threshold: Optional[float] = None):
        if isinstance(image, str):
            # PNG, JPEG (cut short, arithmetic-coded, YCCK, without DHT
            # ... as cv2 reads them), BMP, TIFF (CCITT, JPEG, YCbCr, CMYK
            # too), PNM / PAM, WebP, JPEG 2000, GIF, Sun raster, PFM or
            # HDR, no cv2
            image = read_image_rgb(image)
        return self.task.image_predict(image, predict_threshold,
                                       iou_threshold)

    def calibrate_int8(self, images=None, n_images: int = 16,
                       batch_size: int = 8):
        return self.task.calibrate_int8(images, n_images=n_images,
                                        batch_size=batch_size)

    def save_calibration(self, path: str):
        return self.task.save_calibration(path)

    def load_calibration(self, path: str):
        return self.task.load_calibration(path)

    def batch_predict(self, images, predict_threshold: Optional[float] = None,
                      iou_threshold: Optional[float] = None,
                      mesh: Optional[Mesh] = None):
        """mesh: optional parallel.Mesh, the rows split over its devices."""
        return self.task.batch_predict(images, predict_threshold,
                                       iou_threshold, mesh=mesh)

    def predict_stream(self, images, batch_size: int = 16,
                       imgsz: Optional[int] = None,
                       predict_threshold: Optional[float] = None,
                       iou_threshold: Optional[float] = None,
                       workers: int = 4, mesh: Optional[Mesh] = None):
        """Pipelined streaming inference (all five task families): yields
        one List[YoloResult] per input image, original-image pixels for
        detect / segment / obb / pose, the top-5 classes for classify;
        mesh: optional parallel.Mesh, each batch split over its devices."""
        return self.task.predict_stream(
            images, batch_size=batch_size, imgsz=imgsz,
            predict_threshold=predict_threshold,
            iou_threshold=iou_threshold, workers=workers, mesh=mesh)
