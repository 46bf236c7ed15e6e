"""Config for the port: a copy of the JAX package's ``Config`` dataclass
(yolosharp_tpu/config.py; same fields, same defaults) plus the torch dtype
map and device resolution.

Parity target: Data/Config.cs:10-355. ``compute_dtype`` (a jax.numpy dtype)
is not copied: ``torch_dtype`` takes its place. The fields under "TPU-only
knobs" are routing and layout switches of the JAX package; the port keeps
them so that a config carries over unchanged, and ignores them (on CUDA
every layer its kernels can compute goes through them). int8_predict runs
as in the JAX package: predict takes the int8 route once calibrate_int8 or
load_calibration has given it stats, and float without them; fsdp and
resume_format="orbax" run (parallel/fsdp.py, ckpt/resume.py), and
mesh_shape is read nowhere, as in the JAX package."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch

from .types import (AutoAugmentType, ImageProcessType, ScalarType, TaskType,
                    YoloSize, YoloType)


@dataclasses.dataclass
class Config:
    root_path: str = "Assets/DataSets/coco128"
    train_data_path: str = "train.txt"
    val_data_path: str = "val.txt"
    output_path: str = ""

    image_size: int = 640
    batch_size: int = 16
    number_class: int = 80
    epochs: int = 100
    predict_threshold: float = 0.3
    iou_threshold: float = 0.7
    # parity field: the reference's only consumer is a commented-out SGD
    # (YoloBaseTaskModel.cs:140)
    learning_rate: float = 1e-4
    use_cos_lr: bool = False
    lrf: float = 0.01
    workers: int = min((os.cpu_count() or 8) // 2, 4)

    yolo_type: YoloType = YoloType.v8
    yolo_size: YoloSize = YoloSize.n
    task_type: TaskType = TaskType.detect
    # reference default is Float16 (Config.cs:105); computed in bfloat16
    # unless true_fp16
    scalar_type: ScalarType = ScalarType.float16
    image_process_type: ImageProcessType = ImageProcessType.mosaic

    patience: int = 50
    keypoint_num: int = 17
    keypoint_dim: int = 3

    hsv_v: float = 0.4
    hsv_s: float = 0.7
    hsv_h: float = 0.015
    mask_ratio: int = 4
    mosaic: float = 1.0
    # parity field: the reference's Mosaic always runs _mosaic4
    mosaic_count: int = 4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flip_lr: float = 0.5
    flip_ud: float = 0.0

    classify_ratio_max: float = 4.0 / 3
    classify_ratio_min: float = 0.75
    classify_scale_max: float = 1.0
    classify_scale_min: float = 0.08
    erasing: float = 0.4
    auto_augment: AutoAugmentType = AutoAugmentType.autoaugment

    warm_up_epochs: int = 3
    warm_up_bias_lr: float = 0.1
    close_mosaic: int = 0
    end2end: bool = True

    # ---- additions of the JAX package (no reference counterpart) ----
    # candidate cap of predict-time NMS; NMSOutput.truncated flags images
    # with more above-threshold anchors. None = all anchors (exact).
    nms_pre_topk: Optional[int] = 2048
    # fold BatchNorm into the conv weights for predict (Convs.cs:58-61)
    fuse_inference: bool = True
    # ---- TPU-only knobs: kept so configs carry over, ignored by the port
    # (the field order is the JAX package's, so config.txt reads the same)
    pallas_conv: bool = False
    s2d_max_cin: int = 0
    # read by the port: predict runs the eligible convs int8 once
    # calibrate_int8 or load_calibration has given it stats (float without)
    int8_predict: bool = False
    # ---- the mosaic's render and the fp16 flag, which the port reads:
    # mosaic epochs with mosaic >= 1 plan each batch on the host and render
    # its pixels on the device (data/device_augment.py); False takes the
    # host mosaic4 + random_perspective, as mosaic < 1 always does
    device_augment: bool = True
    # > 0: mosaic partners of the device render drawn from this many extra
    # images of the whole dataset per batch, not from the batch alone
    mosaic_partner_pool: int = 0
    # shard the train state over the data-parallel ranks (parallel/fsdp.py);
    # one device trains unsharded, as in the JAX package
    fsdp: bool = False
    # True fp16 compute with dynamic loss scaling (Amp.cs:3-176); every
    # kernel of the port has a float16 route
    true_fp16: bool = False
    # ---- TPU-only knobs again, ignored by the port
    host_s2d: Optional[bool] = None
    host_s2d_deep: bool = True
    host_s2d_deeper: bool = True
    head_tower_fuse: bool = False
    train_packed_render: bool = True
    train_packed_depth: int = 2
    separable_render: bool = True
    xla_predict_tuning: bool = True
    # a torch.profiler trace of train steps 2-5 of the first epoch, written
    # here as Chrome-trace JSON
    profile_dir: Optional[str] = None
    # "orbax": the resume state as a torch.distributed.checkpoint directory,
    # weights/last_state.dcp (not an orbax checkpoint: JAX cannot read it)
    resume_format: str = "npz"
    val_shape_buckets: int = 4
    occupancy_hint: bool = True
    max_labels: Optional[int] = None   # per-image gt padding (None = auto)
    # read nowhere, as in the JAX package: train() takes the largest count
    # of the visible cards that divides the batch (tasks._make_mesh)
    mesh_shape: Optional[Tuple[int, ...]] = None
    cache_images: bool = True          # eager RAM cache like the reference

    @property
    def kpt_shape(self) -> Tuple[int, int]:
        return (self.keypoint_num, self.keypoint_dim)

    def describe(self) -> str:
        return "\n".join(f"{f.name}: {getattr(self, f.name)}"
                         for f in dataclasses.fields(self))


def torch_dtype(config: Config) -> torch.dtype:
    """float32 -> torch.float32; float16 / bfloat16 -> torch.bfloat16
    (torch.float16 when ``config.true_fp16``), as the JAX package's
    ``Config.compute_dtype``."""
    if config.scalar_type == ScalarType.float32:
        return torch.float32
    return torch.float16 if config.true_fp16 else torch.bfloat16


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device to run on; None means ``cuda``. Asking for CUDA where
    there is none raises: there is no silent CPU fallback (pass
    ``device="cpu"`` to run the port on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the port on the CPU")
    return dev


__all__ = ["Config", "resolve_device", "torch_dtype"]
