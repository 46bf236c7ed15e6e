"""yolosharp_tpu_torch: the PyTorch/CUDA port of yolosharp_tpu.

Same public surface as the JAX package, for v5u, v8, v11 and v12 detection,
instance segmentation, pose estimation, oriented boxes and classification
(Config.task_type):

    from yolosharp_tpu_torch import Config, YoloTask
    task = YoloTask(Config(...))            # device="cuda" by default
    task.train()                            # train + val on Config's dataset
    results = task.image_predict(rgb_uint8_array)
    for results in task.predict_stream(iter(images)): ...

It imports torch and nothing of jax or of the JAX package: the numpy-only
modules it shares with that package (Config, result types, checkpoint file
formats and name map, label parsing, augmentation, loader, metrics) are
copies under the same names. Modules:

- ``config``, ``types``: Config and the result / enum types;
- ``nn``: the v5u / v8 / v11 / v12 detect, segment, pose, OBB and classify
  networks
  (train and eval BatchNorm with the JAX package's statistics, BN-folded
  predict), and the library's other blocks (Conv2, GhostConv, RepConv,
  CBAM, C1 / C2 / C3x / RepC3 / C3Ghost / C3TR, the v10 and HGNetV2
  blocks, AGLU, ...);
- ``ops``: boxes (``clip_keypoints``, the OBB corner forms), the cv2-free
  minimum-area rectangle (``rect``), IoU (``box_iou``, ``bbox_iou``,
  ``mask_iou``, the OKS ``kpt_iou``, ``probiou``), anchors, NMS (greedy,
  and the rotated fast NMS), masks (``crop_mask``, ``process_mask``);
- ``loss``: the task-aligned assigner (``tal``, axis-aligned and rotated),
  the detection, OBB, segmentation, pose and classification losses and the
  End2End pair;
- ``train``: AdamW groups, LR schedules, train and eval steps, TrainState;
- ``data``: cv2-free pixel work (``image_ops``: the PNG / JPEG / BMP /
  TIFF / PNM / PAM / WebP / JPEG 2000 / GIF / Sun raster / PFM / HDR
  reader, with ``jpeg``'s markers and ``csrc/jpeg_decode.cpp``, ``bmp``,
  ``tiff``, ``pnm``, ``webp``, ``jp2`` (``csrc/jp2_decode.cpp``), ``gif``
  (``csrc/gif_decode.cpp``), ``sunras``, ``pfm`` and ``hdr``
  (``csrc/hdr_decode.cpp``),
  resize, HSV, warps, polygon fill, the classify ops' blur / equalize),
  labels, augmentations (letterbox and the host mosaic;
  ``classify_augment``: AutoAugment, RandAugment, AugMix, random erasing), the mosaic's host
  planner and device render of images and masks (``device_augment``),
  datasets (``YoloDataset``, ``ClassificationDataset``), loader;
- ``utils``: val metrics, early stopping, the CSV log;
- ``ckpt``: checkpoint formats and ``convert_checkpoint`` (any of them to
  ``.bin``), BN folding, the JAX bridge, and ``resume`` (the full train
  state);
- ``predict``, ``tasks``: decode and the task layer / YoloTask facade;
- ``kernels`` + ``csrc``: the hand-written CUDA kernels: the 3x3 conv, the
  fused C2f and the fused attention, each in float32, bfloat16 and float16
  (the attention also under autograd for training, its 16-bit backward
  the kernel ``fused_attention_bwd``), and the int8 pair of
  ``int8_predict`` (``quantize_int8``, ``int8_conv``);
- ``parallel``: the multi-device layer: the mesh (``create_mesh``, the
  ``mesh`` argument of batch_predict / predict_stream), the process group
  of data-parallel train and val (``dist``: one process a card, BN
  statistics and loss normalisers over the global batch) and FSDP
  sharding of the train state (``fsdp``);
- ``graft_entry``: ``entry`` and ``dryrun_multichip``, the counterparts of
  the JAX package's ``__graft_entry__``, and ``run_step`` (a train step
  over ranks).
"""

from .ckpt import convert_checkpoint
from .config import Config
from .tasks import (Classifier, Detector, Obber, PoseDetector, Segmenter,
                    YoloTask)
from .types import (AutoAugmentType, ImageProcessType, KeyPoint, ScalarType,
                    TaskType, YoloResult, YoloSize, YoloType)

__all__ = ["AutoAugmentType", "Classifier", "Config", "Detector",
           "ImageProcessType", "KeyPoint", "Obber", "PoseDetector",
           "ScalarType", "Segmenter", "TaskType", "YoloResult", "YoloSize",
           "YoloTask", "YoloType", "convert_checkpoint"]
