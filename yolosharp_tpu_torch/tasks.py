"""Predict half of the task layer for detection, plus the YoloTask facade
(counterpart of yolosharp_tpu/tasks.py: BaseTask / Detector / YoloTask,
predict, load and save only).

Requests arrive as uint8 HWC RGB numpy arrays, are padded with 114 to a
multiple of 32 on the host, shipped as uint8 and normalised (/255) on the
device. Results come back in one bulk transfer as YoloResults in canvas
pixels. With End2End the NMS-free top-k runs with conf 0 and rows are
filtered on the host.
"""

from __future__ import annotations

import copy
import itertools
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .ckpt import (bias_init, clone_one2one, export_state_dict, fold_bn,
                   load_state_dict_file, load_state_dict_into, save_bin,
                   skip_patterns_for_nc_mismatch)
from .config import Config, resolve_device, torch_dtype
from .nn import ArchCfg, YoloNet
from .ops.nms import NMSOutput, non_max_suppression
from .predict import (decode_inference, decode_inference_topk,
                      e2e_postprocess, pad_to_multiple)
from .types import TaskType, YoloResult


def _warn_if_truncated(nms_out) -> None:
    """Surface NMS candidate-pool truncation (see Config.nms_pre_topk)."""
    if np.asarray(nms_out.truncated).any():
        print("WARNING: above-threshold NMS candidates exceeded "
              "Config.nms_pre_topk; low-score boxes may be missing. "
              "Raise nms_pre_topk or set it to None for exact NMS.")


def _to_host(out):
    if isinstance(out, NMSOutput):
        return NMSOutput(*(t.cpu().numpy() for t in out))
    return out.cpu().numpy()


class Detector:
    """v8 / v12 detection: predict, load and save (YoloTask's detect
    task)."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = torch_dtype(config)
        self.arch = ArchCfg(
            version=config.yolo_type.value, size=config.yolo_size.value,
            task="detect", nc=config.number_class, end2end=config.end2end)
        self.net: Optional[YoloNet] = None
        self._fused: Optional[Tuple[tuple, YoloNet]] = None

    # ------------------------------------------------------------- setup
    def _ensure_variables(self) -> YoloNet:
        """The float32 master network, built on first use from a seeded
        generator, with the detection bias prior."""
        if self.net is None:
            net = YoloNet(self.arch, torch.Generator().manual_seed(0))
            bias_init(net, self.config.number_class)
            self.net = net.to(self.device).eval()
        return self.net

    def _predict_variables(self) -> YoloNet:
        """The network predict runs: a copy of the master in the compute
        dtype, BN-folded when Config.fuse_inference (folded in float32 once,
        then cast). Cached until a master parameter or buffer changes."""
        net = self._ensure_variables()
        key = (id(net), tuple(t._version for t in itertools.chain(
            net.parameters(), net.buffers())))
        if self._fused is None or self._fused[0] != key:
            pred = copy.deepcopy(net)
            if self.config.fuse_inference:
                fold_bn(pred)
            self._fused = (key, pred.to(self.dtype).eval())
        return self._fused[1]

    # ------------------------------------------------------------ decode
    def _decode_branch(self, preds):
        branch = preds["one2one"] if self.arch.end2end else preds["one2many"]
        dec = decode_inference(branch, end2end=self.arch.end2end)
        if self.arch.end2end:
            dec = e2e_postprocess(dec.transpose(-1, -2),
                                  nc=self.config.number_class)
        return dec

    @torch.inference_mode()
    def _predict_fn(self, net: YoloNet, img: torch.Tensor, conf: float,
                    iou: float):
        """uint8 canvas (B, H, W, 3) on the device -> NMSOutput, or the
        (B, max_det, 6) End2End rows. `net` comes from _predict_variables;
        End2End runs only the one2one towers (Head.cs:117-127)."""
        nc = self.config.number_class
        x = img.permute(0, 3, 1, 2).float() / 255.0     # channels-last NCHW
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        preds = net(x, skip_one2many=self.arch.end2end)
        if self.arch.end2end:
            return self._decode_branch(preds)
        if self.config.nms_pre_topk:
            # select-then-decode: exact, decodes only the top-k anchors
            dec, trunc = decode_inference_topk(
                preds["one2many"], conf_thres=conf,
                k=self.config.nms_pre_topk)
            out = non_max_suppression(dec, conf, iou, nc=nc)
            return out._replace(truncated=out.truncated | trunc)
        return non_max_suppression(self._decode_branch(preds), conf, iou,
                                   nc=nc)

    # ----------------------------------------------------------- predict
    def _thresholds(self, predict_threshold, iou_threshold):
        conf = (self.config.predict_threshold if predict_threshold is None
                else predict_threshold)
        iou = (self.config.iou_threshold if iou_threshold is None
               else iou_threshold)
        return conf, iou

    def image_predict(self, image, predict_threshold=None,
                      iou_threshold=None) -> List[YoloResult]:
        conf, iou = self._thresholds(predict_threshold, iou_threshold)
        net = self._predict_variables()
        # a copy: views such as img[..., ::-1] have negative strides
        img = torch.from_numpy(np.ascontiguousarray(image, np.uint8))
        img = pad_to_multiple(img[None])
        out = _to_host(self._predict_fn(
            net, img.to(self.device), 0.0 if self.arch.end2end else conf,
            iou))
        if not self.arch.end2end:
            _warn_if_truncated(out)
        return self._batch_results(out, 0, conf)

    def batch_predict(self, images, predict_threshold=None,
                      iou_threshold=None) -> List[List[YoloResult]]:
        """N images -> N result lists in one forward. Mixed sizes are padded
        to a common 32-multiple canvas with 114; boxes are in canvas
        pixels, as image_predict's."""
        conf, iou = self._thresholds(predict_threshold, iou_threshold)
        net = self._predict_variables()
        arrs = [np.asarray(im, np.uint8) for im in images]
        H = -(-max(a.shape[0] for a in arrs) // 32) * 32
        W = -(-max(a.shape[1] for a in arrs) // 32) * 32
        batch = np.full((len(arrs), H, W, 3), 114, np.uint8)
        for i, a in enumerate(arrs):
            batch[i, :a.shape[0], :a.shape[1]] = a
        out = _to_host(self._predict_fn(
            net, torch.from_numpy(batch).to(self.device),
            0.0 if self.arch.end2end else conf, iou))
        if not self.arch.end2end:
            _warn_if_truncated(out)
        return [self._batch_results(out, i, conf) for i in range(len(arrs))]

    def _batch_results(self, out, i, conf) -> List[YoloResult]:
        """Image i of a host-side predict output as YoloResults."""
        rows: List[YoloResult] = []
        if self.arch.end2end:
            for x1, y1, x2, y2, score, cls in out[i][:, :6]:
                if score > conf:
                    rows.append(self._result_from_box(x1, y1, x2, y2,
                                                      score, cls))
        else:
            for j in range(int(out.valid[i].sum())):
                x1, y1, x2, y2 = out.boxes[i][j]
                rows.append(self._result_from_box(
                    x1, y1, x2, y2, out.scores[i][j], out.classes[i][j]))
        return rows

    @staticmethod
    def _result_from_box(x1, y1, x2, y2, score, cls) -> YoloResult:
        # integer truncation mirrors Detector.cs:52-68
        x, y = int(x1), int(y1)
        w, h = int(x2) - x, int(y2) - y
        return YoloResult(class_id=int(cls), score=float(score),
                          center_x=x + w // 2, center_y=y + h // 2,
                          width=w, height=h)

    # -------------------------------------------------------- checkpoint
    def load_model(self, path: str, skip_nc_not_equal_layers: bool = False):
        """LoadModel semantics (YoloBaseTaskModel.cs:27-114): .bin,
        .safetensors or .pt by name; nc-mismatched head layers skipped on
        request; End2End towers cloned from one2many."""
        net = self._ensure_variables()
        sd = load_state_dict_file(path)
        skip: Tuple[str, ...] = ()
        if skip_nc_not_equal_layers:
            skip = skip_patterns_for_nc_mismatch(
                "detect", len(net.model) - 1, sd, self.config.number_class)
        report = load_state_dict_into(net, sd, skip)
        if self.arch.end2end:
            clone_one2one(net)
        if report.skipped:
            bias_init(net, self.config.number_class)
        print(f"Model loaded: {report}")
        return report

    def save_weight(self, path: str, dtype=np.float32) -> None:
        """SaveWeight: LEB128 .bin, one2one excluded (YoloBaseTaskModel.cs:470)."""
        sd = export_state_dict(self._ensure_variables(), dtype=dtype)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_bin(path, sd)


class YoloTask:
    """Public facade (Models/YoloTask.cs:10-107): predict, load and save.
    device: None means cuda (raises where there is none); pass "cpu" to run
    the plain versions on the CPU."""

    def __init__(self, config: Config, device=None):
        if config.task_type != TaskType.detect:
            raise NotImplementedError(
                f"the torch port has only the detect task so far, not "
                f"{config.task_type.value}")
        self.config = config
        self.task = Detector(config, device)

    def load_model(self, path: str, skip_nc_not_equal_layers: bool = False):
        return self.task.load_model(path, skip_nc_not_equal_layers)

    def save_weight(self, path: str):
        return self.task.save_weight(path)

    def image_predict(self, image, predict_threshold: Optional[float] = None,
                      iou_threshold: Optional[float] = None):
        if isinstance(image, str):
            import cv2   # only for file paths; arrays need no cv2

            image = cv2.cvtColor(cv2.imread(image, cv2.IMREAD_COLOR),
                                 cv2.COLOR_BGR2RGB)
        return self.task.image_predict(image, predict_threshold,
                                       iou_threshold)

    def batch_predict(self, images, predict_threshold: Optional[float] = None,
                      iou_threshold: Optional[float] = None):
        return self.task.batch_predict(images, predict_threshold,
                                       iou_threshold)
