"""Detector assembly: config → (model, anchors, postprocess) bundle
(mirror of bdd100k_tpu/models/detector.py)."""

from __future__ import annotations

import dataclasses

import torch

from bdd100k_tpu_torch.configs.detector_configs import DetectorConfig
from bdd100k_tpu_torch.models.layers import init_params
from bdd100k_tpu_torch.models.mobilenet import MobileNetBackbone
from bdd100k_tpu_torch.models.ssd import SSDDetector
from bdd100k_tpu_torch.models.vgg import VGG16Backbone
from bdd100k_tpu_torch.models.yolo import YOLODetector
from bdd100k_tpu_torch.ops import anchors as anchor_ops
from bdd100k_tpu_torch.ops.nms import Detections
from bdd100k_tpu_torch.ops.postprocess import postprocess
from bdd100k_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DetectorBundle:
    config: DetectorConfig
    model: SSDDetector | YOLODetector
    anchors: torch.Tensor           # (A, 4) center format, on the model's device
    cell_sizes: torch.Tensor | None = None  # (A,) YOLO grid cell sizes; None for SSD

    def apply(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            return self.model(images)

    def postprocess(self, loc_preds, cls_preds) -> Detections:
        return postprocess(
            loc_preds, cls_preds, self.anchors, self.config.postprocess,
            self.cell_sizes,
        )


def _build_backbone(config: DetectorConfig, dtype: torch.dtype):
    if config.backbone == "mobilenet":
        return MobileNetBackbone(config.width, dtype, config.quant)
    if config.backbone == "vgg16":
        return VGG16Backbone(dtype, config.quant)
    raise ValueError(f"unknown backbone {config.backbone!r}")


def build_detector(
    config: DetectorConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> DetectorBundle:
    """The model in eval mode with f32 parameters on `device`; `dtype` is
    the working type of its convs (bf16, or f32 for comparisons);
    `config.quant` swaps the dense convs for int8 ones (models/layers.py
    QuantConv; "int8_static" needs `models/quant.calibrate`). The
    parameters are drawn as flax draws them (`layers.init_params`) on the
    CPU from a generator seeded with `seed`, so they do not depend on the
    device. `device` defaults to CUDA and raises without it; the CPU runs
    only when asked for."""
    device = resolve_device(device)
    backbone = _build_backbone(config, dtype)
    cell_sizes = None
    if config.head == "ssd":
        # MobileNet taps 3 maps (strides 8/16/32), VGG 2 (conv4_3, fc7); the
        # extra stages make the rest of the pyramid
        model = SSDDetector(backbone, config.feature_maps, config.num_classes,
                            dtype, config.quant)
        anchors = anchor_ops.ssd_anchors(config.feature_maps)
    elif config.head == "yolo":
        model = YOLODetector(backbone, [len(p) for p in config.yolo_priors],
                             config.num_classes, dtype, config.quant)
        anchors = anchor_ops.yolo_anchors(config.yolo_grids, config.yolo_priors)
        cell_sizes = anchor_ops.yolo_cell_sizes(
            config.yolo_grids, config.yolo_priors).to(device)
    else:
        raise ValueError(f"unknown head {config.head!r}")
    init_params(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    if anchors.shape[0] != config.num_anchors:
        raise ValueError(f"{anchors.shape[0]} anchors for {config.num_anchors}")
    return DetectorBundle(config, model, anchors.to(device), cell_sizes)
