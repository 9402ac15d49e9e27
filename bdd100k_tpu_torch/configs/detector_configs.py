"""Detector configs (mirror of bdd100k_tpu/configs/detector_configs.py).

The three BASELINE families, SSD-MobileNet-300, VGG16-SSD512 and
YOLO-MobileNet-384, and the tiny test configs.
"""

from __future__ import annotations

import dataclasses
import json

from bdd100k_tpu_torch.ops.anchors import (
    SSD300_FEATURE_MAPS,
    SSD512_FEATURE_MAPS,
    YOLO_BDD_PRIORS,
    FeatureMapSpec,
    make_ssd_feature_maps,
)
from bdd100k_tpu_torch.ops.boxes import VARIANCE_CENTER, VARIANCE_SIZE

# BDD100K detection classes; ids 1..10, 0 = background.
BDD100K_CLASSES = (
    "car",
    "bus",
    "truck",
    "person",
    "rider",
    "bike",
    "motor",
    "traffic light",
    "traffic sign",
    "train",
)


@dataclasses.dataclass(frozen=True)
class PostprocessConfig:
    """Postprocess constants (mirror of bdd100k_tpu/ops/postprocess.py)."""

    score_mode: str = "softmax"        # "softmax" (SSD) | "sigmoid" (YOLO)
    decode_mode: str = "ssd"           # "ssd" | "yolo" (σ(tx)+grid decode)
    score_threshold: float = 0.01
    iou_threshold: float = 0.45
    per_class_topk: int = 200
    max_detections: int = 200
    variances: tuple[float, float] = (VARIANCE_CENTER, VARIANCE_SIZE)
    # candidate preselection: only "exact" exists here ("approx" is the
    # TPU's lax.approx_max_k, which has no torch counterpart)
    preselect: str = "exact"


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    name: str
    image_size: int
    backbone: str = "mobilenet"
    head: str = "ssd"
    num_classes: int = len(BDD100K_CLASSES)
    width: float = 1.0                     # MobileNet width multiplier
    match_threshold: float = 0.5           # matcher IoU threshold
    neg_pos_ratio: float = 3.0             # hard-negative mining ratio
    feature_maps: tuple[FeatureMapSpec, ...] = SSD300_FEATURE_MAPS
    # YOLO: grid size and (w, h) priors of each scale (strides 8/16/32)
    yolo_grids: tuple[int, ...] = ()
    yolo_priors: tuple = ()
    postprocess: PostprocessConfig = PostprocessConfig()
    # inference quantization of the dense convs (models/layers.py QuantConv):
    # "none", "int8" (per-batch activation scales) or "int8_static"
    # (calibrated, frozen scales; models/quant.py); the params are the
    # same in every mode
    quant: str = "none"

    @property
    def num_anchors(self) -> int:
        if self.head == "yolo":
            return sum(
                g * g * len(p) for g, p in zip(self.yolo_grids, self.yolo_priors)
            )
        return sum(f.size * f.size * f.num_boxes for f in self.feature_maps)


# BASELINE config 1: SSD-MobileNet 300×300.
SSD_MOBILENET_300 = DetectorConfig(
    name="ssd_mobilenet_300",
    image_size=300,
    backbone="mobilenet",
    head="ssd",
    feature_maps=SSD300_FEATURE_MAPS,
    postprocess=PostprocessConfig(
        score_mode="softmax", decode_mode="ssd", per_class_topk=100
    ),
)


# BASELINE config 2: SSD-VGG16 512×512 (batch=32 eval, on-device NMS);
# 24564 anchors. It keeps per_class_topk=200 (the reference measured
# −0.004 mAP at 100).
SSD_VGG16_512 = DetectorConfig(
    name="ssd_vgg16_512",
    image_size=512,
    backbone="vgg16",
    head="ssd",
    feature_maps=SSD512_FEATURE_MAPS,
    postprocess=PostprocessConfig(score_mode="softmax", decode_mode="ssd"),
)


# BASELINE config 3: YOLO-style multi-scale head (batch=64 train step).
# 384 input → grids 48/24/12 at strides 8/16/32, 9072 anchors.
YOLO_MOBILENET_384 = DetectorConfig(
    name="yolo_mobilenet_384",
    image_size=384,
    backbone="mobilenet",
    head="yolo",
    yolo_grids=(48, 24, 12),
    yolo_priors=YOLO_BDD_PRIORS,
    postprocess=PostprocessConfig(
        score_mode="sigmoid", decode_mode="yolo", per_class_topk=100
    ),
)


def tiny_test_config(head: str = "ssd") -> DetectorConfig:
    """64×64 input, width-0.25 MobileNet: the CPU tests' model."""
    if head == "ssd":
        return DetectorConfig(
            name="ssd_tiny_64",
            image_size=64,
            backbone="mobilenet",
            head="ssd",
            width=0.25,
            feature_maps=make_ssd_feature_maps(
                map_sizes=(8, 4, 2), boxes_per_map=(4, 6, 4)
            ),
        )
    return DetectorConfig(
        name="yolo_tiny_64",
        image_size=64,
        backbone="mobilenet",
        head="yolo",
        width=0.25,
        yolo_grids=(8, 4, 2),
        yolo_priors=YOLO_BDD_PRIORS,
        postprocess=PostprocessConfig(score_mode="sigmoid", decode_mode="yolo"),
    )


def apply_yolo_priors(cfg: DetectorConfig, path: str) -> DetectorConfig:
    """A YOLO config with its anchor priors replaced by a fitted set: the
    JSON that `python -m bdd100k_tpu_torch.data.priors --out` (or the
    reference's scripts/kmeans_priors.py) writes, nested [scale][prior][w, h].

    The head's shapes depend only on the priors per scale, so weights
    trained with one prior set load under another of the same counts; the
    anchors' geometry is what changes."""
    with open(path) as f:
        raw = json.load(f)
    priors = tuple(tuple((float(w), float(h)) for w, h in s) for s in raw)
    if cfg.head != "yolo":
        raise ValueError(f"--yolo_priors needs a YOLO config, got {cfg.name}")
    if len(priors) != len(cfg.yolo_grids):
        raise ValueError(
            f"{path} has {len(priors)} scales; config {cfg.name} expects "
            f"{len(cfg.yolo_grids)}"
        )
    return dataclasses.replace(cfg, yolo_priors=priors)


_CONFIGS = {c.name: c for c in (SSD_MOBILENET_300, SSD_VGG16_512,
                                 YOLO_MOBILENET_384)}
_TINY = ("ssd_tiny_64", "yolo_tiny_64")


def get_config(name: str) -> DetectorConfig:
    if name in _TINY:
        return tiny_test_config(name.split("_")[0])
    if name not in _CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; have {sorted(_CONFIGS) + list(_TINY)}"
        )
    return _CONFIGS[name]
