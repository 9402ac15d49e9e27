"""Postprocess: box decode → scoring → class-wise NMS (mirror of
bdd100k_tpu/ops/postprocess.py), on whatever device the logits live."""

from __future__ import annotations

import torch

from bdd100k_tpu_torch.configs.detector_configs import PostprocessConfig
from bdd100k_tpu_torch.ops import boxes as box_ops
from bdd100k_tpu_torch.ops.nms import Detections, batched_class_nms

__all__ = ["PostprocessConfig", "compute_scores", "postprocess"]


def compute_scores(cls_preds: torch.Tensor, score_mode: str) -> torch.Tensor:
    """(.., A, C+1) logits → (.., A, C) foreground scores."""
    if score_mode == "softmax":
        # jax.nn.softmax's formula: exp(x − max) / Σ exp(x − max)
        e = torch.exp(cls_preds - cls_preds.amax(dim=-1, keepdim=True))
        return (e / e.sum(dim=-1, keepdim=True))[..., 1:]
    if score_mode == "sigmoid":
        obj = torch.sigmoid(cls_preds[..., :1])
        return obj * torch.sigmoid(cls_preds[..., 1:])
    raise ValueError(f"unknown score_mode: {score_mode}")


def postprocess(
    loc_preds: torch.Tensor,
    cls_preds: torch.Tensor,
    anchors_center: torch.Tensor,
    config: PostprocessConfig = PostprocessConfig(),
    cell_sizes: torch.Tensor | None = None,
) -> Detections:
    """loc (B, A, 4), cls (B, A, C+1) logits, anchors (A, 4) center, and
    for decode_mode "yolo" each anchor's cell size (A,) → `Detections` with
    fixed (B, max_detections) slots, clipped to [0, 1].

    The suppression runs the CUDA kernel for CUDA tensors and the plain
    greedy for CPU tensors."""
    loc_preds = loc_preds.to(torch.float32)
    cls_preds = cls_preds.to(torch.float32)
    anchors_center = anchors_center.to(loc_preds.device)
    if config.decode_mode == "yolo":
        if cell_sizes is None:
            raise ValueError('decode_mode="yolo" needs cell_sizes')
        decoded = box_ops.yolo_decode_boxes(
            loc_preds, anchors_center, cell_sizes.to(loc_preds.device))
    elif config.decode_mode == "ssd":
        decoded = box_ops.decode_boxes(loc_preds, anchors_center,
                                       config.variances)
    else:
        raise ValueError(f"unknown decode_mode: {config.decode_mode}")
    decoded = box_ops.clip_boxes(decoded)
    scores = compute_scores(cls_preds, config.score_mode)
    return batched_class_nms(
        decoded,
        scores,
        iou_threshold=config.iou_threshold,
        score_threshold=config.score_threshold,
        per_class_topk=config.per_class_topk,
        max_detections=config.max_detections,
        preselect=config.preselect,
    )
