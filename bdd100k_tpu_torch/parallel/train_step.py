"""The train and eval steps (mirror of bdd100k_tpu/parallel/train_step.py).

One step on the card: uint8 frames + padded GT → augment → forward (bf16
convs, f32 BatchNorm in train mode) → matcher kernel → hard-negative
mining + SSD or YOLO loss → backward (the stride-1 depthwise layers on their dx
and dk kernels) → clip by global norm → weight decay → SGD with momentum
(or Adam) at the reference's LR schedule → optional EMA. Nothing is read
back to the host: the metrics come back as device scalars.

The update follows optax's order and arithmetic:
* the LR of the update made at count n is lr(n), the count before the
  increment (so step 0 runs at lr(0), 0 under warmup);
* clipping scales every gradient by max/‖g‖ only when ‖g‖ ≥ max (not
  `clip_grad_norm_`, which divides by ‖g‖ + 1e-6);
* weight decay adds wd·p after the clip and before momentum, on every
  parameter, for SGD only; momentum is optax's `trace` (t ← g + 0.9·t,
  p ← p − lr·t), which is `torch.optim.SGD` without dampening or Nesterov.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from bdd100k_tpu_torch.configs.train_configs import TrainConfig
from bdd100k_tpu_torch.data.augment import (
    AugmentConfig,
    augment_batch,
    preprocess_eval_batch,
    yuv420_to_rgb_batch,
)
from bdd100k_tpu_torch.models.detector import DetectorBundle
from bdd100k_tpu_torch.models.losses import LossBreakdown, ssd_loss, yolo_loss
from bdd100k_tpu_torch.ops import boxes as box_ops
from bdd100k_tpu_torch.ops import matcher
from bdd100k_tpu_torch.ops.nms import Detections
from bdd100k_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """What a step updates, in place: the model (params and BN running
    statistics), the optimizer's state, the step count and the EMA shadow
    of the params (None when EMA is off)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip_norm: float
    ema_params: list[torch.Tensor] | None = None


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Warmup → piecewise decay, in f32, as the reference's optax schedule
    computes it: the piecewise part is re-based at `warmup_steps`, so its
    boundary keys are warmup-relative, and keys that collide (small
    `total_steps`) multiply their decays."""
    offset = max(cfg.warmup_steps, 0)
    decay_points: dict[int, float] = {}
    for frac, d in zip(cfg.lr_boundaries, cfg.lr_decays):
        key = max(int(frac * cfg.total_steps) - offset, 1)
        decay_points[key] = decay_points.get(key, 1.0) * d
    points = sorted(decay_points.items())
    lr = np.float32(cfg.learning_rate)

    def piecewise(count: int) -> np.float32:
        v = lr
        for threshold, scale in points:
            if count >= threshold:
                v = np.float32(scale) * v
        return v

    def schedule(count: int) -> float:
        if cfg.warmup_steps <= 0:
            return float(piecewise(count))
        if count < cfg.warmup_steps:  # linear 0 → lr
            frac = np.float32(1) - np.float32(count) / np.float32(cfg.warmup_steps)
            return float((np.float32(0) - lr) * frac + lr)
        return float(piecewise(count - cfg.warmup_steps))

    return schedule


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """SGD with momentum (optax `trace`) and weight decay added to the
    gradient, or Adam with optax's defaults and no decay; the LR is set per
    step from the schedule."""
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(
            params, lr=0.0, momentum=cfg.momentum, dampening=0.0,
            nesterov=False, weight_decay=max(cfg.weight_decay, 0.0),
            foreach=True,
        )
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                foreach=True)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def create_train_state(bundle: DetectorBundle, cfg: TrainConfig) -> TrainState:
    params = list(bundle.model.parameters())
    ema = ([p.detach().clone() for p in params] if cfg.ema_decay > 0 else None)
    return TrainState(
        step=0,
        model=bundle.model,
        optimizer=make_optimizer(cfg, params),
        schedule=make_lr_schedule(cfg),
        grad_clip_norm=cfg.grad_clip_norm,
        ema_params=ema,
    )


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """√(Σ‖g‖²) over every gradient, on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """optax's clip, in place and without a host sync: g ← g·(max/‖g‖)
    when ‖g‖ ≥ max, else g unchanged."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def apply_gradients(state: TrainState) -> torch.Tensor:
    """The update from the gradients in `.grad`: clip by global norm, then
    the optimizer (weight decay, momentum) at lr(step), then step += 1 →
    the gradients' global norm before the clip."""
    grads = [p.grad for p in state.model.parameters()]
    norm = global_norm(grads)
    clip_by_global_norm(grads, state.grad_clip_norm, norm)
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return norm


def ema_update(state: TrainState, decay: float) -> None:
    """e ← e − (1 − d)·(e − p) with the TF1 ramp d = min(decay,
    (1 + step)/(10 + step)) at the post-update step, in place."""
    step = np.float32(state.step)
    d = np.minimum(np.float32(decay),
                   (np.float32(1) + step) / (np.float32(10) + step))
    params = [p.detach() for p in state.model.parameters()]
    diff = torch._foreach_sub(state.ema_params, params)
    torch._foreach_mul_(diff, float(np.float32(1) - d))
    torch._foreach_sub_(state.ema_params, diff)


def detection_loss(bundle: DetectorBundle, loc_preds, cls_preds, gt_boxes,
                   gt_labels, gt_mask) -> LossBreakdown:
    """The head's loss over the matcher's output: the matcher kernel for
    CUDA tensors, the oracle for CPU tensors. YOLO encodes its own σ-space
    targets from each anchor's matched GT box."""
    cfg = bundle.config
    match = matcher.encode_targets(
        gt_boxes, gt_labels, gt_mask, bundle.anchors, cfg.match_threshold)
    if cfg.head == "ssd":
        return ssd_loss(loc_preds, cls_preds, match, cfg.neg_pos_ratio)
    matched_boxes = torch.gather(
        gt_boxes, 1, match.matched_gt[..., None].expand(-1, -1, 4))
    sigma_targets = box_ops.yolo_encode_boxes(
        matched_boxes, bundle.anchors, bundle.cell_sizes)
    return yolo_loss(loc_preds, cls_preds, match, sigma_targets,
                     cfg.neg_pos_ratio)


def yuv420_rgb_u8(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The yuv420 wire's planes → uint8 RGB (B, S, S, 3): the BT.601
    conversion scaled to 0..255, plus 0.5, truncated (reference:
    bdd100k_tpu/parallel/train_step.py:197-205)."""
    return (yuv420_to_rgb_batch(y, uv) * 255.0 + 0.5).to(torch.uint8)


def make_train_step(
    bundle: DetectorBundle,
    augment_cfg: AugmentConfig | None = None,
    ema_decay: float = 0.0,
    device: str | torch.device = "cuda",
) -> Callable:
    """step(state, gen, images, gt_boxes, gt_labels, gt_mask) → metrics.

    uint8 images are native-resolution frames and go through the augment
    (draws from `gen`, a generator on the device); a (y, uv) pair from the
    yuv420 wire is first rebuilt into uint8 RGB on the device, as the
    reference does (`yuv420_rgb_u8`); float images are taken as already
    preprocessed (B, S, S, 3) and bypass the augment, as the reference
    does. The metrics are device scalars: loss, conf_loss, loc_loss and
    grad_norm (before the clip). `device` defaults to CUDA and raises
    without it; the bundle must live on it."""
    device = resolve_device(device)
    if bundle.anchors.device.type != device.type:
        raise ValueError(
            f"the bundle lives on {bundle.anchors.device}, not {device}")
    if augment_cfg is None:
        augment_cfg = AugmentConfig(out_size=bundle.config.image_size)

    def step(state: TrainState, gen, images, gt_boxes, gt_labels, gt_mask):
        model = state.model
        model.train()
        if isinstance(images, (tuple, list)):
            images = yuv420_rgb_u8(*images)
        if images.dtype == torch.uint8:
            images, gt_boxes, gt_labels, gt_mask = augment_batch(
                gen, images, gt_boxes, gt_labels, gt_mask, augment_cfg)
        loc, cls = model(images)
        lb = detection_loss(bundle, loc, cls, gt_boxes, gt_labels, gt_mask)
        state.optimizer.zero_grad(set_to_none=True)
        lb.total.backward()
        norm = apply_gradients(state)
        if ema_decay > 0:
            ema_update(state, ema_decay)
        return {
            "loss": lb.total.detach(),
            "conf_loss": lb.conf.detach(),
            "loc_loss": lb.loc.detach(),
            "grad_norm": norm,
        }

    return step


def make_eval_step(bundle: DetectorBundle) -> Callable:
    """step(images) → `Detections` on the bundle's device, fixed slots
    (reference: bdd100k_tpu/parallel/train_step.py::make_eval_step, without
    the mesh).

    `images` is uint8 RGB (B, H, W, 3), a (y, uv) YUV 4:2:0 pair from the
    yuv420 wire, or an already preprocessed float (B, S, S, 3). The
    preprocess, the forward in the bundle's working type (its model in eval
    mode) and the postprocess (the NMS kernel for CUDA tensors) run under
    `torch.inference_mode()`. Nothing is read back and no shape depends on
    the data, so the step never waits for the card: a caller can dispatch
    the next batch before it fetches this one."""
    size = bundle.config.image_size
    model = bundle.model.eval()

    def step(images) -> Detections:
        model.eval()  # a train step between two calls leaves train mode
        with torch.inference_mode():
            if isinstance(images, (tuple, list)) or images.dtype == torch.uint8:
                images = preprocess_eval_batch(images, size)
            loc, cls = model(images)
            return bundle.postprocess(loc, cls)

    return step
