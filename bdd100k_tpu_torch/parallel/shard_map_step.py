"""The explicit data-parallel train step (counterpart of
bdd100k_tpu/parallel/shard_map_step.py).

The pjit form, `train_step.make_train_step(group=)`, computes what one
process computes on the global batch. This form is the reference's
shard_map variant, the collectives written out per shard:
* BatchNorm takes each rank's local statistics (classic local BN), and the
  running statistics are averaged over the ranks after the step;
* the gradients are averaged over the ranks in one flattened all-reduce
  before the clip, and the metrics are averaged;
* each rank draws its own augment stream. The reference folds the shard
  index into the step's key (`jax.random.fold_in`); torch's generators have
  no fold-in and give other numbers than `jax.random` for any seed anyway
  (`data/augment.py`), so the rank's generator is reseeded from the step's
  seed and the rank (`rank_seed`): rank 0 keeps the step's seed, and at one
  rank this step and the pjit step draw alike.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from bdd100k_tpu_torch.data.augment import AugmentConfig, augment_batch
from bdd100k_tpu_torch.models.detector import DetectorBundle
from bdd100k_tpu_torch.models.layers import BatchNorm
from bdd100k_tpu_torch.parallel.train_step import (
    TrainState,
    apply_gradients,
    detection_loss,
    ema_update,
    loss_metrics,
    mean_over_ranks_,
    yuv420_rgb_u8,
)
from bdd100k_tpu_torch.utils.device import resolve_device


def rank_seed(step_seed: int, rank: int) -> int:
    """A rank's augment seed from the step's: distinct per rank, the
    step's own at rank 0."""
    return (step_seed + rank * 0x9E3779B97F4A7C15) % (1 << 63)


def make_shardmap_train_step(
    bundle: DetectorBundle,
    augment_cfg: AugmentConfig | None = None,
    ema_decay: float = 0.0,
    device: str | torch.device = "cuda",
    group=None,
) -> Callable:
    """step(state, gen, images, gt_boxes, gt_labels, gt_mask) → metrics, the
    contract of `make_train_step`; each rank's batch is its own shard and
    `gen` is seeded with the step's seed on every rank (`manual_seed`)."""
    if group is None:
        raise ValueError("the shard_map step needs a process group")
    device = resolve_device(device)
    if bundle.anchors.device.type != device.type:
        raise ValueError(
            f"the bundle lives on {bundle.anchors.device}, not {device}")
    if augment_cfg is None:
        augment_cfg = AugmentConfig(out_size=bundle.config.image_size)
    rank = dist.get_rank(group)
    running = [t for m in bundle.model.modules() if isinstance(m, BatchNorm)
               for t in (m.running_mean, m.running_var)]

    def step(state: TrainState, gen, images, gt_boxes, gt_labels, gt_mask):
        model = state.model
        model.train()
        if isinstance(images, (tuple, list)):
            images = yuv420_rgb_u8(*images)
        if images.dtype == torch.uint8:
            gen.manual_seed(rank_seed(gen.initial_seed(), rank))
            images, gt_boxes, gt_labels, gt_mask = augment_batch(
                gen, images, gt_boxes, gt_labels, gt_mask, augment_cfg)
        loc, cls = model(images)
        lb = detection_loss(bundle, loc, cls, gt_boxes, gt_labels, gt_mask)
        state.optimizer.zero_grad(set_to_none=True)
        lb.total.backward()
        mean_over_ranks_([p.grad for p in model.parameters()], group)
        if running:
            mean_over_ranks_(running, group)
        norm = apply_gradients(state)
        if ema_decay > 0:
            ema_update(state, ema_decay)
        return loss_metrics(lb, norm, group)

    return step
