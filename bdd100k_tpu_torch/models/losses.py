"""Detection losses (mirror of bdd100k_tpu/models/losses.py).

SSD: L = (1/N_pos)·(CE over positives ∪ mined negatives + α·smooth-L1 of
the positives' loc), α = 1, negatives mined at ≤ 3:1 by their CE.

YOLO: L = (1/N_pos)·(objectness BCE over positives ∪ mined negatives +
class BCE over positives + 2·(σ-space MSE of xy + smooth-L1 of log wh) over
positives), negatives mined at ≤ 3:1 (at least one) by their objectness
BCE. The BCE is optax's `sigmoid_binary_cross_entropy` written out,
−y·log σ(x) − (1−y)·log σ(−x), whose last bits differ from
`F.binary_cross_entropy_with_logits`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from bdd100k_tpu_torch.ops.matching import MatchResult
from bdd100k_tpu_torch.ops.mining import hard_negative_mask


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    conf: torch.Tensor
    loc: torch.Tensor


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def ssd_loss(
    loc_preds: torch.Tensor,
    cls_preds: torch.Tensor,
    match: MatchResult,
    neg_pos_ratio: float = 3.0,
) -> LossBreakdown:
    """loc_preds (B, A, 4), cls_preds (B, A, C+1) logits (column 0 is
    background), match: the batched MatchResult → scalar losses, averaged
    over the batch. Mining ranks each negative by its CE, with no gradient
    through the ranking."""
    loc_preds = loc_preds.to(torch.float32)
    cls_preds = cls_preds.to(torch.float32)
    positive = match.positive
    b, a, k = cls_preds.shape
    ce = F.cross_entropy(
        cls_preds.reshape(b * a, k), match.cls_targets.reshape(b * a),
        reduction="none",
    ).reshape(b, a)
    neg_mask = hard_negative_mask(ce.detach(), positive, neg_pos_ratio,
                                  min_negatives=1)
    conf_mask = positive | neg_mask
    num_pos = torch.clamp_min(positive.sum(dim=-1), 1).to(torch.float32)

    conf_loss = torch.where(conf_mask, ce, 0.0).sum(dim=-1) / num_pos
    loc_err = smooth_l1(loc_preds - match.loc_targets).sum(dim=-1)
    loc_loss = torch.where(positive, loc_err, 0.0).sum(dim=-1) / num_pos
    conf_loss = conf_loss.mean()
    loc_loss = loc_loss.mean()
    return LossBreakdown(conf_loss + loc_loss, conf_loss, loc_loss)


YOLO_LOC_WEIGHT = 2.0  # the reference's; objectness and class weigh 1


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax's formula: −y·log σ(x) − (1−y)·log σ(−x), elementwise."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def yolo_loss(
    loc_preds: torch.Tensor,
    obj_cls_preds: torch.Tensor,
    match: MatchResult,
    sigma_xy_targets: torch.Tensor,
    neg_pos_ratio: float = 3.0,
) -> LossBreakdown:
    """loc_preds (B, A, 4) raw (tx, ty, tw, th), obj_cls_preds (B, A, 1+C)
    objectness + class logits, match: the batched MatchResult (its
    loc_targets unused), sigma_xy_targets (B, A, 4) = (σx*, σy*, tw*, th*)
    from `yolo_encode_boxes` of each anchor's matched GT → scalar losses,
    averaged over the batch: (total, obj + cls, loc)."""
    loc_preds = loc_preds.to(torch.float32)
    obj_cls_preds = obj_cls_preds.to(torch.float32)
    positive = match.positive
    pos_f = positive.to(torch.float32)
    num_pos = torch.clamp_min(pos_f.sum(dim=-1), 1.0)

    obj_bce = sigmoid_binary_cross_entropy(obj_cls_preds[..., 0], pos_f)
    neg_mask = hard_negative_mask(obj_bce.detach(), positive, neg_pos_ratio,
                                  min_negatives=1)
    obj_mask = positive | neg_mask
    obj_loss = torch.where(obj_mask, obj_bce, 0.0).sum(dim=-1) / num_pos

    # class BCE over positives; class 1..C → one-hot column 0..C−1, and
    # background (0) → all zeros, as jax.nn.one_hot(−1) gives
    cls_logits = obj_cls_preds[..., 1:]
    num_classes = cls_logits.shape[-1]
    onehot = (match.cls_targets[..., None] - 1
              == torch.arange(num_classes, device=cls_logits.device))
    cls_bce = sigmoid_binary_cross_entropy(cls_logits, onehot).sum(dim=-1)
    cls_loss = torch.where(positive, cls_bce, 0.0).sum(dim=-1) / num_pos

    # coords: xy in σ-space (MSE), wh in log-space (smooth L1)
    sxy = torch.sigmoid(loc_preds[..., :2])
    xy_err = torch.square(sxy - sigma_xy_targets[..., :2]).sum(dim=-1)
    wh_err = smooth_l1(loc_preds[..., 2:] - sigma_xy_targets[..., 2:]).sum(dim=-1)
    loc_loss = torch.where(positive, xy_err + wh_err, 0.0).sum(dim=-1) / num_pos

    obj_loss = obj_loss.mean()
    cls_loss = cls_loss.mean()
    loc_loss = loc_loss.mean()
    total = obj_loss + cls_loss + YOLO_LOC_WEIGHT * loc_loss
    return LossBreakdown(total, obj_loss + cls_loss, loc_loss)
