"""Box math, SSD and YOLO codecs (mirror of bdd100k_tpu/ops/boxes.py).

Corner boxes are (x1, y1, x2, y2), center boxes (cx, cy, w, h), both
normalized to [0, 1]. Every function keeps the reference's operation order,
so f32 results agree to the ulp.
"""

from __future__ import annotations

import torch

VARIANCE_CENTER = 0.1
VARIANCE_SIZE = 0.2

_EPS = 1e-8


def corner_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) → (cx, cy, w, h), with cx = x1 + 0.5·w."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return torch.stack([x1 + 0.5 * w, y1 + 0.5 * h, w, h], dim=-1)


def center_to_corner(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    hw = 0.5 * w
    hh = 0.5 * h
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of corner boxes; negative extents clamp to zero."""
    w = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0.0)
    h = torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0.0)
    return w * h


def clip_boxes(boxes: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.clamp(boxes, lo, hi)


def intersection_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, 4), b (..., N, 4) → (..., M, N) intersection areas."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    return torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)


def iou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, 4), b (..., N, 4) → (..., M, N) IoU:
    inter / max((area_a + area_b) − inter, 1e-8), all f32."""
    inter = intersection_pairwise(a, b)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp_min(union, _EPS)


def decode_boxes(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    variances: tuple[float, float] = (VARIANCE_CENTER, VARIANCE_SIZE),
) -> torch.Tensor:
    """SSD decode of (tx, ty, tw, th) against center anchors → corner boxes."""
    vc, vs = variances
    cxy = deltas[..., :2] * vc * anchors[..., 2:] + anchors[..., :2]
    wh = torch.exp(deltas[..., 2:] * vs) * anchors[..., 2:]
    return center_to_corner(torch.cat([cxy, wh], dim=-1))


def encode_boxes(
    boxes: torch.Tensor,
    anchors: torch.Tensor,
    variances: tuple[float, float] = (VARIANCE_CENTER, VARIANCE_SIZE),
) -> torch.Tensor:
    """SSD encode of corner boxes against center anchors → (tx, ty, tw, th):
    tx = (cx − cx_a) / (w_a·v_c), tw = log(max(w, 1e-8) / w_a) / v_s."""
    vc, vs = variances
    g = corner_to_center(boxes)
    txy = (g[..., :2] - anchors[..., :2]) / (anchors[..., 2:] * vc)
    twh = torch.log(torch.clamp_min(g[..., 2:], _EPS) / anchors[..., 2:]) / vs
    return torch.cat([txy, twh], dim=-1)


def yolo_decode_boxes(
    deltas: torch.Tensor, anchors: torch.Tensor, cell_sizes: torch.Tensor
) -> torch.Tensor:
    """YOLO decode of raw (tx, ty, tw, th) (..., A, 4) against cell-center
    anchors (A, 4) and their cell sizes (A,) → corner boxes:
    c = c_a + (σ(t) − 0.5)·cell, wh = wh_a·exp(t_wh)."""
    sxy = torch.sigmoid(deltas[..., :2])
    cxy = anchors[..., :2] + (sxy - 0.5) * cell_sizes[..., None]
    wh = anchors[..., 2:] * torch.exp(deltas[..., 2:])
    return center_to_corner(torch.cat([cxy, wh], dim=-1))


def yolo_encode_boxes(
    boxes: torch.Tensor, anchors: torch.Tensor, cell_sizes: torch.Tensor
) -> torch.Tensor:
    """The inverse of `yolo_decode_boxes` in σ-space: corner boxes →
    (σ(tx)*, σ(ty)*, tw, th), the post-sigmoid xy target
    (c − c_a)/cell + 0.5 and tw = log(max(w, 1e-8) / w_a)."""
    g = corner_to_center(boxes)
    sxy = (g[..., :2] - anchors[..., :2]) / cell_sizes[..., None] + 0.5
    twh = torch.log(torch.clamp_min(g[..., 2:], _EPS) / anchors[..., 2:])
    return torch.cat([sxy, twh], dim=-1)
