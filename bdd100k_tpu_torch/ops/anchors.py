"""SSD multibox and YOLO grid anchors (mirror of bdd100k_tpu/ops/anchors.py).

Built in numpy f32 exactly as the reference builds them, so the two
anchor tables are bit-equal; each function hands back a torch tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FeatureMapSpec:
    """One tapped feature map's anchor layout."""

    size: int                      # spatial resolution (square)
    num_boxes: int                 # anchors per cell (4 or 6)
    scale: float                   # s_k (fraction of input size)
    next_scale: float              # s_{k+1}, for the extra ar=1 box


def _ssd_scales(num_maps: int, s_min: float, s_max: float, first_scale: float):
    rest = [
        s_min + (s_max - s_min) * k / (num_maps - 2) for k in range(num_maps - 1)
    ]
    step = (s_max - s_min) / (num_maps - 2)
    return [first_scale] + rest, rest[-1] + step


def make_ssd_feature_maps(
    map_sizes: Sequence[int],
    boxes_per_map: Sequence[int],
    s_min: float = 0.2,
    s_max: float = 0.9,
    first_scale: float = 0.1,
) -> tuple[FeatureMapSpec, ...]:
    scales, s_extra = _ssd_scales(len(map_sizes), s_min, s_max, first_scale)
    nexts = scales[1:] + [s_extra]
    return tuple(
        FeatureMapSpec(size=f, num_boxes=nb, scale=s, next_scale=sn)
        for f, nb, s, sn in zip(map_sizes, boxes_per_map, scales, nexts)
    )


SSD300_FEATURE_MAPS = make_ssd_feature_maps(
    map_sizes=(38, 19, 10, 5, 3, 1),
    boxes_per_map=(4, 6, 6, 6, 4, 4),
)
# VGG16-SSD512 adds a seventh map: 24564 anchors
SSD512_FEATURE_MAPS = make_ssd_feature_maps(
    map_sizes=(64, 32, 16, 8, 4, 2, 1),
    boxes_per_map=(4, 6, 6, 6, 6, 4, 4),
)

# aspect-ratio sets by anchors-per-cell: ar=1 twice (s_k and sqrt(s_k s_{k+1}))
_AR_SETS = {
    4: (1.0, 2.0, 0.5),
    6: (1.0, 2.0, 3.0, 0.5, 1.0 / 3.0),
}


def ssd_anchors(
    feature_maps: Sequence[FeatureMapSpec] = SSD300_FEATURE_MAPS,
) -> torch.Tensor:
    """(num_anchors, 4) center-format (cx, cy, w, h) f32 anchors; layout:
    maps in order, then rows (y), cols (x), then the per-cell box set."""
    out = []
    for fm in feature_maps:
        ars = _AR_SETS[fm.num_boxes]
        s = fm.scale
        s_extra = float(np.sqrt(fm.scale * fm.next_scale))
        whs = [(s, s), (s_extra, s_extra)] + [
            (s * float(np.sqrt(ar)), s / float(np.sqrt(ar)))
            for ar in ars[1:]
        ]
        whs = np.asarray(whs, dtype=np.float32)
        assert whs.shape[0] == fm.num_boxes

        coords = (np.arange(fm.size, dtype=np.float32) + 0.5) / fm.size
        cy, cx = np.meshgrid(coords, coords, indexing="ij")
        centers = np.stack([cx, cy], axis=-1)
        centers = np.broadcast_to(
            centers[:, :, None, :], (fm.size, fm.size, fm.num_boxes, 2)
        )
        sizes = np.broadcast_to(
            whs[None, None, :, :], (fm.size, fm.size, fm.num_boxes, 2)
        )
        out.append(np.concatenate([centers, sizes], axis=-1).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out, axis=0).astype(np.float32))


def yolo_anchors(
    grid_sizes: Sequence[int],
    priors_per_scale: Sequence[Sequence[tuple[float, float]]],
) -> torch.Tensor:
    """YOLO anchors: k prior (w, h) pairs at every grid cell of every scale
    → (num_anchors, 4) center-format f32, laid out as `ssd_anchors`:
    scales in order, then rows, cols, then the cell's priors."""
    out = []
    for g, priors in zip(grid_sizes, priors_per_scale):
        priors = np.asarray(priors, dtype=np.float32)
        coords = (np.arange(g, dtype=np.float32) + 0.5) / g
        cy, cx = np.meshgrid(coords, coords, indexing="ij")
        centers = np.stack([cx, cy], axis=-1)
        k = priors.shape[0]
        centers = np.broadcast_to(centers[:, :, None, :], (g, g, k, 2))
        sizes = np.broadcast_to(priors[None, None, :, :], (g, g, k, 2))
        out.append(np.concatenate([centers, sizes], axis=-1).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out, axis=0).astype(np.float32))


def yolo_cell_sizes(
    grid_sizes: Sequence[int],
    priors_per_scale: Sequence[Sequence[tuple[float, float]]],
) -> torch.Tensor:
    """Each anchor's grid cell size (1/g), aligned with `yolo_anchors`."""
    out = [
        np.full(g * g * len(priors), 1.0 / g, dtype=np.float32)
        for g, priors in zip(grid_sizes, priors_per_scale)
    ]
    return torch.from_numpy(np.concatenate(out))


# The reference's default BDD100K YOLO priors (normalized w, h): small,
# medium and large objects on the stride-8, 16 and 32 grids.
YOLO_BDD_PRIORS = (
    ((0.02, 0.03), (0.04, 0.06), (0.08, 0.06)),
    ((0.10, 0.12), (0.16, 0.10), (0.22, 0.22)),
    ((0.35, 0.25), (0.55, 0.45), (0.85, 0.75)),
)
