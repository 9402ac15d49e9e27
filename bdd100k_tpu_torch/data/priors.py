"""YOLO anchor priors by k-means over GT box shapes under 1 − IoU (the
port's own copy of bdd100k_tpu/data/priors.py, numpy only).

    python -m bdd100k_tpu_torch.data.priors --labels train.json --out priors.json

writes the nested [scale][prior][w, h] JSON that `--yolo_priors` reads
(`configs.apply_yolo_priors`), in the format of the reference's
scripts/kmeans_priors.py. Boxes are compared co-centered, so the priors
maximize the mean anchor↔GT shape overlap rather than L2 closeness, which
would over-weight large boxes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _pairwise_shape_iou(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """IoU of co-centered boxes given only shapes: wh (N, 2), centroids
    (K, 2) → (N, K)."""
    inter = np.minimum(wh[:, None, 0], centroids[None, :, 0]) * np.minimum(
        wh[:, None, 1], centroids[None, :, 1]
    )
    union = (
        wh[:, 0] * wh[:, 1]
    )[:, None] + (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_priors(
    wh: np.ndarray,
    k: int = 9,
    seed: int = 0,
    iters: int = 100,
) -> tuple[np.ndarray, float]:
    """Cluster (N, 2) normalized box shapes (degenerate rows dropped) into
    k priors → (centroids (k, 2) sorted by area, mean best IoU over the
    boxes).

    Deterministic for a seed: a k-means++ init in 1 − IoU distance from
    `np.random.default_rng(seed)`, then medians as the update step (robust
    to the heavy tail of road-scene box sizes)."""
    wh = np.asarray(wh, dtype=np.float64)
    wh = wh[(wh[:, 0] > 1e-6) & (wh[:, 1] > 1e-6)]
    if len(wh) < k:
        raise ValueError(f"need ≥ {k} boxes to fit {k} priors, got {len(wh)}")
    rng = np.random.default_rng(seed)

    centroids = wh[rng.integers(len(wh))][None]
    for _ in range(k - 1):
        d = 1.0 - _pairwise_shape_iou(wh, centroids).max(axis=1)
        total = d.sum()
        # every shape already on a centroid: no farthest-point mass, so
        # draw uniformly
        p = np.full(len(wh), 1.0 / len(wh)) if total <= 0.0 else d / total
        centroids = np.vstack([centroids, wh[rng.choice(len(wh), p=p)]])

    assign = np.zeros(len(wh), dtype=np.int64) - 1
    for _ in range(iters):
        iou = _pairwise_shape_iou(wh, centroids)
        new_assign = iou.argmax(axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            members = wh[assign == j]
            if len(members):
                centroids[j] = np.median(members, axis=0)
    mean_iou = float(_pairwise_shape_iou(wh, centroids).max(axis=1).mean())
    order = np.argsort(centroids[:, 0] * centroids[:, 1])
    return centroids[order], mean_iou


def priors_to_scales(
    centroids: np.ndarray, num_scales: int = 3
) -> tuple[tuple[tuple[float, float], ...], ...]:
    """Area-sorted centroids → `num_scales` equal groups, smallest on the
    finest grid, rounded to 4 places: `DetectorConfig.yolo_priors`'s
    format."""
    k = len(centroids)
    if k % num_scales:
        raise ValueError(f"k={k} not divisible by num_scales={num_scales}")
    per = k // num_scales
    return tuple(
        tuple(
            (round(float(w), 4), round(float(h), 4))
            for w, h in centroids[s * per:(s + 1) * per]
        )
        for s in range(num_scales)
    )


def mean_best_iou(wh: np.ndarray, priors) -> float:
    """Mean best shape-IoU of the boxes against a flat or nested prior set,
    the figure of merit for comparing prior sets on a dataset."""
    flat = np.asarray(
        [p for scale in priors for p in scale]
        if priors and isinstance(priors[0][0], (tuple, list, np.ndarray))
        else priors,
        dtype=np.float64,
    )
    wh = np.asarray(wh, dtype=np.float64)
    wh = wh[(wh[:, 0] > 1e-6) & (wh[:, 1] > 1e-6)]
    return float(_pairwise_shape_iou(wh, flat).max(axis=1).mean())


def collect_box_shapes(records: list[dict]) -> np.ndarray:
    """Parsed BDD100K records (`data.bdd100k.load_bdd100k_labels`) →
    (N, 2) normalized (w, h) of every GT box."""
    whs = []
    for rec in records:
        b = np.asarray(rec["boxes"], dtype=np.float64).reshape(-1, 4)
        if len(b):
            whs.append(np.stack([b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1))
    if not whs:
        return np.zeros((0, 2), dtype=np.float64)
    return np.concatenate(whs, axis=0)


def main(argv=None) -> tuple:
    from bdd100k_tpu_torch.data.bdd100k import load_bdd100k_labels
    from bdd100k_tpu_torch.ops.anchors import YOLO_BDD_PRIORS

    p = argparse.ArgumentParser(description="fit YOLO anchor priors by k-means")
    p.add_argument("--labels", required=True,
                   help="BDD100K labels JSON, or a directory of per-image JSONs")
    p.add_argument("--k", type=int, default=9)
    p.add_argument("--scales", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the priors as JSON here")
    args = p.parse_args(argv)

    records = load_bdd100k_labels(args.labels)
    wh = collect_box_shapes(records)
    print(f"{len(records)} images, {len(wh)} GT boxes")
    if len(records) < 512:
        print(f"WARNING: only {len(records)} images; k-means priors overfit "
              "small label samples (fit on >= 512 images before shipping)",
              file=sys.stderr)
    centroids, fitted_iou = kmeans_priors(wh, k=args.k, seed=args.seed)
    priors = priors_to_scales(centroids, num_scales=args.scales)
    print(f"mean best-IoU: fitted {fitted_iou:.4f} (default YOLO_BDD_PRIORS "
          f"on these boxes: {mean_best_iou(wh, YOLO_BDD_PRIORS):.4f})")
    print("yolo_priors = (")
    for scale in priors:
        print(f"    {scale},")
    print(")")
    if args.out:
        Path(args.out).write_text(json.dumps(priors))
        print(f"wrote {args.out}")
    return priors


if __name__ == "__main__":
    main()
