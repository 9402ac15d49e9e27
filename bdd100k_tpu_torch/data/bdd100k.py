"""BDD100K detection labels (mirror of bdd100k_tpu/data/bdd100k.py).

Format (the public BDD100K release): a JSON list, or one JSON per image,
each entry
  {"name": "xxx.jpg",
   "attributes": {"weather": ..., "scene": ..., "timeofday": ...},
   "labels": [{"category": "car", "box2d": {"x1":..,"y1":..,"x2":..,"y2":..},
               "attributes": {"occluded": bool, "truncated": bool}}, ...]}

10 detection classes; boxes in pixels on the 1280×720 frames, normalized
here to [0, 1], categories mapped to ids 1..10 (0 = background).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np

from bdd100k_tpu_torch.configs.detector_configs import BDD100K_CLASSES

BDD100K_CATEGORY_TO_ID = {name: i + 1 for i, name in enumerate(BDD100K_CLASSES)}
# alias spellings seen across BDD100K releases
_ALIASES = {
    "bicycle": "bike",
    "motorcycle": "motor",
    "pedestrian": "person",
    "traffic_light": "traffic light",
    "traffic_sign": "traffic sign",
}

IMAGE_WIDTH = 1280
IMAGE_HEIGHT = 720


def parse_bdd100k_record(
    record: dict,
    image_width: int = IMAGE_WIDTH,
    image_height: int = IMAGE_HEIGHT,
) -> dict:
    """One image's entry → {name, boxes (N, 4) f32 normalized corners,
    labels (N,) int32, attributes, box_attributes}. Labels without a box2d
    and unknown categories (lane and area marks) are skipped; coordinates
    are clamped to [0, 1] at both ends, and boxes left with no area are
    dropped."""
    boxes, labels, box_attrs = [], [], []
    for lab in record.get("labels", []) or []:
        box = lab.get("box2d")
        if box is None:
            continue
        cat = lab.get("category", "")
        cls = BDD100K_CATEGORY_TO_ID.get(_ALIASES.get(cat, cat))
        if cls is None:
            continue
        x1 = min(max(box["x1"] / image_width, 0.0), 1.0)
        y1 = min(max(box["y1"] / image_height, 0.0), 1.0)
        x2 = min(max(box["x2"] / image_width, 0.0), 1.0)
        y2 = min(max(box["y2"] / image_height, 0.0), 1.0)
        if x2 <= x1 or y2 <= y1:
            continue
        boxes.append([x1, y1, x2, y2])
        labels.append(cls)
        a = lab.get("attributes", {}) or {}
        box_attrs.append({"occluded": bool(a.get("occluded", False)),
                          "truncated": bool(a.get("truncated", False))})
    return {
        "name": record.get("name", ""),
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "labels": np.asarray(labels, np.int32),
        "attributes": record.get("attributes", {}) or {},
        "box_attributes": box_attrs,
    }


def load_bdd100k_labels(path: str | Path) -> list[dict]:
    """A split's labels: one JSON list (the release format) or a directory
    of per-image JSONs, read in file-name order."""
    path = Path(path)
    if path.is_dir():
        records: Iterable[dict] = (
            json.loads(p.read_text()) for p in sorted(path.glob("*.json")))
    else:
        data = json.loads(path.read_text())
        records = data if isinstance(data, list) else [data]
    return [parse_bdd100k_record(r) for r in records]


def pad_ground_truth(
    boxes: np.ndarray, labels: np.ndarray, max_boxes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-size GT for static shapes: the first `max_boxes` rows, zero
    padded → (boxes (max_boxes, 4) f32, labels (max_boxes,) int32, mask
    (max_boxes,) bool)."""
    n = min(len(boxes), max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_labels = np.zeros((max_boxes,), np.int32)
    out_mask = np.zeros((max_boxes,), bool)
    if n:
        out_boxes[:n] = boxes[:n]
        out_labels[:n] = labels[:n]
        out_mask[:n] = True
    return out_boxes, out_labels, out_mask
