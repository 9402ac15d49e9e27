"""Synthetic BDD100K-style scenes (mirror of bdd100k_tpu/data/synthetic.py):
rendered in memory, or read from a directory of the reference's JPEGs.

Same RandomState draws in the same order as the reference's
`generate_synthetic_dataset`, so for one seed the frames are bit-equal to
what the reference renders before its JPEG save, and the boxes equal what
its label parser reads back. Nothing is written to disk and no image
library is needed.

`ensure_synthetic_dataset` reads a directory that the reference's
`generate_synthetic_dataset` wrote (the JPEG encode needs PIL, which the
port does not use), such as the committed
`tests/fixtures/synth_val_seed1` (64 seed-1 val scenes).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from bdd100k_tpu_torch.configs.detector_configs import BDD100K_CLASSES
from bdd100k_tpu_torch.data.bdd100k import IMAGE_HEIGHT, IMAGE_WIDTH

# distinct fill color per class so a detector can learn the mapping
_CLASS_COLORS = np.asarray(
    [
        [200, 40, 40],    # car
        [240, 140, 30],   # bus
        [150, 90, 40],    # truck
        [40, 200, 60],    # person
        [40, 220, 160],   # rider
        [60, 80, 230],    # bike
        [140, 60, 220],   # motor
        [230, 220, 40],   # traffic light
        [230, 60, 200],   # traffic sign
        [90, 90, 90],     # train
    ],
    np.uint8,
)

_SIZE_RANGES = {  # rough per-class (w, h) pixel ranges at 1280×720
    "car": ((60, 260), (40, 160)),
    "bus": ((120, 400), (80, 240)),
    "truck": ((100, 360), (70, 220)),
    "person": ((20, 60), (50, 160)),
    "rider": ((20, 60), (50, 140)),
    "bike": ((30, 90), (30, 90)),
    "motor": ((30, 90), (30, 90)),
    "traffic light": ((10, 30), (25, 70)),
    "traffic sign": ((15, 50), (15, 50)),
    "train": ((200, 600), (80, 200)),
}


def _render_scene(rng: np.random.RandomState, boxes_px, classes) -> np.ndarray:
    h, w = IMAGE_HEIGHT, IMAGE_WIDTH
    img = np.zeros((h, w, 3), np.uint8)
    # sky gradient
    horizon = h // 2 + rng.randint(-40, 40)
    sky = np.linspace(180, 90, horizon)[:, None]
    img[:horizon] = np.stack(
        [sky * 0.7, sky * 0.8, sky], axis=-1
    ).astype(np.uint8)
    # ground / road
    img[horizon:] = (60, 62, 66)
    yy, xx = np.mgrid[horizon:h, 0:w]
    half_width = (yy - horizon + 1) * 0.9
    road = np.abs(xx - w / 2) < half_width
    img[horizon:][road] = (45, 45, 50)
    # objects, painted far-to-near
    order = np.argsort([b[3] for b in boxes_px])
    for i in order:
        x1, y1, x2, y2 = (int(v) for v in boxes_px[i])
        color = _CLASS_COLORS[classes[i] - 1]
        jitter = rng.randint(-20, 20, 3)
        img[y1:y2, x1:x2] = np.clip(
            color.astype(int) + jitter, 0, 255
        ).astype(np.uint8)
        img[y1 : min(y1 + 2, y2), x1:x2] //= 2
        img[max(y2 - 2, y1) : y2, x1:x2] //= 2
    noise = rng.randint(-8, 8, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def generate_synthetic_scenes(
    num_images: int = 32, seed: int = 0, max_objects: int = 12
) -> tuple[np.ndarray, list[np.ndarray], list[np.ndarray]]:
    """→ (frames (N, 720, 1280, 3) uint8, boxes [(n_i, 4) f32 normalized
    corner], labels [(n_i,) int32 in 1..10]).

    The draws mirror `generate_synthetic_dataset` one for one, including
    the attribute draws that only feed its JSON, so the stream stays in
    step. The boxes are normalized and clamped as the reference's label
    parser does; none is degenerate at these sizes, so none is dropped.
    """
    rng = np.random.RandomState(seed)
    frames = np.empty((num_images, IMAGE_HEIGHT, IMAGE_WIDTH, 3), np.uint8)
    all_boxes, all_labels = [], []
    for idx in range(num_images):
        n_obj = rng.randint(1, max_objects + 1)
        boxes_px, classes = [], []
        for _ in range(n_obj):
            cls = int(rng.randint(1, len(BDD100K_CLASSES) + 1))
            (wmin, wmax), (hmin, hmax) = _SIZE_RANGES[BDD100K_CLASSES[cls - 1]]
            bw = rng.randint(wmin, wmax + 1)
            bh = rng.randint(hmin, hmax + 1)
            x1 = rng.randint(0, max(IMAGE_WIDTH - bw, 1))
            y1 = rng.randint(
                IMAGE_HEIGHT // 4,
                max(IMAGE_HEIGHT - bh, IMAGE_HEIGHT // 4 + 1),
            )
            box = (
                x1, y1,
                min(x1 + bw, IMAGE_WIDTH - 1), min(y1 + bh, IMAGE_HEIGHT - 1),
            )
            boxes_px.append(box)
            classes.append(cls)
            rng.rand()  # occluded attribute
            rng.rand()  # truncated attribute
        frames[idx] = _render_scene(rng, boxes_px, classes)
        rng.randint(5)  # weather attribute
        rng.randint(3)  # time-of-day attribute
        # the parser's float path: float(px) / size in float64, clamped
        norm = np.asarray(
            [
                [
                    min(max(float(b[0]) / IMAGE_WIDTH, 0.0), 1.0),
                    min(max(float(b[1]) / IMAGE_HEIGHT, 0.0), 1.0),
                    min(max(float(b[2]) / IMAGE_WIDTH, 0.0), 1.0),
                    min(max(float(b[3]) / IMAGE_HEIGHT, 0.0), 1.0),
                ]
                for b in boxes_px
            ],
            np.float32,
        ).reshape(-1, 4)
        all_boxes.append(norm)
        all_labels.append(np.asarray(classes, np.int32))
    return frames, all_boxes, all_labels


FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "synth_val_seed1"


def ensure_synthetic_dataset(
    out_dir: str | Path,
    num_images: int = 32,
    seed: int = 0,
    max_objects: int = 12,
    split: str = "train",
) -> Path:
    """The labels path of a complete synthetic split in `out_dir`:
    `labels/<split>.json` with at least `num_images` records, and the JPEG
    of each of the first `num_images` under `images/<split>/`. Unlike the
    reference it never writes: a short directory raises. The files are
    taken to be what the reference generated for `seed` and `max_objects`;
    their first N records are the N-record set, as generation is
    sequential from the seed."""
    del seed, max_objects  # they made the files; nothing here redraws them
    out_dir = Path(out_dir)
    labels_path = out_dir / "labels" / f"{split}.json"
    try:
        records = json.loads(labels_path.read_text())
    except (OSError, ValueError) as e:
        records, why = [], f"{labels_path} cannot be read ({e})"
    else:
        why = f"{labels_path} holds {len(records)} records"
    missing = [r["name"] for r in records[:num_images]
               if not (out_dir / "images" / split / r["name"]).is_file()]
    if len(records) < num_images or missing:
        if missing:
            why = f"{len(missing)} JPEGs are missing, {missing[0]} first"
        raise FileNotFoundError(
            f"no complete synthetic {split!r} split of {num_images} images in "
            f"{out_dir}: {why}. The port reads the directory that the "
            "reference's generate_synthetic_dataset writes and writes none "
            f"itself; the committed {FIXTURE_DIR} holds the 64 seed-1 "
            "'val' scenes")
    return labels_path
