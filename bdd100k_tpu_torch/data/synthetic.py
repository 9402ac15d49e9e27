"""Synthetic BDD100K-format dataset generator (mirror of
bdd100k_tpu/data/synthetic.py): driving-scene-shaped frames (sky gradient,
road trapezoid) with class-coloured rectangles as objects, JPEG-encoded,
and a labels JSON in the BDD100K release format.

The RandomState draws are the reference's, in its order, so for one seed
`generate_synthetic_dataset` writes the reference's directory byte for
byte: the JPEGs through the port's encoder (`data/jpeg_encode.py`, PIL's
bytes at quality 90) and the labels JSON. `generate_synthetic_scenes`
gives the same scenes in memory, the frames before the JPEG encode, for
tests that need the renders. The committed `tests/fixtures/synth_val_seed1`
holds the 64 seed-1 'val' scenes.
"""

from __future__ import annotations

import json
import os
import time
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


_WEATHERS = ["clear", "rainy", "snowy", "overcast", "foggy"]
_TIMES = ["daytime", "night", "dawn/dusk"]


def _scenes(num_images: int, seed: int, max_objects: int, split: str):
    """The reference generator's loop → for each scene (frame, pixel boxes,
    classes, labels record), from one RandomState in the reference's order
    of draws."""
    rng = np.random.RandomState(seed)
    for idx in range(num_images):
        n_obj = rng.randint(1, max_objects + 1)
        boxes_px, classes, labels_json = [], [], []
        for _ in range(n_obj):
            cls = int(rng.randint(1, len(BDD100K_CLASSES) + 1))
            name = BDD100K_CLASSES[cls - 1]
            (wmin, wmax), (hmin, hmax) = _SIZE_RANGES[name]
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
            labels_json.append({
                "category": name,
                "attributes": {
                    "occluded": bool(rng.rand() < 0.3),
                    "truncated": bool(rng.rand() < 0.1),
                },
                "box2d": {"x1": float(box[0]), "y1": float(box[1]),
                          "x2": float(box[2]), "y2": float(box[3])},
            })
        img = _render_scene(rng, boxes_px, classes)
        record = {
            "name": f"synthetic_{split}_{idx:05d}.jpg",
            "attributes": {
                "weather": _WEATHERS[rng.randint(len(_WEATHERS))],
                "scene": "city street",
                "timeofday": _TIMES[rng.randint(len(_TIMES))],
            },
            "labels": labels_json,
        }
        yield img, boxes_px, classes, record


def generate_synthetic_scenes(
    num_images: int = 32, seed: int = 0, max_objects: int = 12
) -> tuple[np.ndarray, list[np.ndarray], list[np.ndarray]]:
    """→ (frames (N, 720, 1280, 3) uint8, boxes [(n_i, 4) f32 normalized
    corner], labels [(n_i,) int32 in 1..10]): the scenes of
    `generate_synthetic_dataset` before the JPEG encode. The boxes are
    normalized and clamped as the reference's label parser does; none is
    degenerate at these sizes, so none is dropped."""
    frames = np.empty((num_images, IMAGE_HEIGHT, IMAGE_WIDTH, 3), np.uint8)
    all_boxes, all_labels = [], []
    for idx, (img, boxes_px, classes, _) in enumerate(
            _scenes(num_images, seed, max_objects, "train")):
        frames[idx] = img
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


WAIT_SECONDS = 600.0  # how long a lock loser waits for the generator


def _write_atomic(path: Path, data: bytes) -> None:
    """Write under a temporary name and rename: a reader, or a second
    generator writing the same bytes, never sees a partial file."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def generate_synthetic_dataset(
    out_dir: str | Path,
    num_images: int = 32,
    seed: int = 0,
    max_objects: int = 12,
    split: str = "train",
) -> Path:
    """Write images/<split>/*.jpg (quality 90) and then
    labels/<split>.json (BDD100K layout), the reference's bytes → the
    labels JSON path."""
    from bdd100k_tpu_torch.data.jpeg_encode import encode_jpeg

    out_dir = Path(out_dir)
    img_dir = out_dir / "images" / split
    img_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "labels").mkdir(parents=True, exist_ok=True)
    records = []
    for img, _, _, record in _scenes(num_images, seed, max_objects, split):
        _write_atomic(img_dir / record["name"], encode_jpeg(img, quality=90))
        records.append(record)
    labels_path = out_dir / "labels" / f"{split}.json"
    _write_atomic(labels_path, json.dumps(records).encode())
    return labels_path


def ensure_synthetic_dataset(
    out_dir: str | Path,
    num_images: int = 32,
    seed: int = 0,
    max_objects: int = 12,
    split: str = "train",
) -> Path:
    """Generate only when the labels file is missing or holds fewer than
    `num_images` records → its path. Generation is sequential from the
    seed, so a larger existing set's first N records are the N-record set.

    Under a process group (`parallel/mesh.py`), rank 0 generates first and
    the others wait at a barrier; a rank that still finds no complete split
    (its directory is not rank 0's, as on another machine's /tmp) claims a
    local O_EXCL lock and generates its own copy, and the lock's losers
    poll for the labels JSON, which generation writes last, for up to
    WAIT_SECONDS."""
    from bdd100k_tpu_torch.parallel import mesh

    out_dir = Path(out_dir)
    labels_path = out_dir / "labels" / f"{split}.json"

    def complete() -> bool:
        try:
            return len(json.loads(labels_path.read_text())) >= num_images
        except (ValueError, OSError):
            return False

    def ensure() -> Path:
        if complete():
            return labels_path
        return generate_synthetic_dataset(
            out_dir, num_images=num_images, seed=seed,
            max_objects=max_objects, split=split)

    def ensure_claimed() -> None:
        out_dir.mkdir(parents=True, exist_ok=True)
        lock = out_dir / f".gen_lock_{split}"
        try:
            os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            deadline = time.monotonic() + WAIT_SECONDS
            while not complete():
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"waited {WAIT_SECONDS:.0f}s for {labels_path}: a "
                        f"previous generator may have crashed; remove the "
                        f"stale {lock} and retry") from None
                time.sleep(0.5)
            return
        try:
            ensure()
        finally:
            lock.unlink(missing_ok=True)

    if mesh.data_size() > 1:
        if mesh.data_rank() == 0:
            ensure()
        mesh.barrier()
        if not complete():
            ensure_claimed()
        return labels_path
    return ensure()
