"""Detection drawing in numpy, and a PNG writer on zlib (counterpart of
bdd100k_tpu/utils/viz.py, which draws with cv2 or PIL; the card's machine
has neither).

Box outlines are the pixels `cv2.rectangle(img, p1, p2, color,
thickness=2)` draws: a 3-pixel band on each edge, the horizontal bands
spanning x1..x2 and the vertical ones y1..y2, so each outer corner pixel
is left out. Labels ("class score") come from a small built-in 3×5 bitmap
font drawn at twice its size above the box; they are not cv2's glyphs.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from bdd100k_tpu_torch.configs.detector_configs import BDD100K_CLASSES

# one colour per class id (1..10), the reference's
_COLORS = [
    (66, 135, 245), (245, 130, 48), (60, 180, 75), (255, 225, 25),
    (230, 25, 75), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (0, 128, 128),
]

# 3×5 glyphs, rows top to bottom; letters are drawn case-insensitively and
# a character without a glyph is a blank cell
_GLYPHS = {
    "0": "### #.# #.# #.# ###", "1": ".#. ##. .#. .#. ###",
    "2": "### ..# ### #.. ###", "3": "### ..# .## ..# ###",
    "4": "#.# #.# ### ..# ..#", "5": "### #.. ### ..# ###",
    "6": "### #.. ### #.# ###", "7": "### ..# ..# .#. .#.",
    "8": "### #.# ### #.# ###", "9": "### #.# ### ..# ###",
    ".": "... ... ... ... .#.",
    "a": ".#. #.# ### #.# #.#", "b": "##. #.# ##. #.# ##.",
    "c": ".## #.. #.. #.. .##", "d": "##. #.# #.# #.# ##.",
    "e": "### #.. ##. #.. ###", "f": "### #.. ##. #.. #..",
    "g": ".## #.. #.# #.# .##", "h": "#.# #.# ### #.# #.#",
    "i": "### .#. .#. .#. ###", "j": "..# ..# ..# #.# .#.",
    "k": "#.# #.# ##. #.# #.#", "l": "#.. #.. #.. #.. ###",
    "m": "#.# ### ### #.# #.#", "n": "##. #.# #.# #.# #.#",
    "o": ".#. #.# #.# #.# .#.", "p": "##. #.# ##. #.. #..",
    "q": ".#. #.# #.# ##. .##", "r": "##. #.# ##. #.# #.#",
    "s": ".## #.. .#. ..# ##.", "t": "### .#. .#. .#. .#.",
    "u": "#.# #.# #.# #.# ###", "v": "#.# #.# #.# #.# .#.",
    "w": "#.# #.# ### ### #.#", "x": "#.# #.# .#. #.# #.#",
    "y": "#.# #.# .#. .#. .#.", "z": "### ..# .#. #.. ###",
}
_FONT_SCALE = 2


def _glyph(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch.lower(), "... ... ... ... ...").split()
    return np.array([[c == "#" for c in r] for r in rows], bool)


def text_mask(text: str) -> np.ndarray:
    """The label's pixels: (5·s, 4·s·len − s) bool at scale s, one blank
    column between cells."""
    cells = [np.pad(_glyph(ch), ((0, 0), (0, 1))) for ch in text]
    m = np.concatenate(cells, axis=1)[:, :-1] if cells else np.zeros((5, 0), bool)
    return np.kron(m, np.ones((_FONT_SCALE, _FONT_SCALE), bool))


def _paint(img: np.ndarray, mask: np.ndarray, top: int, left: int, color) -> None:
    """Set `img` to `color` where `mask`, placed at (top, left), clipped to
    the image."""
    h, w = img.shape[:2]
    mh, mw = mask.shape
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + mh, h), min(left + mw, w)
    if y0 >= y1 or x0 >= x1:
        return
    sub = mask[y0 - top:y1 - top, x0 - left:x1 - left]
    img[y0:y1, x0:x1][sub] = color


def rectangle_mask(shape: tuple[int, int], x1: int, y1: int, x2: int,
                   y2: int) -> np.ndarray:
    """(H, W) bool: the pixels of cv2.rectangle((x1, y1), (x2, y2),
    thickness=2), clipped to the image."""
    h, w = shape
    x1, x2 = sorted((x1, x2))
    y1, y2 = sorted((y1, y2))
    m = np.zeros((h, w), bool)

    def band(r0, r1, c0, c1):
        r0, r1, c0, c1 = max(r0, 0), min(r1, h - 1), max(c0, 0), min(c1, w - 1)
        if r0 <= r1 and c0 <= c1:
            m[r0:r1 + 1, c0:c1 + 1] = True

    for y in (y1, y2):
        band(y - 1, y + 1, x1, x2)
    for x in (x1, x2):
        band(y1, y2, x - 1, x + 1)
    return m


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray | None = None,
    class_names=BDD100K_CLASSES,
    score_threshold: float = 0.0,
) -> np.ndarray:
    """Draw normalized corner boxes and their labels on an HWC uint8
    image → a copy."""
    img = np.ascontiguousarray(np.array(image, copy=True))
    h, w = img.shape[:2]
    keep = np.asarray(scores) >= score_threshold
    if valid is not None:
        keep &= np.asarray(valid).astype(bool)
    for box, score, cls in zip(np.asarray(boxes)[keep],
                               np.asarray(scores)[keep],
                               np.asarray(classes)[keep]):
        x1, y1 = int(box[0] * w), int(box[1] * h)
        x2, y2 = int(box[2] * w), int(box[3] * h)
        color = _COLORS[(int(cls) - 1) % len(_COLORS)]
        img[rectangle_mask((h, w), x1, y1, x2, y2)] = color
        label = text_mask(f"{class_names[int(cls) - 1]} {score:.2f}")
        # the reference's text baseline: max(y1 − 4, 10)
        _paint(img, label, max(y1 - 4, 10) - label.shape[0], x1, color)
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB → PNG bytes: 8-bit truecolour, no interlace,
    every scanline with filter 0."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(image))
