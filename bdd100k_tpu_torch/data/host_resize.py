"""Resizes of uint8 frames on the host (the card's machine has neither
cv2 nor PIL): `resize_linear`, in numpy, the bytes of `cv2.resize(frame,
(w, h), interpolation=cv2.INTER_LINEAR)`, and `resize_bicubic`, in C,
those of PIL's `Image.resize((w, h))` (below).

The reference's `Predictor` resizes a frame on the host with cv2 when cv2
is present (bdd100k_tpu/infer.py:154-171); this module gives those bytes:

* source coordinates in float32, fx = f32((dx + 0.5)·scale − 0.5) with
  scale = 1 / (dst / src) in float64, clamped to the edge pixel with a
  zero fraction outside the image (horizontally; vertically the row index
  is clamped and the fraction kept);
* 11-bit fixed-point coefficients rint(f32(1 − fx)·2048) and
  rint(fx·2048); the horizontal pass sums exactly in int32;
* the vertical pass rounds as cv2's vector path does,
  ((b0·(S0 >> 4)) >> 16) + ((b1·(S1 >> 4)) >> 16), then (· + 2) >> 2
  saturated to uint8;
* an exact 2× downscale in both axes is cv2's INTER_AREA fast path
  instead: the 2×2 mean (a + b + c + d + 2) >> 2.

The reference's full-resolution dataset route resizes an image that is
not 720×1280 with PIL's default filter (bdd100k_tpu/data/pipeline.py:
146-156); `resize_bicubic` gives those bytes (libImaging/Resample.c).
"""

from __future__ import annotations

import numpy as np

from bdd100k_tpu_torch.utils.host_build import decode_pool_library

COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _taps(n_src: int, n_dst: int, clamp_fraction: bool):
    """→ (i0, i1, a0, a1): the two source indices and fixed-point
    coefficients of each destination index along one axis."""
    scale = 1.0 / (n_dst / n_src)
    fx = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    if clamp_fraction:  # cv2 horizontal: outside the image, the edge pixel
        low, high = sx < 0, sx >= n_src - 1
        fx = np.where(low | high, np.float32(0.0), fx)
        sx = np.where(low, 0, np.where(high, n_src - 1, sx))
    i0 = np.clip(sx, 0, n_src - 1)
    i1 = np.clip(sx + 1, 0, n_src - 1)
    a0 = np.rint((np.float32(1.0) - fx) * np.float32(COEF_SCALE)).astype(np.int32)
    a1 = np.rint(fx * np.float32(COEF_SCALE)).astype(np.int32)
    return i0, i1, a0, a1


def _area2x(frames: np.ndarray) -> np.ndarray:
    s = frames.astype(np.int32)
    total = (s[:, 0::2, 0::2] + s[:, 0::2, 1::2] + s[:, 1::2, 0::2]
             + s[:, 1::2, 1::2])
    return ((total + 2) >> 2).astype(np.uint8)


def resize_linear(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(N, H, W, C) uint8 → (N, height, width, C) uint8, the bytes of
    cv2.resize(INTER_LINEAR) on each frame."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4:
        raise ValueError(f"frames must be (N, H, W, C) uint8, got "
                         f"{frames.dtype} {frames.shape}")
    if height < 1 or width < 1:
        raise ValueError(f"bad target size {height}×{width}")
    _, h, w, _ = frames.shape
    if (h, w) == (height, width):
        return frames.copy()
    if (h, w) == (2 * height, 2 * width):
        return _area2x(frames)
    x0, x1, a0, a1 = _taps(w, width, clamp_fraction=True)
    y0, y1, b0, b1 = _taps(h, height, clamp_fraction=False)
    # horizontal pass, exact in int32, on the source rows the output reads
    rows = np.unique(np.concatenate([y0, y1]))
    src = frames[:, rows]
    mid = np.take(src, x0, axis=2).astype(np.int32)
    mid *= a0[:, None]
    mid += np.take(src, x1, axis=2).astype(np.int32) * a1[:, None]
    mid >>= 4
    # vertical pass with the vector path's rounding
    v = mid[:, np.searchsorted(rows, y0)]
    v *= b0[:, None, None]
    v >>= 16
    v1 = mid[:, np.searchsorted(rows, y1)]
    v1 *= b1[:, None, None]
    v1 >>= 16
    v += v1
    v += 2
    v >>= 2
    return np.clip(v, 0, 255).astype(np.uint8)


def resize_bicubic(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(N, H, W, C) uint8 → (N, height, width, C) uint8, the bytes of
    PIL's `Image.resize((width, height))` (BICUBIC, its default) on each
    frame, in C (`csrc/resample.cc`, Pillow's libImaging/Resample.c): the
    bicubic filter with a = −0.5, its support scaled by the downscale
    factor, weights in fixed point with 22 fractional bits, a horizontal
    pass into a uint8 temporary over the source rows the vertical pass
    reads, then the vertical pass; each rounds half up and clips to
    0..255."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4:
        raise ValueError(f"frames must be (N, H, W, C) uint8, got "
                         f"{frames.dtype} {frames.shape}")
    if height < 1 or width < 1:
        raise ValueError(f"bad target size {height}×{width}")
    n, h, w, c = frames.shape
    if (h, w) == (height, width):
        return frames.copy()
    frames = np.ascontiguousarray(frames)
    out = np.empty((n, height, width, c), np.uint8)
    if decode_pool_library().rs_resize_bicubic(
            frames.ctypes.data, n, h, w, c, height, width, out.ctypes.data):
        raise ValueError(f"cannot resize {frames.shape} to {height}×{width}")
    return out
