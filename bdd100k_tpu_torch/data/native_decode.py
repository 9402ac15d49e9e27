"""ctypes binding of the JPEG decode pool (counterpart of
bdd100k_tpu/data/native_decode.py).

`NativeDecoder(num_workers)` owns one pool of `num_workers` OS threads in
`native/decode_pool.cc`. A batch of JPEG byte strings decodes in one call
that releases the GIL: each image through libjpeg's DCT-domain downscale
(1/2, 1/4 or 1/8, the deepest that still oversamples the target) and the
pool's own fixed-point bilinear resize to a (size, size) square, as RGB, or
as planar YUV 4:2:0 (half the bytes on the way to the card); a batch of
decoded RGB frames resizes and converts to those planes in one call too
(`resize_yuv420_batch`, the serving path's host resize). `decode_full`
decodes one JPEG at full resolution, with no resize, in the calling thread.
The library is built at first use (`utils/host_build.py`); a JPEG the
decoder refuses (arithmetic-coded, 12-bit, CMYK) fails its call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from bdd100k_tpu_torch.utils.host_build import decode_pool_library


class NativeDecoder:
    """Thread-pool JPEG decoder: bytes → (N, size, size, 3) uint8 RGB, or
    (Y (N, S, S), CbCr (N, S/2, S/2, 2)) uint8 planes."""

    def __init__(self, num_workers: int = 8):
        if num_workers < 1:
            raise ValueError(f"num_workers must be ≥ 1, got {num_workers}")
        self._lib = decode_pool_library()
        self._pool = self._lib.dp_create(num_workers)

    @staticmethod
    def _pointers(jpegs: list[bytes]):
        if not jpegs or not all(isinstance(j, bytes) and j for j in jpegs):
            raise ValueError("decode takes a non-empty list of non-empty bytes")
        # the array points into the bytes objects, which the caller's list
        # keeps alive for the call
        bufs = (ctypes.c_char_p * len(jpegs))(*jpegs)
        lens = np.asarray([len(j) for j in jpegs], np.int64)
        return bufs, lens

    @staticmethod
    def _check_size(size: int) -> None:
        if size < 1:
            raise ValueError(f"decode size must be ≥ 1, got {size}")

    def _check(self, nfail: int, n: int) -> None:
        if nfail:
            raise ValueError(f"{nfail}/{n} JPEGs failed to decode")

    def decode_batch(self, jpegs: list[bytes], size: int) -> np.ndarray:
        if self._pool is None:
            raise RuntimeError("the decoder is closed")
        self._check_size(size)
        bufs, lens = self._pointers(jpegs)
        out = np.empty((len(jpegs), size, size, 3), np.uint8)
        nfail = self._lib.dp_decode_batch(
            self._pool, len(jpegs), bufs, lens.ctypes.data, size,
            out.ctypes.data)
        self._check(nfail, len(jpegs))
        return out

    def decode_batch_yuv420(
        self, jpegs: list[bytes], size: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """JPEG chroma is 4:2:0 at the source, so the planes lose nothing
        against RGB; the card rebuilds RGB in the preprocess
        (`augment.yuv420_to_rgb_batch`). `size` must be even."""
        if self._pool is None:
            raise RuntimeError("the decoder is closed")
        if size % 2:
            raise ValueError(f"yuv420 needs an even decode size, got {size}")
        self._check_size(size)
        bufs, lens = self._pointers(jpegs)
        n = len(jpegs)
        out_y = np.empty((n, size, size), np.uint8)
        out_uv = np.empty((n, size // 2, size // 2, 2), np.uint8)
        nfail = self._lib.dp_decode_batch_yuv420(
            self._pool, n, bufs, lens.ctypes.data, size,
            out_y.ctypes.data, out_uv.ctypes.data)
        self._check(nfail, n)
        return out_y, out_uv

    def resize_yuv420_batch(
        self, frames: np.ndarray, size: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Decoded RGB (N, H, W, 3) uint8 → (y (N, S, S), uv (N, S/2, S/2,
        2)) planes: the pool's bilinear resize and BT.601 conversion, one
        frame a worker, in one call. `size` must be even."""
        if self._pool is None:
            raise RuntimeError("the decoder is closed")
        if size % 2:
            raise ValueError(f"yuv420 needs an even size, got {size}")
        self._check_size(size)
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim != 4 or frames.shape[-1] != 3 or not len(frames):
            raise ValueError(f"frames must be (N>0, H, W, 3), got {frames.shape}")
        n, h, w = frames.shape[:3]
        out_y = np.empty((n, size, size), np.uint8)
        out_uv = np.empty((n, size // 2, size // 2, 2), np.uint8)
        self._lib.dp_resize_yuv420_batch(
            self._pool, n, frames.ctypes.data, h, w, size,
            out_y.ctypes.data, out_uv.ctypes.data)
        return out_y, out_uv

    def close(self) -> None:
        """Stop the pool's threads (waits for none: no call is running)."""
        if getattr(self, "_pool", None):
            self._lib.dp_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()


def decode_full(jpeg: bytes) -> np.ndarray:
    """One JPEG → (H, W, 3) uint8 RGB at full resolution: scale 1/1, fancy
    upsampling, no resize (`csrc/jpeg/jfull.cc`), the pixels of PIL's
    `Image.open(path).convert("RGB")`. Releases the GIL while it decodes,
    so a thread pool of these runs in parallel."""
    if not isinstance(jpeg, bytes) or not jpeg:
        raise ValueError("decode_full takes non-empty bytes")
    lib = decode_pool_library()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jd_image_size(jpeg, len(jpeg), ctypes.byref(h), ctypes.byref(w)):
        raise ValueError("the JPEG's header could not be read")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jd_decode_rgb(jpeg, len(jpeg), h.value, w.value, out.ctypes.data):
        raise ValueError("the JPEG failed to decode")
    return out
