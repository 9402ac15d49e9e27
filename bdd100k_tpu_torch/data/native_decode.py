"""ctypes binding of the JPEG decode pool (counterpart of
bdd100k_tpu/data/native_decode.py).

`NativeDecoder(num_workers)` owns one pool of `num_workers` OS threads in
`native/decode_pool.cc`. A batch of JPEG byte strings decodes in one call
that releases the GIL: each image through libjpeg's DCT-domain downscale
(1/2, 1/4 or 1/8, the deepest that still oversamples the target) and the
pool's own fixed-point bilinear resize to a (size, size) square, as RGB, or
as planar YUV 4:2:0 (half the bytes on the way to the card). The pool is
built at first use (`utils/host_build.py`); a JPEG the decoder refuses
(progressive, arithmetic-coded, CMYK) fails the batch.
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

    def close(self) -> None:
        """Stop the pool's threads (waits for none: no call is running)."""
        if getattr(self, "_pool", None):
            self._lib.dp_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()
