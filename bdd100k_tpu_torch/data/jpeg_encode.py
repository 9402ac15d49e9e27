"""Baseline JPEG encoding with the bytes PIL writes (the card's machine has
no PIL).

`encode_jpeg(rgb, quality)` gives what `Image.fromarray(rgb).save(f,
format="JPEG", quality=quality)` gives with PIL's libjpeg-turbo: 4:2:0
chroma, the Annex K tables scaled to `quality`, the standard Huffman
tables, a JFIF 1.01 header. PIL's default quality is 75. The encoder is
C++ (`csrc/jpeg/jencode.cc`, in the decode pool's library, built at first
use) and releases the GIL while it runs. The reference writes its
synthetic splits at quality 90 (`data/synthetic.py`) and the serving CLI's
drawn `.jpg` outputs at 75 (`infer.py`).
"""

from __future__ import annotations

import numpy as np

from bdd100k_tpu_torch.utils.host_build import decode_pool_library

DEFAULT_QUALITY = 75  # PIL's, when save() is given none


def encode_jpeg(rgb_u8: np.ndarray, quality: int = DEFAULT_QUALITY) -> bytes:
    """(H, W, 3) uint8 RGB → the JPEG file's bytes. `quality` is clamped to
    1..100, as libjpeg's jpeg_quality_scaling clamps it."""
    rgb = np.ascontiguousarray(rgb_u8)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(
            f"encode_jpeg takes (H, W, 3) uint8 RGB, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"a JPEG holds 1..65535 rows and columns, not {h}×{w}")
    lib = decode_pool_library()
    cap = h * w + 4096  # most frames fit; a larger one is encoded again
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.je_encode_rgb(rgb.ctypes.data, h, w, int(quality),
                              out.ctypes.data, cap)
        if n < 0:
            raise ValueError(f"the encoder refused a {h}×{w} frame")
        if n <= cap:
            return out[:n].tobytes()
        cap = n
