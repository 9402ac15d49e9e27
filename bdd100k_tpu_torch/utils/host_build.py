"""Build and load the host library: the JPEG decode pool and Pillow's
bicubic resample.

The pool is the reference's own C++ source, `native/decode_pool.cc`, shared
by both packages and compiled here unchanged. It is linked against the
port's JPEG decoder `csrc/jpeg/jdecode.cc` (libjpeg's API subset, giving
libjpeg-turbo's pixels bit for bit) rather than a system libjpeg, on every
machine: the card's machine has no libjpeg, and one decoder everywhere
keeps the pixels the same wherever the port runs. The same library holds
`csrc/jpeg/jfull.cc`, the full-resolution decode of one JPEG,
`csrc/resample.cc`, PIL's default `Image.resize` (floating point without
fused multiply-adds, as Pillow's own build computes its weights), and
`csrc/png.cc`, the PNG decoder's scanline unfiltering, and
`csrc/jpeg/jencode.cc`, the baseline JPEG encoder (libjpeg-turbo's bytes).

One g++ call builds the sources into `bdd100k_tpu_torch/_build/`, keyed by
a hash of the sources, the header and the flags, at first use. A failed
build raises with the compiler's output; there is no other decoder to
fall back to. Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from bdd100k_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC

ROOT = CSRC.parent.parent
SOURCES = (ROOT / "native" / "decode_pool.cc", CSRC / "jpeg" / "jdecode.cc",
           CSRC / "jpeg" / "jfull.cc", CSRC / "resample.cc", CSRC / "png.cc",
           CSRC / "jpeg" / "jencode.cc")
HEADERS = (CSRC / "jpeg" / "jpeglib.h",)
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-ffp-contract=off",
         "-I", str(CSRC / "jpeg")]

# the C entry points of decode_pool.cc and their argument types
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "dp_create": ([_I], ctypes.c_void_p),
    "dp_destroy": ([_P], None),
    # pool, n, jpeg pointers, lengths (long), size, out
    "dp_decode_batch": ([_P, _I, _P, _P, _I, _P], ctypes.c_int),
    # pool, n, jpeg pointers, lengths (long), size, out_y, out_uv
    "dp_decode_batch_yuv420": ([_P, _I, _P, _P, _I, _P, _P], ctypes.c_int),
    # pool, n, frames, h, w, size, out_y, out_uv
    "dp_resize_yuv420_batch": ([_P, _I, _P, _I, _I, _I, _P, _P], ctypes.c_int),
    # jpeg, len (long), &h, &w (jfull.cc)
    "jd_image_size": ([ctypes.c_char_p, ctypes.c_long, _P, _P], ctypes.c_int),
    # jpeg, len (long), scale denominator, h, w, out
    "jd_decode_rgb": ([ctypes.c_char_p, ctypes.c_long, _I, _I, _I, _P],
                      ctypes.c_int),
    # src, n, h, w, c, out_h, out_w, out (resample.cc)
    "rs_resize_bicubic": ([_P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    # filtered rows, rows, stride, bytes a pixel, out (png.cc)
    "png_unfilter": ([ctypes.c_char_p, _I, _I, _I, _P], ctypes.c_int),
    # rgb, h, w, quality, out, capacity (long) (jencode.cc)
    "je_encode_rgb": ([_P, _I, _I, _I, _P, ctypes.c_long], ctypes.c_long),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    blob = b"".join(p.read_bytes() for p in SOURCES + HEADERS)
    # the include path is where the sources live, not part of the key
    flags = " ".join(f for f in FLAGS if f != str(CSRC / "jpeg"))
    key = hashlib.sha256(blob + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdecode_pool-{key}.so"


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the JPEG decode pool of bdd100k_tpu_torch "
            "is built from native/decode_pool.cc at first use")
    return cxx


def build() -> Path:
    """Compile the pool if its library for these sources is missing → its
    path. Concurrent builds each write a temporary file and rename it."""
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *FLAGS, *map(str, SOURCES), "-o", str(tmp)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build the decode pool (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def decode_pool_library() -> ctypes.CDLL:
    """The loaded pool, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (argtypes, restype) in SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _lib = lib
    return _lib
