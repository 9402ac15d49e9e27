"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` (with the shared `csrc/*.cuh` headers it includes)
is compiled by nvcc into its own shared library with a plain C interface
and loaded with ctypes: no PyTorch headers, no
`torch.utils.cpp_extension`, no ninja — a build takes seconds. Libraries
land in `bdd100k_tpu_torch/_build/`, keyed by a hash of the sources and
the flags, at first use (or all at once, in parallel, through `build_all`).
Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# per-source extra flags; the NMS and matcher IoUs must round exactly like
# the f32 reference, so their builds also forbid FMA contraction; ptxas
# reports every kernel's registers, shared memory and spills
_EXTRA_FLAGS = {"nms": ["-fmad=false", "-Xptxas", "-v"],
                "matcher": ["-fmad=false", "-Xptxas", "-v"],
                "depthwise": ["-Xptxas", "-v"]}

# name → (C entry points and their argument types)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "nms": {"greedy_suppress": [_P, _P, _P, _I, _I, _F, _P]},
    "depthwise": {  # pointers, (B, H, W, C), the plan, the stream
        "dw3x3_s1_f32": [_P, _P, _P] + [_I] * 11 + [_P],
        "dw3x3_s1_bf16": [_P, _P, _P] + [_I] * 11 + [_P],
        "dw3x3_s1_fgrad_f32": [_P, _P, _P] + [_I] * 11 + [_P],
        "dw3x3_s1_fgrad_bf16": [_P, _P, _P] + [_I] * 11 + [_P],
        "dw3x3_s1_fgrad_sum": [_P, _P, _I, _I, _P],
    },
    "matcher": {  # pointers, (B, M, A), the plan, threshold and variances
        "encode_targets": [_P] * 8 + [_I] * 3 + [_I] * 4 + [_F] * 3 + [_P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
# name → what nvcc printed on the build this process made (ptxas -v)
BUILD_LOGS: dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "bdd100k_tpu_torch are built from source at first use"
    )


def _command(name: str, out: Path) -> list[str]:
    flags = _BASE_FLAGS + _EXTRA_FLAGS.get(name, [])
    return [_nvcc(), *_ARCH, *flags, "-o", str(out), str(CSRC / f"{name}.cu")]


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers it may
    include (`csrc/*.cuh`) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(
        src + " ".join(_ARCH + _BASE_FLAGS + _EXTRA_FLAGS.get(name, [])).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = _command(name, tmp)  # finds nvcc before anything is written
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            + stderr.decode(errors="replace")
            + stdout.decode(errors="replace")
        )
    os.replace(tmp, out)
    BUILD_LOGS[name] = stderr.decode(errors="replace") + stdout.decode(errors="replace")


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all() -> dict[str, Path]:
    """Compile every kernel source at once (one nvcc each, all started
    together), load them, and return name → library path."""
    with _lock:
        jobs = {n: _start_build(n) for n in SIGNATURES if n not in _libs}
        for n, job in jobs.items():
            _finish_build(n, job)
        for n in jobs:
            _libs[n] = _load(n)
    return {n: library_path(n) for n in SIGNATURES}


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                _finish_build(name, _start_build(name))
                _libs[name] = _load(name)
            lib = _libs[name]
    return lib


# codes of the C entry points beside cudaError_t (csrc/depthwise.cu)
_OWN_ERRORS = {-1: "the TMA tensor map could not be encoded",
               -2: "the kernel refused its launch plan"}


def check(err: int, what: str) -> None:
    """Raise on a non-zero code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: {_OWN_ERRORS.get(err, f'CUDA error {err}')} "
                           "at launch")
