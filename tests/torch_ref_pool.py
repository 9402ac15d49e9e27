"""The reference's native JPEG decode pool, loaded whichever test worker
built it (a helper of the port's tests, not collected as tests).

`bdd100k_tpu/data/native_decode.py` builds `native/build/libdecode_pool.so`
at first use, straight onto that shared path, with no temporary file and
no lock, and keeps its first failure for the rest of the process. Under
pytest-xdist every worker imports every test file, and
tests/test_native_decode.py asks for the pool at import, so on a fresh
checkout several workers run that build at once; a worker that loses the
race (a half-written library, a compiler that finds its output replaced)
cannot use the pool in any file it runs later.

`ref_pool()` returns the reference's module with a library loaded: as it
is when it already loaded one; otherwise built with the reference's own
command into a temporary file under an exclusive lock, renamed into a path
of this checkout's git-ignored `bdd100k_tpu_torch/_build/` keyed by the
source's sha256, and loaded from there, the module's globals pointed at it
as `monkeypatch` would. Nothing of the reference is edited. A build or
load that still fails fails the test with the compiler's stderr.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "bdd100k_tpu_torch" / "_build"


def build_private(src: Path, build_dir: Path = BUILD) -> tuple[Path, str]:
    """`src` built as the reference's `_build` builds it (its flags), into
    `build_dir/ref_decode_pool-<sha256>.so` → (that path, the compiler's
    stderr, empty when the library was already there or built cleanly).
    Builds that run at once wait on one lock; the first writes a temporary
    file and renames it into place, the others find the library."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = build_dir / f"ref_decode_pool-{digest}.so"
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "ref_decode_pool.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so, ""
        fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so.tmp")
        os.close(fd)
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-shared",
             "-std=c++17", "-pthread", str(src), "-o", tmp, "-ljpeg"],
            capture_output=True, text=True)
        if proc.returncode:
            os.unlink(tmp)
            return so, proc.stderr
        os.replace(tmp, so)
    return so, proc.stderr


def ref_pool():
    """The reference's `native_decode` module with its library loaded."""
    from bdd100k_tpu.data import native_decode as ref_nd

    if ref_nd.available():
        return ref_nd
    lost = ref_nd._lib_err
    so, stderr = build_private(ref_nd._SRC)
    with ref_nd._lock:
        ref_nd._SO, ref_nd._lib, ref_nd._lib_err = so, None, None
    if not ref_nd.available():
        pytest.fail(f"the reference's decode pool did not load ({lost}); "
                    f"a private build at {so} failed too: {ref_nd._lib_err}\n"
                    f"{stderr}")
    return ref_nd
