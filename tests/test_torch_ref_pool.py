"""The port's tests reach the reference's native decode pool through
`tests/torch_ref_pool.py`, whichever pytest-xdist worker built it.

The fault it repairs: the reference builds its pool straight onto
`native/build/libdecode_pool.so`, and every worker that imports
tests/test_native_decode.py asks for it at once; a worker that loses that
race keeps the failure (`_lib_err`) for every file it runs later, and the
port's tests that compare against the pool failed on it
(`test_torch_train_files.py::test_train_loader_matches_reference_loader
[512-*]`, "native_decode requested but pool unavailable"). Here the lost
race is simulated, as the module's globals stand after it, and the helper
must still hand back a pool that decodes as the port's does; and builds
started at once must all end with one loadable library.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "tests") not in sys.path:
    sys.path.insert(0, str(ROOT / "tests"))

from torch_ref_pool import ref_pool  # noqa: E402
from bdd100k_tpu_torch.data.native_decode import NativeDecoder  # noqa: E402

JPEG = ROOT / "tests" / "fixtures" / "synth_val_seed1" / "images" / "val" / \
    "synthetic_val_00000.jpg"


def test_a_lost_build_race_still_gives_the_reference_pool(monkeypatch):
    from bdd100k_tpu.data import native_decode as ref_nd

    monkeypatch.setattr(ref_nd, "_SO", ref_nd._SO)  # restored after the test
    monkeypatch.setattr(ref_nd, "_lib", None)
    monkeypatch.setattr(ref_nd, "_lib_err", "simulated lost build race")
    assert not ref_nd.available()
    nd = ref_pool()
    assert nd is ref_nd and nd.available()
    assert nd._SO.parent == ROOT / "bdd100k_tpu_torch" / "_build"
    jpeg = JPEG.read_bytes()
    ref, port = nd.NativeDecoder(2), NativeDecoder(2)
    try:
        for size in (300, 512):
            np.testing.assert_array_equal(ref.decode_batch([jpeg], size),
                                          port.decode_batch([jpeg], size))
            for a, b in zip(ref.decode_batch_yuv420([jpeg], size),
                            port.decode_batch_yuv420([jpeg], size)):
                np.testing.assert_array_equal(a, b)
    finally:
        port.close()


def test_builds_started_at_once_end_with_one_library(tmp_path):
    """Four processes build a fresh copy of the source into one directory
    at once: all get the same path, it loads, and no temporary is left."""
    src = tmp_path / "decode_pool.cc"
    src.write_bytes((ROOT / "native" / "decode_pool.cc").read_bytes())
    out = tmp_path / "build"
    code = ("import sys; from pathlib import Path; import torch_ref_pool as p; "
            "so, err = p.build_private(Path(sys.argv[1]), Path(sys.argv[2])); "
            "print(so)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src), str(out)],
                              cwd=ROOT / "tests", text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(4)]
    paths = set()
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr
        paths.add(stdout.strip())
    assert len(paths) == 1
    so = Path(paths.pop())
    ctypes.CDLL(str(so)).dp_create  # noqa: B018 — the symbol resolves
    assert sorted(f.name for f in out.iterdir()) == sorted(
        [so.name, "ref_decode_pool.lock"])
