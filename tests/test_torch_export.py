"""The port's serving artifact (`bdd100k_tpu_torch/export.py`) against the
in-process port model and the reference's `jax.export` artifact, on the
CPU.

The tiny SSD (`ssd_tiny_64`) is exported at B=2 in f32 from a .npz that
the reference writes from its own seed-0 init (fp16 params, as every
artifact holds them), so both packages bake in the same weights.

* The loaded artifact gives the in-process port model's detections bit
  for bit: the program replays the model's ops, and its weights keep
  their channels_last strides.
* It matches the reference's artifact (`bdd100k_tpu.export.main(...,
  "--nms", "fixpoint")` + `load`) on the same frames: scores and boxes
  within 1e-5, classes and valid equal.
* int8_static calibrated on `tests/fixtures/calib_mixed` equals the
  in-process quantized port model, and matches the reference's
  int8_static artifact within INT8_DET_TOL, the bound of
  tests/test_torch_quant_eval.py, detection by detection (`detections_agree`;
  measured: scores within 2.3e-8 slot by slot, one pair of slots swapped
  on a near-tie).
* The reference's refusals (an empty --ckpt_dir, int8_static without
  --calib_images), a `--platforms cuda,cpu` artifact running on the CPU,
  and `--platforms tpu` refused.
* `scripts/check_export_parity` prints PARITY OK on the tiny model.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import torch  # noqa: E402

from bdd100k_tpu_torch import export as port_export  # noqa: E402
from bdd100k_tpu_torch.configs import get_config  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.models.quant import calibrate_for_driver  # noqa: E402
from bdd100k_tpu_torch.ops import depthwise, nms  # noqa: E402
from bdd100k_tpu_torch.utils.weights import restore_eval_weights  # noqa: E402

# two torch threads: the suite runs these files beside JAX workers
torch.set_num_threads(2)

CONFIG = "ssd_tiny_64"
CALIB = ROOT / "tests" / "fixtures" / "calib_mixed"
B = 2
ATOL = 1e-5
INT8_DET_TOL = 0.02  # tests/test_torch_quant_eval.py's bound on int8 detections
FIELDS = ("boxes", "scores", "classes", "valid")


@pytest.fixture(scope="module")
def npz(tmp_path_factory) -> Path:
    """The reference's seed-0 tiny SSD as a .npz artifact (step 7)."""
    from bdd100k_tpu.configs import TrainConfig
    from bdd100k_tpu.configs.detector_configs import tiny_test_config
    from bdd100k_tpu.models.detector import build_detector as ref_build
    from bdd100k_tpu.parallel.train_step import create_train_state
    from bdd100k_tpu.utils.weights import save_detector_npz

    bundle = ref_build(tiny_test_config("ssd"))
    state = create_train_state(bundle, TrainConfig(), jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("export") / "tiny.npz"
    save_detector_npz(path, jax.device_get(state.params),
                      jax.device_get(state.batch_stats), config_name=CONFIG,
                      step=7)
    return path


@pytest.fixture(scope="module")
def frames() -> np.ndarray:
    return np.random.RandomState(0).randint(0, 255, (B, 64, 64, 3), np.uint8)


def _port_export(tmp_path: Path, npz: Path, *extra: str) -> Path:
    out = tmp_path / "tiny.pt2"
    port_export.main(["--config", CONFIG, "--ckpt_dir", str(npz), "--out",
                      str(out), "--batch_size", str(B), "--device", "cpu",
                      "--dtype", "float32", *extra])
    return out


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, npz) -> tuple[Path, str]:
    """The port's f32 artifact of `npz` for both platforms (traced on the
    CPU) and what the export printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _port_export(tmp_path_factory.mktemp("artifact"), npz,
                           "--platforms", "cuda,cpu")
    return out, buf.getvalue()


def _ref_artifact(tmp_path: Path, npz: Path, frames, *extra: str) -> dict:
    """The reference's artifact of the same weights, run on `frames`. Its
    CLI builds the detector in bf16; the comparison is in f32 on both
    sides, so its `build_detector` is given f32 for the call."""
    import functools

    import jax.numpy as jnp

    from bdd100k_tpu import export as ref_export
    from bdd100k_tpu.models import detector as ref_detector

    out = tmp_path / "tiny.jaxexp"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_detector, "build_detector", functools.partial(
            ref_detector.build_detector, dtype=jnp.float32))
        ref_export.main(["--config", CONFIG, "--ckpt_dir", str(npz), "--out",
                         str(out), "--batch_size", str(B), "--nms",
                         "fixpoint", *extra])
    det = ref_export.load(out)(frames)
    return {k: np.asarray(det[k]) for k in FIELDS}


def _live(npz: Path, frames, quant: str = "none") -> dict:
    """The in-process port model (f32) on `frames`."""
    import dataclasses

    cfg = dataclasses.replace(get_config(CONFIG), quant=quant)
    bundle = build_detector(cfg, dtype=torch.float32, device="cpu")
    restore_eval_weights(bundle.model, npz, expect_config=CONFIG)
    if quant == "int8_static":
        calibrate_for_driver(bundle, calib_images=CALIB)
    with torch.no_grad():
        det = port_export.build_serving_fn(bundle)(torch.from_numpy(frames))
    return {k: v.numpy() for k, v in det.items()}


def _numpy(det: dict) -> dict:
    return {k: v.numpy() for k, v in det.items()}


def test_artifact_equals_the_port_model_and_the_reference(tmp_path, npz, frames,
                                                          artifact):
    out, printed = artifact
    assert f"exported {CONFIG} step=7 batch={B} nms=auto quant=none " \
           f"platforms=['cuda', 'cpu'] -> {out}" in printed
    serve = port_export.load(out)
    launches = (nms.LAUNCHES["greedy_suppress"], depthwise.LAUNCHES["depthwise3x3_s1"])
    got = _numpy(serve(torch.from_numpy(frames)))
    # the CPU runs the plain versions: no kernel launch
    assert launches == (nms.LAUNCHES["greedy_suppress"],
                        depthwise.LAUNCHES["depthwise3x3_s1"])
    live = _live(npz, frames)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)
    ref = _ref_artifact(tmp_path, npz, frames)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=ATOL)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=ATOL)
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert got["valid"].any()


def test_graph_calls_the_kernel_ops(artifact):
    """The artifact's graph reaches the hand kernels through their ops:
    nine stride-1 depthwise layers and one suppression."""
    ep = torch.export.load(artifact[0])
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("bdd100k_tpu_torch.depthwise3x3_s1.default") == 9
    assert targets.count("bdd100k_tpu_torch.greedy_suppress.default") == 1


def test_int8_static_artifact(tmp_path, npz, frames):
    out = _port_export(tmp_path, npz, "--quant", "int8_static",
                       "--calib_images", str(CALIB))
    got = _numpy(port_export.load(out)(torch.from_numpy(frames)))
    live = _live(npz, frames, "int8_static")
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)
    ref = _ref_artifact(tmp_path, npz, frames, "--quant", "int8_static",
                        "--calib_images", str(CALIB))
    detections_agree(got, ref, INT8_DET_TOL)


def detections_agree(got: dict, want: dict, tol: float) -> None:
    """Per image, as tests/test_torch_quant_eval.py's `confident_agree`
    holds int8 detections, over every valid slot: as many valid
    detections on both sides, and each one's class has a detection on the
    other side with score and corners within `tol`. Slots may differ where
    two scores tie within an ulp (the tiny random model's scores crowd
    around 0.092: slots 188 and 189 of image 0 hold two detections
    1e-8 apart, in the other order)."""
    for i in range(len(got["valid"])):
        assert got["valid"][i].sum() == want["valid"][i].sum(), i
        for a, b in ((got, want), (want, got)):
            for j in np.flatnonzero(a["valid"][i]):
                m = ((b["classes"][i] == a["classes"][i, j]) & b["valid"][i]
                     & (np.abs(b["boxes"][i] - a["boxes"][i, j]).max(-1) <= tol)
                     & (np.abs(b["scores"][i] - a["scores"][i, j]) <= tol))
                assert m.any(), (i, j, a["classes"][i, j], a["scores"][i, j])


def test_refuses_an_empty_ckpt_dir(tmp_path):
    empty = tmp_path / "no_ckpts_here"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no checkpoint found under"):
        _port_export(tmp_path, empty)


def test_refuses_int8_static_without_calib_images(tmp_path, npz):
    with pytest.raises(SystemExit, match="needs --calib_images"):
        _port_export(tmp_path, npz, "--quant", "int8_static")


def test_two_platform_artifact_runs_on_the_cpu(artifact, npz, frames):
    serve = port_export.load(artifact[0], device="cpu")
    assert serve.meta["platforms"] == ["cuda", "cpu"]
    got = _numpy(serve(torch.from_numpy(frames)))
    live = _live(npz, frames)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)


@pytest.mark.parametrize("platforms", ["tpu", "cpu,tpu", "gpu"])
def test_refuses_other_platforms(tmp_path, npz, platforms):
    with pytest.raises(SystemExit, match="runs on cuda and cpu only"):
        _port_export(tmp_path, npz, "--platforms", platforms)


def test_load_refuses_a_device_it_was_not_exported_for(artifact):
    with pytest.raises(ValueError, match="was exported for"):
        port_export.load(artifact[0], device="meta")


def test_check_export_parity_prints_parity_ok(tmp_path, npz, capsys):
    from bdd100k_tpu_torch.scripts import check_export_parity

    res = check_export_parity.main([
        "--config", CONFIG, "--ckpt", str(npz), "--calib_images", str(CALIB),
        "--device", "cpu", "--dtype", "float32", "--out",
        str(tmp_path / "parity.pt2")])
    assert "PARITY OK: exported int8_static artifact == in-process model" \
        in capsys.readouterr().out
    assert res["max_abs_diff"] == dict(boxes=0.0, scores=0.0, classes=0.0,
                                       valid=0.0)
