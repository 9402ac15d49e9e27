"""The port's int8 evaluation of the committed artifacts against the
reference's, on the CPU.

The fixture `tests/fixtures/torch_ref_eval_int8.npz` holds the
reference's f32 eval (its own `run_eval`: the native decode at the
model's size, the rgb wire, batches of 32 (VGG512's of 8, to keep the
reference's f32 run small on the CPU: a static model's detections of an
image do not depend on the rest of its batch), an int8_static model
calibrated on the eval set's head, whose pixels the reference's dataset
decodes through cv2) of
* the synth9k SSD300 artifact in int8 and in int8_static over the 64
  seed-1 JPEGs,
* the synth9k VGG16-SSD512 artifact in int8_static and the synth9k
  YOLO-384 artifact in int8 over the first 8 (XLA's CPU int8 convolution
  takes minutes a batch of VGG512; the card's check runs the same 8),
each with its mAP@0.5, detections and (static) calibrated maxima. The
port's f32 eval on the CPU stays within MAP_TOL of the mAP (measured:
1.4e-6 for SSD300 int8, 1.8e-5 int8_static, 0 for YOLO-384), and its
confident detections (score ≥ 0.4) agree: the same number and classes an
image, scores and corners within INT8_DET_TOL.

That tolerance is what int8 leaves of float noise. The two frameworks'
f32 convs sum in different orders, so a few codes flip at the first
quantized layer (SSD300: 4 of 5.76 M at ds1's pointwise conv, on 8
images), and each flip moves the sums it enters by a whole quantization
step, which flips more codes downstream: 1685 of 2.96 M at ds3, 25 % at
ds13 (the same counts on the fixture's frozen maxima, which are the
dynamic ones wherever ReLU6 saturates them at 6). The confident
detections then move by up to 0.0175 (SSD300) and 0.0138 (YOLO-384),
while the mAP stays put. For the same reason calibration gives 15 of
SSD300's 19 maxima exactly (the ReLU6 ceiling) and the four extra-stage
maxima after the cascade within CALIB_RTOL. VGG512 runs its 8 images at
batch 8 on the fixture's maxima (a static model's detections of an image
do not depend on the rest of its batch); its own calibration runs in
`chip_smoke.py`, on the card. Regenerate the fixture with
`python tests/test_torch_quant_eval.py --make-fixture` (~12 min, most of
it XLA's CPU int8 convs of VGG512).
"""

from __future__ import annotations

import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bdd100k_tpu_torch.configs import get_config  # noqa: E402
from bdd100k_tpu_torch.data.pipeline import DetectionDataset  # noqa: E402
from bdd100k_tpu_torch.models import quant as port_quant  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.utils import weights as port_weights  # noqa: E402

# two torch threads: the suite runs these files beside JAX workers
torch.set_num_threads(2)

FIXTURES = ROOT / "tests" / "fixtures"
SYNTH = FIXTURES / "synth_val_seed1"
LABELS = SYNTH / "labels" / "val.json"
IMAGES = SYNTH / "images" / "val"
FIXTURE = FIXTURES / "torch_ref_eval_int8.npz"
ARTIFACTS = ROOT / "artifacts"
EVAL_BATCH = 32
MAP_TOL = 0.002
CONFIDENT = 0.4
INT8_DET_TOL = 0.02   # measured at most 0.0175: see the module docstring
CALIB_RTOL = 0.09     # measured at most 0.083 (extra3's down conv)
CALIB_EXACT = 15      # of SSD300's 19 maxima, the ReLU6-saturated ones
VGG_CPU_IMAGES = 8
# on VGG512's 8 images one low-score detection moves the mAP@0.5 by 0.010
# when the port's own input moves by 2 ulps (measured by the VGG test):
# the subset's float-noise spread, added to MAP_TOL for it
VGG_SUBSET_SPREAD = 0.010
# the flagship cases: (config, quant, images) → artifact
EVAL_CASES = {
    ("ssd_mobilenet_300", "int8", 64): "ssd_mobilenet_300_synth9k.npz",
    ("ssd_mobilenet_300", "int8_static", 64): "ssd_mobilenet_300_synth9k.npz",
    ("ssd_vgg16_512", "int8_static", 8): "ssd_vgg16_512_synth9k.npz",
    ("yolo_mobilenet_384", "int8", 8): "yolo_mobilenet_384_synth9k.npz",
}


def _key(case) -> str:
    config, quant, n = case
    return f"{config}_{quant}_{n}"


def fixture_quant_state(key: str) -> dict[str, torch.Tensor]:
    ref = np.load(FIXTURE)
    names = [s.decode() for s in ref[f"{key}/quant_names"]]
    return {k: torch.tensor(float(v)) for k, v in
            zip(names, ref[f"{key}/quant_values"])}


def _eval_args(batch_size=EVAL_BATCH, **kw):
    return types.SimpleNamespace(
        batch_size=batch_size, num_workers=4, wire="rgb", iou_threshold=0.5,
        coco_map=False, dump_detections=None, calib_images=None,
        calib_batches=8, **kw)


def port_eval(config: str, quant: str, n: int, device="cpu", quant_state=None,
              dtype=torch.float32, images: int | None = None,
              batch_size: int = EVAL_BATCH):
    """The port's `run_eval` of the case's artifact over the first
    `images` (default n) JPEGs → (result, detections as numpy, the model's
    quant state)."""
    images = n if images is None else images
    from bdd100k_tpu_torch import evaluate as port_evaluate

    cfg = dataclasses.replace(get_config(config), quant=quant)
    bundle = build_detector(cfg, dtype=dtype, device=device)
    port_weights.restore_eval_weights(
        bundle.model, ARTIFACTS / EVAL_CASES[config, quant, n],
        expect_config=config)
    ds = DetectionDataset.from_bdd100k(LABELS, IMAGES, decode_size=cfg.image_size)
    ds.records = ds.records[:images]
    dets = []
    real = port_evaluate.make_eval_step

    def recording_step(b):
        step = real(b)

        def run(images):
            det = step(images)
            dets.append([t.cpu().numpy() for t in det])
            return det
        return run

    port_evaluate.make_eval_step = recording_step
    try:
        result = port_evaluate.run_eval(bundle, ds, _eval_args(batch_size),
                                        quant_state=quant_state)
    finally:
        port_evaluate.make_eval_step = real
    arrays = [np.concatenate(a)[:images] for a in zip(*dets)]
    return result, arrays, port_quant.quant_state(bundle.model)


def confident_agree(got, want, n, tol=INT8_DET_TOL):
    """Per image, away from the threshold (within `tol` of it a detection
    may fall on either side): the detections with score ≥ CONFIDENT are as
    many and of the same classes on both sides, and each of the port's has
    one of the reference's of its class with score and corners within
    `tol`."""
    boxes, scores, classes, valid = got
    for i in range(n):
        g = np.flatnonzero(valid[i] & (scores[i] >= CONFIDENT + tol))
        w = np.flatnonzero(want["valid"][i] & (want["scores"][i] >= CONFIDENT + tol))
        g_all = np.flatnonzero(valid[i] & (scores[i] >= CONFIDENT - tol))
        w_all = np.flatnonzero(want["valid"][i] & (want["scores"][i] >= CONFIDENT - tol))
        assert len(g) <= len(w_all) and len(w) <= len(g_all), i
        for j in g:
            m = ((want["classes"][i] == classes[i, j]) & want["valid"][i]
                 & (np.abs(want["boxes"][i] - boxes[i, j]).max(-1) <= tol)
                 & (np.abs(want["scores"][i] - scores[i, j]) <= tol))
            assert m.any(), (i, j, classes[i, j], scores[i, j])
        for j in w:
            m = ((classes[i] == want["classes"][i, j]) & valid[i]
                 & (np.abs(boxes[i] - want["boxes"][i, j]).max(-1) <= tol)
                 & (np.abs(scores[i] - want["scores"][i, j]) <= tol))
            assert m.any(), (i, j, want["classes"][i, j], want["scores"][i, j])


CPU_CASES = [c for c in sorted(EVAL_CASES) if c[0] != "ssd_vgg16_512"]


@pytest.mark.parametrize("case", CPU_CASES, ids=_key)
def test_eval_on_the_cpu_matches_the_fixture(case):
    """f32 eval on the CPU: mAP@0.5 within MAP_TOL of the reference's, the
    confident detections in agreement, and the eval-set-head calibration
    within CALIB_RTOL of the reference's maxima."""
    config, quant, n = case
    ref = np.load(FIXTURE)
    key = _key(case)
    result, dets, state = port_eval(config, quant, n)
    assert result["num_images"] == n
    assert abs(result["mAP"] - float(ref[f"{key}/map50"])) <= MAP_TOL
    want = {k: ref[f"{key}/{k}"] for k in ("boxes", "scores", "classes", "valid")}
    confident_agree(dets, want, n)
    if quant == "int8_static":
        assert result["calib_images_used"] == 64
        assert result["calib_source"] == "eval-set head"
        want_state = fixture_quant_state(key)
        assert sorted(state) == sorted(want_state)
        assert sum(float(state[k]) == float(v)
                   for k, v in want_state.items()) >= CALIB_EXACT
        for k, v in want_state.items():
            np.testing.assert_allclose(float(state[k]), float(v),
                                       rtol=CALIB_RTOL, err_msg=k)


def test_vgg512_requant_pipeline_on_the_fixture_maxima(monkeypatch):
    """VGG16-SSD512 int8_static (codes from block2 to fc7) on the
    reference's maxima: the confident detections agree, and the mAP@0.5
    is within MAP_TOL + VGG_SUBSET_SPREAD of the reference's. The spread
    is measured here: the same eval with the preprocessed input scaled by
    1 + 2^-22 (2 ulps) moves the port's mAP by VGG_SUBSET_SPREAD, onto the
    reference's value; code flips cascade through the requant pipeline
    (tests/test_torch_quant_models.py), and on 8 images one detection near
    the IoU threshold is worth 0.010."""
    from bdd100k_tpu_torch.parallel import train_step

    case = ("ssd_vgg16_512", "int8_static", 8)
    key = _key(case)
    ref = np.load(FIXTURE)
    state = fixture_quant_state(key)
    result, dets, _ = port_eval(*case, quant_state=state, batch_size=VGG_CPU_IMAGES)
    assert "calib_images_used" not in result
    want = {k: ref[f"{key}/{k}"] for k in ("boxes", "scores", "classes", "valid")}
    assert (want["valid"] & (want["scores"] >= CONFIDENT)).sum() >= 30
    confident_agree(dets, want, VGG_CPU_IMAGES)
    fixture_map = float(ref[f"{key}/map50"])
    assert abs(result["mAP"] - fixture_map) <= MAP_TOL + VGG_SUBSET_SPREAD
    real = train_step.preprocess_eval_batch
    monkeypatch.setattr(train_step, "preprocess_eval_batch",
                        lambda images, size: real(images, size) * (1 + 2.0 ** -22))
    nudged, _, _ = port_eval(*case, quant_state=state, batch_size=VGG_CPU_IMAGES)
    spread = abs(nudged["mAP"] - result["mAP"])
    assert spread <= VGG_SUBSET_SPREAD + 1e-9
    # the reference's value is one the port reaches within its own noise
    assert min(abs(m - fixture_map) for m in (result["mAP"], nudged["mAP"])) <= MAP_TOL


def make_fixture() -> None:
    """The reference's f32 eval of each case on the CPU, with its own
    `run_eval` (native decode at the model's size, rgb wire, the eval set's
    head for int8_static calibration)."""
    jax.config.update("jax_platforms", "cpu")
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.evaluate import run_eval as ref_run_eval
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.models.quant import calibrate_for_driver
    from bdd100k_tpu.parallel import train_step as ref_train_step
    from bdd100k_tpu.utils.weights import load_detector_npz as jax_load_npz
    from test_torch_evaluate import _flax_tree
    from torch_ref_pool import ref_pool

    ref_pool()  # its run_eval decodes through the reference's pool
    out = {}
    for case, artifact in EVAL_CASES.items():
        config, quant, n = case
        key = _key(case)
        flat_params, flat_stats, _ = jax_load_npz(ARTIFACTS / artifact)
        params = _flax_tree({k: np.asarray(v, np.float32) for k, v in flat_params.items()})
        stats = _flax_tree({k: np.asarray(v, np.float32) for k, v in flat_stats.items()})
        cfg = dataclasses.replace(jax_config(config), quant=quant)
        bundle = jax_build(cfg, dtype=jnp.float32)
        ds = RefDataset.from_bdd100k(LABELS, IMAGES, decode_size=cfg.image_size)
        ds.records = ds.records[:n]
        quant_vars = None
        if quant == "int8_static":
            # the eval set's head, as run_eval calibrates
            quant_vars, _ = calibrate_for_driver(bundle, params, stats, dataset=ds)
            flat = port_weights._flatten(jax.device_get(quant_vars))
            names = sorted(flat)
            out[f"{key}/quant_names"] = np.asarray(
                [k.replace("/", ".") for k in names], "S96")
            out[f"{key}/quant_values"] = np.asarray([flat[k] for k in names], np.float32)
        dets = []
        real = ref_train_step.make_eval_step

        def recording_step(*a, **kw):
            step = real(*a, **kw)

            def run(*args):
                det = step(*args)
                dets.append([np.asarray(t) for t in jax.device_get(det)])
                return det
            return run

        import bdd100k_tpu.evaluate as ref_evaluate
        ref_evaluate.make_eval_step = recording_step
        try:
            state = types.SimpleNamespace(params=params, batch_stats=stats)
            batch = 8 if config == "ssd_vgg16_512" else EVAL_BATCH
            result = ref_run_eval(bundle, state, ds, _eval_args(batch),
                                  mesh=None, quant_vars=quant_vars)
        finally:
            ref_evaluate.make_eval_step = real
        for name, arr in zip(("boxes", "scores", "classes", "valid"),
                             (np.concatenate(a)[:n] for a in zip(*dets))):
            out[f"{key}/{name}"] = arr
        out[f"{key}/map50"] = np.float64(result["mAP"])
        print(f"{key}: mAP@0.5 {result['mAP']:.6f}", flush=True)
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")




if __name__ == "__main__":
    if "--make-fixture" in sys.argv:
        make_fixture()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
