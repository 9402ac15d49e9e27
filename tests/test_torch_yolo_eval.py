"""The port's YOLO-MobileNet-384 eval at full width against the JAX
reference, on the CPU, for both committed YOLO artifacts, each with the
priors it was trained with:

* `yolo_mobilenet_384_synth9k.npz` with the config's default priors;
* `yolo_mobilenet_384_synth4kds.npz` with
  `--yolo_priors artifacts/yolo_priors_synth4k.json`.

Both artifacts load strictly (157 keys, every parameter and buffer).
`run_eval(device="cpu")` in f32 over the 64 committed seed-1 val JPEGs at
decode_size 384 (the config's image size) is held against the committed
JAX fixture `tests/fixtures/torch_ref_eval_yolo384.npz`: detections slot
by slot but for the named near-tie swaps, boxes and scores within 1e-4,
mAP@0.5, per-class AP and COCO mAP within 1e-6. The CLI, as a user types
it in bf16, gives the reference's bf16 mAP within 0.01.

The fixture holds, for each pair, the reference's f32 detections (its own
DetectionDataset(decode_size=384), make_loader(native_decode=True),
make_eval_step and DetectionEvaluator at batch 32), mAP@0.5, per-class AP
and COCO mAP, and the mAP of its bf16 run_eval. Regenerate it with
`python tests/test_torch_yolo_eval.py --make-fixture` (the full-width JAX
model on the CPU, about a minute).
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "tests") not in sys.path:
    sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_ref_pool import ref_pool  # noqa: E402
from bdd100k_tpu_torch import evaluate as port_eval  # noqa: E402
from bdd100k_tpu_torch.configs import apply_yolo_priors, get_config  # noqa: E402
from bdd100k_tpu_torch.data import pipeline as port_pipeline  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.ops.nms import Detections  # noqa: E402
from bdd100k_tpu_torch.utils import weights as port_weights  # noqa: E402
from test_torch_evaluate import (  # noqa: E402
    DET_ATOL,
    _assert_detections_match,
    _eval_args,
    _flax_tree,
    _run_eval_recording,
)

# two torch threads: the suite runs these files beside JAX workers
torch.set_num_threads(2)

CONFIG = "yolo_mobilenet_384"
ARTIFACTS = ROOT / "artifacts"
FIXTURES = ROOT / "tests" / "fixtures"
SYNTH = FIXTURES / "synth_val_seed1"
LABELS = SYNTH / "labels" / "val.json"
IMAGES = SYNTH / "images" / "val"
FIXTURE = FIXTURES / "torch_ref_eval_yolo384.npz"
# (artifact, priors JSON or None for the config's own)
PAIRS = {
    "synth9k": (ARTIFACTS / "yolo_mobilenet_384_synth9k.npz", None),
    "synth4kds": (ARTIFACTS / "yolo_mobilenet_384_synth4kds.npz",
                  ARTIFACTS / "yolo_priors_synth4k.json"),
}
N_SCENES = 64
EVAL_BATCH = 32
DECODE_SIZE = 384
MAP_ATOL = 1e-6
BF16_MAP_TOL = 0.01
# (image, slot) per pair: the reference's detections at slots s and s+1
# are near-ties (scores 3e-9 to 4.7e-7 apart), inside the two frameworks'
# f32 disagreement, and the port orders them the other way. synth4kds
# fills all 200 slots of every image with low-scored boxes, so it has
# many. Each swap is undone by name before the slot-by-slot comparison;
# any other flip fails, named. mAP is unaffected (equal).
NEAR_TIE_SWAPS = {
    "synth9k": (),
    "synth4kds": ((6, 61), (11, 39), (17, 172), (18, 120), (26, 62), (26, 191),
                  (29, 63), (29, 160), (29, 192), (32, 151), (33, 127),
                  (42, 179), (43, 183), (46, 138), (47, 66), (47, 146),
                  (50, 108), (58, 97), (60, 192)),
}
# images whose last slot (the 200th) holds, in the port, another candidate
# than the reference's, both scored within NEAR_TIE: a near-tie at the
# cross-class top-200 cut. That slot is left out of the comparison.
NEAR_TIE_CUTS = {"synth9k": (), "synth4kds": (36,)}
NEAR_TIE = 1e-6


def _config(priors):
    cfg = get_config(CONFIG)
    return apply_yolo_priors(cfg, priors) if priors else cfg


@pytest.mark.parametrize("pair", PAIRS)
def test_yolo_artifact_covers_the_model_exactly(pair):
    path, priors = PAIRS[pair]
    params, stats, meta = port_weights.read_detector_npz(path)
    assert len(params) + len(stats) + 1 == 157 and meta["config"] == CONFIG
    assert {v.dtype for v in params.values()} == {np.dtype(np.float16)}
    sd, _ = port_weights.load_detector_npz(path, expect_config=CONFIG)
    model = build_detector(_config(priors), device="cpu").model
    own = model.state_dict()
    assert set(sd) == set(own)
    n_bn = sum(k.endswith("running_mean") for k in own)
    assert len(params) + len(stats) + n_bn == len(own)
    model.load_state_dict(sd)
    out = params["head2/out/kernel"].astype(np.float32)      # HWIO → OIHW
    assert out.shape == (1, 1, 256, 3 * 15)
    np.testing.assert_array_equal(model.head2.out.weight.detach().numpy(),
                                  out.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.head0.out.bias.detach().numpy(),
                                  params["head0/out/bias"].astype(np.float32))
    np.testing.assert_array_equal(model.head1.conv.BatchNorm_0.running_var.numpy(),
                                  stats["head1/conv/BatchNorm_0/var"])


def _undo_near_ties(got: Detections, ref: dict, pair: str) -> Detections:
    """The port's detections with each named swap undone and each named
    cut's last slot set to the reference's, after checking that it is
    one: a near-tie in the reference and the port's two slots the
    reference's two, crossed; or a last slot scored within NEAR_TIE of the
    reference's."""
    arrays = [a.copy() for a in got]
    for i, s in NEAR_TIE_SWAPS[pair]:
        two = slice(s, s + 2)
        assert abs(float(ref["scores"][i, s] - ref["scores"][i, s + 1])) < NEAR_TIE, (i, s)
        np.testing.assert_array_equal(got.classes[i, two], ref["classes"][i, two][::-1])
        np.testing.assert_allclose(got.boxes[i, two], ref["boxes"][i, two][::-1],
                                   rtol=0, atol=DET_ATOL)
        for a in arrays:
            a[i, two] = a[i, two][::-1].copy()
    for i in NEAR_TIE_CUTS[pair]:
        assert got.valid[i, -1] and ref["valid"][i, -1]
        assert abs(float(got.scores[i, -1] - ref["scores"][i, -1])) < NEAR_TIE, i
        for a, name in zip(arrays, ("boxes", "scores", "classes", "valid")):
            a[i, -1] = ref[name][i, -1]
    return Detections(*arrays)


def _fixture(pair: str) -> dict:
    with np.load(FIXTURE) as z:
        return {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(pair + "/")}


@pytest.mark.parametrize("pair", PAIRS)
def test_run_eval_cpu_f32_matches_jax_fixture(monkeypatch, pair):
    path, priors = PAIRS[pair]
    ref = _fixture(pair)
    cfg = _config(priors)
    bundle = build_detector(cfg, dtype=torch.float32, device="cpu")
    port_weights.restore_eval_weights(bundle.model, path, expect_config=CONFIG)
    dataset = port_pipeline.DetectionDataset.from_bdd100k(
        LABELS, IMAGES, decode_size=cfg.image_size)
    assert cfg.image_size == DECODE_SIZE
    result, det = _run_eval_recording(monkeypatch, bundle, dataset, _eval_args())
    assert result["num_images"] == N_SCENES
    assert det.boxes.shape == (N_SCENES, 200, 4)
    _assert_detections_match(_undo_near_ties(det, ref, pair), ref)
    assert abs(result["mAP"] - float(ref["map50"])) <= MAP_ATOL
    per_class = [np.nan if v is None else v for v in result["per_class"].values()]
    np.testing.assert_allclose(per_class, ref["per_class_ap"], rtol=0, atol=MAP_ATOL)
    assert abs(result["coco"]["mAP"] - float(ref["coco_map"])) <= MAP_ATOL


@pytest.mark.parametrize("pair", PAIRS)
def test_evaluate_cli_bf16_on_the_cpu(tmp_path, pair):
    """As a user types it, in bf16 (the CLI's dtype): the reference's bf16
    run_eval mAP within 0.01, and the --out JSON with its keys."""
    path, priors = PAIRS[pair]
    ref = _fixture(pair)
    out = tmp_path / "result.json"
    argv = ["--config", CONFIG, "--synthetic", str(N_SCENES),
            "--synthetic_dir", str(SYNTH), "--ckpt_dir", str(path),
            "--batch_size", str(EVAL_BATCH), "--num_workers", "4",
            "--out", str(out), "--device", "cpu"]
    if priors:
        argv += ["--yolo_priors", str(priors)]
    result = port_eval.main(argv)
    assert result["num_images"] == N_SCENES
    assert abs(result["mAP"] - float(ref["bf16_run_eval_map50"])) <= BF16_MAP_TOL
    assert set(json.loads(out.read_text())) >= {"mAP", "per_class",
                                                "images_per_sec", "num_images"}


# ------------------------------------------------------------------ fixture


def make_fixture() -> None:
    """Run the reference's eval path in f32 over the 64 JPEGs on the CPU
    for both artifact/priors pairs, and its bf16 run_eval, and write the
    fixture."""
    jax.config.update("jax_platforms", "cpu")
    from bdd100k_tpu.configs.detector_configs import BDD100K_CLASSES
    from bdd100k_tpu.configs.detector_configs import apply_yolo_priors as jax_apply
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.data.pipeline import make_loader as ref_loader
    from bdd100k_tpu.evaluate import run_eval as ref_run_eval
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.ops.map_metric import DetectionEvaluator
    from bdd100k_tpu.parallel.train_step import make_eval_step
    from bdd100k_tpu.utils.weights import load_detector_npz as jax_load_npz

    ref_pool()
    ds = RefDataset.from_bdd100k(LABELS, IMAGES, max_boxes=100,
                                 decode_size=DECODE_SIZE)
    out, meta = {}, {}
    for pair, (path, priors) in PAIRS.items():
        flat_params, flat_stats, art_meta = jax_load_npz(path)
        params = _flax_tree({k: np.asarray(v, np.float32)
                             for k, v in flat_params.items()})
        stats = _flax_tree({k: np.asarray(v, np.float32)
                            for k, v in flat_stats.items()})
        cfg = jax_config(CONFIG)
        if priors:
            cfg = jax_apply(cfg, str(priors))
        bundle = jax_build(cfg, dtype=jnp.float32)
        step = make_eval_step(bundle)
        evaluator = DetectionEvaluator(cfg.num_classes, list(BDD100K_CLASSES))
        dets, seen = [], 0
        for batch in ref_loader(ds, EVAL_BATCH, shuffle=False, num_epochs=1,
                                drop_last=False, native_decode=True, num_workers=4):
            det = jax.device_get(step(params, stats, batch.images))
            for i in range(det.boxes.shape[0]):
                if seen == len(ds):
                    break
                evaluator.add_image(det.boxes[i], det.scores[i], det.classes[i],
                                    batch.boxes[i], batch.labels[i],
                                    det_valid=det.valid[i], gt_mask=batch.mask[i])
                dets.append([np.asarray(a[i]) for a in det])
                seen += 1
        result = evaluator.compute(iou_threshold=0.5)
        coco = evaluator.compute_range()
        state = types.SimpleNamespace(params=params, batch_stats=stats)
        args = types.SimpleNamespace(batch_size=EVAL_BATCH, num_workers=4,
                                     wire="rgb", iou_threshold=0.5,
                                     coco_map=False, dump_detections=None)
        bf16_map = ref_run_eval(jax_build(cfg), state, ds, args, mesh=None)["mAP"]
        boxes, scores, classes, valid = (np.stack(a) for a in zip(*dets))
        out.update({
            f"{pair}/boxes": boxes, f"{pair}/scores": scores,
            f"{pair}/classes": classes, f"{pair}/valid": valid,
            f"{pair}/map50": np.float64(result["mAP"]),
            f"{pair}/per_class_ap": np.asarray(
                [np.nan if v is None else v for v in result["per_class"].values()],
                np.float64),
            f"{pair}/coco_map": np.float64(coco["mAP"]),
            f"{pair}/bf16_run_eval_map50": np.float64(bf16_map),
        })
        meta[pair] = {"artifact": path.name, "step": art_meta.get("step"),
                      "priors": priors.name if priors else "YOLO_BDD_PRIORS"}
        print(f"{pair}: mAP@0.5 {result['mAP']:.6f} (f32), {bf16_map:.6f} "
              f"(bf16), COCO {coco['mAP']:.6f}, mean valid detections "
              f"{valid.sum(1).mean():.1f}")
    out["meta"] = np.frombuffer(json.dumps({
        "pairs": meta, "scenes": "tests/fixtures/synth_val_seed1, seed 1, all 64",
        "route": "native", "decode_size": DECODE_SIZE, "dtype": "float32",
        "batch_size": EVAL_BATCH, "jax": jax.__version__,
    }).encode(), np.uint8)
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")


if __name__ == "__main__":
    if "--make-fixture" in sys.argv:
        make_fixture()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
