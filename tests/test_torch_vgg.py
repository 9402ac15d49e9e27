"""The port's VGG16-SSD512 family against the JAX reference, on the CPU.

* the layers VGG adds: `L2Norm` against flax to 1e-6 of its largest
  output (outputs reach the scale, 20 at init, where one f32 ulp is
  1.9e-6, and the channel sum runs in another order), the flax-SAME max
  pools (2×2 at stride 2 on even and odd maps, 3×3 at stride 1) at f32
  atol 1e-6 (measured equal), and the dilated fc6 conv against flax's at
  1e-5;
* the config, its 24564 anchors bit-equal to the reference's;
* VGG16-SSD at a 64² geometry and full widths (`dataclasses.replace` of
  the VGG config with the feature maps (8, 4, 2, 1) in both packages),
  from the reference's `PRNGKey(0)` init carried across with
  `state_dict_from_flax`: f32 logits against JAX live within 1e-4 (15
  bias-only convs, the L2Norm and 5 BatchNorm extra stages summed in
  another order; measured below 2e-5), postprocessed detections slot for
  slot, one f32 train step against the committed reference step
  (`tests/fixtures/torch_ref_train_vgg64.npz`), an artifact the port
  writes loading in the reference's `load_into_state` with the same
  logits, and the trainer taking the config;
* the committed artifact `artifacts/ssd_vgg16_512_synth9k.npz`: it covers
  the model exactly (110 keys), and on two of the 64 seed-1 JPEGs decoded
  at 512 the port's f32 detections equal the reference's
  (`tests/fixtures/torch_ref_eval_vgg512.npz`), boxes and scores within
  1e-4.

The eval fixture also carries the reference's f32 detections over all 64
JPEGs, its mAP@0.5 and COCO mAP and the sha256 of each decoded 512² image:
the card's check (`chip_smoke.py`) holds the port's eval to them.
Regenerate both fixtures with `python tests/test_torch_vgg.py
--make-fixture` (the JAX VGG512 in f32 on the CPU over the 64 JPEGs).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import sys
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
from bdd100k_tpu_torch import train as port_train  # noqa: E402
from bdd100k_tpu_torch.configs import TrainConfig, get_config  # noqa: E402
from bdd100k_tpu_torch.data.augment import preprocess_eval_batch  # noqa: E402
from bdd100k_tpu_torch.data.native_decode import NativeDecoder  # noqa: E402
from bdd100k_tpu_torch.models import layers as port_layers  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.ops import anchors as port_anchors  # noqa: E402
from bdd100k_tpu_torch.ops.nms import Detections  # noqa: E402
from bdd100k_tpu_torch.parallel import train_step  # noqa: E402
from bdd100k_tpu_torch.utils import weights as port_weights  # noqa: E402
from test_torch_evaluate import _flax_tree  # noqa: E402

# two torch threads: the suite runs these files beside JAX workers
torch.set_num_threads(2)

CONFIG = "ssd_vgg16_512"
ARTIFACT = ROOT / "artifacts" / "ssd_vgg16_512_synth9k.npz"
FIXTURES = ROOT / "tests" / "fixtures"
SYNTH = FIXTURES / "synth_val_seed1"
LABELS = SYNTH / "labels" / "val.json"
IMAGES = SYNTH / "images" / "val"
EVAL_FIXTURE = FIXTURES / "torch_ref_eval_vgg512.npz"
TRAIN_FIXTURE = FIXTURES / "torch_ref_train_vgg64.npz"
EVAL_BATCH = 32
ARTIFACT_IMAGES = (0, 1)   # the two JPEGs the CPU holds to the fixture
MAP_SIZES_64 = (8, 4, 2, 1)
BOXES_64 = (4, 6, 6, 4)
LAYER_ATOL = 1e-6
CONV_ATOL = 1e-5
LOGIT_ATOL = 1e-4
DET_ATOL = 1e-4
SAMPLES = 512              # elements of each param the train fixture keeps
CFG = TrainConfig(batch_size=2, max_boxes=8, learning_rate=1e-3,
                  warmup_steps=0, total_steps=100)
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
UPDATE_REL = 2e-2          # of the largest |update| in each tensor
STATS_ATOL = 1e-5


def _vgg64_port():
    return dataclasses.replace(
        get_config(CONFIG), name="ssd_vgg16_64", image_size=64,
        feature_maps=port_anchors.make_ssd_feature_maps(MAP_SIZES_64, BOXES_64))


def _vgg64_jax():
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.ops.anchors import make_ssd_feature_maps

    return dataclasses.replace(
        jax_config(CONFIG), name="ssd_vgg16_64", image_size=64,
        feature_maps=make_ssd_feature_maps(MAP_SIZES_64, BOXES_64))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


# ------------------------------------------------------------------ layers


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", [(2, 8, 8, 512), (1, 5, 7, 16)])
def test_l2norm_matches_flax(shape):
    from bdd100k_tpu.models.layers import L2Norm as JaxL2Norm

    rng = np.random.RandomState(0)
    x = rng.normal(0, 3, shape).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero pixel: the 1e-10 keeps it finite
    scale = rng.uniform(5, 25, shape[-1]).astype(np.float32)
    want = np.asarray(JaxL2Norm().apply({"params": {"scale": scale}}, x))
    layer = port_layers.L2Norm(shape[-1])
    assert (layer.weight.detach() == 20.0).all()
    layer.weight.data = torch.from_numpy(scale)
    with torch.no_grad():
        got = layer(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LAYER_ATOL * np.abs(want).max())


@pytest.mark.parametrize("window,stride,size", [
    (2, 2, 8), (2, 2, 9), (2, 2, 13), (3, 1, 8), (3, 1, 7)])
def test_max_pool_same_matches_flax(window, stride, size):
    import flax.linen as fnn

    x = np.random.RandomState(1).normal(0, 1, (2, size, size + 2, 4)).astype(np.float32)
    x -= 10.0  # every value negative: a zero pad would win where flax's −inf does not
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (window, window),
                                   strides=(stride, stride), padding="SAME"))
    got = port_layers.max_pool_same(_nchw(x), window, stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=LAYER_ATOL)


@pytest.mark.parametrize("size", [8, 13])
def test_dilated_fc6_matches_flax(size):
    """fc6: a 3×3 conv at dilation 6, flax SAME (6 on every side)."""
    import flax.linen as fnn

    rng = np.random.RandomState(2)
    x = rng.normal(0, 1, (2, size, size, 16)).astype(np.float32)
    conv = fnn.Conv(24, (3, 3), kernel_dilation=(6, 6), padding="SAME")
    variables = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(variables, x))
    port = port_layers.Conv(16, 24, 3, bias=True, dtype=torch.float32, dilation=6)
    sd = port_weights.state_dict_from_flax({"fc6": variables["params"]}, {})
    port.load_state_dict({k.removeprefix("fc6."): v for k, v in sd.items()})
    got = port(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)


# ------------------------------------------------------------------ config


def test_vgg512_config_and_anchors_match_jax():
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.ops.anchors import ssd_anchors as jax_anchors

    cfg, jcfg = get_config(CONFIG), jax_config(CONFIG)
    assert (cfg.image_size, cfg.backbone, cfg.head) == (512, "vgg16", "ssd")
    assert [dataclasses.astuple(f) for f in cfg.feature_maps] == [
        dataclasses.astuple(f) for f in jcfg.feature_maps]
    assert cfg.postprocess.per_class_topk == jcfg.postprocess.per_class_topk == 200
    assert cfg.num_anchors == jcfg.num_anchors == 24564
    np.testing.assert_array_equal(
        port_anchors.ssd_anchors(cfg.feature_maps).numpy(),
        np.asarray(jax_anchors(jcfg.feature_maps)))


# --------------------------------------------------- the 64² geometry, live


@functools.lru_cache(maxsize=None)
def _jax_vgg64():
    """The reference's VGG16-SSD at 64² in f32, its PRNGKey(0) variables
    and its jitted forward + postprocess."""
    from bdd100k_tpu.models.detector import build_detector as jax_build

    bundle = jax_build(_vgg64_jax(), dtype=jnp.float32)
    variables = jax.device_get(bundle.init(jax.random.PRNGKey(0)))

    @jax.jit
    def run(variables, images):
        loc, cls = bundle.model.apply(variables, images, train=False)
        return loc, cls, bundle.postprocess(loc, cls)

    return variables, run


def _images64(seed=3, n=2):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)


def _port_vgg64(variables):
    bundle = build_detector(_vgg64_port(), dtype=torch.float32, device="cpu")
    bundle.model.load_state_dict(port_weights.state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    return bundle


def test_vgg64_logits_and_detections_match_jax():
    """From the reference's own init: f32 logits within LOGIT_ATOL, and
    the postprocessed detections slot for slot (valid and classes equal,
    boxes and scores within DET_ATOL)."""
    variables, run = _jax_vgg64()
    images = _images64()
    jloc, jcls, jdet = jax.device_get(run(variables, jnp.asarray(images)))
    bundle = _port_vgg64(variables)
    assert bundle.anchors.shape[0] == 8 * 8 * 4 + 4 * 4 * 6 + 2 * 2 * 6 + 4
    loc, cls = bundle.apply(torch.from_numpy(images))
    np.testing.assert_allclose(loc.numpy(), jloc, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(cls.numpy(), jcls, rtol=0, atol=LOGIT_ATOL)
    det = bundle.postprocess(loc, cls)
    assert det.valid.any()
    np.testing.assert_array_equal(det.valid.numpy(), jdet.valid)
    np.testing.assert_array_equal(det.classes.numpy(), jdet.classes)
    np.testing.assert_allclose(det.scores.numpy(), jdet.scores, rtol=0, atol=DET_ATOL)
    valid = jdet.valid[..., None]
    np.testing.assert_allclose(np.where(valid, det.boxes.numpy(), 0),
                               np.where(valid, jdet.boxes, 0), rtol=0, atol=DET_ATOL)


def test_port_vgg_artifact_loads_in_jax_with_the_same_logits(tmp_path):
    """`save_detector_npz` of the port's VGG64 (drawn from its own seeded
    init): the reference's `load_into_state` reads it back, the L2Norm
    `scale` included, and gives the port's logits."""
    from bdd100k_tpu.utils.weights import load_detector_npz as jax_load_npz

    variables, run = _jax_vgg64()
    bundle = build_detector(_vgg64_port(), dtype=torch.float32, device="cpu", seed=5)
    with torch.no_grad():
        bundle.model.backbone.conv4_3_norm.weight.mul_(0.5)  # not the init value
    path = tmp_path / "vgg64.npz"
    port_weights.save_detector_npz(path, bundle.model.state_dict(),
                                   config_name="ssd_vgg16_64", param_dtype=np.float32)
    params, stats, meta = jax_load_npz(path)
    assert "backbone/conv4_3_norm/scale" in params
    assert set(params) == set(_flat(variables["params"]))
    assert set(stats) == set(_flat(variables["batch_stats"]))
    loaded = {"params": _flax_tree(params), "batch_stats": _flax_tree(stats)}
    images = _images64(seed=4)
    jloc, jcls, _ = jax.device_get(run(loaded, jnp.asarray(images)))
    loc, cls = bundle.apply(torch.from_numpy(images))
    np.testing.assert_allclose(loc.numpy(), jloc, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(cls.numpy(), jcls, rtol=0, atol=LOGIT_ATOL)


def _float_batch(seed=0, b=2, m=8, size=64):
    """A fixed preprocessed batch: images in [-1, 1], 1–4 GT boxes each."""
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        n = rng.randint(1, 5)
        cxy = rng.uniform(0.2, 0.8, (n, 2))
        wh = rng.uniform(0.1, 0.5, (n, 2))
        boxes[i, :n] = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
        labels[i, :n] = rng.randint(1, 11, n)
        mask[i, :n] = True
    return images, boxes, labels, mask


def _stride(n: int) -> int:
    return max(1, n // SAMPLES)


def test_one_vgg64_step_matches_jax_fixture():
    """The whole f32 step (forward in train mode, matcher, SSD loss with
    mining, backward, clip, decay, momentum, the extra stages' BatchNorm
    statistics) against the reference's f32 step from the same init:
    loss parts to 1e-5 relative, grad norm to 1e-4, each tensor's update
    (new − old, SAMPLES elements of it) to 2e-2 of its largest element,
    the statistics to 1e-5."""
    ref = np.load(TRAIN_FIXTURE)
    variables, _ = _jax_vgg64()
    bundle = _port_vgg64(variables)
    bundle.model.train()
    old = _flat(variables["params"])
    state = train_step.create_train_state(bundle, CFG)
    step = train_step.make_train_step(bundle, device="cpu")
    metrics = step(state, None, *[torch.from_numpy(a) for a in _float_batch()])
    for k, rtol in (("loss", LOSS_RTOL), ("conf_loss", LOSS_RTOL),
                    ("loc_loss", LOSS_RTOL), ("grad_norm", GRAD_NORM_RTOL)):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]), rtol=rtol,
                                   err_msg=k)
    new_params, new_stats = port_weights.flax_from_state_dict(bundle.model.state_dict())
    assert set(new_params) == set(old)
    for k, v in new_params.items():
        s = _stride(v.size)
        before = old[k].ravel()[::s]
        want = ref[f"params/{k}"] - before
        got = v.ravel()[::s] - before
        slack = UPDATE_REL * np.abs(want).max() + np.spacing(np.abs(before))
        assert (np.abs(got - want) <= slack).all(), k
    assert set(new_stats) == {k[len("batch_stats/"):] for k in ref.files
                              if k.startswith("batch_stats/")}
    for k, v in new_stats.items():
        np.testing.assert_allclose(v, ref[f"batch_stats/{k}"], rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


def test_trainer_takes_the_vgg_config(tmp_path, monkeypatch):
    """`python -m bdd100k_tpu_torch.train --config ssd_vgg16_512` builds
    the VGG family (here at the 64² geometry, two steps on the CPU) and
    runs the SSD loss, mining and matcher on its anchors."""
    monkeypatch.setattr(port_train, "get_config",
                        lambda name: _vgg64_port() if name == CONFIG else get_config(name))
    port_train.main([
        "--config", CONFIG, "--synthetic", "4", "--batch_size", "2",
        "--total_steps", "2", "--warmup_steps", "0", "--log_every", "1",
        "--ckpt_dir", str(tmp_path / "run"), "--device", "cpu"])
    lines = [json.loads(x) for x in (tmp_path / "run" / "train.jsonl")
             .read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines)


# ------------------------------------------------------------------ artifact


def test_vgg_artifact_covers_the_model_exactly():
    params, stats, meta = port_weights.read_detector_npz(ARTIFACT)
    with np.load(ARTIFACT) as z:
        assert len(z.files) == 110
    assert meta["config"] == CONFIG
    bundle = build_detector(get_config(CONFIG), dtype=torch.float32, device="cpu")
    sd = port_weights.state_dict_from_flax(params, stats)
    model_sd = bundle.model.state_dict()
    assert set(sd) == set(model_sd)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(model_sd[k].shape), k
    assert sum(p.numel() for p in bundle.model.parameters()) == sum(
        v.size for v in params.values())
    bundle.model.load_state_dict(sd)  # strict


def test_vgg_artifact_on_two_jpegs_matches_the_fixture():
    """Images 0 and 1 of the 64, decoded at 512 by the pool, through the
    port's f32 forward and postprocess on the artifact: slot-equal to the
    reference's f32 detections, boxes and scores within DET_ATOL."""
    ref = np.load(EVAL_FIXTURE)
    bundle = build_detector(get_config(CONFIG), dtype=torch.float32, device="cpu")
    port_weights.restore_eval_weights(bundle.model, ARTIFACT, expect_config=CONFIG)
    paths = sorted(IMAGES.glob("*.jpg"))
    decoder = NativeDecoder(2)
    try:
        images = decoder.decode_batch([paths[i].read_bytes() for i in ARTIFACT_IMAGES], 512)
    finally:
        decoder.close()
    for j, i in enumerate(ARTIFACT_IMAGES):
        assert hashlib.sha256(images[j].tobytes()).hexdigest() == \
            ref["image_sha256"][i].decode()
    loc, cls = bundle.apply(preprocess_eval_batch(torch.from_numpy(images), 512))
    det = Detections(*(t.numpy() for t in bundle.postprocess(loc, cls)))
    want = {k: ref[k][list(ARTIFACT_IMAGES)] for k in ("boxes", "scores", "classes",
                                                       "valid")}
    assert det.valid.sum() > 0
    np.testing.assert_array_equal(det.valid, want["valid"])
    np.testing.assert_array_equal(det.classes, want["classes"])
    np.testing.assert_allclose(det.scores, want["scores"], rtol=0, atol=DET_ATOL)
    valid = want["valid"][..., None]
    np.testing.assert_allclose(np.where(valid, det.boxes, 0),
                               np.where(valid, want["boxes"], 0), rtol=0, atol=DET_ATOL)
    assert 0.0 < float(ref["map50"]) <= 1.0


# ------------------------------------------------------------------ fixtures


def _make_train_fixture() -> None:
    from bdd100k_tpu.configs import TrainConfig as JaxTrainConfig
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.parallel.train_step import create_train_state, make_train_step

    bundle = jax_build(_vgg64_jax(), dtype=jnp.float32)
    cfg = JaxTrainConfig(**{f: getattr(CFG, f) for f in (
        "batch_size", "max_boxes", "learning_rate", "warmup_steps", "total_steps")})
    state = create_train_state(bundle, cfg, jax.random.PRNGKey(0))
    variables, _ = _jax_vgg64()
    # the same init as the live tests draw
    for a, b in zip(jax.tree.leaves(jax.device_get(state.params)),
                    jax.tree.leaves(variables["params"])):
        np.testing.assert_array_equal(a, b)
    step = make_train_step(bundle, donate=False)
    new, metrics = step(state, jax.random.PRNGKey(1),
                        *[jnp.asarray(a) for a in _float_batch()])
    out = {k: np.float32(v) for k, v in jax.device_get(metrics).items()}
    for k, v in _flat(jax.device_get(new.params)).items():
        out[f"params/{k}"] = v.ravel()[::_stride(v.size)]
    for k, v in _flat(jax.device_get(new.batch_stats)).items():
        out[f"batch_stats/{k}"] = v
    np.savez_compressed(TRAIN_FIXTURE, **out)
    print(f"wrote {TRAIN_FIXTURE} ({TRAIN_FIXTURE.stat().st_size} bytes): loss "
          f"{float(out['loss']):.6f}, grad norm {float(out['grad_norm']):.4f}")


def _make_eval_fixture() -> None:
    """The reference's eval path in f32 over the 64 JPEGs at 512 (its own
    DetectionDataset, make_loader(native_decode=True), make_eval_step and
    DetectionEvaluator at b32)."""
    from bdd100k_tpu.configs.detector_configs import BDD100K_CLASSES
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.data.pipeline import make_loader as ref_loader
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.ops.map_metric import DetectionEvaluator
    from bdd100k_tpu.parallel.train_step import make_eval_step
    from bdd100k_tpu.utils.weights import load_detector_npz as jax_load_npz

    ref_pool()
    flat_params, flat_stats, meta = jax_load_npz(ARTIFACT)
    params = _flax_tree({k: np.asarray(v, np.float32) for k, v in flat_params.items()})
    stats = _flax_tree({k: np.asarray(v, np.float32) for k, v in flat_stats.items()})
    ds = RefDataset.from_bdd100k(LABELS, IMAGES, max_boxes=100, decode_size=512)
    cfg = jax_config(CONFIG)
    step = make_eval_step(jax_build(cfg, dtype=jnp.float32))
    evaluator = DetectionEvaluator(cfg.num_classes, list(BDD100K_CLASSES))
    dets, shas, seen = [], [], 0
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
            shas.append(hashlib.sha256(np.asarray(batch.images[i]).tobytes()).hexdigest())
            seen += 1
    result = evaluator.compute(iou_threshold=0.5)
    coco = evaluator.compute_range()
    boxes, scores, classes, valid = (np.stack(a) for a in zip(*dets))
    np.savez_compressed(
        EVAL_FIXTURE,
        boxes=boxes, scores=scores, classes=classes, valid=valid,
        map50=np.float64(result["mAP"]),
        per_class_ap=np.asarray(
            [np.nan if v is None else v for v in result["per_class"].values()],
            np.float64),
        coco_map=np.float64(coco["mAP"]),
        image_sha256=np.asarray(shas, "S64"),
        meta=np.frombuffer(json.dumps({
            "artifact": ARTIFACT.name, "step": meta.get("step"),
            "scenes": "tests/fixtures/synth_val_seed1, seed 1, all 64",
            "route": "native", "decode_size": 512, "dtype": "float32",
            "batch_size": EVAL_BATCH, "jax": jax.__version__,
        }).encode(), np.uint8),
    )
    print(f"wrote {EVAL_FIXTURE} ({EVAL_FIXTURE.stat().st_size} bytes): mAP@0.5 "
          f"{result['mAP']:.6f} (f32), COCO {coco['mAP']:.6f}")


def make_fixture() -> None:
    jax.config.update("jax_platforms", "cpu")
    _make_train_fixture()
    _make_eval_fixture()


if __name__ == "__main__":
    if "--make-fixture" in sys.argv:
        make_fixture()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
