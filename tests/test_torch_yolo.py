"""The port's YOLO family against the JAX reference, on the CPU.

* `yolo_anchors` and `yolo_cell_sizes`, bit-equal, at full width with the
  default priors and the committed fitted ones, and at the tiny config;
* the σ-space box codec to 1e-6, its round trip and the 1e-8 floor on
  zero-size boxes;
* the `yolo_tiny_64` forward from weights carried over from the JAX
  `PRNGKey(0)` init (logits to 1e-5), and postprocess with
  `decode_mode="yolo"` (valid slots and classes equal; boxes and scores
  to 1e-5);
* hard-negative mining with `min_negatives=1`, `yolo_loss` and the YOLO
  branch of `detection_loss` (total, obj+cls and loc to 1e-6 relative) on
  a batch with padded GT rows and an image with no GT;
* one f32 `yolo_tiny_64` train step against the committed JAX fixture
  `tests/fixtures/torch_ref_train_yolo_tiny.npz` (tolerances below);
* `apply_yolo_priors` and its two errors, the k-means priors and the
  port's `python -m bdd100k_tpu_torch.data.priors`;
* the golden pipelines of tests/test_golden.py, both heads: the four
  fixture JPEGs decoded by the reference's `DetectionDataset`, the uint8
  frames through the port's preprocess, forward and postprocess from the
  JAX `PRNGKey(0)` init, against `golden_tiny_{ssd,yolo}.npz`;
* an artifact the port writes for `yolo_tiny_64` loads in the reference's
  `load_into_state` with the same logits; `load_predictor` and the trainer
  take a YOLO config and a priors file.

Regenerate the train fixture with `python tests/test_torch_yolo.py
--make-fixture` (the JAX step on the CPU and, in a subprocess, its f64
evaluation; about 30 s).

Train-step tolerances. The reference's f32 step is not the rounding-free
step: its BatchNorm statistics, E[x²] − E[x]² reduced in f32 over a batch
of 4, move its loss by 7.1e-6 and its grad norm by 1.1e-3 from an f64
evaluation of the same step (the reference itself, BatchNorm in f64 too),
while the port's f32 step sits within 7.7e-7 and 1.3e-6 of it. So the
port is held twice:
* against the reference's f64 evaluation (committed in the fixture):
  loss and obj+cls to 1e-6 relative, loc to 2e-5 (measured 7.7e-7, 0.0
  and 7.0e-6), grad norm to 1e-5 (1.3e-6), each gradient tensor to 1e-3
  of its largest element (worst 1.4e-4);
* against the reference's f32 step (loss, parts, the new params and the
  new BatchNorm statistics): loss and obj+cls to 1e-5 relative, loc and
  the grad norm to 1e-4 and 2e-3 (measured 6.3e-6, 4.9e-5 and 1.1e-3),
  each tensor's update (new − old params) to 5e-2 of its largest element
  plus one ulp of the param, which the fixture's f32 params cannot resolve
  (worst 3.2e-2: BatchNorm scales and biases, where the reference's own
  f32 statistics move it up to 5.6e-2 from f64), the statistics to 1e-5.
"""

from __future__ import annotations

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bdd100k_tpu_torch import train as port_train  # noqa: E402
from bdd100k_tpu_torch.configs import (  # noqa: E402
    TrainConfig,
    apply_yolo_priors,
    get_config,
    tiny_test_config,
)
from bdd100k_tpu_torch.data import priors as port_priors  # noqa: E402
from bdd100k_tpu_torch.data.augment import preprocess_eval_batch  # noqa: E402
from bdd100k_tpu_torch.infer import load_predictor  # noqa: E402
from bdd100k_tpu_torch.models import losses as port_losses  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.ops import anchors as port_anchors  # noqa: E402
from bdd100k_tpu_torch.ops import boxes as port_boxes  # noqa: E402
from bdd100k_tpu_torch.ops import matching as port_matching  # noqa: E402
from bdd100k_tpu_torch.ops.mining import hard_negative_mask  # noqa: E402
from bdd100k_tpu_torch.ops.postprocess import postprocess  # noqa: E402
from bdd100k_tpu_torch.parallel import train_step  # noqa: E402
from bdd100k_tpu_torch.utils import weights as port_weights  # noqa: E402

# two torch threads: the suite runs these files beside JAX workers
torch.set_num_threads(2)

FIXTURES = ROOT / "tests" / "fixtures"
TRAIN_FIXTURE = FIXTURES / "torch_ref_train_yolo_tiny.npz"
PRIORS_JSON = ROOT / "artifacts" / "yolo_priors_synth4k.json"
STRIDE = 4
CFG = TrainConfig(batch_size=4, max_boxes=8, learning_rate=1e-3,
                  warmup_steps=0, total_steps=100)
CODEC_ATOL = 1e-6
LOGIT_ATOL = 1e-5
DET_ATOL = 1e-5
LOSS_RTOL = 1e-6         # the loss function on the same logits
# the train step against the reference's f32 step and against its f64
# evaluation (see the module docstring)
STEP_RTOL = {"loss": 1e-5, "conf_loss": 1e-5, "loc_loss": 1e-4,
             "grad_norm": 2e-3}
F64_RTOL = {"loss": 1e-6, "conf_loss": 1e-6, "loc_loss": 2e-5,
            "grad_norm": 1e-5}
F64_GRAD_REL = 1e-3
UPDATE_REL = 5e-2
STATS_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_tiny(head: str = "yolo"):
    """The reference's tiny model in f32 and its PRNGKey(0) variables."""
    from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
    from bdd100k_tpu.models.detector import build_detector as jax_build

    bundle = jax_build(jax_tiny(head), dtype=jnp.float32)
    return bundle, jax.device_get(bundle.init(jax.random.PRNGKey(0)))


def _port_tiny(variables, head: str = "yolo"):
    bundle = build_detector(tiny_test_config(head), dtype=torch.float32,
                            device="cpu")
    bundle.model.load_state_dict(port_weights.state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    return bundle


def _gt_batch(seed=0, b=4, m=8):
    """Padded GT: 1–4 boxes an image, a garbage box in a padded row of
    image 0, and image 1 with no GT at all."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        if i == 1:
            continue
        n = rng.randint(1, 5)
        cxy = rng.uniform(0.2, 0.8, (n, 2))
        wh = rng.uniform(0.03, 0.5, (n, 2))
        boxes[i, :n] = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
        labels[i, :n] = rng.randint(1, 11, n)
        mask[i, :n] = True
    boxes[0, m - 1] = (0.1, 0.2, 0.6, 0.9)   # padding holding a box
    labels[0, m - 1] = 3
    return boxes, labels, mask


def _float_batch(seed=0, size=64):
    images = np.random.RandomState(seed + 100).uniform(
        -1, 1, (4, size, size, 3)).astype(np.float32)
    return (images, *_gt_batch(seed))


# ------------------------------------------------------------ anchors, codec


@pytest.mark.parametrize("which", ["yolo_mobilenet_384", "yolo_384_fitted",
                                   "yolo_tiny_64"])
def test_yolo_anchors_and_cell_sizes_bit_equal(which):
    from bdd100k_tpu.configs.detector_configs import apply_yolo_priors as jax_apply
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.ops import anchors as ref

    name = "yolo_mobilenet_384" if which == "yolo_384_fitted" else which
    cfg, jcfg = get_config(name), jax_config(name)
    if which == "yolo_384_fitted":
        cfg, jcfg = apply_yolo_priors(cfg, PRIORS_JSON), jax_apply(jcfg, PRIORS_JSON)
    assert cfg.yolo_priors == jcfg.yolo_priors
    assert cfg.num_anchors == jcfg.num_anchors
    got = port_anchors.yolo_anchors(cfg.yolo_grids, cfg.yolo_priors).numpy()
    want = np.asarray(ref.yolo_anchors(jcfg.yolo_grids, jcfg.yolo_priors))
    assert got.shape == want.shape == (cfg.num_anchors, 4)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_anchors.yolo_cell_sizes(cfg.yolo_grids, cfg.yolo_priors).numpy(),
        np.asarray(ref.yolo_cell_sizes(jcfg.yolo_grids, jcfg.yolo_priors)))
    if name == "yolo_mobilenet_384":
        assert cfg.num_anchors == 9072
    assert port_anchors.YOLO_BDD_PRIORS == ref.YOLO_BDD_PRIORS


def _codec_inputs(seed=0):
    cfg = get_config("yolo_mobilenet_384")
    anchors = port_anchors.yolo_anchors(cfg.yolo_grids, cfg.yolo_priors).numpy()
    cells = port_anchors.yolo_cell_sizes(cfg.yolo_grids, cfg.yolo_priors).numpy()
    rng = np.random.RandomState(seed)
    deltas = rng.normal(0, 1.5, (2, anchors.shape[0], 4)).astype(np.float32)
    cxy = rng.uniform(0, 1, (2, anchors.shape[0], 2))
    wh = rng.uniform(0.001, 0.8, (2, anchors.shape[0], 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    boxes[0, :50, 2:] = boxes[0, :50, :2]         # zero-size: the 1e-8 floor
    boxes[1, :50, 2] = boxes[1, :50, 0]           # zero width only
    return deltas, boxes, anchors, cells


def test_yolo_box_codec_matches_jax():
    from bdd100k_tpu.ops import boxes as ref

    deltas, boxes, anchors, cells = _codec_inputs()
    t = [torch.from_numpy(a) for a in (deltas, boxes, anchors, cells)]
    got = port_boxes.yolo_decode_boxes(t[0], t[2], t[3]).numpy()
    want = np.asarray(ref.yolo_decode_boxes(deltas, anchors, cells))
    np.testing.assert_allclose(got, want, rtol=0, atol=CODEC_ATOL)
    enc = port_boxes.yolo_encode_boxes(t[1], t[2], t[3]).numpy()
    want = np.asarray(ref.yolo_encode_boxes(boxes, anchors, cells))
    np.testing.assert_allclose(enc, want, rtol=0, atol=CODEC_ATOL)
    # the floor: log(1e-8 / w_a), finite, on both sides
    assert np.isfinite(enc).all()
    np.testing.assert_allclose(enc[0, :50, 2:],
                               np.log(np.float32(1e-8) / anchors[:50, 2:]),
                               rtol=1e-6)
    np.testing.assert_allclose(enc[1, :50, 2],
                               np.log(np.float32(1e-8) / anchors[:50, 2]),
                               rtol=1e-6)


def test_yolo_codec_round_trip():
    """encode(decode(t)) should give (σ(tx), σ(ty), tw, th), the σ-space
    targets. The trip goes through corner boxes, whose coordinates of size
    |x| keep a center only to ~eps·|x| (divided by the cell in σ-space)
    and a width w only to ~eps·|x|/w relative (in log space), and one ulp
    of exp's difference between the frameworks grows by as much. So the
    port's trip, the reference's and the ideal targets are held to 1e-6 +
    4·eps·|x| / (cell for xy, w for wh) of each other; decode and encode
    alone are held to 1e-6 above."""
    from bdd100k_tpu.ops import boxes as ref

    deltas, _, anchors, cells = _codec_inputs(1)
    d, a, c = (torch.from_numpy(x) for x in (deltas, anchors, cells))
    decoded = port_boxes.yolo_decode_boxes(d, a, c)
    back = port_boxes.yolo_encode_boxes(decoded, a, c).numpy()
    want = np.asarray(ref.yolo_encode_boxes(
        ref.yolo_decode_boxes(deltas, anchors, cells), anchors, cells))
    ideal = torch.cat([torch.sigmoid(d[..., :2]), d[..., 2:]], -1).numpy()
    corner = np.abs(decoded.numpy()).reshape(*decoded.shape[:-1], 2, 2).max(-2)
    corner = np.concatenate([corner, corner], -1)      # |x| for x and w, etc.
    wh = (decoded[..., 2:] - decoded[..., :2]).numpy()
    eps = np.finfo(np.float32).eps
    slack = CODEC_ATOL + 4 * eps * corner / np.concatenate(
        [np.broadcast_to(cells[:, None], wh.shape), wh], -1)
    for got in (back, want):
        assert (np.abs(got - ideal) <= slack).all()
    assert (np.abs(back - want) <= slack).all()


# ------------------------------------------------------------ forward, postprocess


def test_tiny_yolo_logits_match_jax():
    ref, variables = _jax_tiny()
    x = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    loc_ref, cls_ref = jax.jit(ref.apply)(variables, jnp.asarray(x))
    bundle = _port_tiny(variables)
    loc, cls = bundle.apply(torch.from_numpy(x))
    assert loc.shape == (2, 252, 4) and cls.shape == (2, 252, 11)
    np.testing.assert_allclose(loc.numpy(), np.asarray(loc_ref), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_ref), rtol=0,
                               atol=LOGIT_ATOL)
    assert bundle.cell_sizes is not None and bundle.cell_sizes.shape == (252,)


@pytest.mark.parametrize("which", ["tiny", "yolo_mobilenet_384"])
def test_yolo_postprocess_matches_jax(which):
    """Random logits through decode_mode="yolo" and sigmoid scoring; the
    logit scale gives some hundreds of candidates above the threshold."""
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.ops import anchors as ref_anchors
    from bdd100k_tpu.ops.postprocess import postprocess as ref_post

    name = "yolo_tiny_64" if which == "tiny" else which
    cfg, jcfg = get_config(name), jax_config(name)
    anchors = port_anchors.yolo_anchors(cfg.yolo_grids, cfg.yolo_priors)
    cells = port_anchors.yolo_cell_sizes(cfg.yolo_grids, cfg.yolo_priors)
    rng = np.random.RandomState(3)
    a = anchors.shape[0]
    loc = rng.normal(0, 1, (2, a, 4)).astype(np.float32)
    cls = rng.normal(-4, 2, (2, a, 11)).astype(np.float32)
    got = postprocess(torch.from_numpy(loc), torch.from_numpy(cls), anchors,
                      cfg.postprocess, cells)
    want = jax.device_get(ref_post(
        jnp.asarray(loc), jnp.asarray(cls),
        ref_anchors.yolo_anchors(jcfg.yolo_grids, jcfg.yolo_priors),
        jcfg.postprocess,
        ref_anchors.yolo_cell_sizes(jcfg.yolo_grids, jcfg.yolo_priors)))
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    v = want.valid
    assert v.sum() > 50
    np.testing.assert_array_equal(got.classes.numpy()[v], want.classes[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], want.boxes[v], rtol=0,
                               atol=DET_ATOL)
    np.testing.assert_allclose(got.scores.numpy()[v], want.scores[v], rtol=0,
                               atol=DET_ATOL)
    with pytest.raises(ValueError, match="needs cell_sizes"):
        postprocess(torch.from_numpy(loc), torch.from_numpy(cls), anchors,
                    cfg.postprocess)


# ------------------------------------------------------------ mining, loss


def test_mining_min_negatives_one_matches_jax():
    """YOLO mines with a floor of one negative: an image with no positive
    still contributes its hardest negative; tied losses keep anchor order."""
    from bdd100k_tpu.ops.mining import hard_negative_mask as ref

    rng = np.random.RandomState(4)
    loss = rng.rand(4, 300).astype(np.float32)
    loss[:, 100:140] = 0.5                        # ties
    positive = rng.rand(4, 300) < 0.02
    positive[1] = False                           # no positives: the floor
    positive[2, :4] = True
    got = hard_negative_mask(torch.from_numpy(loss), torch.from_numpy(positive),
                             3.0, min_negatives=1).numpy()
    want = np.asarray(ref(jnp.asarray(loss), jnp.asarray(positive), 3.0,
                          min_negatives=1))
    np.testing.assert_array_equal(got, want)
    assert got[1].sum() == 1 and got[1, np.argmax(loss[1])]


def _loss_inputs(name: str, seed=5):
    cfg = get_config(name)
    a = cfg.num_anchors
    rng = np.random.RandomState(seed)
    loc = rng.normal(0, 1, (4, a, 4)).astype(np.float32)
    cls = rng.normal(-2, 2, (4, a, 11)).astype(np.float32)
    return cfg, loc, cls, _gt_batch(seed)


@pytest.mark.parametrize("name", ["yolo_tiny_64", "yolo_mobilenet_384"])
def test_yolo_loss_and_detection_loss_match_jax(name):
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.models.losses import yolo_loss as ref_yolo_loss
    from bdd100k_tpu.ops.matching import MatchResult as RefMatch
    from bdd100k_tpu.parallel.train_step import detection_loss as ref_loss

    cfg, loc, cls, (gtb, gtl, gtm) = _loss_inputs(name)
    jb = jax_build(jax_config(name), dtype=jnp.float32)
    want = jax.jit(functools.partial(ref_loss, jb))(
        jnp.asarray(loc), jnp.asarray(cls), jnp.asarray(gtb), jnp.asarray(gtl),
        jnp.asarray(gtm))
    bundle = build_detector(cfg, dtype=torch.float32, device="cpu")
    t = [torch.from_numpy(x) for x in (loc, cls, gtb, gtl, gtm)]
    got = train_step.detection_loss(bundle, *t)
    for g, w, field in zip(got, want, ("total", "obj+cls", "loc")):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL, err_msg=field)
    # yolo_loss alone, both sides on the port's match and σ-space targets
    match = port_matching.encode_targets(t[2], t[3], t[4], bundle.anchors)
    assert not match.positive[1].any() and match.positive[0].any()
    matched = torch.gather(t[2], 1, match.matched_gt[..., None].expand(-1, -1, 4))
    sigma = port_boxes.yolo_encode_boxes(matched, bundle.anchors, bundle.cell_sizes)
    got = port_losses.yolo_loss(t[0], t[1], match, sigma)
    want = ref_yolo_loss(jnp.asarray(loc), jnp.asarray(cls),
                         RefMatch(*(jnp.asarray(x.numpy()) for x in match)),
                         jnp.asarray(sigma.numpy()))
    for g, w, field in zip(got, want, ("total", "obj+cls", "loc")):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL, err_msg=field)


def test_sigmoid_bce_is_optax_formula():
    import optax

    x = np.linspace(-30, 30, 241, dtype=np.float32)
    for y in (0.0, 1.0):
        got = port_losses.sigmoid_binary_cross_entropy(
            torch.from_numpy(x), torch.full(x.shape, y))
        want = optax.sigmoid_binary_cross_entropy(jnp.asarray(x), jnp.full(x.shape, y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------------------------ train step


@functools.lru_cache(maxsize=None)
def _jax_state():
    from bdd100k_tpu.configs import TrainConfig as JaxTrainConfig
    from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.parallel.train_step import create_train_state

    bundle = jax_build(jax_tiny("yolo"), dtype=jnp.float32)
    cfg = JaxTrainConfig(**{f: getattr(CFG, f) for f in (
        "batch_size", "max_boxes", "learning_rate", "warmup_steps", "total_steps")})
    return bundle, create_train_state(bundle, cfg, jax.random.PRNGKey(0))


def _flat(tree, prefix="", dtype=np.float32):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/", dtype))
        else:
            out[prefix + k] = np.asarray(v, dtype)
    return out


def _reference_f64_step() -> dict:
    """The reference's loss and gradients for the fixture batch evaluated
    in f64 throughout, its BatchNorm included (the reference pins
    BatchNorm to f32, so its module is swapped for one in f64): the
    rounding-free values both f32 steps approximate. Needs jax_enable_x64,
    so `make_fixture` runs it in a subprocess."""
    import types

    import flax.linen as fnn

    from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
    from bdd100k_tpu.models import layers as ref_layers
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.parallel.train_step import detection_loss

    assert jax.config.jax_enable_x64
    _, state = _jax_state()
    f64 = jnp.float64

    def batch_norm_f64(*args, **kw):
        return fnn.BatchNorm(*args, **{**kw, "dtype": f64, "param_dtype": f64})

    names = {k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("__")}
    ref_layers.nn = types.SimpleNamespace(**{**names, "BatchNorm": batch_norm_f64})
    bundle = jax_build(jax_tiny("yolo"), dtype=f64)
    cast = lambda t: jax.tree.map(lambda x: jnp.asarray(np.asarray(x), f64), t)  # noqa: E731
    params, stats = cast(jax.device_get(state.params)), cast(
        jax.device_get(state.batch_stats))
    images, gtb, gtl, gtm = _float_batch()

    def loss_fn(p):
        (loc, cls), _ = bundle.model.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(images, f64),
            train=True, mutable=["batch_stats"])
        lb = detection_loss(bundle, loc.astype(f64), cls.astype(f64),
                            jnp.asarray(gtb, f64), jnp.asarray(gtl),
                            jnp.asarray(gtm))
        return lb.total, lb

    (_, lb), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    grads = _flat(jax.device_get(grads), dtype=np.float64)
    out = {"f64/loss": lb.total, "f64/conf_loss": lb.conf, "f64/loc_loss": lb.loc,
           "f64/grad_norm": np.sqrt(sum(np.sum(g * g) for g in grads.values()))}
    # the gradients kept in f32: their rounding (6e-8) is far below the
    # tolerance they serve
    out.update({f"f64/grads/{k}": np.float32(g.ravel()[::STRIDE])
                for k, g in grads.items()})
    return {k: np.float64(v) if np.ndim(v) == 0 else v for k, v in out.items()}


def make_fixture():
    """The reference's f32 train step (loss, grad norm, every 4th element
    of each new param, the new BatchNorm statistics) and its f64
    evaluation of the same step (loss parts, grad norm, every 4th element
    of each gradient)."""
    import os
    import subprocess
    import tempfile

    from bdd100k_tpu.parallel.train_step import make_train_step

    bundle, state = _jax_state()
    step = make_train_step(bundle, donate=False)
    new, metrics = step(state, jax.random.PRNGKey(1),
                        *[jnp.asarray(a) for a in _float_batch()])
    out = {k: np.float32(v) for k, v in jax.device_get(metrics).items()}
    for k, v in _flat(jax.device_get(new.params)).items():
        out[f"params/{k}"] = v.ravel()[::STRIDE]
    for k, v in _flat(jax.device_get(new.batch_stats)).items():
        out[f"batch_stats/{k}"] = v
    with tempfile.TemporaryDirectory() as tmp:
        f64_path = Path(tmp) / "f64.npz"
        subprocess.run([sys.executable, __file__, "--f64-step", str(f64_path)],
                       check=True, env={**os.environ, "JAX_ENABLE_X64": "1",
                                        "JAX_PLATFORMS": "cpu"})
        with np.load(f64_path) as z:
            out.update({k: z[k] for k in z.files})
    np.savez_compressed(TRAIN_FIXTURE, **out)
    print(f"wrote {TRAIN_FIXTURE} ({TRAIN_FIXTURE.stat().st_size} bytes): "
          f"loss {float(out['loss']):.7f} (f32), {float(out['f64/loss']):.7f} "
          f"(f64); grad norm {float(out['grad_norm']):.4f} (f32), "
          f"{float(out['f64/grad_norm']):.4f} (f64)")


def _port_step_state():
    _, jstate = _jax_state()
    params = jax.device_get(jstate.params)
    stats = jax.device_get(jstate.batch_stats)
    bundle = build_detector(tiny_test_config("yolo"), dtype=torch.float32,
                            device="cpu")
    bundle.model.load_state_dict(port_weights.state_dict_from_flax(params, stats))
    return bundle, _flat(params)


def test_one_yolo_step_matches_jax_fixture():
    """The whole f32 step (forward in train mode, matcher, YOLO loss,
    backward, clip, decay, momentum, BatchNorm statistics) against the
    reference's f32 step, with tolerances for the reference's own f32
    BatchNorm rounding (see the module docstring)."""
    ref = np.load(TRAIN_FIXTURE)
    bundle, old = _port_step_state()
    state = train_step.create_train_state(bundle, CFG)
    step = train_step.make_train_step(bundle, device="cpu")
    metrics = step(state, None, *[torch.from_numpy(a) for a in _float_batch()])
    for k in ("loss", "conf_loss", "loc_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]), err_msg=k,
                                   rtol=STEP_RTOL[k])
    assert float(ref["grad_norm"]) > CFG.grad_clip_norm  # the clip was active
    new_params, new_stats = port_weights.flax_from_state_dict(
        bundle.model.state_dict())
    assert set(new_params) == set(old)
    assert any(k.startswith("head2/out") for k in new_params)
    for k, v in new_params.items():
        before = old[k].ravel()[::STRIDE]
        want = ref[f"params/{k}"] - before
        got = v.ravel()[::STRIDE] - before
        slack = UPDATE_REL * np.abs(want).max() + np.spacing(np.abs(before))
        assert (np.abs(got - want) <= slack).all(), k
    assert set(new_stats) == {k[len("batch_stats/"):] for k in ref.files
                              if k.startswith("batch_stats/")}
    for k, v in new_stats.items():
        np.testing.assert_allclose(v, ref[f"batch_stats/{k}"], rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


def test_one_yolo_step_matches_the_reference_in_f64():
    """The port's f32 loss and gradients against the reference's f64
    evaluation of the same step: the loss to 1e-6 relative, each gradient
    tensor to 1e-3 of its largest element."""
    ref = np.load(TRAIN_FIXTURE)
    bundle, old = _port_step_state()
    model = bundle.model.train()
    loc, cls = model(torch.from_numpy(_float_batch()[0]))
    lb = train_step.detection_loss(
        bundle, loc, cls, *[torch.from_numpy(a) for a in _float_batch()[1:]])
    lb.total.backward()
    for k, v in zip(("loss", "conf_loss", "loc_loss"), lb):
        np.testing.assert_allclose(float(v.detach()), float(ref[f"f64/{k}"]), err_msg=k,
                                   rtol=F64_RTOL[k])
    grads, _ = port_weights.flax_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})
    assert set(grads) == set(old)
    norm = np.sqrt(sum(np.sum(np.float64(g) ** 2) for g in grads.values()))
    np.testing.assert_allclose(norm, float(ref["f64/grad_norm"]),
                               rtol=F64_RTOL["grad_norm"])
    for k, g in grads.items():
        want = ref[f"f64/grads/{k}"]
        np.testing.assert_allclose(g.ravel()[::STRIDE], want, rtol=0,
                                   atol=F64_GRAD_REL * np.abs(want).max() + 1e-12,
                                   err_msg=k)


# ------------------------------------------------------------ priors


def test_apply_yolo_priors_matches_jax_and_refuses(tmp_path):
    from bdd100k_tpu.configs.detector_configs import apply_yolo_priors as jax_apply
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config

    cfg = apply_yolo_priors(get_config("yolo_mobilenet_384"), PRIORS_JSON)
    want = jax_apply(jax_config("yolo_mobilenet_384"), str(PRIORS_JSON))
    assert cfg.yolo_priors == want.yolo_priors and cfg.num_anchors == 9072
    assert cfg.yolo_priors[0][0] == (0.0234, 0.0431)
    with pytest.raises(ValueError, match="needs a YOLO config"):
        apply_yolo_priors(get_config("ssd_mobilenet_300"), PRIORS_JSON)
    two = tmp_path / "two.json"
    two.write_text(json.dumps(json.loads(PRIORS_JSON.read_text())[:2]))
    with pytest.raises(ValueError, match="has 2 scales"):
        apply_yolo_priors(get_config("yolo_tiny_64"), two)


def _label_shapes():
    from bdd100k_tpu_torch.data.bdd100k import load_bdd100k_labels

    records = load_bdd100k_labels(FIXTURES / "synth_val_seed1" / "labels" / "val.json")
    return records, port_priors.collect_box_shapes(records)


@pytest.mark.parametrize("seed,k", [(0, 9), (3, 6)])
def test_kmeans_priors_match_reference(seed, k):
    from bdd100k_tpu.data import priors as ref

    records, wh = _label_shapes()
    np.testing.assert_array_equal(wh, ref.collect_box_shapes(records))
    got, got_iou = port_priors.kmeans_priors(wh, k=k, seed=seed)
    want, want_iou = ref.kmeans_priors(wh, k=k, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got_iou == want_iou
    assert port_priors.priors_to_scales(got) == ref.priors_to_scales(want)
    pri = port_priors.priors_to_scales(got)
    assert port_priors.mean_best_iou(wh, pri) == ref.mean_best_iou(wh, pri)
    # a degenerate label set: every shape one box
    same = np.tile([[0.1, 0.2]], (20, 1))
    np.testing.assert_array_equal(port_priors.kmeans_priors(same, k=3, seed=seed)[0],
                                  ref.kmeans_priors(same, k=3, seed=seed)[0])
    with pytest.raises(ValueError, match="need ≥"):
        port_priors.kmeans_priors(wh[:k - 1], k=k)


def test_priors_cli_writes_what_apply_yolo_priors_reads(tmp_path, capsys):
    out = tmp_path / "priors.json"
    labels = FIXTURES / "synth_val_seed1" / "labels" / "val.json"
    priors = port_priors.main(["--labels", str(labels), "--out", str(out)])
    assert "mean best-IoU" in capsys.readouterr().out
    assert json.loads(out.read_text()) == [[list(p) for p in s] for s in priors]
    cfg = apply_yolo_priors(get_config("yolo_tiny_64"), out)
    assert cfg.yolo_priors == priors


# ------------------------------------------------------------ golden pipelines


# (image, slot): the golden detections at slots s and s+1 are one f32 ulp
# apart in score (near-ties between boxes of two classes, 1e-8 apart),
# inside the two frameworks' f32 disagreement, and the port orders them the
# other way. Each is undone by name before the comparison; any other flip
# fails.
GOLDEN_NEAR_TIE_SWAPS = {"ssd": ((2, 10), (2, 126)), "yolo": ()}


@pytest.mark.parametrize("head", ["ssd", "yolo"])
def test_golden_pipeline_outputs_on_the_port(head):
    """tests/test_golden.py's pipelines on the port: JPEG (the reference's
    decode) → preprocess → forward → postprocess, from the JAX PRNGKey(0)
    init, with the golden file's tolerances."""
    from bdd100k_tpu.data.pipeline import DetectionDataset

    golden = np.load(FIXTURES / f"golden_tiny_{head}.npz")
    dataset = DetectionDataset.from_bdd100k(FIXTURES / "labels.json", FIXTURES,
                                            max_boxes=16)
    assert len(dataset) == 4
    images = np.stack([dataset[i]["image"] for i in range(4)])
    _, variables = _jax_tiny(head)
    bundle = _port_tiny(variables, head)
    with torch.inference_mode():
        x = preprocess_eval_batch(torch.from_numpy(images), 64)
        det = bundle.postprocess(*bundle.model(x))
    boxes, scores, classes = (t.numpy().copy() for t in det[:3])
    for i, s in GOLDEN_NEAR_TIE_SWAPS[head]:
        assert abs(golden["scores"][i, s] - golden["scores"][i, s + 1]) < 1e-7
        assert classes[i, s] != classes[i, s + 1]
        for a in (boxes, scores, classes):
            a[i, [s, s + 1]] = a[i, [s + 1, s]]
    np.testing.assert_array_equal(det.valid.numpy(), golden["valid"])
    v = golden["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(classes[v], golden["classes"][v])
    np.testing.assert_allclose(scores[v], golden["scores"][v],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(boxes[v], golden["boxes"][v],
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ weights, entry points


def test_port_yolo_artifact_loads_in_jax_with_the_same_logits(tmp_path):
    from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
    from bdd100k_tpu.configs.train_configs import TrainConfig as JaxTrainConfig
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.parallel.train_step import create_train_state
    from bdd100k_tpu.utils.weights import load_into_state

    bundle = build_detector(tiny_test_config("yolo"), dtype=torch.float32,
                            device="cpu", seed=3)
    with torch.no_grad():  # move the BN statistics and head biases off init
        gen = torch.Generator().manual_seed(1)
        for name, buf in bundle.model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.add_(torch.rand(buf.shape, generator=gen))
        for name, p in bundle.model.named_parameters():
            if name.endswith("out.bias"):
                p.add_(torch.randn(p.shape, generator=gen))
    path = tmp_path / "yolo.npz"
    port_weights.save_detector_npz(path, bundle.model.state_dict(),
                                   config_name="yolo_tiny_64", step=5)
    jb = jax_build(jax_tiny("yolo"), dtype=jnp.float32)
    state = create_train_state(jb, JaxTrainConfig(), jax.random.PRNGKey(0))
    state, step = load_into_state(state, path, expect_config="yolo_tiny_64")
    assert step == 5
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    loc, cls = jax.jit(jb.model.apply)(
        {"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(x))
    sd, meta = port_weights.load_detector_npz(path, expect_config="yolo_tiny_64")
    assert meta["config"] == "yolo_tiny_64"
    bundle.model.load_state_dict(sd)
    with torch.inference_mode():
        ploc, pcls = bundle.model(torch.from_numpy(x))
    np.testing.assert_allclose(ploc.numpy(), np.asarray(loc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pcls.numpy(), np.asarray(cls), rtol=0, atol=1e-4)


def test_load_predictor_takes_yolo_and_priors(tmp_path):
    bundle = build_detector(tiny_test_config("yolo"), dtype=torch.float32,
                            device="cpu", seed=2)
    path = tmp_path / "yolo.npz"
    port_weights.save_detector_npz(path, bundle.model.state_dict(),
                                   config_name="yolo_tiny_64")
    frames = np.random.RandomState(0).randint(0, 256, (3, 72, 128, 3), np.uint8)
    dets = {}
    for name, priors in (("default", None), ("fitted", PRIORS_JSON)):
        pred = load_predictor("yolo_tiny_64", path, batch_size=4, device="cpu",
                              dtype=torch.float32, yolo_priors=priors)
        assert pred.bundle.cell_sizes is not None
        dets[name] = pred(frames)
        assert dets[name].boxes.shape == (3, 200, 4)
        assert np.isfinite(dets[name].boxes).all() and dets[name].valid.any()
    want = port_anchors.yolo_anchors((8, 4, 2), apply_yolo_priors(
        tiny_test_config("yolo"), PRIORS_JSON).yolo_priors)
    assert torch.equal(pred.bundle.anchors, want)
    # the same weights decode other boxes under other priors
    assert not np.array_equal(dets["default"].boxes, dets["fitted"].boxes)


@pytest.mark.parametrize("priors", [False, True], ids=["default", "fitted"])
def test_trainer_runs_yolo_tiny_on_the_cpu(tmp_path, priors):
    extra = ["--yolo_priors", str(PRIORS_JSON)] if priors else []
    state = port_train.main([
        "--config", "yolo_tiny_64", "--synthetic", "8", "--batch_size", "4",
        "--total_steps", "2", "--warmup_steps", "0", "--log_every", "1",
        "--ckpt_dir", str(tmp_path), "--device", "cpu", "--no_resume", *extra])
    assert state.step == 2
    recs = [json.loads(line) for line in
            (tmp_path / "train.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r[k]) for r in recs
               for k in ("loss", "conf_loss", "loc_loss", "grad_norm"))


if __name__ == "__main__":
    if "--make-fixture" in sys.argv:
        make_fixture()
    elif "--f64-step" in sys.argv:
        np.savez(sys.argv[sys.argv.index("--f64-step") + 1], **_reference_f64_step())
    else:
        sys.exit(pytest.main([__file__, "-q"]))
