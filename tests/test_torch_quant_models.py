"""Quantized tiny models of the port against the JAX reference, on the
CPU: an SSD at 96² (its extra stage reaches a 1×1 map through a VALID
conv), the tiny YOLO and VGG16-SSD at 64², each in int8 and int8_static,
from the reference's init.

Calibration gives the same maxima, and on the reference's frozen maxima
(its `quant` collection carried across) the f32 logits agree. Codes that
flip between the two are counted and held to TINY_MODELS' measured
counts. They start where a float conv sums in another order than XLA's
and a product lands within an ulp of .5: none do in five of the six
models, which agree within LOGIT_ATOL. In VGG's int8_static pipeline one
such flip at the input of block2's first conv (after block1's float
convs) spreads, because every emitting conv rounds its output again:
27434 of 1.03 M codes flip by the head, the logits move up to 0.063 and
the calibration maxima up to 2.2 %. The pipeline itself is exact on
equal inputs (tests/test_torch_quant.py::
test_emit_int8_chain_matches_the_reference). The reference's `quant`
collection also carries into the port and back unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
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

from bdd100k_tpu_torch.configs import get_config, tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.models import quant as port_quant  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.ops.anchors import make_ssd_feature_maps  # noqa: E402
from bdd100k_tpu_torch.utils import weights as port_weights  # noqa: E402
from test_torch_quant import port_int8_convs, reference_int8_convs  # noqa: E402

# two torch threads: the suite runs these files beside JAX workers
torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
CALIB_RTOL = 1e-5


def _tiny(kind: str, quant: str, jax_side: bool):
    """(config) of the tiny models: SSD at 96² with an extra stage to a 1×1
    map (3×3 VALID), tiny YOLO, VGG16-SSD at 64²."""
    if jax_side:
        from bdd100k_tpu.configs.detector_configs import get_config as gc
        from bdd100k_tpu.configs.detector_configs import tiny_test_config as tc
        from bdd100k_tpu.ops.anchors import make_ssd_feature_maps as fm
    else:
        gc, tc, fm = get_config, tiny_test_config, make_ssd_feature_maps
    if kind == "ssd96":
        cfg = dataclasses.replace(tc("ssd"), name="ssd_tiny_96", image_size=96,
                                  feature_maps=fm((12, 6, 3, 1), (4, 6, 6, 4)))
    elif kind == "yolo":
        cfg = tc("yolo")
    else:
        cfg = dataclasses.replace(gc("ssd_vgg16_512"), name="ssd_vgg16_64",
                                  image_size=64,
                                  feature_maps=fm((8, 4, 2, 1), (4, 6, 6, 4)))
    return dataclasses.replace(cfg, quant=quant)


@functools.lru_cache(maxsize=None)
def _reference_tiny(kind: str, quant: str):
    """The reference's tiny model in f32: bundle, its PRNGKey(0) variables
    and two batches (a calibration batch and another)."""
    from bdd100k_tpu.models.detector import build_detector as jax_build

    bundle = jax_build(_tiny(kind, quant, True), dtype=jnp.float32)
    variables = jax.device_get(bundle.init(jax.random.PRNGKey(0)))
    s = bundle.config.image_size
    rng = np.random.RandomState(7)
    batches = [rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32) for _ in range(2)]
    return bundle, variables, batches


# (kind, quant) → (codes that flip between the port and the reference over
# the whole model on the second batch, logit atol, calibration rtol), as
# measured on the CPU; see the module docstring for VGG's int8_static
TINY_MODELS = {
    ("ssd96", "int8"): (0, LOGIT_ATOL, 0.0),
    ("ssd96", "int8_static"): (0, LOGIT_ATOL, CALIB_RTOL),
    ("yolo", "int8"): (0, LOGIT_ATOL, 0.0),
    ("yolo", "int8_static"): (0, LOGIT_ATOL, CALIB_RTOL),
    ("vgg64", "int8"): (0, LOGIT_ATOL, 0.0),
    ("vgg64", "int8_static"): (27434, 0.07, 0.03),
}


@pytest.mark.parametrize("kind,quant", sorted(TINY_MODELS))
def test_tiny_quantized_models_match_the_reference(kind, quant):
    from bdd100k_tpu.models.quant import calibrate as ref_calibrate

    max_flips, logit_atol, calib_rtol = TINY_MODELS[kind, quant]
    ref, variables, (calib, x) = _reference_tiny(kind, quant)
    params, stats = variables["params"], variables.get("batch_stats", {})
    bundle = build_detector(_tiny(kind, quant, False), dtype=torch.float32,
                            device="cpu")
    bundle.model.load_state_dict(port_weights.state_dict_from_flax(params, stats))
    apply_vars = {"params": params, **({"batch_stats": stats} if stats else {})}
    if quant == "int8_static":
        want_q = jax.device_get(ref_calibrate(ref, params, stats, [calib]))
        got_q = port_quant.calibrate(bundle, [calib])
        ref_state = port_weights.quant_state_from_flax(want_q)
        assert set(got_q) == set(ref_state) and len(got_q) > 3
        for name, v in ref_state.items():
            np.testing.assert_allclose(float(got_q[name]), float(v),
                                       rtol=calib_rtol, err_msg=name)
        # run both on the reference's frozen maxima
        port_quant.load_quant_state(bundle.model, ref_state)
        apply_vars["quant"] = want_q
    with reference_int8_convs() as ref_seen:
        jloc, jcls = jax.jit(functools.partial(ref.model.apply, train=False))(
            apply_vars, jnp.asarray(x))
        jax.effects_barrier()
    with torch.inference_mode(), port_int8_convs() as seen:
        loc, cls = bundle.model(torch.from_numpy(x))
    assert len(seen) == len(ref_seen) > 3
    flips = 0
    for (a, b, _), (ra, rb, _) in zip(seen, ref_seen):
        np.testing.assert_array_equal(b, rb)
        flips += int((a != ra).sum())
    assert flips <= max_flips, flips
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0, atol=logit_atol)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=0, atol=logit_atol)


def test_quant_collection_carries_across_and_back():
    """The reference's `quant` collection → the port's quant state → a
    model → back, unchanged; a state that misses or adds a layer is
    refused."""
    from bdd100k_tpu.models.quant import calibrate as ref_calibrate

    ref, variables, (calib, _) = _reference_tiny("vgg64", "int8_static")
    want = jax.device_get(ref_calibrate(ref, variables["params"],
                                       variables["batch_stats"], [calib]))
    state = port_weights.quant_state_from_flax(want)
    assert any(k.endswith("out_amax") for k in state)
    bundle = build_detector(_tiny("vgg64", "int8_static", False),
                            dtype=torch.float32, device="cpu")
    port_quant.load_quant_state(bundle.model, state)
    back = port_weights.flax_from_quant_state(port_quant.quant_state(bundle.model))
    flat = port_weights._flatten
    assert flat(back).keys() == flat(want).keys()
    for k, v in flat(want).items():
        assert float(flat(back)[k]) == float(v), k
    with pytest.raises(ValueError, match="missing"):
        port_quant.load_quant_state(bundle.model, dict(list(state.items())[1:]))
    with pytest.raises(ValueError, match="unexpected"):
        port_quant.load_quant_state(bundle.model,
                                    {**state, "extra1.act_amax": torch.tensor(1.0)})




if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
