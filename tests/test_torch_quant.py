"""The port's int8 quant layers and calibration against the JAX
reference, on the CPU (the tiny models: tests/test_torch_quant_models.py;
the flagship evals: tests/test_torch_quant_eval.py).

* `QuantConv` (models/layers.py) against the reference's, dynamic and
  static, at stride 2, dilation 6, VALID and 1×1, single and chained
  `emit_int8`: with the same input and the same amax, the activation
  codes, weight codes, scales and int32 accumulators are equal (atol 0)
  and the f32 outputs bit-equal. The reference runs jitted, as its
  entry points run it: XLA turns its "/ 127" of the scales into multiplies by
  f32(1/127), reassociates the scale products and fuses the epilogue's
  multiply-add, and the port computes the same (an eager call of the
  reference divides, and a weight code or two a layer differs). Its codes
  and accumulators are read by an ordered host callback wrapped around
  its own `jax.lax.conv_general_dilated` call (int32 accumulation only),
  the port's by wrapping `int8_conv2d`;
* `max_pool_q` on codes, and `static_quant_matches_dynamic` (the
  reference's own check, ported);
* `calibrate` and its zero-batch refusal, and the calibration helpers
  byte-equal to the reference's: `calibration_batches_from_dataset` (the
  reference's cv2 route at 300, 384 and 512 on the 64 seed-1 JPEGs) and
  `calibration_batches_from_images` (PIL's route, on JPEGs and PNGs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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

from bdd100k_tpu_torch.configs import tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.data.pipeline import DetectionDataset  # noqa: E402
from bdd100k_tpu_torch.models import layers as port_layers  # noqa: E402
from bdd100k_tpu_torch.models import quant as port_quant  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.utils import weights as port_weights  # noqa: E402

# two torch threads: the suite runs these files beside JAX workers
torch.set_num_threads(2)

FIXTURES = ROOT / "tests" / "fixtures"
SYNTH = FIXTURES / "synth_val_seed1"
LABELS = SYNTH / "labels" / "val.json"
IMAGES = SYNTH / "images" / "val"


# ---------------------------------------------------------------- spies


@contextlib.contextmanager
def reference_int8_convs():
    """Record (codes, weight codes, int32 accumulator) of every int8 conv
    the reference runs, NHWC / HWIO as it holds them, in order (an
    ordered host callback, so a jitted call records too)."""
    seen = []
    real = jax.lax.conv_general_dilated

    def record(*arrays):
        seen.append(tuple(np.asarray(a) for a in arrays))

    def spy(*args, **kw):
        out = real(*args, **kw)
        if kw.get("preferred_element_type") == jnp.int32:
            jax.debug.callback(record, args[0], args[1], out, ordered=True)
        return out

    jax.lax.conv_general_dilated = spy
    try:
        yield seen
    finally:
        jax.lax.conv_general_dilated = real


@contextlib.contextmanager
def port_int8_convs():
    """The same record of the port's `int8_conv2d` calls, in the
    reference's layouts."""
    seen = []
    real = port_layers.int8_conv2d

    def spy(x_q, w_q, *args):
        out = real(x_q, w_q, *args)
        seen.append((x_q.permute(0, 2, 3, 1).numpy(),
                     w_q.permute(2, 3, 1, 0).numpy(),
                     out.permute(0, 2, 3, 1).numpy()))
        return out

    port_layers.int8_conv2d = spy
    try:
        yield seen
    finally:
        port_layers.int8_conv2d = real


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------- QuantConv

# name → (static, emit, stride, padding, dilation, kernel, spatial size)
CONV_CASES = {
    "dynamic": (False, False, 1, "SAME", 1, 3, 13),
    "static": (True, False, 1, "SAME", 1, 3, 13),
    "static_emit": (True, True, 1, "SAME", 1, 3, 13),
    "dynamic_stride2": (False, False, 2, "SAME", 1, 3, 13),
    "static_stride2_valid": (True, False, 2, "VALID", 1, 3, 13),
    "static_emit_dilation6": (True, True, 1, "SAME", 6, 3, 19),
    "dynamic_1x1": (False, False, 1, "SAME", 1, 1, 13),
    "static_valid_3_to_1": (True, False, 1, "VALID", 1, 3, 3),
}


def _ref_quantconv(static, emit, stride, padding, dil, k, x, cout, dtype):
    from bdd100k_tpu.models.layers import QuantConv as RefQuantConv

    return RefQuantConv(cout, (k, k), strides=(stride, stride), padding=padding,
                        kernel_dilation=(dil, dil), use_bias=True, dtype=dtype,
                        static_act=static, emit_int8=emit)


def _jit_apply(mod, variables, x, **kw):
    """`mod.apply` jitted → its output, with `.seen`, the int8 convs it
    ran, when it returns one array or an Int8Act."""
    with reference_int8_convs() as seen:
        out = jax.device_get(jax.jit(functools.partial(mod.apply, **kw))(
            variables, jnp.asarray(x)))
        jax.effects_barrier()
    if isinstance(out, tuple):  # Int8Act
        res = type(out)(*out)
        return types.SimpleNamespace(codes=res.codes, scale=res.scale, seen=seen)
    return types.SimpleNamespace(array=out, seen=seen)


def _port_quantconv(mod_args, params, quant, dtype):
    static, emit, stride, padding, dil, k, cin, cout = mod_args
    pm = port_layers.QuantConv(cin, cout, k, stride, padding, bias=True,
                               dtype=dtype, dilation=dil, static_act=static,
                               emit_int8=emit)
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(params["kernel"].transpose(3, 2, 0, 1))))
        pm.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    if static:
        pm.act_amax.fill_(float(quant["act_amax"]))
        if emit:
            pm.out_amax.fill_(float(quant["out_amax"]))
    return pm


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_quantconv_matches_the_reference(case):
    static, emit, stride, padding, dil, k, hw = CONV_CASES[case]
    cin, cout = 16, 24
    rng = np.random.RandomState(0)
    x = (rng.randn(2, hw, hw, cin) * 3).astype(np.float32)
    mod = _ref_quantconv(static, emit, stride, padding, dil, k, x, cout,
                         jnp.float32)
    v = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = {"kernel": np.asarray(v["params"]["kernel"]),
              "bias": (rng.randn(cout) * 0.1).astype(np.float32)}
    quant = None
    if static:  # calibrate on x itself: both maxima are real
        _, muts = jax.jit(functools.partial(mod.apply, mutable=["quant"]))(
            {"params": params, "quant": v["quant"]}, jnp.asarray(x))
        quant = jax.device_get(muts["quant"])
    variables = {"params": params, **({"quant": quant} if static else {})}
    want = _jit_apply(mod, variables, x)
    ref_seen = want.seen
    pm = _port_quantconv((static, emit, stride, padding, dil, k, cin, cout),
                         params, quant, torch.float32)
    with torch.no_grad(), port_int8_convs() as seen:
        got = pm(_nchw(x))
    (x_q, w_q, acc), (rx, rw, racc) = seen[0], ref_seen[0]
    np.testing.assert_array_equal(x_q, rx)
    np.testing.assert_array_equal(w_q, rw)
    np.testing.assert_array_equal(acc, racc)
    assert acc.dtype == np.int32 and np.abs(acc).max() > 2 ** 14
    if emit:
        np.testing.assert_array_equal(_nhwc(got.codes), np.asarray(want.codes))
        assert got.codes.dtype == torch.int8
        assert float(got.scale) == float(want.scale)
    else:
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want.array))
        if static:  # the calibrating pass: the same running max
            pm.act_amax.zero_()
            pm.calibrating = True
            pm(_nchw(x))
            assert float(pm.act_amax) == float(quant["act_amax"])


def test_static_quantconv_in_bf16_quantizes_in_bf16():
    """Static quantization multiplies in the input's type: bf16 codes and
    the f32 inverse of the bf16 multiplier, as the reference's."""
    static, emit, stride, padding, dil, k, hw = CONV_CASES["static"]
    rng = np.random.RandomState(4)
    x = (rng.randn(2, hw, hw, 16) * 3).astype(np.float32)
    mod = _ref_quantconv(True, False, 1, "SAME", 1, 3, x, 24, jnp.bfloat16)
    v = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = {"kernel": np.asarray(v["params"]["kernel"]),
              "bias": np.zeros(24, np.float32)}
    quant = {"act_amax": np.float32(7.3)}
    xb = jnp.asarray(x, jnp.bfloat16)
    ref_seen = _jit_apply(mod, {"params": params, "quant": quant}, xb).seen
    pm = _port_quantconv((True, False, 1, "SAME", 1, 3, 16, 24), params, quant,
                         torch.bfloat16)
    xt = _nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    x_q, s = pm.quantize_input(xt)
    np.testing.assert_array_equal(_nhwc(x_q), ref_seen[0][0])
    inv = np.float32(np.float32(127.0) / np.float32(7.3))
    inv = np.asarray(jnp.asarray(inv).astype(jnp.bfloat16).astype(jnp.float32))
    assert float(s) == float(np.float32(np.float32(1.0) / inv) * np.float32(1 / 127))


@pytest.mark.parametrize("emit_out", [True, False], ids=["emit_out", "dequant_out"])
def test_emit_int8_chain_matches_the_reference(emit_out):
    """A VGG block of three static convs: the first two emit codes into
    the next, the last emits (emit_out) or dequantizes. Calibrated on the
    same batch, every stage's codes and accumulators are equal, and the
    block's output too."""
    from bdd100k_tpu.models.layers import VGGConvBlock as RefBlock

    rng = np.random.RandomState(1)
    x = np.maximum(rng.randn(2, 12, 12, 8), 0).astype(np.float32)
    ref = RefBlock(16, 3, jnp.float32, "int8_static", emit_out=emit_out)
    v = ref.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = jax.device_get(v["params"])
    _, muts = jax.jit(functools.partial(ref.apply, mutable=["quant"]))(
        {"params": params, "quant": v["quant"]}, jnp.asarray(x))
    quant = jax.device_get(muts["quant"])
    want = _jit_apply(ref, {"params": params, "quant": quant}, x)
    ref_seen = want.seen
    block = port_layers.VGGConvBlock(8, 16, 3, torch.float32, "int8_static",
                                     emit_out=emit_out)
    block.load_state_dict(port_weights.state_dict_from_flax(params, {}))
    # the port calibrates to the same maxima on the same batch
    port_quant.calibrate(types.SimpleNamespace(
        model=block, anchors=torch.zeros(1),
        config=types.SimpleNamespace(image_size=12)), [_nchw(x)])
    state = port_quant.quant_state(block)
    assert state == {k: v for k, v in port_weights.quant_state_from_flax(
        quant).items()}
    with torch.no_grad(), port_int8_convs() as seen:
        got = block(_nchw(x))
    assert len(seen) == len(ref_seen) == 3
    for (a, b, c), (ra, rb, rc) in zip(seen, ref_seen):
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(b, rb)
        np.testing.assert_array_equal(c, rc)
    if emit_out:
        assert isinstance(got, port_layers.Int8Act)
        np.testing.assert_array_equal(_nhwc(got.codes), np.asarray(want.codes))
        assert float(got.scale) == float(want.scale)
    else:
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want.array))


@pytest.mark.parametrize("window,stride,size", [(2, 2, 9), (2, 2, 8), (3, 1, 7)])
def test_max_pool_q_pools_the_codes_as_the_reference(window, stride, size):
    from bdd100k_tpu.models.layers import Int8Act as RefAct
    from bdd100k_tpu.models.layers import max_pool_q as ref_pool

    codes = np.random.RandomState(size).randint(0, 128, (2, size, size, 5)).astype(np.int8)
    want = ref_pool(RefAct(jnp.asarray(codes), jnp.float32(0.25)),
                    (window, window), (stride, stride))
    got = port_layers.max_pool_q(
        port_layers.Int8Act(_nchw(codes), torch.tensor(0.25)), window, stride)
    assert got.codes.dtype == torch.int8
    np.testing.assert_array_equal(_nhwc(got.codes), np.asarray(want.codes))
    assert float(got.scale) == 0.25
    x = np.random.RandomState(0).randn(1, size, size, 3).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(port_layers.max_pool_q(_nchw(x), window, stride)),
        np.asarray(ref_pool(jnp.asarray(x), (window, window), (stride, stride))))


def test_static_quant_matches_dynamic_on_calibration_batch():
    """int8_static calibrated on batch X reproduces dynamic int8 on X (the
    reference's own check, tests/test_quant.py, with its tolerance): in
    f32 the frozen running max of each layer equals the amax the dynamic
    branch takes, so every layer's codes are equal; the logits differ by
    the last bits of the two dequant scales, which XLA folds differently
    (m · f32(1/127)² against (1 / f32(127 / m)) · f32(1/127))."""
    cfg = tiny_test_config("ssd")
    dyn = build_detector(dataclasses.replace(cfg, quant="int8"),
                         dtype=torch.float32, device="cpu")
    st = build_detector(dataclasses.replace(cfg, quant="int8_static"),
                        dtype=torch.float32, device="cpu")
    assert [k for k, _ in dyn.model.named_parameters()] == \
        [k for k, _ in st.model.named_parameters()]
    st.model.load_state_dict(dyn.model.state_dict())
    zero = port_quant.init_quant_vars(st)
    assert zero and all(float(v) == 0.0 for v in zero.values())
    assert port_quant.init_quant_vars(dyn) is None
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    state = port_quant.calibrate(st, [x])
    assert all(float(v) > 0 for v in state.values())
    with torch.inference_mode(), port_int8_convs() as seen_dyn:
        want = dyn.model(x)
    with torch.inference_mode(), port_int8_convs() as seen_st:
        got = st.model(x)
    assert len(seen_dyn) == len(seen_st) > 3
    for (a, _, c), (ra, _, rc) in zip(seen_st, seen_dyn):
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(c, rc)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_calibrate_refuses_zero_batches():
    st = build_detector(dataclasses.replace(tiny_test_config("ssd"),
                                            quant="int8_static"),
                        dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="zero batches"):
        port_quant.calibrate(st, [])
    none = build_detector(tiny_test_config("ssd"), dtype=torch.float32, device="cpu")
    assert port_quant.calibrate(none, [torch.zeros(1, 64, 64, 3)]) is None


# ------------------------------------------------------- calibration data


@pytest.mark.parametrize("size", [300, 384, 512])
def test_calibration_batches_from_dataset_equal_the_reference(size):
    """The eval set's head as the reference's `dataset[i]["image"]`
    decodes it on this host (cv2: IMREAD_REDUCED_COLOR_2 at 300, a full
    decode at 384 and 512, then INTER_LINEAR), 64 JPEGs in 8 batches."""
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.models.quant import calibration_batches_from_dataset as ref_batches

    ref = ref_batches(RefDataset.from_bdd100k(LABELS, IMAGES, decode_size=size))
    got = port_quant.calibration_batches_from_dataset(
        DetectionDataset.from_bdd100k(LABELS, IMAGES, decode_size=size))
    assert len(got) == len(ref) == 8
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)
    ds = DetectionDataset.from_bdd100k(LABELS, IMAGES, decode_size=size)
    ds.records = ds.records[:11]  # a partial tail pads with its last image
    batches = port_quant.calibration_batches_from_dataset(ds, num_batches=3)
    assert [b.shape[0] for b in batches] == [8, 8]
    np.testing.assert_array_equal(batches[1][3:], np.repeat(batches[1][2:3], 5, 0))


def _calibration_dir(tmp_path) -> Path:
    """Three JPEGs, a palette PNG, an RGBA PNG and a file that is neither."""
    from PIL import Image

    d = tmp_path / "calib"
    d.mkdir()
    jpegs = sorted(IMAGES.glob("*.jpg"))
    for p in jpegs[:3]:
        (d / p.name).symlink_to(p)
    with Image.open(jpegs[3]) as im:
        im.convert("P", palette=Image.ADAPTIVE, colors=64).save(d / "frame_p.png")
    with Image.open(jpegs[4]) as im:
        rgba = im.convert("RGBA").resize((640, 360))
        rgba.putalpha(128)
        rgba.save(d / "frame_rgba.PNG")
    (d / "notes.txt").write_text("not an image")
    return d


@pytest.mark.parametrize("size", [300, 384])
def test_calibration_batches_from_images_equal_the_reference(tmp_path, size):
    """PIL's route: open, convert("RGB"), resize((s, s)) with its default
    bicubic; JPEGs and PNGs (one of another size), the tail padded."""
    from bdd100k_tpu.models.quant import calibration_batches_from_images as ref_batches

    d = _calibration_dir(tmp_path)
    want = ref_batches(d, size)
    got = port_quant.calibration_batches_from_images(d, size)
    assert len(got) == len(want) == 1 and got[0].shape == (8, size, size, 3)
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(SystemExit, match="no images"):
        port_quant.calibration_batches_from_images(tmp_path / "calib" / "..", size)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
