"""The port's serving surface against the JAX reference, on the CPU.

* the host resize (`data/host_resize.py`) bit-equal to
  `cv2.resize(INTER_LINEAR)` on downscales from 1280×720 and 1920×1080 to
  300, 384 and 512, on exact 2× downscales (cv2's 2×2-mean path), and on
  upscales and odd sizes, where the share of bytes that differ, measured
  0, is asserted 0;
* the pool's `resize_yuv420_batch` through the port's binding, byte-equal
  to the reference's binding of the same C source;
* the full-resolution decode (`decode_full`) sha256-equal to PIL's
  `Image.open(p).convert("RGB")` on the 64 seed-1 JPEGs and the four train
  fixtures, and `DetectionDataset(decode_size=None)` batches equal to the
  reference's PIL route;
* `Predictor` at `tiny_test_config("ssd")` from the reference's init,
  against the reference's `Predictor`, for host resize on and off and
  both wires;
* the CLI (`python -m bdd100k_tpu_torch.infer --device cpu --dtype
  float32`) with SSD300 on 8 of the JPEGs and on one image at full
  resolution: its printed lines equal the reference CLI's lines in f32
  from `tests/fixtures/torch_ref_infer_cli.json` (same images, classes and
  count above --score_threshold 0.4; scores and corners within one step of
  the printed third decimal, measured equal); `--video` exits non-zero
  with its reason; a JPEG that fails to decode on the producer thread
  exits non-zero; `--out_dir` writes `det_<name>` in the input's format,
  a JPEG as PIL's quality-75 save of the drawn frame, byte for byte;
* int8 and PNG input: `--quant int8_static --calib_images
  tests/fixtures/calib_mixed` (two JPEGs and three PNGs: palette, RGBA and
  16-bit grey) over 8 JPEGs, `--quant int8` on one PNG at full
  resolution, and a directory holding a PNG with `--host_resize off`
  (PIL's route, which reads it) against the reference CLI's lines; with
  host resize on, the pool takes the bytes and the PNG fails its batch,
  as it does in the reference (pinned in the fixture); `load_predictor`
  in int8_static on the SSD300 artifact gives the int8 eval fixture's
  detections;
* the drawing: box outlines equal `cv2.rectangle(thickness=2)`'s pixels,
  on the border too, and the PNG writer's file reads back in PIL as the
  same array.

The fixture holds the reference CLI's lines (`bdd100k_tpu.infer.main`,
its detector built in f32: the reference's CLI has no dtype flag and runs
in bf16, whose rounding moves printed scores by up to 0.03, far past the
third decimal) for SSD300, YOLO-384 and VGG16-SSD512 on their synth9k
artifacts over the 64 JPEGs at --batch_size 32 on the default (yuv420)
wire, `--wire rgb` and `--host_resize off`, its `--image` lines for
image 0, and under "int8" the SSD300 lines of the int8 and PNG runs
above. The card's check (`chip_smoke.py`) holds the port's CLI on the
card to all of them. Regenerate it with `python tests/test_torch_infer_cli.py
--make-fixture`.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import subprocess
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
from bdd100k_tpu_torch import infer as port_infer  # noqa: E402
from bdd100k_tpu_torch.configs import tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.data import pipeline as port_pipeline  # noqa: E402
from bdd100k_tpu_torch.data.host_resize import resize_linear  # noqa: E402
from bdd100k_tpu_torch.data.native_decode import NativeDecoder, decode_full  # noqa: E402
from bdd100k_tpu_torch.data.synthetic import generate_synthetic_scenes  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.utils import viz  # noqa: E402
from bdd100k_tpu_torch.utils.weights import state_dict_from_flax  # noqa: E402

# two torch threads: the suite runs these files beside JAX workers
torch.set_num_threads(2)

FIXTURES = ROOT / "tests" / "fixtures"
IMAGES = FIXTURES / "synth_val_seed1" / "images" / "val"
CLI_FIXTURE = FIXTURES / "torch_ref_infer_cli.json"
CALIB_DIR = FIXTURES / "calib_mixed"
PNG_IMAGE = CALIB_DIR / "train_00003_rgba.png"
ARTIFACTS = ROOT / "artifacts"
CONFIGS = {
    "ssd_mobilenet_300": ARTIFACTS / "ssd_mobilenet_300_synth9k.npz",
    "yolo_mobilenet_384": ARTIFACTS / "yolo_mobilenet_384_synth9k.npz",
    "ssd_vgg16_512": ARTIFACTS / "ssd_vgg16_512_synth9k.npz",
}
# the directory sweep's modes: name → extra CLI flags
MODES = {"yuv420": [], "rgb": ["--wire", "rgb"],
         "host_resize_off": ["--host_resize", "off"]}
CLI_BATCH = 32
CPU_IMAGES = 8
LINE_TOL = 1e-3 + 1e-6  # one step of the printed third decimal
# int8: the frameworks' f32 summation orders flip a few codes, and the
# flips cascade (tests/test_torch_quant_eval.py measured confident
# detections moving up to 0.0175), so int8 lines agree to this, and a line
# this close to the threshold may print on one side only
INT8_LINE_TOL = 0.02
THRESHOLD = 0.4
DET_ATOL = 1e-4


def _jpegs() -> list[Path]:
    return sorted(IMAGES.glob("*.jpg"))


# ------------------------------------------------------------ host resize


def _decoded(i: int = 0) -> np.ndarray:
    return decode_full(_jpegs()[i].read_bytes())


def _noise(h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)


RESIZE_CASES = {
    **{f"720p_scene_to_{s}": (lambda: _decoded(), s, s) for s in (300, 384, 512)},
    **{f"1080p_to_{s}": (lambda: _noise(1080, 1920), s, s) for s in (300, 384, 512)},
    "2x_1024_to_512": (lambda: _noise(1024, 1024, 1), 512, 512),
    "2x_768_to_384": (lambda: _noise(768, 768, 2), 384, 384),
    "2x_720p_to_360x640": (lambda: _noise(720, 1280, 3), 360, 640),
    "up_375x500_to_384": (lambda: _noise(375, 500, 4), 384, 384),
    "up_375x500_to_512": (lambda: _noise(375, 500, 5), 512, 512),
    "odd_97x131_to_61x77": (lambda: _noise(97, 131, 6), 61, 77),
    "up_7x9_to_31x17": (lambda: _noise(7, 9, 7), 31, 17),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_host_resize_bit_equal_to_cv2(case):
    import cv2

    make, h, w = RESIZE_CASES[case]
    src = make()
    want = cv2.resize(src, (w, h), interpolation=cv2.INTER_LINEAR)
    got = resize_linear(np.stack([src, src[::-1]]), h, w)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(
        got[1], cv2.resize(src[::-1].copy(), (w, h), interpolation=cv2.INTER_LINEAR))


def test_resize_yuv420_batch_equals_the_reference_binding():
    frames = np.stack([_decoded(i) for i in range(3)])
    ref, port = ref_pool().NativeDecoder(2), NativeDecoder(2)
    try:
        for src, size in ((frames, 300), (frames, 512), (frames[:, :-1, :-3], 384)):
            want = ref.resize_yuv420_batch(src, size)
            got = port.resize_yuv420_batch(src, size)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        with pytest.raises(ValueError, match="even"):
            port.resize_yuv420_batch(frames, 301)
    finally:
        port.close()


# ------------------------------------------------------- full-res decode


def test_full_resolution_decode_sha256_equals_pil():
    from PIL import Image

    paths = _jpegs() + sorted(FIXTURES.glob("synthetic_train_*.jpg"))
    assert len(paths) == 68
    assert json.loads(CLI_FIXTURE.read_text())["full_res_sha256"] == _pil_sha256s()
    for p in paths:
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB"))
        got = decode_full(p.read_bytes())
        assert got.shape == want.shape == (720, 1280, 3)
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            hashlib.sha256(want.tobytes()).hexdigest(), p.name


def test_full_resolution_decode_refuses_garbage():
    with pytest.raises(ValueError):
        decode_full(b"\xff\xd8 not a jpeg")
    data = _jpegs()[0].read_bytes()
    with pytest.raises(ValueError):
        decode_full(data[:2])


def test_full_resolution_loader_matches_reference():
    """`DetectionDataset(decode_size=None)` through `make_loader`: the
    reference's PIL route (a thread pool over `__getitem__`), batch for
    batch, the padded final batch included; a JPEG of another size is
    resized to 720×1280."""
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.data.pipeline import make_loader as ref_loader

    labels = FIXTURES / "synth_val_seed1" / "labels" / "val.json"
    ds = port_pipeline.DetectionDataset.from_bdd100k(labels, IMAGES)
    ds.records = ds.records[:5]
    ref = RefDataset.from_bdd100k(labels, IMAGES)
    ref.records = ref.records[:5]
    got = list(port_pipeline.make_loader(ds, 4, shuffle=False, num_epochs=1,
                                         drop_last=False, num_workers=2))
    want = list(ref_loader(ref, 4, shuffle=False, num_epochs=1, drop_last=False,
                           num_workers=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(ds[2]["image"], np.asarray(ref[2]["image"]))
    with pytest.raises(ValueError, match="even decode_size"):
        next(port_pipeline.make_loader(ds, 4, wire_format="yuv420"))
    small = ds.decode_full(_encode_jpeg(_noise(360, 640, 8)))
    assert small.shape == (720, 1280, 3)


def _encode_jpeg(a: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


# ------------------------------------------------------------ Predictor


@functools.lru_cache(maxsize=None)
def _jax_tiny_ssd():
    from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
    from bdd100k_tpu.models.detector import build_detector as jax_build

    bundle = jax_build(jax_tiny("ssd"), dtype=jnp.float32)
    return bundle, jax.device_get(bundle.init(jax.random.PRNGKey(0)))


# (image, slot) pairs whose classes come out crossed: the random-init
# model's scores tie there (equal in the reference to 1e-8), and the yuv420
# wire's f32 colour conversion moves them by an ulp (max score difference
# 2.2e-8)
PREDICTOR_NEAR_TIE_SWAPS = {
    ("rgb", False): (), ("rgb", True): (),
    ("yuv420", False): ((1, 140),), ("yuv420", True): ((2, 135),),
}
NEAR_TIE = 1e-6


def _undo_near_tie_swaps(got, want, swaps):
    """`got` with each named adjacent pair swapped back, after checking
    that it is a near-tie of the reference crossed in the port."""
    arrays = [np.array(a, copy=True) for a in got]
    for i, s in swaps:
        pair = slice(s, s + 2)
        assert abs(float(want.scores[i, s] - want.scores[i, s + 1])) < NEAR_TIE
        np.testing.assert_array_equal(got.classes[i, pair],
                                      np.asarray(want.classes)[i, pair][::-1])
        for a in arrays:
            a[i, pair] = a[i, pair][::-1].copy()
    return type(got)(*arrays)


@pytest.mark.parametrize("host_resize", [False, True], ids=["device_resize",
                                                            "host_resize"])
@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_tiny_predictor_matches_jax_with_host_resize_and_wires(host_resize, wire):
    """The port's `Predictor` and the reference's, from the reference's
    init at the tiny SSD config, on three 720p frames padded to a batch of
    four: host resize by cv2 (reference) and the port's numpy resize, the
    yuv420 wire through the pool's resize and conversion, or the host's
    conversion of the full frames."""
    from bdd100k_tpu.infer import Predictor as JaxPredictor

    ref_bundle, variables = _jax_tiny_ssd()
    state = type("State", (), {"params": variables["params"],
                               "batch_stats": variables["batch_stats"]})
    ref = JaxPredictor(ref_bundle, state, batch_size=4, host_resize=host_resize,
                       wire=wire)
    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32, device="cpu")
    bundle.model.load_state_dict(state_dict_from_flax(variables["params"],
                                                      variables["batch_stats"]))
    pred = port_infer.Predictor(bundle, batch_size=4, host_resize=host_resize,
                                wire=wire)
    frames, _, _ = generate_synthetic_scenes(3, seed=1)
    got, want = pred(frames), ref(frames)
    assert got.valid.shape == (3, 200) and got.valid.any()
    got = _undo_near_tie_swaps(got, want, PREDICTOR_NEAR_TIE_SWAPS[wire, host_resize])
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid, valid)
    np.testing.assert_array_equal(got.classes, np.asarray(want.classes))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=0, atol=DET_ATOL)
    np.testing.assert_allclose(got.boxes[valid], np.asarray(want.boxes)[valid],
                               rtol=0, atol=DET_ATOL)


@pytest.mark.parametrize("wire,host_resize,size,want", [
    ("auto", True, 300, "yuv420"), ("auto", True, 301, "rgb"),
    ("auto", False, 300, "rgb"), ("yuv420", False, 300, "yuv420"),
    ("rgb", True, 300, "rgb")])
def test_wire_resolves_as_the_reference(wire, host_resize, size, want):
    # the reference's expression, bdd100k_tpu/infer.py load_predictor
    ref = ("yuv420" if wire == "yuv420" or (wire == "auto" and host_resize
                                            and size % 2 == 0) else "rgb")
    assert port_infer.resolve_predictor_wire(wire, host_resize, size) == ref == want


def test_load_predictor_takes_int8_static():
    """The SSD300 artifact in int8_static on the int8 eval fixture's
    frozen maxima: an image's confident detections (static scales: the
    rest of the batch does not matter) equal the reference eval's, on the
    pool's decode at 300 that the eval ran on."""
    from test_torch_quant_eval import confident_agree, fixture_quant_state
    from bdd100k_tpu_torch.models.quant import load_quant_state

    pred = port_infer.load_predictor(
        "ssd_mobilenet_300", CONFIGS["ssd_mobilenet_300"], batch_size=2,
        device="cpu", dtype=torch.float32, quant="int8_static")
    assert pred.bundle.config.quant == "int8_static"
    key = "ssd_mobilenet_300_int8_static_64"
    load_quant_state(pred.bundle.model, fixture_quant_state(key))
    pred._needs_calib = False  # the fixture's maxima stand in for calibration
    dec = NativeDecoder(1)
    try:
        frames = dec.decode_batch([p.read_bytes() for p in _jpegs()[:2]], 300)
    finally:
        dec.close()
    det = pred(frames)
    ref = np.load(FIXTURES / "torch_ref_eval_int8.npz")
    want = {k: ref[f"{key}/{k}"][:2] for k in ("boxes", "scores", "classes", "valid")}
    confident_agree(det, want, 2)


# ------------------------------------------------------------------ CLI


def _reference_lines(ref: dict, *keys: str) -> dict:
    """The fixture's printed lines under `keys`, parsed."""
    for k in keys:
        ref = ref[k]
    return port_infer.parse_detection_lines("\n".join(ref))


def assert_lines_agree(got: dict, want: dict, names: list[str],
                       tol: float = LINE_TOL) -> None:
    """Per image: the same number of lines and classes; each line has a
    reference line of its class with score and corners within `tol`
    (with a wider `tol`, lines within it of the threshold are left out)."""
    def keep(lines):
        return sorted(x for x in lines if tol <= LINE_TOL
                      or abs(x[1] - THRESHOLD) > tol)

    for name in names:
        g, w = keep(got.get(name, [])), keep(want.get(name, []))
        assert [x[0] for x in g] == [x[0] for x in w], (name, g, w)
        left = list(w)
        for cls, score, box in g:
            hit = [j for j, (c, s, b) in enumerate(left) if c == cls
                   and abs(s - score) <= tol
                   and max(abs(p - q) for p, q in zip(b, box)) <= tol]
            assert hit, (name, cls, score, box, w)
            left.pop(hit[0])


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_infer.main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def eight_jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("eight")
    for p in _jpegs()[:CPU_IMAGES]:
        (d / p.name).symlink_to(p)
    return d


def test_cli_dir_sweep_matches_the_reference_lines(eight_jpegs):
    """SSD300 on 8 JPEGs at batch 4, the default (yuv420) wire, f32 on the
    CPU, against the reference CLI's lines for the same images."""
    ref = json.loads(CLI_FIXTURE.read_text())
    out = _cli(["--config", "ssd_mobilenet_300",
                "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
                "--image_dir", str(eight_jpegs), "--batch_size", "4",
                "--device", "cpu", "--dtype", "float32"])
    assert f"{CPU_IMAGES} images in" in out and "imgs/sec" in out
    names = [p.name for p in _jpegs()[:CPU_IMAGES]]
    got = port_infer.parse_detection_lines(out)
    assert sum(map(len, got.values())) > 10
    assert_lines_agree(got, _reference_lines(ref, "dir", "ssd_mobilenet_300",
                                             "yuv420"), names)


def _keep_drawn(monkeypatch) -> dict:
    """{file name: drawn frame} of every output `--out_dir` writes."""
    drawn = {}
    real = port_infer.write_drawn

    def keep(path, image):
        drawn[path.name] = image.copy()
        real(path, image)

    monkeypatch.setattr(port_infer, "write_drawn", keep)
    return drawn


def _pil_jpeg(image: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG")  # PIL's default quality
    return buf.getvalue()


def test_cli_single_image_matches_the_reference_lines(tmp_path, monkeypatch):
    """`--image` decodes at full resolution and resizes on the device; its
    lines equal the reference CLI's, and --out_dir writes det_<name>, the
    bytes of PIL's save of the drawn frame."""
    ref = json.loads(CLI_FIXTURE.read_text())
    image = _jpegs()[0]
    drawn = _keep_drawn(monkeypatch)
    out = _cli(["--config", "ssd_mobilenet_300",
                "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
                "--image", str(image), "--device", "cpu", "--dtype", "float32",
                "--out_dir", str(tmp_path)])
    assert "warm latency" in out
    assert_lines_agree(port_infer.parse_detection_lines(out),
                       _reference_lines(ref, "single", "ssd_mobilenet_300"),
                       [image.name])
    name = f"det_{image.name}"
    assert drawn[name].shape == (720, 1280, 3)
    assert (tmp_path / name).read_bytes() == _pil_jpeg(drawn[name])


def test_cli_out_dir_writes_a_png_per_image(eight_jpegs, tmp_path, monkeypatch):
    """The directory sweep writes det_<name> for each input, a JPEG here:
    PIL's quality-75 save of the frame drawn on the decode at model size."""
    drawn = _keep_drawn(monkeypatch)
    out = _cli(["--config", "ssd_mobilenet_300",
                "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
                "--image_dir", str(eight_jpegs), "--batch_size", "8",
                "--device", "cpu", "--out_dir", str(tmp_path)])
    assert "8 images in" in out
    names = [f"det_{p.name}" for p in _jpegs()[:CPU_IMAGES]]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)
    for name in names:
        assert drawn[name].shape == (300, 300, 3)
        assert (tmp_path / name).read_bytes() == _pil_jpeg(drawn[name])


def test_cli_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_infer.main(["--image", str(_jpegs()[0]),
                         "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"])])


@pytest.mark.parametrize("argv,reason", [
    (["--video", "drive.mp4"], "cv2.VideoCapture"),
], ids=["video"])
def test_cli_refuses_with_its_reason(argv, reason):
    with pytest.raises(SystemExit, match=reason):
        port_infer.main(argv + ["--device", "cpu"])


def test_cli_int8_static_with_calib_images_matches_the_reference(eight_jpegs):
    """`--quant int8_static --calib_images` (JPEGs and PNGs) over 8 JPEGs at
    batch 4, f32 on the CPU: the reference CLI's lines (static scales, so
    its batch of 32 and this one of 4 print the same)."""
    ref = json.loads(CLI_FIXTURE.read_text())
    out = _cli(["--config", "ssd_mobilenet_300",
                "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
                "--image_dir", str(eight_jpegs), "--batch_size", "4",
                "--quant", "int8_static", "--calib_images", str(CALIB_DIR),
                "--device", "cpu", "--dtype", "float32"])
    assert f"calibrated act scales on 8 frames from {CALIB_DIR}" in out
    names = [p.name for p in _jpegs()[:CPU_IMAGES]]
    got = port_infer.parse_detection_lines(out)
    assert sum(map(len, got.values())) > 10
    assert_lines_agree(got, _reference_lines(ref, "int8", "dir_int8_static"), names,
                       tol=INT8_LINE_TOL)


def test_cli_int8_on_a_png_image_matches_the_reference():
    """`--image x.png --quant int8`: the PNG decodes as PIL's
    convert("RGB") at full resolution and the lines equal the
    reference's."""
    ref = json.loads(CLI_FIXTURE.read_text())
    out = _cli(["--config", "ssd_mobilenet_300",
                "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
                "--image", str(PNG_IMAGE), "--quant", "int8",
                "--device", "cpu", "--dtype", "float32"])
    assert "warm latency" in out
    assert_lines_agree(port_infer.parse_detection_lines(out),
                       _reference_lines(ref, "int8", "single_png_int8"),
                       [PNG_IMAGE.name], tol=INT8_LINE_TOL)


def test_cli_png_in_the_directory_as_the_reference(tmp_path):
    """A .png in the swept directory: with --host_resize off PIL's route
    reads it and the lines equal the reference's; with host resize on the
    pool takes the bytes and the PNG's batch fails, ending the run
    non-zero, as the reference's does (its outcome is pinned in the
    fixture)."""
    ref = json.loads(CLI_FIXTURE.read_text())
    for p in _jpegs()[:2]:
        (tmp_path / p.name).symlink_to(p)
    (tmp_path / PNG_IMAGE.name).symlink_to(PNG_IMAGE)
    names = sorted(p.name for p in tmp_path.iterdir())
    out = _cli(["--config", "ssd_mobilenet_300",
                "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
                "--image_dir", str(tmp_path), "--batch_size", "4",
                "--host_resize", "off", "--device", "cpu", "--dtype", "float32"])
    assert "3 images in" in out
    assert_lines_agree(port_infer.parse_detection_lines(out),
                       _reference_lines(ref, "int8", "png_dir_host_resize_off"),
                       names)
    assert "failed to decode" in ref["int8"]["png_dir_host_resize_on_error"]
    with pytest.raises(RuntimeError, match="image_dir pipeline failed") as err:
        _cli(["--config", "ssd_mobilenet_300",
              "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
              "--image_dir", str(tmp_path), "--batch_size", "4",
              "--device", "cpu"])
    assert "failed to decode" in str(err.value.__cause__)


def test_cli_single_truncated_jpeg_raises_as_pil(tmp_path):
    """`--image` of a JPEG cut in half raises, naming the file, where the
    reference's PIL read raises "image file is truncated"."""
    from PIL import Image

    cut = tmp_path / "cut.jpg"
    data = _jpegs()[1].read_bytes()
    cut.write_bytes(data[:len(data) // 2])
    with pytest.raises(OSError, match="truncated"):
        with Image.open(cut) as im:
            im.convert("RGB")
    with pytest.raises(OSError, match=f"{cut}.*truncated"):
        _cli(["--config", "ssd_mobilenet_300",
              "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
              "--image", str(cut), "--device", "cpu"])


def test_cli_decode_error_on_the_producer_exits_non_zero(tmp_path):
    """A JPEG that fails to decode mid-sweep surfaces in the consumer and
    ends the process with a non-zero code, never a clean end."""
    for p in _jpegs()[:4]:
        (tmp_path / p.name).symlink_to(p)
    (tmp_path / "synthetic_val_00002.jpg").unlink()
    (tmp_path / "synthetic_val_00002.jpg").write_bytes(b"\xff\xd8 broken")
    proc = subprocess.run(
        [sys.executable, "-m", "bdd100k_tpu_torch.infer",
         "--ckpt_dir", str(CONFIGS["ssd_mobilenet_300"]),
         "--image_dir", str(tmp_path), "--batch_size", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode != 0
    assert "image_dir pipeline failed" in proc.stderr
    assert "failed to decode" in proc.stderr
    assert "imgs/sec" not in proc.stdout


# ------------------------------------------------------------------ viz


RECTS = {
    "inside": (5, 4, 14, 12), "reversed": (14, 12, 5, 4), "thin": (3, 3, 3, 9),
    "point": (10, 10, 10, 10), "border": (0, 0, 29, 21),
    "past_the_border": (-4, -3, 35, 30), "one_corner_out": (20, 15, 40, 40),
}


@pytest.mark.parametrize("rect", sorted(RECTS))
def test_rectangle_mask_equals_cv2(rect):
    import cv2

    x1, y1, x2, y2 = RECTS[rect]
    want = np.zeros((22, 30), np.uint8)
    cv2.rectangle(want, (x1, y1), (x2, y2), 255, 2)
    got = viz.rectangle_mask((22, 30), x1, y1, x2, y2)
    np.testing.assert_array_equal(got, want > 0)


def test_draw_detections_draws_boxes_and_labels():
    """The outlines land where cv2.rectangle's do, in the class colour;
    the label sits above the box; nothing else changes."""
    import cv2

    img = np.full((120, 160, 3), 7, np.uint8)
    boxes = np.array([[0.25, 0.5, 0.75, 0.9], [0.1, 0.1, 0.2, 0.2],
                      [0.0, 0.0, 1.0, 1.0]], np.float32)
    drawn = viz.draw_detections(img, boxes, np.array([0.9, 0.3, 0.8]),
                                np.array([1, 2, 10]), np.array([True, True, False]),
                                score_threshold=0.5)
    want = np.zeros((120, 160), np.uint8)
    cv2.rectangle(want, (40, 60), (120, 108), 255, 2)
    changed = (drawn != img).any(-1)
    assert (changed >= (want > 0)).all()
    assert (drawn[want > 0] == (66, 135, 245)).all()
    label = changed & ~(want > 0)
    rows = np.flatnonzero(label.any(1))
    assert label.any() and rows.max() < 60 and rows.min() >= 46
    assert (img == 7).all()


def test_png_writer_reads_back_in_pil(tmp_path):
    from PIL import Image

    a = np.random.RandomState(9).randint(0, 256, (37, 53, 3), dtype=np.uint8)
    viz.write_png(tmp_path / "a.png", a)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), a)


# ------------------------------------------------------------------ fixture


def _reference_cli(argv) -> str:
    """The reference's CLI with its detector in f32 → its stdout."""
    import bdd100k_tpu.infer as ref_infer
    from bdd100k_tpu.models.detector import build_detector as jax_build

    real = ref_infer.build_detector
    ref_infer.build_detector = functools.partial(jax_build, dtype=jnp.float32)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ref_infer.main(argv)
    finally:
        ref_infer.build_detector = real
    return buf.getvalue()


def _pil_sha256s() -> dict[str, str]:
    """{name: sha256 of PIL's full-resolution RGB decode} of the 64 JPEGs,
    the reference's pixels for the card's check of `decode_full`."""
    from PIL import Image

    out = {}
    for p in _jpegs():
        with Image.open(p) as im:
            out[p.name] = hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()
                                         ).hexdigest()
    return out


def _detection_lines(text: str) -> list[str]:
    """The CLI's detection lines, each with its image's file name only."""
    return [f"{Path(name).name}: {rest}" for name, rest in
            (line.rsplit(": ", 1) for line in text.splitlines()
             if "]" in line and ": " in line)]


def _make_calib_dir() -> None:
    """tests/fixtures/calib_mixed: two train JPEGs and three PNGs made from
    the other two (palette and RGBA at 640×360, 16-bit grey at 320×180)."""
    from PIL import Image

    CALIB_DIR.mkdir(exist_ok=True)
    train = [FIXTURES / f"synthetic_train_0000{i}.jpg" for i in range(4)]
    for p in train[:2]:
        (CALIB_DIR / p.name).write_bytes(p.read_bytes())
    with Image.open(train[2]) as im:
        im.convert("RGB").resize((640, 360)).convert(
            "P", palette=Image.ADAPTIVE, colors=256).save(
            CALIB_DIR / "train_00002_p.png")
    with Image.open(train[3]) as im:
        rgba = im.convert("RGBA").resize((640, 360))
        rgba.putalpha(96)
        rgba.save(PNG_IMAGE)
        grey = np.asarray(im.convert("L").resize((320, 180))).astype(np.uint16) * 3
        Image.fromarray(grey).save(CALIB_DIR / "train_00003_gray16.png")


def make_int8_fixture() -> None:
    """The "int8" part of the fixture: the reference CLI (f32) with
    int8_static and --calib_images over the 64 JPEGs, int8 on one PNG,
    and a directory with a PNG with host resize off and on."""
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    base = ["--config", "ssd_mobilenet_300", "--ckpt_dir",
            str(CONFIGS["ssd_mobilenet_300"])]
    out = json.loads(CLI_FIXTURE.read_text())
    part = {}
    part["dir_int8_static"] = _detection_lines(_reference_cli(
        base + ["--image_dir", str(IMAGES), "--batch_size", str(CLI_BATCH),
                "--quant", "int8_static", "--calib_images", str(CALIB_DIR)]))
    part["single_png_int8"] = _detection_lines(_reference_cli(
        base + ["--image", str(PNG_IMAGE), "--quant", "int8"]))
    with tempfile.TemporaryDirectory() as d:
        for p in _jpegs()[:2]:
            (Path(d) / p.name).symlink_to(p)
        (Path(d) / PNG_IMAGE.name).symlink_to(PNG_IMAGE)
        part["png_dir_host_resize_off"] = _detection_lines(_reference_cli(
            base + ["--image_dir", d, "--batch_size", "4",
                    "--host_resize", "off"]))
        try:
            _reference_cli(base + ["--image_dir", d, "--batch_size", "4"])
            part["png_dir_host_resize_on_error"] = ""
        except Exception as e:  # noqa: BLE001 — the outcome is what is pinned
            part["png_dir_host_resize_on_error"] = f"{e!r}: {e.__cause__!r}"
    part["calib_dir"] = sorted(p.name for p in CALIB_DIR.iterdir())
    out["int8"] = part
    CLI_FIXTURE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote the int8 part of {CLI_FIXTURE}: "
          + ", ".join(f"{k} {len(v)}" for k, v in part.items()))


def make_fixture() -> None:
    jax.config.update("jax_platforms", "cpu")
    out = {"dir": {}, "single": {}, "meta": {
        "command": "bdd100k_tpu.infer.main with build_detector(dtype=float32)",
        "image_dir": str(IMAGES.relative_to(ROOT)), "batch_size": CLI_BATCH,
        "score_threshold": 0.4, "jax": jax.__version__,
        "modes": {k: v for k, v in MODES.items()}}}
    for config, artifact in CONFIGS.items():
        base = ["--config", config, "--ckpt_dir", str(artifact)]
        out["dir"][config] = {}
        for mode, extra in MODES.items():
            text = _reference_cli(base + ["--image_dir", str(IMAGES),
                                          "--batch_size", str(CLI_BATCH), *extra])
            out["dir"][config][mode] = _detection_lines(text)
            n = len(out["dir"][config][mode])
            print(f"{config} {mode}: {n} lines", flush=True)
        text = _reference_cli(base + ["--image", str(_jpegs()[0])])
        out["single"][config] = _detection_lines(text)
    out["full_res_sha256"] = _pil_sha256s()
    CLI_FIXTURE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {CLI_FIXTURE} ({CLI_FIXTURE.stat().st_size} bytes)")
    make_int8_fixture()


if __name__ == "__main__":
    if "--make-calib-dir" in sys.argv:
        _make_calib_dir()
    elif "--make-int8-fixture" in sys.argv:
        make_int8_fixture()
    elif "--make-fixture" in sys.argv:
        make_fixture()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
