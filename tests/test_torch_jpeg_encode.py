"""The port's JPEG encoder and what writes through it, against PIL and the
JAX reference, on the CPU.

* `encode_jpeg` (`csrc/jpeg/jencode.cc`) gives PIL's bytes (libjpeg-turbo,
  `Image.fromarray(rgb).save(f, "JPEG", quality=q)`) at quality 75 and 90
  and at the edges of the range, at 720×1280, 300×300, one 64×64 block
  run, sizes that are no multiple of 16 (301×517, 9×23, 1×1), on flat,
  gradient, saturated and noise frames; and the 64 committed seed-1 JPEGs
  from their renders;
* `generate_synthetic_dataset` writes the reference's directory byte for
  byte (8 images at seed 0: the JPEGs and the labels JSON), and
  `train --synthetic 8` writes it and trains from its files;
* `ensure_synthetic_dataset` generates only when the split is short;
* `infer --out_dir` writes `det_<name>` in the input's format: for JPEG
  inputs PIL's quality-75 bytes of the drawn frame, equal to the committed
  sha256s of `tests/fixtures/torch_ref_jpeg_encode.json` (the
  reference CLI's f32 detections on two committed JPEGs, drawn by the
  port's `draw_detections` and saved by PIL: the reference draws its
  labels with cv2's Hershey font, which the port does not carry); a PNG
  input as a PNG with the drawn pixels.

The fixture also holds the sha256s of the reference generator's 8-image
seed-0 train split, which `chip_smoke.py` checks on the card's machine
(no PIL there). Remake it with `python tests/test_torch_jpeg_encode.py
--make-fixture` (the reference CLI in f32 on two JPEGs, ~20 s).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bdd100k_tpu_torch import infer as port_infer  # noqa: E402
from bdd100k_tpu_torch import train as port_train  # noqa: E402
from bdd100k_tpu_torch.data import synthetic  # noqa: E402
from bdd100k_tpu_torch.data.jpeg_encode import encode_jpeg  # noqa: E402
from bdd100k_tpu_torch.data.png import decode_png  # noqa: E402

torch.set_num_threads(2)

FIXTURES = ROOT / "tests" / "fixtures"
SYNTH = FIXTURES / "synth_val_seed1"
IMAGES = SYNTH / "images" / "val"
ARTIFACT = ROOT / "artifacts" / "ssd_mobilenet_300_synth9k.npz"
FIXTURE = FIXTURES / "torch_ref_jpeg_encode.json"
OUT_IMAGES = ["synthetic_val_00003.jpg", "synthetic_val_00007.jpg"]


def _pil_jpeg(rgb: np.ndarray, quality: int | None = None) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    kw = {} if quality is None else {"quality": quality}
    Image.fromarray(rgb).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _frame(kind: str, h: int, w: int) -> np.ndarray:
    rng = np.random.RandomState(h * 7 + w)
    if kind == "flat":
        return np.full((h, w, 3), (77, 140, 201), np.uint8)
    if kind == "gradient":
        y, x = np.mgrid[0:h, 0:w]
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (x + y) % 256], -1).astype(np.uint8)
    if kind == "saturated":  # 0/255 blocks: the largest coefficients
        return (rng.rand(h, w, 3) > 0.5).astype(np.uint8) * 255
    return rng.randint(0, 256, (h, w, 3), dtype=np.uint8)


SIZES = [(720, 1280), (300, 300), (64, 64), (301, 517), (9, 23), (1, 1)]
KINDS = ["flat", "gradient", "saturated", "noise"]


@pytest.mark.parametrize("quality", [75, 90])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("kind", KINDS)
def test_encoder_gives_pil_bytes(kind, size, quality):
    rgb = _frame(kind, *size)
    assert encode_jpeg(rgb, quality) == _pil_jpeg(rgb, quality)


@pytest.mark.parametrize("quality", [1, 10, 49, 50, 100])
def test_encoder_across_the_quality_range(quality):
    rgb = _frame("noise", 40, 72)
    assert encode_jpeg(rgb, quality) == _pil_jpeg(rgb, quality)


def test_default_quality_is_pils():
    rgb = _frame("gradient", 48, 80)
    assert encode_jpeg(rgb) == _pil_jpeg(rgb) == _pil_jpeg(rgb, 75)


def test_encoder_refuses_what_jpeg_cannot_hold():
    with pytest.raises(ValueError, match="uint8 RGB"):
        encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8 RGB"):
        encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="1..65535"):
        encode_jpeg(np.zeros((0, 4, 3), np.uint8))


def test_encoder_writes_the_fixtures_from_their_renders():
    """The 64 committed seed-1 scenes, each the JPEG the reference's
    generator wrote (quality 90)."""
    frames, _, _ = synthetic.generate_synthetic_scenes(64, seed=1)
    for i, frame in enumerate(frames):
        want = (IMAGES / f"synthetic_val_{i:05d}.jpg").read_bytes()
        assert encode_jpeg(frame, 90) == want, i


# ------------------------------------------------------------ generator


@pytest.fixture(scope="module")
def reference_split(tmp_path_factory):
    """The reference's `generate_synthetic_dataset` of 8 seed-0 scenes."""
    from bdd100k_tpu.data.synthetic import generate_synthetic_dataset

    d = tmp_path_factory.mktemp("ref_split")
    generate_synthetic_dataset(d, num_images=8, seed=0)
    return d


def _tree(d: Path) -> dict[str, bytes]:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _sha256s(d: Path) -> dict[str, str]:
    return {k: hashlib.sha256(v).hexdigest() for k, v in _tree(d).items()}


def test_generate_synthetic_dataset_writes_the_reference_directory(
        reference_split, tmp_path):
    labels = synthetic.generate_synthetic_dataset(tmp_path, num_images=8, seed=0)
    assert labels == tmp_path / "labels" / "train.json"
    assert _tree(tmp_path) == _tree(reference_split)
    want = json.loads(FIXTURE.read_text())["synthetic_train_seed0_8_sha256"]
    assert _sha256s(tmp_path) == want


def test_train_synthetic_writes_the_split_and_trains_from_it(
        reference_split, tmp_path, capsys):
    data = tmp_path / "synth"
    port_train.main(["--config", "ssd_tiny_64", "--synthetic", "8",
                     "--synthetic_dir", str(data), "--decode_size", "64",
                     "--batch_size", "4", "--max_boxes", "16",
                     "--total_steps", "2", "--warmup_steps", "0",
                     "--log_every", "1", "--num_workers", "1", "--device", "cpu",
                     "--ckpt_dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "dataset: 8 images" in out and "done at step 2" in out
    assert _tree(data) == _tree(reference_split)


def test_ensure_synthetic_dataset_generates_only_when_short(tmp_path, monkeypatch):
    calls = []
    real = synthetic.generate_synthetic_dataset
    monkeypatch.setattr(synthetic, "generate_synthetic_dataset",
                        lambda *a, **k: calls.append(k["num_images"]) or real(*a, **k))
    labels = synthetic.ensure_synthetic_dataset(tmp_path, num_images=3, seed=0)
    assert calls == [3]
    assert synthetic.ensure_synthetic_dataset(tmp_path, 2, seed=0) == labels
    assert synthetic.ensure_synthetic_dataset(tmp_path, 3, seed=0) == labels
    assert calls == [3]  # complete: nothing rewritten
    synthetic.ensure_synthetic_dataset(tmp_path, 4, seed=0)
    assert calls == [3, 4]
    assert len(json.loads(labels.read_text())) == 4
    # generation is sequential from the seed: the 3-scene set is the head
    head = real(tmp_path / "head", 3, seed=0)
    assert json.loads(head.read_text()) == json.loads(labels.read_text())[:3]
    # the committed split is complete: read as it is
    assert synthetic.ensure_synthetic_dataset(SYNTH, 64, seed=1, split="val") == (
        SYNTH / "labels" / "val.json")


# ------------------------------------------------------ infer --out_dir


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_infer.main(argv)
    return buf.getvalue()


def _two_inputs(tmp_path: Path) -> Path:
    d = tmp_path / "in"
    d.mkdir()
    for name in OUT_IMAGES:
        shutil.copy(IMAGES / name, d / name)
    return d


def test_infer_out_dir_writes_the_reference_jpegs(tmp_path):
    """The port's CLI in f32 on the two JPEGs: each det_<name>.jpg is
    PIL's quality-75 save of the reference's detections drawn, byte for
    byte."""
    want = json.loads(FIXTURE.read_text())["infer_out_sha256"]
    out = tmp_path / "out"
    _cli(["--config", "ssd_mobilenet_300", "--ckpt_dir", str(ARTIFACT),
          "--image_dir", str(_two_inputs(tmp_path)), "--batch_size", "2",
          "--dtype", "float32", "--device", "cpu", "--out_dir", str(out)])
    got = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
           for p in sorted(out.iterdir())}
    assert got == {f"det_{n}": h for n, h in want.items()}


def test_infer_out_dir_writes_a_png_input_as_png(tmp_path, monkeypatch):
    """A PNG input comes back as det_<name>.png holding the drawn pixels;
    a JPEG input's file is PIL's save of its drawn frame."""
    from PIL import Image

    d = tmp_path / "in"
    d.mkdir()
    Image.open(IMAGES / OUT_IMAGES[0]).save(d / "frame.png")
    shutil.copy(IMAGES / OUT_IMAGES[1], d / "frame2.jpg")
    drawn = {}
    real = port_infer.write_drawn

    def keep(path, image):
        drawn[path.name] = image.copy()
        real(path, image)

    monkeypatch.setattr(port_infer, "write_drawn", keep)
    out = tmp_path / "out"
    for name in ("frame.png", "frame2.jpg"):
        _cli(["--config", "ssd_mobilenet_300", "--ckpt_dir", str(ARTIFACT),
              "--image", str(d / name), "--device", "cpu",
              "--out_dir", str(out)])
    assert sorted(p.name for p in out.iterdir()) == ["det_frame.png", "det_frame2.jpg"]
    png = (out / "det_frame.png").read_bytes()
    np.testing.assert_array_equal(decode_png(png), drawn["det_frame.png"])
    with Image.open(out / "det_frame.png") as im:
        assert im.format == "PNG"
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      drawn["det_frame.png"])
    assert drawn["det_frame2.jpg"].shape == (720, 1280, 3)
    assert (out / "det_frame2.jpg").read_bytes() == _pil_jpeg(drawn["det_frame2.jpg"])


# ------------------------------------------------------------- fixture


def make_fixture() -> None:
    """The reference CLI's f32 detections on OUT_IMAGES (its directory
    sweep at batch 2), drawn by the port's `draw_detections` and saved by
    PIL at its default quality → their sha256s."""
    import tempfile

    import jax
    import jax.numpy as jnp

    import bdd100k_tpu.infer as ref_infer
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu_torch.utils.viz import draw_detections

    jax.config.update("jax_platforms", "cpu")
    hashes = {}

    def emit(args, name, frame, det_i, out_dir):
        drawn = draw_detections(frame, det_i["boxes"], det_i["scores"],
                                det_i["classes"], det_i["valid"],
                                score_threshold=args.score_threshold)
        hashes[Path(name).name] = hashlib.sha256(_pil_jpeg(drawn)).hexdigest()

    real_build, real_emit = ref_infer.build_detector, ref_infer._emit
    ref_infer.build_detector = functools.partial(jax_build, dtype=jnp.float32)
    ref_infer._emit = emit
    try:
        with tempfile.TemporaryDirectory() as tmp:
            d = _two_inputs(Path(tmp))
            ref_infer.main(["--config", "ssd_mobilenet_300", "--ckpt_dir",
                            str(ARTIFACT), "--image_dir", str(d),
                            "--batch_size", "2", "--out_dir", str(Path(tmp) / "out")])
    finally:
        ref_infer.build_detector, ref_infer._emit = real_build, real_emit
    from bdd100k_tpu.data.synthetic import generate_synthetic_dataset

    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_dataset(tmp, num_images=8, seed=0)
        split = _sha256s(Path(tmp))
    FIXTURE.write_text(json.dumps({
        "infer_out_command": "bdd100k_tpu.infer.main --image_dir <the two "
                             "images> --batch_size 2 --out_dir, detector in "
                             "float32; each frame drawn by bdd100k_tpu_torch."
                             "utils.viz.draw_detections and saved by PIL at "
                             "its default quality",
        "infer_out_sha256": hashes,
        "synthetic_train_seed0_8_command": "bdd100k_tpu.data.synthetic."
                                           "generate_synthetic_dataset(dir, "
                                           "num_images=8, seed=0)",
        "synthetic_train_seed0_8_sha256": split}, indent=1, sort_keys=True) + "\n")
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    if "--make-fixture" in sys.argv:
        make_fixture()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
