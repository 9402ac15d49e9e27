"""Progressive JPEGs and non-720p frames in the port's decode, against the
JAX reference's routes, on the CPU.

* `data/host_resize.resize_bicubic` bit-equal to PIL's `Image.resize((1280,
  720))` (BICUBIC, its default) from 1920×1080, 640×480, 1280×800, and an
  upscale from 640×360, on a scene and on noise;
* `DetectionDataset(decode_size=None)` on non-720p JPEGs equal to the
  reference's `DetectionDataset._decode` (PIL's open, convert, resize),
  single images and loader batches;
* the committed fixture `tests/fixtures/decode_repairs/`: four progressive
  JPEGs (4:2:0, 4:4:4, gray, restart markers) and four non-720p baseline
  JPEGs, with `ref_sha256.json`, the sha256 of the reference's decodes of
  each (its native pool at 300 rgb, 300 yuv420 and 512, PIL at 1/1, and
  PIL's resize to 720×1280). The test holds the JSON to a fresh run of the
  reference and the port's decodes to the JSON; `chip_smoke.py` holds the
  port's decodes on the card to the same JSON, since the card's machine
  has no PIL;
* `ref_smoothing_sha256.json`: the reference pool's decodes of those
  progressive files cut short (4:2:0 at 5, 20 and 35 % of the file, gray
  and 4:4:4 at 20 %, where libjpeg-turbo's interblock smoothing applies;
  4:4:4 at 43 %, inside a DHT segment, which libjpeg reads on through fake
  EOI bytes; the restart-marker file at 65 %, at a restart boundary in its
  last scan), at 300 rgb, 300 yuv420 and 512, held to a fresh run of the
  reference here and to the port's decodes here and on the card
  (`chip_smoke.py`'s decode_smoothing).

Regenerate the fixture with `python tests/test_torch_decode_repairs.py
--make-fixture` (a few seconds).
"""

from __future__ import annotations

import hashlib
import io
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

from torch_ref_pool import ref_pool  # noqa: E402
from bdd100k_tpu_torch.data import pipeline as port_pipeline  # noqa: E402
from bdd100k_tpu_torch.data.host_resize import resize_bicubic  # noqa: E402
from bdd100k_tpu_torch.data.native_decode import NativeDecoder, decode_full  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures"
IMAGES = FIXTURES / "synth_val_seed1" / "images" / "val"
REPAIRS = FIXTURES / "decode_repairs"
SHA_JSON = REPAIRS / "ref_sha256.json"
SMOOTHING_JSON = REPAIRS / "ref_smoothing_sha256.json"
# (fixture, share of the file kept): cuts before the last scans
SMOOTHING_CUTS = (("progressive_420", 0.05), ("progressive_420", 0.20),
                  ("progressive_420", 0.35), ("progressive_gray", 0.20),
                  ("progressive_444", 0.20), ("progressive_444", 0.43),
                  ("progressive_restart", 0.65))
PROGRESSIVE = {"progressive_420": {}, "progressive_444": {"subsampling": 0},
               "progressive_gray": {}, "progressive_restart": {"restart_marker_blocks": 3}}
# (height, width) of the non-720p fixtures; 640×360 is an upscale
OTHER_SIZES = ((1080, 1920), (480, 640), (800, 1280), (360, 640))
POOL_SIZES = (300, 512)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _scene(h: int, w: int, index: int = 3) -> np.ndarray:
    """A val scene resampled to h×w (Lanczos), as frames of another camera
    would look."""
    from PIL import Image

    with Image.open(IMAGES / f"synthetic_val_{index:05d}.jpg") as im:
        return np.asarray(im.convert("RGB").resize((w, h), Image.LANCZOS))


def _encode(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90, **kw)
    return buf.getvalue()


def make_fixture() -> None:
    """Write the JPEGs and the reference's sha256s of their decodes."""
    from PIL import Image

    REPAIRS.mkdir(parents=True, exist_ok=True)
    base = _scene(720, 1280, index=1)
    for name, kw in PROGRESSIVE.items():
        img = base[..., 0] if name.endswith("gray") else base
        (REPAIRS / f"{name}.jpg").write_bytes(_encode(img, progressive=True, **kw))
    for h, w in OTHER_SIZES:
        (REPAIRS / f"frame_{w}x{h}.jpg").write_bytes(_encode(_scene(h, w)))
    ref = ref_pool().NativeDecoder(2)
    out = {"decode_progressive": {}, "resize_bicubic": {}}
    for name in PROGRESSIVE:
        jpeg = (REPAIRS / f"{name}.jpg").read_bytes()
        rec = {str(s): sha(ref.decode_batch([jpeg], s)[0]) for s in POOL_SIZES}
        if not name.endswith("gray"):
            y, uv = ref.decode_batch_yuv420([jpeg], 300)
            rec["300_yuv420"] = [sha(y[0]), sha(uv[0])]
        with Image.open(io.BytesIO(jpeg)) as im:
            rec["full"] = sha(np.asarray(im.convert("RGB")))
        out["decode_progressive"][name] = rec
    for path in sorted(REPAIRS.glob("frame_*.jpg")):
        out["resize_bicubic"][path.name] = sha(_reference_decode(path))
    SHA_JSON.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


def _records(names: list[str]) -> list[dict]:
    return [{"name": n, "boxes": np.zeros((0, 4), np.float32),
             "labels": np.zeros((0,), np.int32)} for n in names]


def _reference_decode(path: Path) -> np.ndarray:
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset

    return RefDataset(_records([path.name]), path.parent)[0]["image"]


def _frames() -> list[Path]:
    return sorted(REPAIRS.glob("frame_*.jpg"))


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("hw", OTHER_SIZES, ids=[f"{w}x{h}" for h, w in OTHER_SIZES])
@pytest.mark.parametrize("content", ["scene", "noise"])
def test_resize_bicubic_bit_equal_to_pil(hw, content):
    from PIL import Image

    h, w = hw
    img = (_scene(h, w) if content == "scene" else
           np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8))
    got = resize_bicubic(np.stack([img, img[::-1]]), 720, 1280)
    for g, src in zip(got, (img, img[::-1].copy())):
        want = np.asarray(Image.fromarray(src).resize((1280, 720)))
        np.testing.assert_array_equal(g, want)


def test_resize_bicubic_edges():
    """Odd sizes in one axis only, a tiny source, and the identity."""
    from PIL import Image

    rng = np.random.RandomState(0)
    for h, w, oh, ow in ((720, 1281, 720, 1280), (721, 1280, 720, 1280),
                         (7, 5, 720, 1280), (9, 13, 4, 3)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh)))
        np.testing.assert_array_equal(resize_bicubic(img[None], oh, ow)[0], want)
    img = rng.randint(0, 256, (1, 4, 6, 3)).astype(np.uint8)
    np.testing.assert_array_equal(resize_bicubic(img, 4, 6), img)
    with pytest.raises(ValueError, match="uint8"):
        resize_bicubic(img.astype(np.int32), 2, 2)


def test_dataset_full_resolution_resizes_as_the_reference():
    """`DetectionDataset(decode_size=None)` on the non-720p JPEGs: each
    image and one loader batch equal to the reference's PIL route."""
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.data.pipeline import make_loader as ref_loader

    names = [p.name for p in _frames()]
    assert len(names) == len(OTHER_SIZES)
    ds = port_pipeline.DetectionDataset(_records(names), REPAIRS)
    ref_ds = RefDataset(_records(names), REPAIRS)
    for i in range(len(names)):
        got, want = ds[i]["image"], ref_ds[i]["image"]
        assert got.shape == (720, 1280, 3)
        np.testing.assert_array_equal(got, want)
    kw = dict(shuffle=False, num_epochs=1, num_workers=2)
    got = next(port_pipeline.make_loader(ds, len(names), **kw))
    want = next(ref_loader(ref_ds, len(names), native_decode=False, **kw))
    np.testing.assert_array_equal(got.images, want.images)


# ------------------------------------------------------------------ fixture


def test_fixture_sha256s_are_the_reference_decodes():
    """The committed JSON against a fresh run of the reference (its pool
    and PIL) on the committed JPEGs."""
    from PIL import Image

    want = json.loads(SHA_JSON.read_text())
    ref = ref_pool().NativeDecoder(2)
    for name, rec in want["decode_progressive"].items():
        jpeg = (REPAIRS / f"{name}.jpg").read_bytes()
        assert b"\xff\xc2" in jpeg  # SOF2: progressive
        for s in POOL_SIZES:
            assert sha(ref.decode_batch([jpeg], s)[0]) == rec[str(s)]
        if "300_yuv420" in rec:
            y, uv = ref.decode_batch_yuv420([jpeg], 300)
            assert [sha(y[0]), sha(uv[0])] == rec["300_yuv420"]
        with Image.open(io.BytesIO(jpeg)) as im:
            assert sha(np.asarray(im.convert("RGB"))) == rec["full"]
    assert sorted(want["resize_bicubic"]) == [p.name for p in _frames()]
    for path in _frames():
        assert sha(_reference_decode(path)) == want["resize_bicubic"][path.name]


def test_port_decodes_match_the_fixture_sha256s():
    """What `chip_smoke.py`'s decode_progressive and resize_bicubic phases
    check on the card, here on the CPU."""
    want = json.loads(SHA_JSON.read_text())
    dec = NativeDecoder(2)
    try:
        for name, rec in want["decode_progressive"].items():
            jpeg = (REPAIRS / f"{name}.jpg").read_bytes()
            for s in POOL_SIZES:
                assert sha(dec.decode_batch([jpeg], s)[0]) == rec[str(s)], (name, s)
            if "300_yuv420" in rec:
                y, uv = dec.decode_batch_yuv420([jpeg], 300)
                assert [sha(y[0]), sha(uv[0])] == rec["300_yuv420"], name
            assert sha(decode_full(jpeg)) == rec["full"], name
    finally:
        dec.close()
    ds = port_pipeline.DetectionDataset([], REPAIRS)
    for path in _frames():
        got = ds.decode_full(path.read_bytes())
        assert sha(got) == want["resize_bicubic"][path.name], path.name


def smoothing_cuts() -> dict[str, bytes]:
    """"<fixture>@<percent>" → the committed progressive file cut there."""
    out = {}
    for name, share in SMOOTHING_CUTS:
        jpeg = (REPAIRS / f"{name}.jpg").read_bytes()
        out[f"{name}@{int(share * 100)}"] = jpeg[:int(len(jpeg) * share)]
    return out


def pool_sha256s(decoder, jpeg: bytes, gray: bool) -> dict:
    """sha256s of a pool's decodes at 300 rgb, 300 yuv420 (not gray) and
    512."""
    rec = {str(s): sha(decoder.decode_batch([jpeg], s)[0]) for s in POOL_SIZES}
    if not gray:
        y, uv = decoder.decode_batch_yuv420([jpeg], 300)
        rec["300_yuv420"] = [sha(y[0]), sha(uv[0])]
    return rec


def test_smoothing_fixture_is_the_reference_pool_s():
    want = json.loads(SMOOTHING_JSON.read_text())
    cuts = smoothing_cuts()
    assert sorted(want) == sorted(cuts)
    ref = ref_pool().NativeDecoder(2)
    for key, jpeg in cuts.items():
        assert not jpeg.endswith(b"\xff\xd9")  # cut before its EOI
        assert pool_sha256s(ref, jpeg, "gray" in key) == want[key], key


def test_port_smooths_the_cut_files_to_the_fixture_sha256s():
    want = json.loads(SMOOTHING_JSON.read_text())
    dec = NativeDecoder(2)
    try:
        for key, jpeg in smoothing_cuts().items():
            assert pool_sha256s(dec, jpeg, "gray" in key) == want[key], key
    finally:
        dec.close()


def make_smoothing_fixture() -> None:
    ref = ref_pool().NativeDecoder(2)
    out = {key: pool_sha256s(ref, jpeg, "gray" in key)
           for key, jpeg in smoothing_cuts().items()}
    SMOOTHING_JSON.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--make-fixture"]:
        make_fixture()
        make_smoothing_fixture()
        print(f"wrote {REPAIRS}")
    else:
        sys.exit(f"usage: {sys.argv[0]} --make-fixture")
