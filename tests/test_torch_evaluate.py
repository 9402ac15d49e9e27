"""The port's eval path, from JPEG files to mAP, against the JAX reference,
on the CPU.

* the BDD100K label parser on the committed labels and on hand-written
  records (aliases, unknown categories, clamping, degenerate boxes, a
  directory of per-image JSONs);
* the decode pool, built from the shared `native/decode_pool.cc` with the
  port's own JPEG decoder, bit-equal to the reference's native route (the
  same C++ against this box's libjpeg-turbo) on the 64 committed seed-1
  val JPEGs and the train fixtures, RGB and YUV 4:2:0, at several sizes,
  and on encodings the fixtures do not cover;
* the yuv420 pieces (`rgb_to_yuv420_host`, `yuv420_to_rgb_batch`, the
  preprocess's tuple branch) against the reference;
* the eval loader: order, the end of `num_epochs=1`, the padded final
  batch, and its batches equal to the reference loader's;
* `run_eval` on the CPU at full width in f32 over the 64 JPEGs against the
  committed JAX fixture `tests/fixtures/torch_ref_eval_synth9k.npz`, on
  the rgb wire (detections and mAP) and on yuv420 (mAP);
* `save_detector_npz` (loads in the reference's `load_into_state`, same
  logits), `restore_eval_weights` on a port run directory with and without
  `--ema`, `--dump_detections` against the reference's `_dump_image`, the
  CLI on the CPU, and the committed JPEGs against a fresh run of the
  reference's generator.

The fixture holds the reference's f32 detections over the 64 scenes (its
own DetectionDataset(decode_size=300), make_loader(native_decode=True),
make_eval_step and DetectionEvaluator at batch 32), its mAP, per-class AP
and COCO mAP, the sha256 of each decoded 300² image and the pixels of the
first four, and the mAP of the reference's run_eval in f32 on the
yuv420 wire. Regenerate it with `python tests/test_torch_evaluate.py
--make-fixture` (the full-width JAX model on the CPU, about a minute).
"""

from __future__ import annotations

import hashlib
import io
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
from bdd100k_tpu_torch.configs import get_config, tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.data import augment as port_augment  # noqa: E402
from bdd100k_tpu_torch.data import bdd100k as port_labels  # noqa: E402
from bdd100k_tpu_torch.data import pipeline as port_pipeline  # noqa: E402
from bdd100k_tpu_torch.data.native_decode import NativeDecoder, decode_full  # noqa: E402
from bdd100k_tpu_torch.data.synthetic import ensure_synthetic_dataset  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.ops.nms import Detections  # noqa: E402
from bdd100k_tpu_torch.utils import weights as port_weights  # noqa: E402

ARTIFACT = ROOT / "artifacts" / "ssd_mobilenet_300_synth9k.npz"
FIXTURES = ROOT / "tests" / "fixtures"
SYNTH = FIXTURES / "synth_val_seed1"
LABELS = SYNTH / "labels" / "val.json"
IMAGES = SYNTH / "images" / "val"
FIXTURE = FIXTURES / "torch_ref_eval_synth9k.npz"
N_SCENES = 64
EVAL_BATCH = 32
# the f32 detections of the two frameworks differ by their summation
# orders only: tests/test_torch_predictor.py measured 1.2e-5 (boxes) and
# 1.9e-6 (scores) on the same model and holds them at 1e-4
DET_ATOL = 1e-4
MAP_ATOL = 1e-6
# (image, slot): the two detections at slots s and s+1 have reference
# scores within 1e-6 of each other (near-ties between unrelated boxes,
# 3e-8 to 1e-7 apart; of one class at (35, 120), of two elsewhere),
# inside the two frameworks' f32 disagreement, and the port orders them
# the other way. Each swap is undone by name before the slot-by-slot
# comparison; any other flip fails, named. mAP is unaffected (equal).
NEAR_TIE_SWAPS = ((9, 98), (19, 84), (20, 189), (33, 119), (35, 120),
                  (58, 89), (60, 94))
NEAR_TIE = 1e-6


def _jpeg_files() -> list[Path]:
    return sorted(IMAGES.glob("*.jpg")) + sorted(FIXTURES.glob("synthetic_train_*.jpg"))


def _ref_decoder():
    return ref_pool().NativeDecoder(4)


# ------------------------------------------------------------------ labels


def _assert_records_equal(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        assert g["boxes"].dtype == w["boxes"].dtype == np.float32
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["labels"].dtype == w["labels"].dtype
        assert g["attributes"] == w["attributes"]
        assert g["box_attributes"] == w["box_attributes"]


@pytest.mark.parametrize("path", [LABELS, FIXTURES / "labels.json"],
                         ids=["synth_val_seed1", "labels.json"])
def test_label_parser_on_committed_labels(path):
    from bdd100k_tpu.data.bdd100k import load_bdd100k_labels as ref_load

    got = port_labels.load_bdd100k_labels(path)
    _assert_records_equal(got, ref_load(path))
    assert sum(len(r["labels"]) for r in got) > 0


def _box(x1, y1, x2, y2):
    return {"x1": x1, "y1": y1, "x2": x2, "y2": y2}


HAND_RECORDS = [
    {"name": "aliases.jpg", "attributes": {"weather": "rainy"},
     "labels": [{"category": a, "box2d": _box(10, 20, 110, 220)}
                for a in ("bicycle", "motorcycle", "pedestrian",
                          "traffic_light", "traffic_sign", "car")]},
    {"name": "unknown.jpg",
     "labels": [{"category": "lane", "poly2d": [[0, 0], [5, 5]]},
                {"category": "drivable area", "box2d": _box(0, 0, 50, 50)},
                {"category": "bus"},  # no box2d
                {"category": "truck", "box2d": _box(5, 5, 60, 70),
                 "attributes": {"occluded": True, "truncated": 1}}]},
    {"name": "clamped.jpg",
     "labels": [{"category": "car", "box2d": _box(-12.5, -3, 1300, 740)},
                {"category": "train", "box2d": _box(1200, 700, 1400, 800)}]},
    {"name": "degenerate.jpg",
     "labels": [{"category": "car", "box2d": _box(100, 100, 100, 200)},
                {"category": "car", "box2d": _box(100, 200, 300, 150)},
                {"category": "rider", "box2d": _box(-50, 10, -5, 90)},
                {"category": "person", "box2d": _box(1290, 10, 1300, 90)},
                {"category": "bike", "box2d": _box(400.25, 300.5, 401, 301)}]},
    {"name": "empty.jpg", "labels": None, "attributes": None},
    {"labels": []},
]


@pytest.mark.parametrize("record", HAND_RECORDS,
                         ids=[r.get("name", "no_name") for r in HAND_RECORDS])
def test_label_parser_on_hand_records(record):
    from bdd100k_tpu.data.bdd100k import parse_bdd100k_record as ref_parse

    got = port_labels.parse_bdd100k_record(record)
    _assert_records_equal([got], [ref_parse(record)])
    name = record.get("name")
    if name == "aliases.jpg":
        assert got["labels"].tolist() == [6, 7, 4, 8, 9, 1]
    elif name == "unknown.jpg":
        assert got["labels"].tolist() == [3]
        assert got["box_attributes"] == [{"occluded": True, "truncated": True}]
    elif name == "clamped.jpg":
        np.testing.assert_array_equal(
            got["boxes"], np.float32([[0, 0, 1, 1], [1200 / 1280, 700 / 720, 1, 1]]))
    elif name == "degenerate.jpg":
        assert got["labels"].tolist() == [6]  # only the sliver with area
    else:
        assert got["boxes"].shape == (0, 4) and got["labels"].shape == (0,)


def test_label_parser_on_a_directory_of_jsons(tmp_path):
    from bdd100k_tpu.data.bdd100k import load_bdd100k_labels as ref_load

    records = json.loads(LABELS.read_text())[:5]
    for i, r in enumerate(reversed(records)):  # names sort back into order
        (tmp_path / f"{4 - i:03d}.json").write_text(json.dumps(r))
    (tmp_path / "notes.txt").write_text("not a label")
    got = port_labels.load_bdd100k_labels(tmp_path)
    _assert_records_equal(got, ref_load(tmp_path))
    assert [r["name"] for r in got] == [r["name"] for r in records]


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("size", [300, 150, 64, 512, 384])
@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_pool_decode_bit_equal_to_reference(wire, size):
    """All 64 val JPEGs and the train fixtures: 1/2-scale IDCT at 300 and
    150, 1/8 at 64, full-scale IDCT with fancy upsampling at 512 and at
    384 (YOLO's decode size)."""
    jpegs = [p.read_bytes() for p in _jpeg_files()]
    assert len(jpegs) == N_SCENES + 4
    ref = _ref_decoder()
    dec = NativeDecoder(4)
    try:
        if wire == "rgb":
            np.testing.assert_array_equal(dec.decode_batch(jpegs, size),
                                          ref.decode_batch(jpegs, size))
        else:
            got, want = (dec.decode_batch_yuv420(jpegs, size),
                         ref.decode_batch_yuv420(jpegs, size))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    finally:
        dec.close()


def _encodings() -> dict[str, bytes]:
    """JPEGs the fixtures do not cover: other chroma subsamplings, gray,
    optimized Huffman tables, quality 100, restart markers, sizes that are
    no multiple of the MCU."""
    from PIL import Image

    base = np.asarray(Image.open(IMAGES / "synthetic_val_00000.jpg").convert("RGB"))
    rng = np.random.RandomState(0)
    out = {}

    def enc(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", **kw)
        return buf.getvalue()

    for h, w in ((720, 1280), (201, 333), (37, 45)):
        crop = np.ascontiguousarray(base[:h, :w])
        noise = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for name, img in (("scene", crop), ("noise", noise)):
            tag = f"{name}{h}x{w}"
            for ss in (0, 1, 2):
                out[f"{tag}_subsampling{ss}"] = enc(img, quality=90, subsampling=ss)
            out[f"{tag}_optimized"] = enc(img, quality=75, optimize=True)
            out[f"{tag}_q100"] = enc(img, quality=100)
            out[f"{tag}_gray"] = enc(img[..., 0], quality=85)
            out[f"{tag}_restart_blocks"] = enc(img, quality=90, restart_marker_blocks=3)
    return out


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_pool_decode_bit_equal_on_other_encodings(wire):
    encodings = _encodings()
    ref = _ref_decoder()
    dec = NativeDecoder(2)
    bad = []
    try:
        for name, jpeg in encodings.items():
            for size in (300, 64, 16, 600):
                if wire == "rgb":
                    got = (dec.decode_batch([jpeg], size),)
                    want = (ref.decode_batch([jpeg], size),)
                else:
                    got = dec.decode_batch_yuv420([jpeg], size)
                    want = ref.decode_batch_yuv420([jpeg], size)
                if any(not np.array_equal(g, w) for g, w in zip(got, want)):
                    bad.append((name, size))
    finally:
        dec.close()
    assert not bad, f"differs from the reference's decode: {bad}"


def _progressive_encodings() -> dict[str, bytes]:
    """synthetic_val_00001.jpg re-saved progressive by PIL (libjpeg's
    default scan script: spectral selection and successive approximation,
    end-of-band runs): 4:2:0, 4:4:4, gray, and with restart markers."""
    from PIL import Image

    base = np.asarray(Image.open(IMAGES / "synthetic_val_00001.jpg").convert("RGB"))

    def enc(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90,
                                  progressive=True, **kw)
        return buf.getvalue()

    return {"420": enc(base), "444": enc(base, subsampling=0),
            "gray": enc(base[..., 0]), "restart": enc(base, restart_marker_blocks=3)}


@pytest.mark.parametrize("variant", ["420", "444", "gray", "restart"])
def test_pool_decodes_progressive_as_the_reference(variant):
    """Bit-equal to the reference's native decode at 300 (rgb and yuv420)
    and 512, and to PIL at 1/1."""
    from PIL import Image

    jpeg = _progressive_encodings()[variant]
    assert b"\xff\xc2" in jpeg  # SOF2: progressive
    ref = _ref_decoder()
    dec = NativeDecoder(2)
    try:
        for size in (300, 512):
            np.testing.assert_array_equal(dec.decode_batch([jpeg], size),
                                          ref.decode_batch([jpeg], size))
        if variant != "gray":  # the yuv420 wire takes YCbCr JPEGs
            for g, w in zip(dec.decode_batch_yuv420([jpeg], 300),
                            ref.decode_batch_yuv420([jpeg], 300)):
                np.testing.assert_array_equal(g, w)
    finally:
        dec.close()
    with Image.open(io.BytesIO(jpeg)) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(decode_full(jpeg), want)


def test_pool_decodes_truncated_as_the_reference():
    """A baseline file cut in half, and a progressive one cut in its last
    scan (every coefficient's scans begun, so libjpeg's interblock
    smoothing is off): equal to the reference's decode, which pads the
    missing data with zeros. Cuts before the last scans, which libjpeg
    smooths: the next test."""
    whole = (IMAGES / "synthetic_val_00002.jpg").read_bytes()
    progressive = _progressive_encodings()["420"]
    last_sos = progressive.rindex(b"\xff\xda")
    cuts = [whole[:len(whole) // 2],
            progressive[:(last_sos + len(progressive)) // 2]]
    ref = _ref_decoder()
    dec = NativeDecoder(1)
    try:
        for cut in cuts:
            for size in (300, 512):
                np.testing.assert_array_equal(dec.decode_batch([cut], size),
                                              ref.decode_batch([cut], size))
        with pytest.raises(ValueError, match="yuv420 needs an even"):
            dec.decode_batch_yuv420([whole], 301)
    finally:
        dec.close()


# (variant, share of the file kept) of the early progressive cuts: the
# 4:2:0 file at 5, 20 and 35 % (inside its Y AC 1-5 scan, its first Y
# refinement and its Cb refinement), gray and 4:4:4 at 20 %
SMOOTHED_CUTS = [("420", 0.05), ("420", 0.20), ("420", 0.35), ("gray", 0.20),
                 ("444", 0.20)]


@pytest.mark.parametrize("variant,share", SMOOTHED_CUTS,
                         ids=[f"{v}-{int(s * 100)}pct" for v, s in SMOOTHED_CUTS])
def test_pool_smooths_early_progressive_cuts_as_the_reference(variant, share):
    """A progressive file cut before its last scans: libjpeg-turbo 2.1's
    interblock smoothing estimates the coefficients that are not yet
    refined, from the DC values around each block (the iMCU rows past the
    cut with the status before the cut scan). The pool's decode equals the
    reference pool's at 300 (rgb and yuv420) and 512."""
    jpeg = _progressive_encodings()[variant]
    cut = jpeg[:int(len(jpeg) * share)]
    assert cut.count(b"\xff\xda") < jpeg.count(b"\xff\xda")  # scans missing
    ref = _ref_decoder()
    dec = NativeDecoder(2)
    try:
        for size in (300, 512):
            np.testing.assert_array_equal(dec.decode_batch([cut], size),
                                          ref.decode_batch([cut], size))
        if variant != "gray":
            for g, w in zip(dec.decode_batch_yuv420([cut], 300),
                            ref.decode_batch_yuv420([cut], 300)):
                np.testing.assert_array_equal(g, w)
    finally:
        dec.close()


@pytest.mark.parametrize("variant", ["420", "444", "gray", "restart"])
def test_pool_decodes_every_cut_as_the_reference(variant):
    """The progressive file cut at every whole percent of its length: the
    pool's decode at 300 and 512 equals the reference pool's, or both
    refuse the cut. This holds the cuts inside marker segments (read on
    through the fake EOI bytes libjpeg's memory source supplies, with a
    Huffman table checked only when a scan uses it) and at restart
    boundaries (the MCU after a clean interval decodes from zero bits)."""
    jpeg = _progressive_encodings()[variant]
    ref = _ref_decoder()
    dec = NativeDecoder(2)

    def run(d, cut, size):
        try:
            return d.decode_batch([cut], size)
        except ValueError:
            return None

    decoded = 0
    try:
        for pct in range(1, 100):
            cut = jpeg[:len(jpeg) * pct // 100]
            for size in (300, 512):
                got, want = run(dec, cut, size), run(ref, cut, size)
                assert (got is None) == (want is None), (pct, size)
                if want is not None:
                    np.testing.assert_array_equal(got, want, err_msg=f"{pct} %")
                    decoded += 1
    finally:
        dec.close()
    assert decoded >= 190


def test_full_resolution_routes_refuse_truncated_jpegs_as_pil(tmp_path):
    """PIL raises "image file is truncated" on a JPEG whose data ends
    before its EOI marker (LOAD_TRUNCATED_IMAGES is off): the port's
    full-resolution routes, which the reference serves through PIL, raise
    too, naming the file; the pool at a decode_size decodes what is
    there, as the reference's pool does."""
    from PIL import Image, ImageFile

    assert not ImageFile.LOAD_TRUNCATED_IMAGES
    baseline = (IMAGES / "synthetic_val_00002.jpg").read_bytes()
    progressive = _progressive_encodings()["420"]
    for name, data in (("base", baseline), ("prog", progressive)):
        cut = data[:len(data) // 2]
        with pytest.raises(OSError, match="truncated"):
            with Image.open(io.BytesIO(cut)) as im:
                im.convert("RGB")
        with pytest.raises(OSError, match=f"{name}.jpg.*truncated"):
            decode_full(cut, name=f"{name}.jpg")
        with pytest.raises(OSError, match="truncated"):
            decode_full(data[:-1])  # only the EOI marker's last byte gone
        (tmp_path / f"{name}.jpg").write_bytes(cut)
        np.testing.assert_array_equal(decode_full(data), decode_full(data + b"xx"))
    records = [{"name": "base.jpg", "boxes": np.zeros((0, 4), np.float32),
                "labels": np.zeros((0,), np.int32)}]
    ds = port_pipeline.DetectionDataset(records, tmp_path)
    with pytest.raises(OSError, match="base.jpg.*truncated"):
        ds[0]
    with pytest.raises(OSError, match="base.jpg.*truncated"):
        next(port_pipeline.make_loader(ds, 1, shuffle=False, num_epochs=1,
                                       num_workers=1))
    pooled = port_pipeline.DetectionDataset(records, tmp_path, decode_size=300)
    assert pooled[0]["image"].shape == (300, 300, 3)


def test_decoded_pixels_match_the_fixture():
    """The port's decode of the 64 JPEGs against the sha256 the reference's
    decode left in the fixture (and the pixels it stored)."""
    ref = np.load(FIXTURE)
    jpegs = [p.read_bytes() for p in sorted(IMAGES.glob("*.jpg"))]
    dec = NativeDecoder(4)
    try:
        images = dec.decode_batch(jpegs, 300)
    finally:
        dec.close()
    digests = [hashlib.sha256(im.tobytes()).hexdigest() for im in images]
    assert digests == [d.decode() for d in ref["image_sha256"]]
    np.testing.assert_array_equal(images[:4], ref["images_first4"])


# ------------------------------------------------------------------ yuv420


def test_rgb_to_yuv420_host_matches_reference():
    from bdd100k_tpu.data.pipeline import rgb_to_yuv420_host as ref_fn

    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (3, 6, 10, 3)).astype(np.uint8)
    images[0] = 0
    images[1] = 255
    for got, want in zip(port_pipeline.rgb_to_yuv420_host(images), ref_fn(images)):
        np.testing.assert_array_equal(got, want)


def _planes(size: int):
    jpegs = [p.read_bytes() for p in sorted(IMAGES.glob("*.jpg"))[:3]]
    dec = NativeDecoder(2)
    try:
        return dec.decode_batch_yuv420(jpegs, size)
    finally:
        dec.close()


def test_yuv420_to_rgb_batch_matches_reference():
    from bdd100k_tpu.data.augment import yuv420_to_rgb_batch as ref_fn

    y, uv = _planes(300)
    y[0, :4, :4] = 255  # saturate the clip at both ends
    uv[0, :2, :2] = (255, 255)
    y[1, :4, :4] = 0
    uv[1, :2, :2] = (0, 0)
    got = port_augment.yuv420_to_rgb_batch(torch.from_numpy(y), torch.from_numpy(uv))
    want = np.asarray(ref_fn(jnp.asarray(y), jnp.asarray(uv)))
    assert got.shape == (3, 300, 300, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [300, 150])
def test_preprocess_eval_yuv420_matches_reference(size):
    """At 300² the resize folds away (a pure normalize); 150² planes go
    through the antialiased resize to 300."""
    from bdd100k_tpu.data.augment import preprocess_eval_batch as ref_fn

    y, uv = _planes(size)
    got = port_augment.preprocess_eval_batch(
        (torch.from_numpy(y), torch.from_numpy(uv)), 300)
    want = np.asarray(ref_fn((jnp.asarray(y), jnp.asarray(uv)), 300))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 if size == 300 else 1e-5)


# ------------------------------------------------------------------ loader


def _port_dataset(n: int | None = None, size: int = 300):
    ds = port_pipeline.DetectionDataset.from_bdd100k(LABELS, IMAGES, decode_size=size)
    if n is not None:
        ds.records = ds.records[:n]
    return ds


def test_dataset_without_decode_size_decodes_as_pil():
    """Without a decode_size an image decodes at full resolution, to PIL's
    pixels, the reference's route there (tests/test_torch_infer_cli.py
    holds the loader to the reference's, tests/test_torch_decode_repairs.py
    the resize of other sizes)."""
    from PIL import Image

    ds = port_pipeline.DetectionDataset.from_bdd100k(LABELS, IMAGES)
    assert ds.decode_size is None
    with Image.open(IMAGES / ds.records[0]["name"]) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(ds[0]["image"], want)


def test_eval_loader_order_end_and_padded_final_batch():
    ds = _port_dataset(5, size=64)
    batches = list(port_pipeline.make_loader(
        ds, 4, shuffle=False, num_epochs=1, drop_last=False, num_workers=2))
    assert len(batches) == 2  # num_epochs=1 ends
    boxes, labels, mask = ds.padded_gt_arrays()
    order = [0, 1, 2, 3, 4, 4, 4, 4]  # the last index repeated
    got_images = np.concatenate([b.images for b in batches])
    single = np.stack([ds[i]["image"] for i in range(5)])
    np.testing.assert_array_equal(got_images, single[order])
    np.testing.assert_array_equal(np.concatenate([b.boxes for b in batches]),
                                  boxes[order])
    np.testing.assert_array_equal(np.concatenate([b.labels for b in batches]),
                                  labels[order])
    np.testing.assert_array_equal(np.concatenate([b.mask for b in batches]),
                                  mask[order])
    assert ds[3]["name"] == ds.records[3]["name"]
    # dropping the partial batch leaves one; without num_epochs it cycles
    assert len(list(port_pipeline.make_loader(
        ds, 4, shuffle=False, num_epochs=1, num_workers=2))) == 1
    with pytest.raises(ValueError, match="cannot fill one batch"):
        next(port_pipeline.make_loader(ds, 6, num_workers=1))


@pytest.mark.parametrize("shuffle,wire", [(False, "rgb"), (True, "rgb"),
                                          (False, "yuv420")])
def test_eval_loader_matches_reference_loader(shuffle, wire):
    """Every batch of one epoch, images and GT, equal to the reference's
    loader on its native route (shuffled: the same seed's permutation)."""
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.data.pipeline import make_loader as ref_loader

    n = 11
    ds = _port_dataset(n, size=64)
    ref_ds = RefDataset.from_bdd100k(LABELS, IMAGES, decode_size=64)
    ref_ds.records = ref_ds.records[:n]
    kw = dict(shuffle=shuffle, seed=3, num_epochs=1, drop_last=False,
              num_workers=2, wire_format=wire)
    got = list(port_pipeline.make_loader(ds, 4, **kw))
    ref_pool()
    want = list(ref_loader(ref_ds, 4, native_decode=True, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(jax.tree_util.tree_leaves(tuple(g)),
                        jax.tree_util.tree_leaves(tuple(w))):
            np.testing.assert_array_equal(a, b)


def test_resolve_wire_matches_reference():
    from bdd100k_tpu.data.pipeline import resolve_wire as ref_resolve

    odd = types.SimpleNamespace(decode_size=301)
    none = types.SimpleNamespace(decode_size=None)
    even = types.SimpleNamespace(decode_size=300)
    ref_pool()  # "auto" asks the reference whether its pool loaded
    for choice, ds in (("auto", None), ("auto", odd), ("auto", none),
                       ("auto", even), ("rgb", even), ("yuv420", None)):
        assert port_pipeline.resolve_wire(choice, ds) == ref_resolve(choice, ds)


def test_ensure_synthetic_dataset_reads_and_never_writes(tmp_path):
    """A complete split (the committed 64 seed-1 scenes) is read and never
    rewritten; a short one is generated, as the reference's
    ensure_synthetic_dataset does, with the reference's bytes."""
    before = {p: p.stat().st_mtime_ns for p in SYNTH.rglob("*")}
    assert ensure_synthetic_dataset(SYNTH, 64, seed=1, split="val") == LABELS
    assert {p: p.stat().st_mtime_ns for p in SYNTH.rglob("*")} == before
    (tmp_path / "labels").mkdir()
    (tmp_path / "labels" / "val.json").write_text(
        json.dumps(json.loads(LABELS.read_text())[:3]))
    labels = ensure_synthetic_dataset(tmp_path, 4, seed=1, split="val")
    assert labels.read_bytes() == json.dumps(
        json.loads(LABELS.read_text())[:4]).encode()
    for r in json.loads(labels.read_text()):
        assert (tmp_path / "images" / "val" / r["name"]).read_bytes() == (
            IMAGES / r["name"]).read_bytes()


def test_committed_jpegs_equal_a_fresh_reference_generation(tmp_path):
    from bdd100k_tpu.data.synthetic import generate_synthetic_dataset

    labels = generate_synthetic_dataset(tmp_path, num_images=N_SCENES, seed=1,
                                        split="val")
    assert labels.read_bytes() == LABELS.read_bytes()
    fresh = sorted((tmp_path / "images" / "val").glob("*.jpg"))
    assert [p.name for p in fresh] == [p.name for p in sorted(IMAGES.glob("*.jpg"))]
    for p in fresh:
        assert p.read_bytes() == (IMAGES / p.name).read_bytes(), p.name


# ------------------------------------------------------------------ eval


def _eval_args(**kw):
    base = dict(batch_size=EVAL_BATCH, num_workers=4, wire="rgb",
                iou_threshold=0.5, coco_map=True, dump_detections=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _run_eval_recording(monkeypatch, bundle, dataset, args):
    """`run_eval` with the detections of every batch recorded on their
    way out of the eval step (the path itself is unchanged)."""
    dets = []
    real = port_eval.make_eval_step

    def recording(b):
        step = real(b)

        def run(images):
            det = step(images)
            dets.append(Detections(*(t.cpu().numpy() for t in det)))
            return det

        return run

    monkeypatch.setattr(port_eval, "make_eval_step", recording)
    result = port_eval.run_eval(bundle, dataset, args)
    n = len(dataset)
    return result, Detections(*(np.concatenate(a)[:n] for a in zip(*dets)))


def _undo_near_tie_swaps(got: Detections, ref) -> Detections:
    """The port's detections with each of NEAR_TIE_SWAPS swapped back,
    after checking that it is one: a near-tie in the reference, and the
    port's two slots equal to the reference's two, crossed."""
    arrays = [a.copy() for a in got]
    for i, s in NEAR_TIE_SWAPS:
        pair = slice(s, s + 2)
        assert abs(float(ref["scores"][i, s] - ref["scores"][i, s + 1])) < NEAR_TIE, (i, s)
        np.testing.assert_array_equal(got.classes[i, pair], ref["classes"][i, pair][::-1])
        for a in arrays:
            a[i, pair] = a[i, pair][::-1].copy()
    return Detections(*arrays)


def _assert_detections_match(got: Detections, ref) -> None:
    """valid and classes equal slot by slot; boxes (where valid) and
    scores within DET_ATOL. A mismatch names its image and slot."""
    flips = np.argwhere((got.valid != ref["valid"]) | (got.classes != ref["classes"]))
    assert not len(flips), "valid/class differ at (image, slot) " + ", ".join(
        f"({i}, {s}): port {got.classes[i, s]}/{got.scores[i, s]:.6f} vs "
        f"ref {ref['classes'][i, s]}/{ref['scores'][i, s]:.6f}"
        for i, s in flips[:10])
    valid = ref["valid"]
    score_err = np.abs(got.scores - ref["scores"])
    box_err = np.where(valid[..., None], np.abs(got.boxes - ref["boxes"]), 0).max(-1)
    for name, err in (("score", score_err), ("box", box_err)):
        i, s = np.unravel_index(np.argmax(err), err.shape)
        assert err[i, s] <= DET_ATOL, (
            f"{name} differs by {err[i, s]} at image {i}, slot {s}")


def test_run_eval_cpu_f32_matches_jax_fixture(monkeypatch):
    ref = np.load(FIXTURE)
    meta = json.loads(bytes(ref["meta"]).decode())
    assert meta["route"] == "native" and meta["dtype"] == "float32"
    bundle = build_detector(get_config("ssd_mobilenet_300"), dtype=torch.float32,
                            device="cpu")
    step = port_weights.restore_eval_weights(
        bundle.model, ARTIFACT, expect_config="ssd_mobilenet_300")
    assert step == meta["step"]
    result, det = _run_eval_recording(monkeypatch, bundle, _port_dataset(),
                                      _eval_args())
    assert result["num_images"] == N_SCENES
    assert det.boxes.shape == (N_SCENES, 200, 4) and det.valid.sum() > 0
    _assert_detections_match(_undo_near_tie_swaps(det, ref), ref)
    assert abs(result["mAP"] - float(ref["map50"])) <= MAP_ATOL
    per_class = [np.nan if v is None else v for v in result["per_class"].values()]
    np.testing.assert_allclose(per_class, ref["per_class_ap"], rtol=0,
                               atol=MAP_ATOL)
    assert abs(result["coco"]["mAP"] - float(ref["coco_map"])) <= MAP_ATOL


def test_run_eval_cpu_f32_yuv420_matches_jax_fixture():
    """The yuv420 wire end to end: the pool's planes, their rebuild on the
    device and the rest of the path, against the reference's run_eval on
    the same wire."""
    ref = np.load(FIXTURE)
    bundle = build_detector(get_config("ssd_mobilenet_300"), dtype=torch.float32,
                            device="cpu")
    port_weights.restore_eval_weights(bundle.model, ARTIFACT)
    result = port_eval.run_eval(bundle, _port_dataset(),
                                _eval_args(wire="yuv420", coco_map=False))
    assert result["num_images"] == N_SCENES
    assert abs(result["mAP"] - float(ref["map50_yuv420"])) <= MAP_ATOL


def test_dump_detections_match_reference_dump_image():
    from bdd100k_tpu.evaluate import _dump_image as ref_dump

    rng = np.random.RandomState(7)
    b, k = 3, 6
    det = Detections(
        boxes=rng.rand(b, k, 4).astype(np.float32),
        scores=rng.rand(b, k).astype(np.float32),
        classes=rng.randint(1, 11, (b, k)).astype(np.int32),
        valid=rng.rand(b, k) > 0.3)
    ds = types.SimpleNamespace(image_width=1280, image_height=720,
                               records=[{"name": f"f{i}.jpg"} for i in range(5)])
    for idx, row in ((0, 0), (4, 1), (2, 2)):
        got = port_eval._dump_image(ds, idx, det, row)
        assert got == ref_dump(ds, idx, det, row)
        assert len(got["labels"]) == int(det.valid[row].sum())


def test_eval_step_takes_uint8_yuv420_and_float_alike():
    from bdd100k_tpu_torch.parallel.train_step import make_eval_step

    cfg = tiny_test_config("ssd")
    bundle = build_detector(cfg, dtype=torch.float32, device="cpu")
    step = make_eval_step(bundle)
    y, uv = _planes(64)
    rgb = port_augment.yuv420_to_rgb_batch(torch.from_numpy(y), torch.from_numpy(uv))
    a = step((torch.from_numpy(y), torch.from_numpy(uv)))
    c = step((rgb - 0.5) / 0.5)
    assert a.boxes.shape == (3, 200, 4) and a.boxes.is_inference()
    for x, z in zip(a, c):
        torch.testing.assert_close(x, z, rtol=0, atol=0)
    frames = torch.from_numpy(np.stack([_port_dataset(3, 64)[i]["image"]
                                        for i in range(3)]))
    u = step(frames)
    torch.testing.assert_close(
        u.scores, step((frames.float() / 255.0 - 0.5) / 0.5).scores,
        rtol=0, atol=0)


# ------------------------------------------------------------------ weights


def _flax_tree(flat: dict) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree


def test_port_artifact_loads_in_jax_with_the_same_logits(tmp_path):
    from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
    from bdd100k_tpu.configs.train_configs import TrainConfig as JaxTrainConfig
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.parallel.train_step import create_train_state
    from bdd100k_tpu.utils.weights import load_into_state

    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                            device="cpu", seed=3)
    with torch.no_grad():  # move the BN statistics off their init
        for name, buf in bundle.model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.add_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(1)))
    path = tmp_path / "port.npz"
    meta = port_weights.save_detector_npz(
        path, bundle.model.state_dict(), config_name="ssd_tiny_64", step=7,
        source="ema")
    assert meta == {"format_version": 1, "config": "ssd_tiny_64", "step": 7,
                    "source": "ema", "param_dtype": "float16"}
    jb = jax_build(jax_tiny("ssd"), dtype=jnp.float32)
    state = create_train_state(jb, JaxTrainConfig(), jax.random.PRNGKey(0))
    state, step = load_into_state(state, path, ema=True,
                                  expect_config="ssd_tiny_64")
    assert step == 7
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    loc, cls = jb.model.apply({"params": state.params,
                               "batch_stats": state.batch_stats},
                              jnp.asarray(x), train=False)
    # the port's model, with the fp16-rounded params the artifact holds
    sd, _ = port_weights.load_detector_npz(path)
    bundle.model.load_state_dict(sd)
    with torch.inference_mode():
        ploc, pcls = bundle.model(torch.from_numpy(x))
    np.testing.assert_allclose(ploc.numpy(), np.asarray(loc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pcls.numpy(), np.asarray(cls), rtol=0, atol=1e-4)
    # and the artifact is the port's weights: f16 params, f32 statistics
    with np.load(path) as z:
        kinds = {k.split("/")[0]: z[k].dtype for k in z.files if "/" in k}
    assert kinds == {"params": np.float16, "batch_stats": np.float32}


def test_restore_eval_weights_refuses_ema_on_a_params_artifact(tmp_path):
    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                            device="cpu")
    path = tmp_path / "params.npz"
    port_weights.save_detector_npz(path, bundle.model.state_dict(),
                                   config_name="ssd_tiny_64")
    with pytest.raises(SystemExit, match="source='params'"):
        port_weights.restore_eval_weights(bundle.model, path, ema=True)
    assert port_weights.restore_eval_weights(bundle.model, path) == 0


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A port training run of 3 steps with an EMA shadow, and one without."""
    from bdd100k_tpu_torch import train as port_train

    runs = {}
    for name, extra in (("ema", ["--ema_decay", "0.9"]), ("plain", [])):
        d = tmp_path_factory.mktemp(name)
        port_train.main(["--config", "ssd_tiny_64", "--synthetic", "8",
                         "--batch_size", "4", "--total_steps", "3",
                         "--warmup_steps", "0", "--log_every", "1",
                         "--ckpt_dir", str(d), "--device", "cpu", *extra])
        runs[name] = d
    return runs


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema"])
def test_restore_eval_weights_from_a_port_run_directory(tiny_run, ema):
    run = tiny_run["ema"]
    payload = torch.load(run / "ckpt_3.pt", weights_only=True)
    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                            device="cpu")
    step = port_weights.restore_eval_weights(bundle.model, run, ema=ema,
                                             expect_config="ssd_tiny_64")
    assert step == 3
    params = [p.detach() for p in bundle.model.parameters()]
    want = payload["ema"] if ema else [
        payload["model"][k] for k, _ in bundle.model.named_parameters()]
    for p, w in zip(params, want, strict=True):
        torch.testing.assert_close(p, w, rtol=0, atol=0)
    for k, buf in bundle.model.named_buffers():  # BN statistics either way
        torch.testing.assert_close(buf, payload["model"][k], rtol=0, atol=0)
    assert not torch.equal(payload["ema"][0], payload["model"][
        next(iter(dict(bundle.model.named_parameters())))])


def test_restore_eval_weights_ema_needs_a_shadow(tiny_run, tmp_path):
    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                            device="cpu")
    with pytest.raises(SystemExit, match="without --ema_decay"):
        port_weights.restore_eval_weights(bundle.model, tiny_run["plain"], ema=True)
    before = [p.clone() for p in bundle.model.parameters()]
    assert port_weights.restore_eval_weights(bundle.model, tmp_path / "none") == 0
    assert all(torch.equal(a, b) for a, b in zip(before, bundle.model.parameters()))
    assert not (tmp_path / "none").exists()


# ------------------------------------------------------------------ CLI


def test_evaluate_cli_on_the_cpu(tmp_path):
    """As a user types it, at full width in bf16 on five scenes at batch 4
    (a padded final batch): the dump and the results JSON are written with
    the reference's keys, and the padded rows stay out of the mAP."""
    dump, out = tmp_path / "dets.json", tmp_path / "result.json"
    result = port_eval.main([
        "--synthetic", "5", "--synthetic_dir", str(SYNTH),
        "--ckpt_dir", str(ARTIFACT), "--batch_size", "4", "--coco_map",
        "--nms", "pallas", "--preselect", "approx", "--num_workers", "2",
        "--dump_detections", str(dump), "--out", str(out), "--device", "cpu"])
    assert result["num_images"] == 5
    assert 0.0 < result["mAP"] <= 1.0
    entries = json.loads(dump.read_text())
    assert [e["name"] for e in entries] == [
        r["name"] for r in json.loads(LABELS.read_text())[:5]]
    saved = json.loads(out.read_text())
    assert set(saved) >= {"mAP", "per_class", "coco", "images_per_sec",
                          "num_images"}
    assert set(saved["per_class"]) == set(port_eval.BDD100K_CLASSES)


def test_evaluate_cli_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_eval.main(["--synthetic", "4", "--synthetic_dir", str(SYNTH),
                        "--ckpt_dir", str(ARTIFACT)])


@pytest.mark.parametrize("argv,calibrated", [
    (["--quant", "int8"], None),
    (["--quant", "int8_static", "--calib_batches", "1"], 8),
], ids=["int8", "int8_static_calib_batches"])
def test_evaluate_cli_runs_int8(tmp_path, argv, calibrated):
    """`--quant` as the reference's: int8 runs as it is, int8_static first
    calibrates on the eval set's first --calib_batches batches of 8 and
    records the protocol in the result JSON."""
    out = tmp_path / "result.json"
    result = port_eval.main(argv + [
        "--synthetic", "10", "--synthetic_dir", str(SYNTH),
        "--ckpt_dir", str(ARTIFACT), "--batch_size", "8",
        "--device", "cpu", "--num_workers", "2", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert result["num_images"] == saved["num_images"] == 10
    assert 0.3 < result["mAP"] <= 1.0
    if calibrated is None:
        assert "calib_images_used" not in saved
    else:
        assert saved["calib_images_used"] == calibrated
        assert saved["calib_source"] == "eval-set head"


@pytest.mark.parametrize("argv,refusal", [
    (["--multihost"], None),
    (["--mesh_data", "2"], "must equal the world size"),
    (["--sync_dir", "sync"], None),
    (["--mesh_data", "1"], None),
    (["--multihost", "--sync_dir", "sync", "--mesh_data", "1"], None),
])
def test_evaluate_cli_refuses_flags_of_later_slices(tmp_path, monkeypatch, argv,
                                                    refusal):
    """Evaluate has no flag of a later slice left: item 11's run, a world of
    one rank evaluating as one process (as the reference's does), and
    only a --mesh_data other than the world size is refused, as the
    reference's mesh refuses to need more devices than it has."""
    monkeypatch.chdir(tmp_path)
    argv = argv + ["--synthetic", "4", "--synthetic_dir", str(SYNTH),
                   "--ckpt_dir", str(ARTIFACT), "--batch_size", "4",
                   "--num_workers", "2", "--device", "cpu"]
    if refusal is not None:
        with pytest.raises(SystemExit, match=refusal):
            port_eval.main(argv)
        return
    if "--multihost" in argv:
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                     ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
            monkeypatch.setenv(k, v)
    result = port_eval.main(argv)
    assert result["num_images"] == 4 and 0.0 < result["mAP"] <= 1.0


@pytest.fixture(scope="module")
def yolo_tiny_artifact(tmp_path_factory):
    """A port-written `yolo_tiny_64` artifact from the seeded init."""
    bundle = build_detector(tiny_test_config("yolo"), dtype=torch.float32,
                            device="cpu", seed=1)
    path = tmp_path_factory.mktemp("yolo") / "yolo_tiny.npz"
    port_weights.save_detector_npz(path, bundle.model.state_dict(),
                                   config_name="yolo_tiny_64")
    return path


@pytest.mark.parametrize("extra", [
    [], ["--yolo_priors", str(ROOT / "artifacts" / "yolo_priors_synth4k.json")],
], ids=["default_priors", "yolo_priors"])
def test_evaluate_cli_runs_yolo_on_the_cpu(yolo_tiny_artifact, tmp_path,
                                           monkeypatch, extra):
    """The YOLO configs and --yolo_priors run through the CLI (the tiny
    YOLO config, 5 scenes at batch 4); the dataset decodes at the config's
    image size, and the priors reach the anchors."""
    seen = {}
    real = port_eval.run_eval

    def recording(bundle, dataset, args):
        seen.update(anchors=bundle.anchors, decode_size=dataset.decode_size)
        return real(bundle, dataset, args)

    out = tmp_path / "result.json"
    monkeypatch.setattr(port_eval, "run_eval", recording)
    result = port_eval.main([
        "--config", "yolo_tiny_64", "--synthetic", "5",
        "--synthetic_dir", str(SYNTH), "--ckpt_dir", str(yolo_tiny_artifact),
        "--batch_size", "4", "--num_workers", "2", "--out", str(out),
        "--device", "cpu", *extra])
    assert result["num_images"] == 5 and np.isfinite(result["mAP"])
    assert seen["decode_size"] == 64
    priors = tiny_test_config("yolo").yolo_priors
    if extra:
        priors = json.loads(Path(extra[1]).read_text())
    assert float(seen["anchors"][0, 2]) == np.float32(priors[0][0][0])
    assert set(json.loads(out.read_text())) >= {"mAP", "per_class", "num_images"}


# ------------------------------------------------------------------ fixture


def make_fixture() -> None:
    """Run the reference's eval path in f32 over the 64 JPEGs on the CPU,
    and its bf16 run_eval (the CLI's dtype), and write the fixture."""
    jax.config.update("jax_platforms", "cpu")
    from bdd100k_tpu.configs.detector_configs import BDD100K_CLASSES
    from bdd100k_tpu.configs.detector_configs import get_config as jax_config
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.data.pipeline import make_loader as ref_loader
    from bdd100k_tpu.evaluate import run_eval as ref_run_eval
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.ops.map_metric import DetectionEvaluator
    from bdd100k_tpu.parallel.train_step import make_eval_step
    from bdd100k_tpu.utils.weights import load_detector_npz as jax_load_npz

    ref_pool()
    flat_params, flat_stats, meta = jax_load_npz(ARTIFACT)
    params = _flax_tree({k: np.asarray(v, np.float32) for k, v in flat_params.items()})
    stats = _flax_tree({k: np.asarray(v, np.float32) for k, v in flat_stats.items()})
    ds = RefDataset.from_bdd100k(LABELS, IMAGES, max_boxes=100, decode_size=300)
    cfg = jax_config("ssd_mobilenet_300")
    bundle = jax_build(cfg, dtype=jnp.float32)
    step = make_eval_step(bundle)
    evaluator = DetectionEvaluator(cfg.num_classes, list(BDD100K_CLASSES))
    dets, images, seen = [], [], 0
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
            images.append(np.asarray(batch.images[i]))
            seen += 1
    result = evaluator.compute(iou_threshold=0.5)
    coco = evaluator.compute_range()
    # the reference's own run_eval: in f32 on the yuv420 wire, and in bf16
    # (the CLI's default dtype) on rgb
    state = types.SimpleNamespace(params=params, batch_stats=stats)
    args = types.SimpleNamespace(batch_size=EVAL_BATCH, num_workers=4,
                                 wire="yuv420", iou_threshold=0.5,
                                 coco_map=False, dump_detections=None)
    yuv_map = ref_run_eval(bundle, state, ds, args, mesh=None)["mAP"]
    args.wire = "rgb"
    bf16_map = ref_run_eval(jax_build(cfg), state, ds, args, mesh=None)["mAP"]
    boxes, scores, classes, valid = (np.stack(a) for a in zip(*dets))
    np.savez_compressed(
        FIXTURE,
        boxes=boxes, scores=scores, classes=classes, valid=valid,
        map50=np.float64(result["mAP"]),
        map50_yuv420=np.float64(yuv_map),
        per_class_ap=np.asarray(
            [np.nan if v is None else v for v in result["per_class"].values()],
            np.float64),
        coco_map=np.float64(coco["mAP"]),
        image_sha256=np.asarray(
            [hashlib.sha256(im.tobytes()).hexdigest() for im in images], "S64"),
        images_first4=np.stack(images[:4]),
        meta=np.frombuffer(json.dumps({
            "artifact": ARTIFACT.name, "step": meta.get("step"),
            "scenes": "tests/fixtures/synth_val_seed1, seed 1, all 64",
            "route": "native", "decode_size": 300, "dtype": "float32",
            "batch_size": EVAL_BATCH, "jax": jax.__version__,
            "reference_bf16_run_eval_map50": bf16_map,
        }).encode(), np.uint8),
    )
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes): mAP@0.5 "
          f"{result['mAP']:.6f} (f32), {yuv_map:.6f} (f32, yuv420), "
          f"{bf16_map:.6f} (bf16), COCO {coco['mAP']:.6f}")


if __name__ == "__main__":
    if "--make-fixture" in sys.argv:
        make_fixture()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
