"""The port's PNG decoder (`bdd100k_tpu_torch/data/png.py`) against PIL's
`Image.open(p).convert("RGB")`, on the CPU.

The committed fixtures under `tests/fixtures/png/` are written here with
zlib, not PIL, so they hold what PIL cannot write: grey at 1, 2, 4 and 16
bits (16-bit samples above 255, which PIL's I;16 conversion clips), RGB,
grey + alpha and RGBA at 16 bits (PIL keeps the high byte), palettes at
1, 2, 4 and 8 bits (one shorter than its indices, which PIL reads as
black), tRNS chunks (ignored for RGB), Adam7
interlacing (on odd sizes whose last passes are empty), and all five
filter types, cycled row by row. `pil_sha256.json` holds PIL's decodes,
which `chip_smoke.py`'s `png_decode` checks on the card. Each is also
held to PIL here pixel for pixel, as are PIL-written files of every mode
PIL saves, a 720p frame, and truncated or corrupt files, which both
refuse. Regenerate with `python tests/test_torch_png.py --make-fixture`.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bdd100k_tpu_torch.data.png import _ADAM7, decode_png, is_png  # noqa: E402

PNG_DIR = ROOT / "tests" / "fixtures" / "png"
SHA_FILE = PNG_DIR / "pil_sha256.json"
IMAGES = ROOT / "tests" / "fixtures" / "synth_val_seed1" / "images" / "val"


# ------------------------------------------------------------ the writer


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _filter_rows(raw: np.ndarray, bpp: int) -> bytes:
    """Rows (R, stride) uint8 → filtered scanlines, the filter type
    cycling 0-4 by row."""
    out = bytearray()
    prior = np.zeros(raw.shape[1], np.int32)
    for r, row in enumerate(raw.astype(np.int32)):
        ftype = r % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        b = prior
        if ftype == 0:
            pred = np.zeros_like(row)
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(ftype)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples (H, W, C) → rows (H, stride) of `depth`-bit big-endian
    samples."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None].astype(np.uint8) >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def write_png(samples: np.ndarray, ctype: int, depth: int, *,
              interlace: bool = False, palette: np.ndarray | None = None,
              trns: bytes | None = None) -> bytes:
    """A PNG of `samples` (H, W, C) in colour type `ctype` at `depth`."""
    h, w = samples.shape[:2]
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, channels * depth // 8)
    if interlace:
        data = b"".join(
            _filter_rows(_pack(samples[y0::dy, x0::dx], depth), bpp)
            for y0, x0, dy, dx in _ADAM7 if y0 < h and x0 < w)
    else:
        data = _filter_rows(_pack(samples, depth), bpp)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    # the image data split over two IDAT chunks
    z = zlib.compress(data, 6)
    return (out + _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
            + _chunk(b"IEND", b""))


def _cases() -> dict[str, bytes]:
    """name → PNG bytes, every kind the decoder takes."""
    rng = np.random.RandomState(5)

    def s(h, w, c, depth):
        return rng.randint(0, 1 << depth, (h, w, c)).astype(
            np.uint16 if depth == 16 else np.uint8)

    pal = rng.randint(0, 256, (256, 3))
    out = {}
    for depth in (1, 2, 4, 8, 16):
        out[f"gray{depth}"] = write_png(s(23, 37, 1, depth), 0, depth)
    out["gray16_adam7"] = write_png(s(13, 11, 1, 16), 0, 16, interlace=True)
    out["gray2_adam7"] = write_png(s(9, 14, 1, 2), 0, 2, interlace=True)
    out["gray8_trns"] = write_png(s(23, 37, 1, 8), 0, 8, trns=b"\x00\x07")
    for depth in (8, 16):
        out[f"rgb{depth}"] = write_png(s(23, 37, 3, depth), 2, depth)
        out[f"la{depth}"] = write_png(s(19, 29, 2, depth), 4, depth)
        out[f"rgba{depth}"] = write_png(s(19, 29, 4, depth), 6, depth)
    out["rgb8_trns"] = write_png(s(23, 37, 3, 8), 2, 8, trns=b"\x00\x01\x00\x02\x00\x03")
    out["rgb8_adam7"] = write_png(s(33, 41, 3, 8), 2, 8, interlace=True)
    out["rgba16_adam7"] = write_png(s(7, 5, 4, 16), 6, 16, interlace=True)
    out["rgb8_adam7_1x1"] = write_png(s(1, 1, 3, 8), 2, 8, interlace=True)
    for depth in (1, 2, 4, 8):
        n = 1 << depth
        out[f"pal{depth}"] = write_png(s(23, 37, 1, depth), 3, depth, palette=pal[:n])
    out["pal4_adam7"] = write_png(s(17, 19, 1, 4), 3, 4, interlace=True,
                                  palette=pal[:16])
    out["pal8_trns"] = write_png(s(23, 37, 1, 8), 3, 8, palette=pal,
                                 trns=bytes(range(0, 256, 8)))
    # indices up to 255 against a 40-entry palette
    out["pal8_short"] = write_png(s(23, 37, 1, 8), 3, 8, palette=pal[:40])
    return out


def _pil_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("name", sorted(_cases()))
def test_crafted_png_decodes_as_pil(name):
    data = _cases()[name]
    want = _pil_rgb(data)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_committed_fixtures_are_the_writer_s_and_match_pil_s_sha256():
    shas = json.loads(SHA_FILE.read_text())
    cases = _cases()
    assert sorted(shas) == sorted(cases)
    for name, data in cases.items():
        assert (PNG_DIR / f"{name}.png").read_bytes() == data, name
        assert _sha(decode_png(data)) == shas[name] == _sha(_pil_rgb(data)), name


def _pil_png(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_written() -> dict[str, bytes]:
    from PIL import Image

    rng = np.random.RandomState(3)
    rgb = Image.fromarray(rng.randint(0, 256, (29, 31, 3), np.uint8))
    with Image.open(sorted(IMAGES.glob("*.jpg"))[0]) as im:
        frame = im.convert("RGB")
    return {
        "RGB": _pil_png(rgb), "RGBA": _pil_png(rgb.convert("RGBA")),
        "L": _pil_png(rgb.convert("L")), "LA": _pil_png(rgb.convert("LA")),
        "1": _pil_png(rgb.convert("1")),
        "P": _pil_png(rgb.convert("P", palette=Image.ADAPTIVE, colors=100)),
        "P_bits4": _pil_png(rgb.convert("P", palette=Image.ADAPTIVE, colors=16),
                            bits=4),
        "P_transparency": _pil_png(
            rgb.convert("P", palette=Image.ADAPTIVE, colors=16), transparency=2),
        "I;16": _pil_png(Image.fromarray(
            rng.randint(0, 5000, (29, 31)).astype(np.uint16))),
        "frame_720p": _pil_png(frame),
        "frame_720p_optimized": _pil_png(frame, optimize=True),
    }


@pytest.mark.parametrize("mode", sorted(_pil_written()))
def test_pil_written_png_decodes_as_pil(mode):
    data = _pil_written()[mode]
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def test_truncated_and_corrupt_png_raise_like_pil():
    from PIL import Image

    data = _pil_written()["frame_720p"]
    assert is_png(data) and not is_png(b"\xff\xd8\xff")
    cut = data[:len(data) // 2]
    with pytest.raises(OSError):
        with Image.open(io.BytesIO(cut)) as im:
            im.convert("RGB")
    with pytest.raises(OSError, match="frame.png.*truncated"):
        decode_png(cut, name="frame.png")
    bad = bytearray(data)
    bad[40] ^= 0xFF  # inside the first IDAT: its CRC no longer matches
    with pytest.raises(OSError, match="CRC"):
        decode_png(bytes(bad), name="bad.png")
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8 not a png")


def make_fixture() -> None:
    PNG_DIR.mkdir(parents=True, exist_ok=True)
    shas = {}
    for name, data in _cases().items():
        (PNG_DIR / f"{name}.png").write_bytes(data)
        shas[name] = _sha(_pil_rgb(data))
    SHA_FILE.write_text(json.dumps(shas, indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(shas)} PNGs and {SHA_FILE}")


if __name__ == "__main__":
    if "--make-fixture" in sys.argv:
        make_fixture()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
