"""PNG decoding to the pixels of PIL's `Image.open(p).convert("RGB")`, with
the stdlib's zlib and numpy (the card's machine has no PIL). The
reference reads PNG input through PIL in its calibration directories and
its serving CLI (bdd100k_tpu/models/quant.py, bdd100k_tpu/infer.py).

Every standard colour type and bit depth, as PIL converts it to RGB:
* grey at 1, 2, 4 and 8 bits scaled to 0–255 (1 bit: 0 or 255); grey at
  16 bits is PIL's mode I;16, whose conversion clips the value to 255;
* RGB at 8 bits; at 16 bits the high byte of each sample;
* palette at 1, 2, 4 and 8 bits through PLTE (an index past the palette
  reads black, as PIL's conversion gives it);
* grey + alpha and RGBA: the alpha dropped, not composited (16 bits: the
  high bytes);
* tRNS ignored (it only marks transparency), and Adam7 interlacing.

The scanlines are unfiltered in C (`csrc/png.cc`, in the decode pool's
library): numpy cannot vectorize the Average and Paeth filters, which
PIL's and libpng's writers use. Chunk CRCs are checked; a file whose image
data ends early raises OSError naming it ("image file is truncated"), as
PIL does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from bdd100k_tpu_torch.utils.host_build import decode_pool_library

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (row start, column start, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes, name: str):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise OSError(f"{name}: image file is truncated (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise OSError(f"{name}: image file is truncated (in a "
                          f"{ctype.decode('latin-1')} chunk)")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + payload) != crc:
            raise OSError(f"{name}: broken PNG file (bad CRC in "
                          f"{ctype.decode('latin-1')})")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end


def _unfilter(raw: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    out = np.empty((rows, stride), np.uint8)
    if rows and stride:
        if decode_pool_library().png_unfilter(raw, rows, stride, bpp,
                                              out.ctypes.data):
            raise ValueError("bad PNG filter type")
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int
             ) -> np.ndarray:
    """Unfiltered rows (R, stride) → samples (R, width, channels), uint8
    for depth ≤ 8 (unscaled), uint16 at 16 bits."""
    r = rows.shape[0]
    if depth == 16:
        s = rows.reshape(r, -1)[:, :width * channels * 2]
        return s.view(">u2").astype(np.uint16).reshape(r, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(r, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    bits = bits.reshape(r, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def _to_rgb(s: np.ndarray, ctype: int, depth: int,
            palette: np.ndarray | None) -> np.ndarray:
    """Samples → (H, W, 3) uint8 as PIL's convert("RGB") gives them."""
    if ctype == 3:
        return palette[s[..., 0]]
    if depth == 16:
        if ctype == 0:  # mode I;16, clipped into 0-255 by the conversion
            grey = np.minimum(s[..., 0], 255).astype(np.uint8)
            return np.repeat(grey[..., None], 3, axis=2)
        s = (s >> 8).astype(np.uint8)
    elif depth < 8:  # grey: 1 bit is mode "1", 2 and 4 bits scale up
        s = s * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def decode_png(data: bytes, name: str | None = None) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8 RGB, the pixels of PIL's
    `Image.open(p).convert("RGB")`; raises OSError naming `name` on a
    truncated or corrupt file."""
    name = name or "PNG data"
    if not is_png(data):
        raise ValueError(f"{name}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            rgb = np.frombuffer(payload, np.uint8).reshape(-1, 3)[:256]
            palette = np.zeros((256, 3), np.uint8)  # past PLTE: black
            palette[:len(rgb)] = rgb
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise OSError(f"{name}: broken PNG file (no IHDR)")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or comp or filt \
            or interlace > 1 or width == 0 or height == 0:
        raise OSError(f"{name}: unsupported PNG (colour type {ctype}, "
                      f"depth {depth}, interlace {interlace})")
    if ctype == 3 and palette is None:
        raise OSError(f"{name}: broken PNG file (palette image without PLTE)")
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat))
    except zlib.error as e:
        raise OSError(f"{name}: broken PNG file ({e})") from e
    channels = _CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)

    def plane(w: int, h: int, offset: int):
        stride = (w * bits + 7) // 8
        size = h * (stride + 1)
        if offset + size > len(raw):
            raise OSError(f"{name}: image file is truncated (the image data "
                          "ends early)")
        rows = _unfilter(raw[offset:offset + size], h, stride, bpp)
        return _samples(rows, w, channels, depth), offset + size

    if interlace == 0:
        samples, _ = plane(width, height, 0)
    else:
        dtype = np.uint16 if depth == 16 else np.uint8
        samples = np.zeros((height, width, 1 if depth < 8 else channels), dtype)
        offset = 0
        for y0, x0, dy, dx in _ADAM7:
            w = (width - x0 + dx - 1) // dx if width > x0 else 0
            h = (height - y0 + dy - 1) // dy if height > y0 else 0
            if w == 0 or h == 0:
                continue
            part, offset = plane(w, h, offset)
            samples[y0::dy, x0::dx] = part
    return _to_rgb(samples, ctype, depth, palette)
