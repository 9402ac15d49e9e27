"""MobileNetV1 backbone with SSD feature taps (mirror of
bdd100k_tpu/models/mobilenet.py). Stride-1 depthwise layers: ds1, ds3,
ds5, ds7–ds11 and ds13; stride 2: ds2, ds4, ds6 and ds12. In the int8
modes the blocks' pointwise convs quantize; the stem stays in the working
type, as the reference keeps it."""

from __future__ import annotations

import torch
import torch.nn as nn

from bdd100k_tpu_torch.models.layers import ConvBN, DepthwiseSeparable


def _w(ch: int, mult: float) -> int:
    """Width-multiplied channel count, kept a multiple of 8."""
    return max(8, int(ch * mult + 4) // 8 * 8)


# (name, output channels at width 1, stride)
_BLOCKS = (
    ("ds1", 64, 1), ("ds2", 128, 2), ("ds3", 128, 1), ("ds4", 256, 2),
    ("ds5", 256, 1), ("ds6", 512, 2), ("ds7", 512, 1), ("ds8", 512, 1),
    ("ds9", 512, 1), ("ds10", 512, 1), ("ds11", 512, 1), ("ds12", 1024, 2),
    ("ds13", 1024, 1),
)
_TAPS = ("ds5", "ds11", "ds13")  # strides 8, 16, 32


class MobileNetBackbone(nn.Module):
    """Returns taps at strides (8, 16, 32): (256, 512, 1024) channels at
    width 1.0."""

    def __init__(self, width: float = 1.0, dtype=torch.bfloat16,
                 quant: str = "none"):
        super().__init__()
        ch = _w(32, width)
        self.stem = ConvBN(3, ch, 3, 2, dtype=dtype)
        for name, out, stride in _BLOCKS:
            setattr(self, name, DepthwiseSeparable(ch, _w(out, width), stride,
                                                   dtype, quant))
            ch = _w(out, width)
        self.tap_channels = tuple(
            _w(out, width) for name, out, _ in _BLOCKS if name in _TAPS
        )

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem(x)
        taps = []
        for name, _, _ in _BLOCKS:
            x = getattr(self, name)(x)
            if name in _TAPS:
                taps.append(x)
        return taps
