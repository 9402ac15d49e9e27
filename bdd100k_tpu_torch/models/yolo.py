"""YOLO-style multi-scale detection head (mirror of
bdd100k_tpu/models/yolo.py).

One head a backbone tap (strides 8, 16, 32): a 3×3 ConvBN to 256 channels
(quantized in the int8 modes), then a 1×1 conv with bias (which stays in
the working type) to k·(5 + C) channels, reshaped to (B, H·W·k,
5 + C) in the (scale, row, col, prior) order of `ops.anchors.yolo_anchors`.
Columns 0–3 are (tx, ty, tw, th); column 4 is the objectness logit and the
rest the class logits, which postprocess scores as sigmoid(obj)·sigmoid(cls).
Module names follow the flax paths (`head{i}/conv`, `head{i}/out`), so the
weight mapping in utils/weights.py carries the reference's artifacts over.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from bdd100k_tpu_torch.models.layers import Conv, ConvBN


class YOLOHead(nn.Module):
    """Detection head for one scale: 3×3 ConvBN → 1×1 conv → k×(5+C)."""

    def __init__(self, in_ch: int, num_priors: int, num_classes: int,
                 mid_channels: int = 256, dtype=torch.bfloat16,
                 quant: str = "none"):
        super().__init__()
        self.num_classes = num_classes
        self.conv = ConvBN(in_ch, mid_channels, 3, dtype=dtype, quant=quant)
        self.out = Conv(mid_channels, num_priors * (5 + num_classes), 1,
                        bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        # NCHW → NHWC before the reshape: (B, H, W, k·(5+C)) → (B, H·W·k, 5+C)
        out = self.out(self.conv(x)).permute(0, 2, 3, 1)
        out = out.reshape(b, -1, 5 + self.num_classes).to(torch.float32)
        return out[..., :4], out[..., 4:]


class YOLODetector(nn.Module):
    """Backbone taps (one a scale) + per-scale heads, concatenated. Takes
    NHWC images, returns loc (B, A, 4) and obj+cls (B, A, 1+C) logits in
    f32."""

    def __init__(self, backbone: nn.Module, priors_per_scale: Sequence[int],
                 num_classes: int = 10, dtype=torch.bfloat16,
                 quant: str = "none"):
        super().__init__()
        self.backbone = backbone
        self.priors_per_scale = tuple(priors_per_scale)
        if len(backbone.tap_channels) != len(self.priors_per_scale):
            raise ValueError(
                f"{len(backbone.tap_channels)} taps for "
                f"{len(self.priors_per_scale)} scales")
        for i, (ch, k) in enumerate(zip(backbone.tap_channels,
                                        self.priors_per_scale)):
            self.add_module(f"head{i}", YOLOHead(ch, k, num_classes,
                                                 dtype=dtype, quant=quant))

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        taps = self.backbone(images.permute(0, 3, 1, 2))
        locs, objs = [], []
        for i, tap in enumerate(taps):
            loc, obj_cls = getattr(self, f"head{i}")(tap)
            locs.append(loc)
            objs.append(obj_cls)
        return torch.cat(locs, dim=1), torch.cat(objs, dim=1)
