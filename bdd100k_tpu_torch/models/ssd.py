"""SSD multibox heads and detector assembly (mirror of
bdd100k_tpu/models/ssd.py). In the int8 modes the extra stages quantize
and the multibox heads stay in the working type."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from bdd100k_tpu_torch.models.layers import Conv, ConvBN
from bdd100k_tpu_torch.ops.anchors import FeatureMapSpec


class MultiboxHead(nn.Module):
    """Loc + conf 3×3 convs for one feature map."""

    def __init__(self, in_ch, num_boxes, num_classes, dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.loc = Conv(in_ch, num_boxes * 4, 3, bias=True, dtype=dtype)
        self.conf = Conv(in_ch, num_boxes * (num_classes + 1), 3, bias=True,
                         dtype=dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        # NCHW → NHWC before the reshape: (B, H, W, nb·4) → (B, H·W·nb, 4)
        # in row-major (y, x, box) order, the anchor layout of ops/anchors.py
        loc = self.loc(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
        conf = self.conf(x).permute(0, 2, 3, 1).reshape(b, -1, self.num_classes + 1)
        return loc.to(torch.float32), conf.to(torch.float32)


class ExtraFeatureStage(nn.Module):
    """1×1 squeeze + 3×3 downsample conv producing the next pyramid map."""

    def __init__(self, in_ch, mid, out, cur_size, target_size,
                 dtype=torch.bfloat16, quant="none"):
        super().__init__()
        self.squeeze = ConvBN(in_ch, mid, 1, dtype=dtype, quant=quant)
        if target_size == -(-cur_size // 2):        # halve: 3×3 s2 SAME
            self.down = ConvBN(mid, out, 3, 2, dtype=dtype, quant=quant)
        elif target_size == cur_size - 2:           # e.g. 3→1: 3×3 VALID
            self.down = ConvBN(mid, out, 3, 1, padding="VALID", dtype=dtype,
                               quant=quant)
        else:
            raise ValueError(f"can't reach map size {target_size} from {cur_size}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.squeeze(x))


class SSDDetector(nn.Module):
    """Backbone taps + extra stages + multibox heads. Takes NHWC images,
    returns loc (B, A, 4) and conf (B, A, C+1) logits in f32."""

    def __init__(self, backbone: nn.Module, feature_maps: Sequence[FeatureMapSpec],
                 num_classes: int = 10, dtype=torch.bfloat16,
                 quant: str = "none"):
        super().__init__()
        self.backbone = backbone
        self.feature_maps = tuple(feature_maps)
        n_taps = len(backbone.tap_channels)
        chans = list(backbone.tap_channels)
        cur = self.feature_maps[n_taps - 1].size
        for i, fm in enumerate(self.feature_maps[n_taps:]):
            mid, out = (256, 512) if i == 0 else (128, 256)
            self.add_module(
                f"extra{i + 1}",
                ExtraFeatureStage(chans[-1], mid, out, cur, fm.size, dtype,
                                  quant),
            )
            chans.append(out)
            cur = fm.size
        for i, (fm, ch) in enumerate(zip(self.feature_maps, chans)):
            self.add_module(
                f"head{i}", MultiboxHead(ch, fm.num_boxes, num_classes, dtype)
            )
        self.n_taps = n_taps

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        taps = self.backbone(images.permute(0, 3, 1, 2))
        for fm, tap in zip(self.feature_maps, taps):
            if tap.shape[-1] != fm.size:
                raise ValueError(
                    f"backbone tap {tuple(tap.shape)} != feature map {fm.size}"
                )
        feats = list(taps)
        x = taps[-1]
        for i in range(len(self.feature_maps) - self.n_taps):
            x = getattr(self, f"extra{i + 1}")(x)
            feats.append(x)
        locs, confs = [], []
        for i, f in enumerate(feats):
            loc, conf = getattr(self, f"head{i}")(f)
            locs.append(loc)
            confs.append(conf)
        return torch.cat(locs, dim=1), torch.cat(confs, dim=1)
