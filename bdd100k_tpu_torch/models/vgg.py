"""VGG16 backbone, SSD variant (mirror of bdd100k_tpu/models/vgg.py).

Blocks 1–5 of 3×3 convs with bias and ReLU (no BatchNorm), 2×2 stride-2
max pools between them; pool5 is 3×3 at stride 1 (SSD's change, which
keeps stride 16); fc6 and fc7 become a 3×3 conv at dilation 6 and a 1×1
conv. Taps: conv4_3 through its L2Norm at stride 8, relu(fc7) at stride
16. Module names are the flax ones (`block{i}.conv{j}`, `conv4_3_norm`,
`fc6`, `fc7`), so the artifact's keys map onto them mechanically.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdd100k_tpu_torch.models.layers import Conv, L2Norm, VGGConvBlock, max_pool_same

# (output channels, convs) of blocks 1–5
_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Backbone(nn.Module):
    """Returns taps at strides (8, 16): (512, 1024) channels."""

    tap_channels = (512, 1024)

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        ch = 3
        for i, (out, n) in enumerate(_BLOCKS):
            self.add_module(f"block{i + 1}", VGGConvBlock(ch, out, n, dtype))
            ch = out
        self.conv4_3_norm = L2Norm(512)
        self.fc6 = Conv(512, 1024, 3, bias=True, dtype=dtype, dilation=6)
        self.fc7 = Conv(1024, 1024, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = max_pool_same(self.block1(x), 2, 2)
        x = max_pool_same(self.block2(x), 2, 2)
        x = max_pool_same(self.block3(x), 2, 2)
        x = self.block4(x)
        tap8 = self.conv4_3_norm(x)
        x = self.block5(max_pool_same(x, 2, 2))
        x = max_pool_same(x, 3, 1)  # pool5
        x = F.relu(self.fc6(x))
        tap16 = F.relu(self.fc7(x))
        return [tap8, tap16]
