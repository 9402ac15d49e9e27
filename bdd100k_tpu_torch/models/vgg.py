"""VGG16 backbone, SSD variant (mirror of bdd100k_tpu/models/vgg.py).

Blocks 1–5 of 3×3 convs with bias and ReLU (no BatchNorm), 2×2 stride-2
max pools between them; pool5 is 3×3 at stride 1 (SSD's change, which
keeps stride 16); fc6 and fc7 become a 3×3 conv at dilation 6 and a 1×1
conv. Taps: conv4_3 through its L2Norm at stride 8, relu(fc7) at stride
16. Module names are the flax ones (`block{i}.conv{j}`, `conv4_3_norm`,
`fc6`, `fc7`), so the artifact's keys map onto them mechanically.

In the int8 modes every conv after block1 quantizes. In "int8_static" the
activations stay int8 codes from block2 to fc7 (the requant pipeline):
blocks 2, 3 and 5 and fc6 emit codes, the pools (pool5 too) run on them,
and only block4's last conv dequantizes, for the float L2Norm tap.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdd100k_tpu_torch.models.layers import (
    L2Norm,
    VGGConvBlock,
    conv2d,
    max_pool_q,
    relu_q,
)

# (output channels, convs) of blocks 1–5
_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Backbone(nn.Module):
    """Returns taps at strides (8, 16): (512, 1024) channels."""

    tap_channels = (512, 1024)

    def __init__(self, dtype=torch.bfloat16, quant: str = "none"):
        super().__init__()
        ch = 3
        for i, (out, n) in enumerate(_BLOCKS):
            # block1 stays in the working type; blocks 2, 3 and 5 feed
            # quantized convs through their pools, block4 the L2Norm tap
            q = "none" if i == 0 else quant
            self.add_module(f"block{i + 1}", VGGConvBlock(
                ch, out, n, dtype, q, emit_out=i + 1 in (2, 3, 5)))
            ch = out
        self.conv4_3_norm = L2Norm(512)
        self.fc6 = conv2d(quant, 512, 1024, 3, bias=True, dtype=dtype,
                          dilation=6, emit_int8=True)
        self.fc7 = conv2d(quant, 1024, 1024, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = max_pool_q(self.block1(x), 2, 2)
        x = max_pool_q(self.block2(x), 2, 2)
        x = max_pool_q(self.block3(x), 2, 2)
        x = self.block4(x)
        tap8 = self.conv4_3_norm(x)
        x = self.block5(max_pool_q(x, 2, 2))
        x = max_pool_q(x, 3, 1)  # pool5
        x = relu_q(self.fc6(x))
        tap16 = F.relu(self.fc7(x))
        return [tap8, tap16]
