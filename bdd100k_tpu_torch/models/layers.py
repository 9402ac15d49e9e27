"""Conv building blocks (mirror of bdd100k_tpu/models/layers.py).

Activations flow as NCHW tensors in channels_last memory, i.e. NHWC in
memory like the reference, so the depthwise kernel reads them in place.
Parameters stay f32 (flax's param_dtype); each conv casts its input and
weight to the working type `dtype` (bf16 by default, f32 for comparisons),
and BatchNorm runs in f32 with flax's formula before ReLU6 in `dtype`.
Submodule names follow the flax paths (`Conv_0`, `BatchNorm_0`) so the
weight mapping in utils/weights.py is mechanical.

Parameters start where flax starts them: every conv kernel from
lecun_normal (a normal truncated at ±2σ with σ = √(1/fan_in) / 0.8796…,
the std of a unit normal truncated there), every bias at 0, BatchNorm at
scale 1, bias 0, mean 0, var 1. `init_params` redraws a whole model from an
explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from bdd100k_tpu_torch.ops.depthwise import (
    conv2d_same,
    depthwise_conv3x3,
    same_pads,
)

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # flax momentum 0.97
# std of a unit normal truncated to (−2, 2): flax's variance_scaling divides
# by it so that the truncated draw keeps the variance it asks for
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None):
    """flax `lecun_normal()` = variance_scaling(1, "fan_in",
    "truncated_normal") on a torch (O, I/groups, kh, kw) weight, whose
    fan_in is I/groups·kh·kw, as flax's for the HWIO kernel."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)
    return weight


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm in f32 with flax's operation order:
    (x − mean) · (rsqrt(var + eps) · scale) + bias.

    In train mode the statistics are the batch's, taken over (N, H, W) in
    f32 with flax's fast variance E[x²] − E[x]² clipped at 0 (biased), and
    the running statistics move as ra ← 0.97·ra + 0.03·batch with that
    biased variance. `F.batch_norm(training=True)` would fold the unbiased
    variance into `running_var`, so it is not used."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(
                    keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(
                    keep * self.running_var + self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + (
            self.bias[:, None, None]
        )


class Conv(nn.Conv2d):
    """nn.Conv2d with flax SAME/VALID padding, a kernel dilation and a
    per-call working type."""

    def __init__(self, in_ch, features, kernel, stride=1, padding="SAME",
                 groups=1, bias=False, dtype=torch.bfloat16, dilation=1):
        super().__init__(in_ch, features, kernel, stride, 0, dilation, groups,
                         bias)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        self.same = padding == "SAME"
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if self.same:
            return conv2d_same(x, w, b, self.stride[0], self.groups,
                               self.dilation[0])
        return F.conv2d(x, w, b, self.stride, 0, self.dilation, self.groups)


class DepthwiseConv3x3(nn.Module):
    """3×3 SAME depthwise conv: stride 1 on the hand-written kernel (CUDA
    tensors) or its plain version (CPU tensors), stride 2 on a grouped
    F.conv2d. Weight (C, 1, 3, 3), as nn.Conv2d(groups=C) keeps it; it is
    left undrawn here, for `init_params` or a load to fill."""

    def __init__(self, features: int, stride: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, 1, 3, 3))
        self.stride = stride
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.to(self.dtype).permute(2, 3, 1, 0)    # (3, 3, 1, C)
        y = depthwise_conv3x3(
            x.to(self.dtype).permute(0, 2, 3, 1), k, (self.stride,) * 2
        )
        return y.permute(0, 3, 1, 2)


class ConvBN(nn.Module):
    """Conv → BatchNorm → ReLU6 (MobileNet block)."""

    def __init__(self, in_ch, features, kernel=3, stride=1, padding="SAME",
                 groups=1, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        if groups > 1 and groups == features == in_ch and kernel == 3 \
                and padding == "SAME":
            self.Conv_0 = DepthwiseConv3x3(features, stride, dtype)
        else:
            self.Conv_0 = Conv(in_ch, features, kernel, stride, padding,
                               groups, bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        # relu6 = hardtanh(0, 6), whose gradient is 0 at exactly 0 and 6,
        # as jax.nn.relu6's is (a clamp's would pass it there)
        return F.relu6(x.to(self.dtype))


class DepthwiseSeparable(nn.Module):
    """MobileNetV1 block: 3×3 depthwise ConvBN + 1×1 pointwise ConvBN."""

    def __init__(self, in_ch, features, stride=1, dtype=torch.bfloat16):
        super().__init__()
        self.dw = ConvBN(in_ch, in_ch, 3, stride, groups=in_ch, dtype=dtype)
        self.pw = ConvBN(in_ch, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax `max_pool(padding="SAME")` on NCHW: −inf pads where flax pads
    (a 2×2 stride-2 pool on an odd map at the bottom and right only), so a
    pad never wins the max."""
    ph = same_pads(x.shape[-2], window, stride)
    pw = same_pads(x.shape[-1], window, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learned per-channel scale
    (init 20), the SSD conv4_3 normaliser: in f32, x / √(Σc x² + 1e-10) ·
    scale, cast back to the input's type. The scale is `weight`, which the
    weight mapping fills from flax's `scale`."""

    def __init__(self, features: int, init_scale: float = 20.0):
        super().__init__()
        self.init_scale = init_scale
        self.weight = nn.Parameter(torch.full((features,), init_scale))

    def reset_parameters(self) -> None:
        nn.init.constant_(self.weight, self.init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-10)
        return (xf / norm * self.weight[:, None, None]).to(x.dtype)


class VGGConvBlock(nn.Module):
    """n × (3×3 SAME conv with bias → ReLU), no BatchNorm, as classic
    VGG16; the convs are `conv1`..`convN`, the flax names."""

    def __init__(self, in_ch, features, num_convs, dtype=torch.bfloat16):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i + 1}", Conv(
                in_ch if i == 0 else features, features, 3, bias=True,
                dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return x


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of `model` as flax initialises it, in module
    order, from `generator`; BatchNorm back to scale 1, bias 0, mean 0,
    var 1; an L2Norm scale back to its initial value."""
    for mod in model.modules():
        if isinstance(mod, (Conv, DepthwiseConv3x3)):
            mod.reset_parameters(generator)
        elif isinstance(mod, (BatchNorm, L2Norm)):
            mod.reset_parameters()
    return model
