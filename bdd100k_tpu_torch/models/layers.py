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

Modules also take a `quant` mode, "none", "int8" or "int8_static", as the
reference's do: both int8 modes swap the dense convs for `QuantConv`
(int8 weights and activations, an exact int32 accumulator), while the
depthwise convs stay in the working type. The parameters are the same in
every mode, so any checkpoint loads into a quantized model; the static
mode's calibrated activation maxima are buffers of their `QuantConv`s,
outside the state_dict (`models/quant.py` fills them,
`utils/weights.py` carries the reference's `quant` collection over).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from bdd100k_tpu_torch.ops.depthwise import (
    conv2d_same,
    depthwise_conv3x3,
    same_pads,
)
from bdd100k_tpu_torch.ops.int8_conv import int8_conv2d

QUANT_MODES = ("none", "int8", "int8_static")

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


class _MeanOverRanks(torch.autograd.Function):
    """The mean of a tensor over a process group's ranks, in the forward and
    the backward: y = Σ_r x_r / R, so each rank's gradient of x is the mean
    of every rank's gradient of y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


_BN_GROUP = None  # set by global_batch_statistics


@contextlib.contextmanager
def global_batch_statistics(group):
    """BatchNorm in train mode inside the block takes its statistics over
    the global batch that the ranks of `group` hold together (each rank the
    same number of rows), as the reference's BatchNorm does over a batch
    sharded on the mesh; None keeps them local."""
    global _BN_GROUP
    saved, _BN_GROUP = _BN_GROUP, group
    try:
        yield
    finally:
        _BN_GROUP = saved


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm in f32 with flax's operation order:
    (x − mean) · (rsqrt(var + eps) · scale) + bias.

    In train mode the statistics are the batch's, taken over (N, H, W) in
    f32 with flax's fast variance E[x²] − E[x]² clipped at 0 (biased), and
    the running statistics move as ra ← 0.97·ra + 0.03·batch with that
    biased variance. `F.batch_norm(training=True)` would fold the unbiased
    variance into `running_var`, so it is not used. Inside
    `global_batch_statistics(group)`, E[x] and E[x²] are first averaged over
    the group's ranks in one all-reduce (not `nn.SyncBatchNorm`, whose
    Welford update and unbiased running variance are not flax's)."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            mean_sq = (x * x).mean(dim=(0, 2, 3))
            if _BN_GROUP is not None:
                both = _MeanOverRanks.apply(torch.cat([mean, mean_sq]), _BN_GROUP)
                mean, mean_sq = both.chunk(2)
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
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


class Int8Act(NamedTuple):
    """A quantized activation between static-int8 convs: int8 codes (NCHW,
    post-ReLU, so in [0, 127]) and the f32 scalar dequant scale (value ≈
    codes · scale). A `QuantConv` with `emit_int8` makes one; the next
    `QuantConv` takes its codes and scale as they are, and `relu_q` /
    `max_pool_q` act on the codes."""

    codes: torch.Tensor
    scale: torch.Tensor
    # the emitting conv's max(out_amax, 1e-12): scale = out_max · f32(1/127),
    # and the consumer's dequant takes out_max · f32(1/127)², as XLA folds it
    out_max: torch.Tensor | None = None


def relu_q(x):
    """ReLU; a no-op on `Int8Act` (the emitting conv clipped at 0)."""
    return x if isinstance(x, Int8Act) else F.relu(x)


def max_pool_q(x, window: int, stride: int):
    """`max_pool_same`, on the codes of an `Int8Act` (max commutes with the
    positive-scale quantizer; the scale is unchanged). The codes pool as
    f32, which holds them exactly, and the −inf pads never win."""
    if isinstance(x, Int8Act):
        codes = max_pool_same(x.codes.to(torch.float32), window, stride)
        return Int8Act(codes.to(torch.int8), x.scale, x.out_max)
    return max_pool_same(x, window, stride)


def _div(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t as one f32 division (torch's `num / t` multiplies by the
    reciprocal, which rounds twice)."""
    return torch.full_like(t, num) / t


# f32(1/127): XLA folds the reference's divisions by 127 into multiplies
_R127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _mul_add(acc: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None) -> torch.Tensor:
    """acc · scale + bias per output channel, with the product unrounded:
    the fused multiply-add XLA's CPU compiler makes of the reference's
    epilogue. |acc| < 2^27 times an f32 scale is exact in f64, so the sum
    rounds in f64 and again to f32 (a double rounding that differs from
    one fused rounding only when the f64 sum ends in exactly half an f32
    ulp)."""
    out = acc.to(torch.float64) * scale.to(torch.float64)[:, None, None]
    if bias is not None:
        out = out + bias.to(torch.float64)[:, None, None]
    return out.to(torch.float32)


class QuantConv(nn.Module):
    """Post-training int8 conv, with `Conv`'s parameters (reference:
    bdd100k_tpu/models/layers.py QuantConv).

    The arithmetic is the reference's as XLA compiles it (its entry points run
    it jitted), which reassociates and contracts what the source writes:

    Weights: a symmetric scale per output channel over (kh, kw, I),
    w_max = max(|k|, 1e-12), w_scale = w_max · f32(1/127) (the source's
    "/ 127"), codes clip(round(k / w_scale), −127, 127), a true division,
    rounding half to even as jnp.round.

    Activations, dynamic ("int8"): one amax over the whole f32 batch,
    inv = 127 / max(amax, 1e-12), a_scale = 1 / inv, codes
    clip(round(x · inv)), all in f32. Static ("int8_static"): the amax is
    the calibrated `act_amax` buffer, and the quantize runs in the input's
    type: inv = min(127 / max(amax, 1e-12), finfo(type).max) cast to it,
    a_scale = 1 / f32(inv) (in f32 the same bits as the dynamic branch).
    An `Int8Act` input brings its codes and exact scale instead.

    The int32 accumulator (`ops/int8_conv.int8_conv2d`) dequantizes with
    the per-channel scale a_scale · w_scale, which XLA forms as w_max ·
    (a_scale · f32(1/127)) — dynamic: w_max · (max(amax, 1e-12) ·
    f32(1/127)²), since 1 / (127 / m) folds to m / 127 — as one fused
    multiply-add, acc · scale + bias, then casts to `dtype`. With
    `emit_int8` (static only) it requantizes instead: fma(acc, scale ·
    emit_inv, bias · emit_inv) rounded and clipped to [0, 127] (the next
    ReLU folded in), and returns `Int8Act(codes, 1 / emit_inv)`,
    emit_inv = 127 / max(out_amax, 1e-12), whose scale XLA folds to
    max(out_amax, 1e-12) · f32(1/127) (and the consumer's s to
    max(out_amax, 1e-12) · f32(1/127)²).

    While `calibrating`, a static conv first raises `act_amax` to the
    input's f32 amax, quantizes with it, and returns floats; an emitting
    one also raises `out_amax` to max(max(out), 0). The buffers are not
    in the state_dict: the params are what every quant mode shares."""

    def __init__(self, in_ch, features, kernel, stride=1, padding="SAME",
                 bias=False, dtype=torch.bfloat16, dilation=1,
                 static_act=False, emit_int8=False):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype
        self.static_act = static_act
        self.emit_int8 = emit_int8 and static_act
        self.calibrating = False
        if static_act:
            self.register_buffer("act_amax", torch.zeros(()), persistent=False)
        if self.emit_int8:
            self.register_buffer("out_amax", torch.zeros(()), persistent=False)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def quantized_weight(self) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (int8 codes (O, I, kh, kw), f32 w_max (O,)); the scale is
        w_max · f32(1/127)."""
        w = self.weight.to(torch.float32)
        w_max = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12)
        w_scale = w_max * _R127.to(w.device)
        w_q = torch.clamp(torch.round(w / w_scale[:, None, None, None]),
                          -127, 127)
        return w_q.to(torch.int8), w_max

    def quantize_input(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        """The input → (int8 codes, f32 scalar s), with the per-channel
        dequant scale w_max · s: s = a_scale · f32(1/127), or dynamically
        max(amax, 1e-12) · f32(1/127)² (a_scale = 1 / inv = amax / 127)."""
        r127 = _R127.to(x.codes.device if isinstance(x, Int8Act) else x.device)
        if isinstance(x, Int8Act):
            if x.out_max is None:
                return x.codes, x.scale * r127
            return x.codes, x.out_max * (r127 * r127)
        if not self.static_act:
            xf = x.to(torch.float32)
            amax = torch.clamp_min(xf.abs().amax(), 1e-12)
            x_q = torch.clamp(torch.round(xf * _div(127.0, amax)), -127, 127)
            return x_q.to(torch.int8), amax * (r127 * r127)
        if self.calibrating:
            with torch.no_grad():
                self.act_amax.copy_(torch.maximum(
                    self.act_amax, x.to(torch.float32).abs().amax()))
        inv = torch.clamp_max(_div(127.0, torch.clamp_min(self.act_amax, 1e-12)),
                              torch.finfo(x.dtype).max).to(x.dtype)
        x_q = torch.clamp(torch.round(x * inv), -127, 127)
        a_scale = _div(1.0, inv.to(torch.float32))
        return x_q.to(torch.int8), a_scale * r127

    def accumulate(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (the int32 accumulator, the f32 per-channel dequant scale)."""
        x_q, s = self.quantize_input(x)
        w_q, w_max = self.quantized_weight()
        acc = int8_conv2d(x_q, w_q, self.stride, self.padding, self.dilation)
        return acc, w_max * s

    def forward(self, x):
        acc, scale_c = self.accumulate(x)
        bias = None if self.bias is None else self.bias.to(torch.float32)
        if self.emit_int8 and not self.calibrating:
            out_max = torch.clamp_min(self.out_amax, 1e-12)
            emit_inv = _div(127.0, out_max)
            val = _mul_add(acc, scale_c * emit_inv,
                           None if bias is None else bias * emit_inv)
            codes = torch.clamp(torch.round(val), 0, 127).to(torch.int8)
            # 1 / emit_inv, which XLA folds to out_max / 127
            return Int8Act(codes, out_max * _R127.to(out_max.device), out_max)
        out = _mul_add(acc, scale_c, bias)
        if self.emit_int8 and self.calibrating:
            with torch.no_grad():
                self.out_amax.copy_(torch.maximum(
                    self.out_amax, torch.clamp_min(out.amax(), 0.0)))
        return out.to(self.dtype)


def conv2d(quant: str, in_ch, features, kernel, stride=1, padding="SAME",
           groups=1, bias=False, dtype=torch.bfloat16, dilation=1,
           emit_int8=False) -> nn.Module:
    """`Conv`, the depthwise 3×3 module, or in the int8 modes a dense conv's
    `QuantConv` (reference: layers.py conv2d). Depthwise convs stay in the
    working type in every mode; `emit_int8` marks a conv whose (post-ReLU)
    consumer is another quantized conv, and acts in "int8_static" only."""
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}")
    if groups > 1 and groups == features == in_ch and kernel == 3 \
            and padding == "SAME" and dilation == 1:
        return DepthwiseConv3x3(features, stride, dtype)
    if quant != "none" and groups == 1:
        return QuantConv(in_ch, features, kernel, stride, padding, bias, dtype,
                         dilation, static_act=quant == "int8_static",
                         emit_int8=emit_int8)
    return Conv(in_ch, features, kernel, stride, padding, groups, bias, dtype,
                dilation)


class ConvBN(nn.Module):
    """Conv → BatchNorm → ReLU6 (MobileNet block)."""

    def __init__(self, in_ch, features, kernel=3, stride=1, padding="SAME",
                 groups=1, dtype=torch.bfloat16, quant="none"):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = conv2d(quant, in_ch, features, kernel, stride, padding,
                             groups, bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        # relu6 = hardtanh(0, 6), whose gradient is 0 at exactly 0 and 6,
        # as jax.nn.relu6's is (a clamp's would pass it there)
        return F.relu6(x.to(self.dtype))


class DepthwiseSeparable(nn.Module):
    """MobileNetV1 block: 3×3 depthwise ConvBN + 1×1 pointwise ConvBN."""

    def __init__(self, in_ch, features, stride=1, dtype=torch.bfloat16,
                 quant="none"):
        super().__init__()
        self.dw = ConvBN(in_ch, in_ch, 3, stride, groups=in_ch, dtype=dtype,
                         quant=quant)
        self.pw = ConvBN(in_ch, features, 1, dtype=dtype, quant=quant)

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
    VGG16; the convs are `conv1`..`convN`, the flax names. In
    "int8_static" every conv but the last emits int8 codes into the next,
    and the last does too with `emit_out` (its output feeds another
    quantized conv, not a float consumer such as the L2Norm tap)."""

    def __init__(self, in_ch, features, num_convs, dtype=torch.bfloat16,
                 quant="none", emit_out=False):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i + 1}", conv2d(
                quant, in_ch if i == 0 else features, features, 3, bias=True,
                dtype=dtype, emit_int8=i + 1 < num_convs or emit_out))

    def forward(self, x):
        for i in range(self.num_convs):
            x = relu_q(getattr(self, f"conv{i + 1}")(x))
        return x


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of `model` as flax initialises it, in module
    order, from `generator`; BatchNorm back to scale 1, bias 0, mean 0,
    var 1; an L2Norm scale back to its initial value."""
    for mod in model.modules():
        if isinstance(mod, (Conv, DepthwiseConv3x3, QuantConv)):
            mod.reset_parameters(generator)
        elif isinstance(mod, (BatchNorm, L2Norm)):
            mod.reset_parameters()
    return model
