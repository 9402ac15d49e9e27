"""3×3 SAME depthwise conv, NHWC (counterpart of
bdd100k_tpu/ops/pallas_depthwise.py::depthwise_conv3x3).

Stride 1 — nine of MobileNet's thirteen depthwise layers — runs the
hand-written CUDA kernels of `csrc/depthwise.cu` for a CUDA tensor and the
plain versions below for a CPU tensor; there is no other route. The
forward is the op `bdd100k_tpu_torch::depthwise3x3_s1` (`torch.library`,
so an exported program calls it by name); the layers call it directly at
inference and through `DepthwiseS1` when a gradient is wanted. Stride 2
stays a grouped `F.conv2d` with flax's asymmetric SAME pad, as the
reference keeps XLA for it.

The forward kernel replaces `_fwd_pallas` (pallas_depthwise.py:219) and
the filter-gradient kernel `_fgrad_pallas` (pallas_depthwise.py:242). Both
are bound by bytes (18 flops per element against 2–4 bytes moved), so
their bound is bytes ÷ 3.35 TB/s; the source's header says how the design
meets it. How a shape is cut into work — tile rows and columns, channel
chunk, rows a thread, persistent blocks, shared memory — is decided here
alone, by `_plan`, and handed to the C entry points; `_work_items` mirrors
the kernels' arithmetic over that plan, so the CPU tests can check that
every output is covered once.

Training differentiates the stride-1 route through `DepthwiseS1`, the
counterpart of the custom VJP `_dw3x3_s1` (pallas_depthwise.py:266-285):
dx is the forward kernel run on the output gradient with the filter
flipped in both spatial dims, and dk is the filter-gradient kernel, a
(3, 3, C) f32 reduction over B·H·W in two passes of fixed shape (one
partial a persistent block, then their sum in a fixed order). On CPU
tensors the same Function runs the plain versions of both pieces.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from bdd100k_tpu_torch.utils import cuda_build

LAUNCHES = {"depthwise3x3_s1": 0, "depthwise3x3_s1_fgrad": 0}

SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448      # shared memory one block may use (227 KB)
MAX_THREADS = 256         # csrc/depthwise.cu: __launch_bounds__ (256, 2), so
MAX_REGS = 128            # a thread holds at most 65536 / (256 · 2) registers
MAX_STAGES = 4            # csrc/depthwise.cu: the most buffers in the TMA ring
RING = 128                # csrc/depthwise.cu: the ring's mbarriers, first
ROWS = (8, 4, 2, 1)       # csrc/depthwise.cu: the rows a thread it is built for
CHANNEL_ALIGN = 8         # channel chunks, and C, are multiples of this
FULL_WIDTH = 40           # maps at most this wide are one tile wide
CHUNK_BYTES = 128         # the most bytes of one pixel a tile takes
MIN_ITEMS = 2 * SMS       # work items to leave, where the shape has them
MAX_BLOCKS_PER_SM = 4
STAGES = {"fwd": 2, "fgrad": 3}  # the ring's depth, per kernel


def _r128(n: int) -> int:
    return -(-n // 128) * 128


@dataclass(frozen=True)
class Plan:
    """One launch of a kernel of csrc/depthwise.cu over (b, h, w, c).

    A work item is a tile of th × tw outputs and cb channels; a thread owns
    `vec` channels, one column and `rows` rows of it. Block (p, chunk) of
    the (parts, chunks) grid takes the spatial items [p·n/parts,
    (p+1)·n/parts) of its chunk, n = b · bands · coltiles."""

    kernel: str          # "fwd" (forward and dx) or "fgrad" (dk's first pass)
    b: int
    h: int
    w: int
    c: int
    itemsize: int
    vec: int
    cb: int
    tw: int
    th: int
    rows: int
    stages: int
    parts: int
    smem: int

    @property
    def chunks(self) -> int:
        return -(-self.c // self.cb)

    @property
    def strips(self) -> int:
        return self.th // self.rows

    @property
    def threads(self) -> int:
        return self.cb // self.vec * self.tw * self.strips

    @property
    def bands(self) -> int:
        return -(-self.h // self.th)

    @property
    def coltiles(self) -> int:
        return -(-self.w // self.tw)

    @property
    def n_spatial(self) -> int:
        return self.b * self.bands * self.coltiles

    @property
    def boxes(self) -> list[tuple[int, int, int, int]]:
        """The TMA boxes a stage loads, innermost dim first: the x halo,
        and for dk also the g tile."""
        halo = (self.cb, self.tw + 2, self.th + 2, 1)
        return [halo] if self.kernel == "fwd" else [halo, (self.cb, self.tw, self.th, 1)]


def _smem(kernel: str, tw: int, th: int, cb: int, itemsize: int,
          threads: int, stages: int) -> int:
    """Bytes of dynamic shared memory: RING for the mbarriers, then `stages`
    ring buffers (each box rounded to 128 bytes); for dk, at least the
    block's (threads, 9, 16 bytes of channels) f32 sums, which reuse the
    ring."""
    stage = _r128((th + 2) * (tw + 2) * cb * itemsize)
    if kernel == "fwd":
        return RING + stages * stage
    stage += _r128(th * tw * cb * itemsize)
    return RING + max(stages * stage, threads * 9 * 16 // itemsize * 4)


def _blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of `threads` threads and `smem` bytes that fit on one SM at
    once: shared memory, threads, registers at the launch bound's cap, at
    most MAX_BLOCKS_PER_SM."""
    regs = -(-threads // 32) * 32 * MAX_REGS
    return max(1, min(SMEM_LIMIT // smem, 2048 // threads, 65536 // regs,
                      MAX_BLOCKS_PER_SM))


@functools.lru_cache(maxsize=None)
def _plan(b: int, h: int, w: int, c: int, itemsize: int,
          kernel: str = "fwd") -> Plan:
    """The launch plan of `kernel` over x (b, h, w, c) of `itemsize`-byte
    elements (C a multiple of 8). Chosen from a sweep of plans on the H100
    (PERF.md):
    * tiles as wide as the map where W ≤ 40 (no half-empty tiles on the
      38², 19² and 10² maps), else W split evenly into tiles of ≤ 32;
    * a channel chunk of ≤ 128 bytes a pixel and ≤ MAX_THREADS threads over
      one tile row, one that divides C where that costs less than half of
      it, or half that chunk;
    * of those chunks and the tile rows that leave min(2·132, the most any
      plan gives) work items, the plan that pads least — padded rows ×
      padded channels × (rows + 2) / rows, each thread reading two halo
      rows — then has the most threads a block (warps hide the latency),
      the widest chunk, the fewest rows loaded (bands × (th + 2)) and the
      most rows a thread;
    * persistent blocks: the forward no more than fit on the card at once
      (`_blocks_per_sm`), so no block waits for a second wave; the filter
      gradient one an SM, so the partials and each block's closing
      reduction stay few."""
    vec = 16 // itemsize
    tw = w if w <= FULL_WIDTH else -(-w // -(-w // 32))
    cg = min(CHUNK_BYTES // itemsize // vec, MAX_THREADS // tw)
    cap = min(c, max(CHANNEL_ALIGN, cg * vec // CHANNEL_ALIGN * CHANNEL_ALIGN))
    # the largest chunk that divides C, unless that is under half the cap;
    # and half of it, which may let more thread strips fit in a block
    cb = next(d for d in range(cap, 0, -CHANNEL_ALIGN) if c % d == 0)
    cb = cb if 2 * cb >= cap else cap
    widths = {cb} | ({cb // 2} if cb % (2 * CHANNEL_ALIGN) == 0 else set())
    coltiles = -(-w // tw)
    shapes = [(cb, r, s) for cb in widths for r in ROWS
              for s in range(1, min(MAX_THREADS // (cb // vec * tw), 254 // r) + 1)
              if (s - 1) * r < h]  # no strip wholly below the map

    def items(sh):
        cb, r, s = sh
        return b * -(-h // (r * s)) * coltiles * -(-c // cb)

    def cost(sh):
        cb, r, s = sh
        th = r * s
        bands = -(-h // th)
        padded = bands * th * -(-c // cb) * cb / c
        return (padded * (r + 2) / r, -(cb // vec * tw * s), -cb,
                bands * (th + 2), -r)

    enough = min(MIN_ITEMS, max(map(items, shapes)))
    cb, rows, strips = min((sh for sh in shapes if items(sh) >= enough), key=cost)
    th = rows * strips
    chunks = -(-c // cb)
    threads = cb // vec * tw * strips
    stages = STAGES[kernel]
    smem = _smem(kernel, tw, th, cb, itemsize, threads, stages)
    n_spatial = b * -(-h // th) * coltiles
    per_sm = _blocks_per_sm(smem, threads) if kernel == "fwd" else 1
    parts = max(1, min(n_spatial, SMS * per_sm // chunks))
    return Plan(kernel, b, h, w, c, itemsize, vec, cb, tw, th, rows, stages,
                parts, smem)


def _work_items(plan: Plan) -> dict[tuple[int, int], list[tuple[int, int, int, int]]]:
    """Block (p, chunk) → its work items (image, i0, j0, c0) in order, as
    the kernels of csrc/depthwise.cu compute them (`Tiling::item`)."""
    n, per_image = plan.n_spatial, plan.bands * plan.coltiles
    out = {}
    for ch in range(plan.chunks):
        for p in range(plan.parts):
            items = []
            for s in range(p * n // plan.parts, (p + 1) * n // plan.parts):
                b, r = divmod(s, per_image)
                band, ct = divmod(r, plan.coltiles)
                items.append((b, band * plan.th, ct * plan.tw, ch * plan.cb))
            out[(p, ch)] = items
    return out


def depthwise3x3_s1_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), k (3, 3, C) → (B, H, W, C) in x's type:
    o[b,i,j,c] = Σ xpad[b,i+dh,j+dw,c]·k[dh,dw,c], accumulated in f32 in
    the reference kernel's tap order (dh outer, dw inner)."""
    b, h, w, c = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    kf = k.to(torch.float32)
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
    for dh in range(3):
        for dw in range(3):
            acc = acc + xp[:, dh:dh + h, dw:dw + w, :] * kf[dh, dw]
    return acc.to(x.dtype)


def depthwise3x3_s1_fgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x, g (B, H, W, C) → dk (3, 3, C) f32:
    dk[dh,dw,c] = Σ_{b,i,j} g[b,i,j,c]·xpad[b,i+dh,j+dw,c], in f32."""
    b, h, w, c = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    gf = g.to(torch.float32)
    taps = [
        (xp[:, dh:dh + h, dw:dw + w, :] * gf).sum(dim=(0, 1, 2))
        for dh in range(3) for dw in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, c)


def _check_nhwc_pair(name: str, x: torch.Tensor, other: torch.Tensor,
                     other_shape: tuple) -> None:
    """What the kernels of csrc/depthwise.cu take: CUDA tensors of one
    type, f32 or bf16, contiguous NHWC, C a multiple of 8, 16-byte-aligned
    base pointers (TMA and 16-byte vector loads)."""
    if not x.is_cuda or not other.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16) or other.dtype != x.dtype:
        raise TypeError(
            f"{name} takes f32 or bf16 tensors of one type, "
            f"got {x.dtype} and {other.dtype}"
        )
    if x.dim() != 4 or tuple(other.shape) != other_shape:
        raise ValueError(
            f"{name}: shapes {tuple(x.shape)} and {tuple(other.shape)}, "
            f"expected (B, H, W, C) and {other_shape}"
        )
    if not x.is_contiguous() or not other.is_contiguous():
        raise ValueError(f"{name} needs contiguous NHWC tensors")
    if x.shape[-1] % CHANNEL_ALIGN:
        raise ValueError(f"{name} needs C a multiple of {CHANNEL_ALIGN}, "
                         f"got {x.shape[-1]}")
    if (x.data_ptr() | other.data_ptr()) % 16:
        raise ValueError(f"{name} needs 16-byte-aligned tensors")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def depthwise3x3_s1_cuda(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The forward kernel: x (B, H, W, C) contiguous bf16 or f32 on the
    card, k (3, 3, C) of the same type → (B, H, W, C) of that type."""
    _check_nhwc_pair("depthwise3x3_s1_cuda", x, k, (3, 3, x.shape[-1]))
    b, h, w, c = x.shape
    plan = _plan(b, h, w, c, x.element_size())
    lib = cuda_build.kernel_library("depthwise")
    out = torch.empty_like(x)
    fn = lib.dw3x3_s1_bf16 if x.dtype == torch.bfloat16 else lib.dw3x3_s1_f32
    err = fn(x.data_ptr(), k.data_ptr(), out.data_ptr(), b, h, w, c, plan.tw,
             plan.th, plan.rows, plan.cb, plan.stages, plan.parts, plan.smem,
             _stream(x))
    cuda_build.check(err, "depthwise3x3_s1")
    LAUNCHES["depthwise3x3_s1"] += 1
    return out


def fgrad_partials_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dk's first pass: x, g (B, H, W, C) contiguous, of one type (bf16 or
    f32) on the card → (parts, 9, C) f32, one row of partial sums a
    persistent block."""
    _check_nhwc_pair("depthwise3x3_s1_fgrad_cuda", x, g, tuple(x.shape))
    b, h, w, c = x.shape
    plan = _plan(b, h, w, c, x.element_size(), "fgrad")
    part = torch.empty((plan.parts, 9, c), dtype=torch.float32, device=x.device)
    lib = cuda_build.kernel_library("depthwise")
    fn = (lib.dw3x3_s1_fgrad_bf16 if x.dtype == torch.bfloat16
          else lib.dw3x3_s1_fgrad_f32)
    err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), b, h, w, c, plan.tw,
             plan.th, plan.rows, plan.cb, plan.stages, plan.parts, plan.smem,
             _stream(x))
    cuda_build.check(err, "depthwise3x3_s1_fgrad")
    return part


def fgrad_sum_cuda(part: torch.Tensor) -> torch.Tensor:
    """dk's second pass: (parts, 9, C) f32 on the card → dk (3, 3, C) f32,
    summed over the parts in a fixed order."""
    parts, _, c = part.shape
    dk = torch.empty((3, 3, c), dtype=torch.float32, device=part.device)
    lib = cuda_build.kernel_library("depthwise")
    err = lib.dw3x3_s1_fgrad_sum(part.data_ptr(), dk.data_ptr(), parts, c,
                                 _stream(part))
    cuda_build.check(err, "depthwise3x3_s1_fgrad_sum")
    return dk


def depthwise3x3_s1_fgrad_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The filter-gradient kernel: x, g (B, H, W, C) contiguous, of one type
    (bf16 or f32) on the card → dk (3, 3, C) f32, the same bits every run."""
    dk = fgrad_sum_cuda(fgrad_partials_cuda(x, g))
    LAUNCHES["depthwise3x3_s1_fgrad"] += 1
    return dk


# The op the paths call, registered with the dispatcher (not
# `torch.library.custom_op`, whose first call imports TorchDynamo, ~1.5 s a
# process, and whose calls cost ~15 µs more of host time than this one's).
# Both implementations take x in whatever layout it comes (an exported
# graph need not keep the strides it was traced with); the kernel's makes
# it contiguous, which is free when it already is.
_LIB = torch.library.Library("bdd100k_tpu_torch", "FRAGMENT")
_LIB.define("depthwise3x3_s1(Tensor x, Tensor k) -> Tensor")
_LIB.impl("depthwise3x3_s1", depthwise3x3_s1_plain, "CPU")
_LIB.impl("depthwise3x3_s1",
          lambda x, k: depthwise3x3_s1_cuda(x.contiguous(), k.contiguous()), "CUDA")


@torch.library.register_fake("bdd100k_tpu_torch::depthwise3x3_s1", lib=_LIB)
def _(x, k):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def depthwise3x3_s1(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-1 forward through the op `bdd100k_tpu_torch::depthwise3x3_s1`
    (one node of an exported graph): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; no other device has an implementation."""
    return torch.ops.bdd100k_tpu_torch.depthwise3x3_s1(x, k)


def depthwise3x3_s1_fgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Filter-gradient route: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return depthwise3x3_s1_fgrad_cuda(x, g)
    if x.device.type != "cpu":
        raise ValueError(f"no depthwise route for device {x.device}")
    return depthwise3x3_s1_fgrad_plain(x, g)


class DepthwiseS1(torch.autograd.Function):
    """Differentiable stride-1 SAME 3×3 depthwise conv, x (B, H, W, C) and
    k (3, 3, C) contiguous, all three pieces on the kernels (CUDA tensors)
    or their plain versions (CPU tensors)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, k)
        return depthwise3x3_s1(x, k)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, k = ctx.saved_tensors
        # The gradient reaching the layer's NHWC view is laid out as the
        # BatchNorm / cuDNN backward after it chose, often NCHW-contiguous;
        # the kernels take contiguous NHWC only, so this may copy g once
        # (2·B·H·W·C bytes in bf16, read and written) per layer and step.
        g = g.contiguous()
        dx = depthwise3x3_s1(g, k.flip(0, 1).contiguous()).to(x.dtype)
        dk = depthwise3x3_s1_fgrad(x, g).to(k.dtype)
        return dx, dk


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA SAME padding (lo, hi) for one spatial dim: the extra pixel
    goes at the end, so a stride-2 conv on an even size pads (0, 1)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    groups: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """NCHW conv with flax SAME padding (asymmetric where flax pads so); a
    dilated kernel pads as its dilated extent (k − 1)·d + 1 does."""
    kh, kw = ((k - 1) * dilation + 1 for k in weight.shape[-2:])
    ph = same_pads(x.shape[-2], kh, stride)
    pw = same_pads(x.shape[-1], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, bias, stride, (ph[0], pw[0]), dilation,
                        groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, bias, stride, 0, dilation, groups)


def depthwise_conv3x3(
    x: torch.Tensor, kernel: torch.Tensor, strides: tuple[int, int] = (1, 1)
) -> torch.Tensor:
    """x (B, H, W, C), kernel in flax's grouped layout (3, 3, 1, C), SAME.

    Stride 1 → `DepthwiseS1` (the kernels, differentiable); stride 2 →
    grouped `F.conv2d`, which autograd differentiates."""
    c = x.shape[-1]
    if tuple(strides) == (1, 1):
        k = kernel.reshape(3, 3, c).contiguous()
        if torch.is_grad_enabled() and (x.requires_grad or k.requires_grad):
            return DepthwiseS1.apply(x.contiguous(), k)
        return depthwise3x3_s1(x.contiguous(), k)
    if strides[0] != strides[1]:
        raise ValueError(f"unequal strides {strides} are not supported")
    y = conv2d_same(
        x.permute(0, 3, 1, 2),
        kernel.permute(3, 2, 0, 1),
        stride=strides[0],
        groups=c,
    )
    return y.permute(0, 2, 3, 1)
