"""Exact int8 × int8 → int32 convolution: im2col, then `torch._int_mm`.

The reference accumulates its quantized convs in int32 on the MXU
(bdd100k_tpu/models/layers.py QuantConv, `conv_general_dilated` with
`preferred_element_type=int32`). An f32 conv over the codes is not exact
past 2^24, and a 3×3×512 VGG conv reaches 4608·127² ≈ 7.4e7, so the port
takes an integer route: the codes are unfolded with the conv's own pads,
stride and dilation into a (M, K) matrix, K in the reference's HWIO order
(ky, kx, c), and multiplied by the weight codes with `_int_mm`.
A 1×1 stride-1 conv needs no unfold.

`_int_mm` on the card wants M > 16, K and N multiples of 8, and its second
operand column-major (cuBLASLt's int8 GEMM takes no other layout); the
weights are held as (N, K) rows and passed transposed, M, K and N are
zero-padded to that on every device (zero codes leave every sum exact),
so the CPU runs the same shapes. The unfold runs over chunks of the batch,
at most `CHUNK_BYTES` of columns at a time (VGG512's block2 conv2 at B=32
would be 2.1 M rows by K = 1152, 2.4 GB of int8 at once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bdd100k_tpu_torch.ops.depthwise import same_pads

CHUNK_BYTES = 1 << 28


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)ᵀ int8 → (M, N) int32, exact, through
    `torch._int_mm` with M padded past 16 and K, N to multiples of 8, the
    second operand the column-major view of `w`'s rows."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def weight_matrix(w_q: torch.Tensor) -> torch.Tensor:
    """(O, I, kh, kw) int8 codes → (O, kh·kw·I), each row in (ky, kx, c)
    order, the reference's HWIO kernel flattened."""
    return w_q.permute(0, 2, 3, 1).reshape(w_q.shape[0], -1)


def out_size(n: int, k: int, stride: int, dilation: int, same: bool) -> int:
    ke = (k - 1) * dilation + 1
    return -(-n // stride) if same else (n - ke) // stride + 1


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                padding: str = "SAME", dilation: int = 1) -> torch.Tensor:
    """x_q (B, C, H, W) int8 codes, w_q (O, C, kh, kw) int8 codes → the
    int32 accumulator (B, O, OH, OW), channels_last in memory, with flax's
    SAME (lo, hi) or VALID padding."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding {padding!r}")
    b, c, h, w = x_q.shape
    o, _, kh, kw = w_q.shape
    same = padding == "SAME"
    oh = out_size(h, kh, stride, dilation, same)
    ow = out_size(w, kw, stride, dilation, same)
    wm = weight_matrix(w_q)
    x = x_q.permute(0, 2, 3, 1)                       # (B, H, W, C) view
    if kh == kw == 1 and stride == 1:
        acc = int_mm(x.reshape(b * h * w, c), wm)
        return acc.reshape(b, oh, ow, o).permute(0, 3, 1, 2)
    if same:
        ph = same_pads(h, (kh - 1) * dilation + 1, stride)
        pw = same_pads(w, (kw - 1) * dilation + 1, stride)
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    span_h, span_w = (oh - 1) * stride + 1, (ow - 1) * stride + 1
    per_image = oh * ow * kh * kw * c
    chunk = max(1, min(b, CHUNK_BYTES // max(per_image, 1)))
    out = torch.empty((b, oh, ow, o), dtype=torch.int32, device=x_q.device)
    for lo in range(0, b, chunk):
        xs = x[lo:lo + chunk]
        taps = [xs[:, ky * dilation:ky * dilation + span_h:stride,
                   kx * dilation:kx * dilation + span_w:stride]
                for ky in range(kh) for kx in range(kw)]
        cols = torch.cat(taps, dim=3).reshape(-1, kh * kw * c)
        out[lo:lo + chunk] = int_mm(cols, wm).reshape(-1, oh, ow, o)
    return out.permute(0, 3, 1, 2)
