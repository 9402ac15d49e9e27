"""On-device augmentation and the eval-time preprocess (mirror of
bdd100k_tpu/data/augment.py).

The training augment is batched over the images and runs on the card:
expand (zoom-out) + an IoU-constrained crop sampled from a fixed number of
trials + the resize, fused into one separable linear resample per image;
horizontal flip; photometric jitter in YIQ. GT stays padded with a mask.

Every random number is drawn up front by `draw_augment` from an explicit
`torch.Generator`, and the parts take those draws as arguments, so the
deterministic parts can be held against the reference at given draws
(`jax.random` and torch's generators give different numbers for one seed).
The draws follow the reference's distributions one for one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """SSD-sampler constants (the reference's values)."""

    out_size: int = 300
    # photometric
    brightness_delta: float = 0.125
    contrast_range: tuple[float, float] = (0.5, 1.5)
    saturation_range: tuple[float, float] = (0.5, 1.5)
    hue_delta: float = 0.1            # fraction of a full IQ rotation
    # geometric: SSD §2.2 sampler
    min_ious: tuple[float, ...] = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9)
    crop_scale_range: tuple[float, float] = (0.3, 1.0)   # per-side scale
    crop_ar_range: tuple[float, float] = (0.5, 2.0)
    num_trials: int = 8
    expand_prob: float = 0.5
    expand_max: float = 4.0
    flip_prob: float = 0.5
    mean_fill: float = 0.5            # canvas fill, in [0, 1]
    # output normalization: (x − mean) / std
    norm_mean: float = 0.5
    norm_std: float = 0.5


class AugmentDraws(NamedTuple):
    """One step's random numbers for B images and T trials, already mapped
    onto the ranges the reference draws from."""

    expand_u: torch.Tensor      # (B,) U[0, 1): expand when < expand_prob
    ratio: torch.Tensor         # (B,) U[1, expand_max): canvas side
    expand_off: torch.Tensor    # (B, 2) U[0, 1): image offset in the canvas
    mode: torch.Tensor          # (B,) int in [0, 1 + len(min_ious)); 0 keeps
    scale: torch.Tensor         # (B, T) U[crop_scale_range)
    log_ar: torch.Tensor        # (B, T) U[log ar_lo, log ar_hi)
    pos: torch.Tensor           # (B, T, 2) U[0, 1): rect offset in the canvas
    brightness: torch.Tensor    # (B,) U[−delta, delta)
    contrast: torch.Tensor      # (B,)
    saturation: torch.Tensor    # (B,)
    hue: torch.Tensor           # (B,) rotation angle, radians
    flip_u: torch.Tensor        # (B,) U[0, 1): flip when < flip_prob


def draw_augment(gen: torch.Generator, b: int, cfg: AugmentConfig,
                 device: torch.device) -> AugmentDraws:
    """All of one step's draws for `b` images, from `gen` (on `device`)."""
    t = cfg.num_trials

    def u(*shape, lo=0.0, hi=1.0):
        x = torch.rand(shape, generator=gen, device=device)
        return lo + x * (hi - lo)

    return AugmentDraws(
        expand_u=u(b),
        ratio=u(b, lo=1.0, hi=cfg.expand_max),
        expand_off=u(b, 2),
        mode=torch.randint(0, len(cfg.min_ious) + 1, (b,), generator=gen,
                           device=device),
        scale=u(b, t, lo=cfg.crop_scale_range[0], hi=cfg.crop_scale_range[1]),
        log_ar=u(b, t, lo=math.log(cfg.crop_ar_range[0]),
                 hi=math.log(cfg.crop_ar_range[1])),
        pos=u(b, t, 2),
        brightness=u(b, lo=-cfg.brightness_delta, hi=cfg.brightness_delta),
        contrast=u(b, lo=cfg.contrast_range[0], hi=cfg.contrast_range[1]),
        saturation=u(b, lo=cfg.saturation_range[0], hi=cfg.saturation_range[1]),
        hue=u(b, lo=-cfg.hue_delta, hi=cfg.hue_delta) * (2.0 * math.pi),
        flip_u=u(b),
    )


def _rect_gt_iou(rect: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of rects (..., 4) against boxes (..., 4), broadcast, corners."""
    x1 = torch.maximum(rect[..., 0], boxes[..., 0])
    y1 = torch.maximum(rect[..., 1], boxes[..., 1])
    x2 = torch.minimum(rect[..., 2], boxes[..., 2])
    y2 = torch.minimum(rect[..., 3], boxes[..., 3])
    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    ra = torch.clamp_min(rect[..., 2] - rect[..., 0], 0.0) * torch.clamp_min(
        rect[..., 3] - rect[..., 1], 0.0)
    ba = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0.0) * torch.clamp_min(
        boxes[..., 3] - boxes[..., 1], 0.0)
    return inter / torch.clamp_min(ra + ba - inter, 1e-8)


def _centers_inside(boxes: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """Whether each box's centre lies strictly inside the rect, broadcast."""
    centers = (boxes[..., :2] + boxes[..., 2:]) * 0.5
    return ((centers[..., 0] > rect[..., 0]) & (centers[..., 0] < rect[..., 2])
            & (centers[..., 1] > rect[..., 1]) & (centers[..., 1] < rect[..., 3]))


def _sample_crop_rect(draws: AugmentDraws, boxes: torch.Tensor,
                      mask: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """The geometric rect of each image, maybe-expand ∘ maybe-crop, in the
    original normalized coords (beyond [0, 1] is the zoom-out canvas):
    boxes (B, M, 4), mask (B, M) → (B, 4).

    A trial rect is valid when some real GT has IoU ≥ the mode's min_iou
    with it and its centre strictly inside; the first valid trial wins;
    mode 0, or no valid trial, keeps the canvas."""
    ratio = torch.where(draws.expand_u < cfg.expand_prob, draws.ratio, 1.0)
    off = draws.expand_off * (ratio - 1.0)[:, None]
    canvas = torch.stack(
        [-off[:, 0], -off[:, 1], ratio - off[:, 0], ratio - off[:, 1]], dim=-1)
    min_iou = torch.tensor((0.0,) + tuple(cfg.min_ious),
                           device=boxes.device)[draws.mode]

    sq = torch.sqrt(torch.exp(draws.log_ar))
    cw = torch.clamp(draws.scale * sq, 0.05, 1.0) * ratio[:, None]
    ch = torch.clamp(draws.scale / sq, 0.05, 1.0) * ratio[:, None]
    rx1 = canvas[:, 0:1] + draws.pos[..., 0] * (ratio[:, None] - cw)
    ry1 = canvas[:, 1:2] + draws.pos[..., 1] * (ratio[:, None] - ch)
    rects = torch.stack([rx1, ry1, rx1 + cw, ry1 + ch], dim=-1)   # (B, T, 4)

    r = rects[:, :, None, :]                                      # (B, T, 1, 4)
    bx = boxes[:, None, :, :]                                     # (B, 1, M, 4)
    ok = (mask[:, None, :] & _centers_inside(bx, r)
          & (_rect_gt_iou(r, bx) >= min_iou[:, None, None]))
    valid = ok.any(dim=-1)                                        # (B, T)
    first = valid.to(torch.uint8).argmax(dim=-1)                  # first True
    chosen = torch.gather(rects, 1, first[:, None, None].expand(-1, 1, 4))[:, 0]
    keep_canvas = (draws.mode == 0) | ~valid.any(dim=-1)
    return torch.where(keep_canvas[:, None], canvas, chosen)


def _transform_boxes(rect, boxes, labels, mask):
    """GT into rect coords, (B, 4) rects over (B, M, ·) GT: keep the boxes
    whose centre lies inside, clip to [0, 1], zero the rest."""
    rw = (rect[:, 2] - rect[:, 0])[:, None]
    rh = (rect[:, 3] - rect[:, 1])[:, None]
    inside = _centers_inside(boxes, rect[:, None, :])
    new = torch.stack(
        [
            (boxes[..., 0] - rect[:, 0:1]) / rw,
            (boxes[..., 1] - rect[:, 1:2]) / rh,
            (boxes[..., 2] - rect[:, 0:1]) / rw,
            (boxes[..., 3] - rect[:, 1:2]) / rh,
        ],
        dim=-1,
    )
    new = torch.clamp(new, 0.0, 1.0)
    new_mask = mask & inside
    return torch.where(new_mask[..., None], new, 0.0), labels, new_mask


def _linear_weights(in_size: int, out_size: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """jax.image's `compute_weight_mat` for the antialiased linear
    (triangle) kernel, per image: scale, translation (B,) → (B, out, in)
    f32. Output pixel o samples input coordinate (o + 0.5 − t)/scale − 0.5;
    on a downscale the triangle widens by 1/scale; each output's weights
    are normalized to sum 1 and zeroed when it samples outside the input."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5)
    x = (sample_f[:, :, None]
         - torch.arange(in_size, dtype=torch.float32, device=dev)).abs() / (
        kernel_scale[:, None, None])
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=-1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None], w, 0.0)


def _resample(image_f: torch.Tensor, rect: torch.Tensor, out_size: int,
              fill: float) -> torch.Tensor:
    """Crop-or-expand + resize of (B, H, W, C) f32 images to the (B, S, S,
    C) view of each image's rect, as `jax.image.scale_and_translate(...,
    method="linear")` (antialiased) does it in the reference: the image is
    shifted by −fill so that samples outside it read fill, cast to bf16,
    and contracted with the two separable weight matrices (S×H, S×W) in
    bf16 — here two `torch.matmul`s, the reference's being XLA's."""
    b, h, w, c = image_f.shape
    s = out_size
    rw = (rect[:, 2] - rect[:, 0]) * w
    rh = (rect[:, 3] - rect[:, 1]) * h
    scale_y, scale_x = s / rh, s / rw
    t_y = -scale_y * rect[:, 1] * h
    t_x = -scale_x * rect[:, 0] * w
    wy = _linear_weights(h, s, scale_y, t_y).to(torch.bfloat16)   # (B, S, H)
    wx = _linear_weights(w, s, scale_x, t_x).to(torch.bfloat16)   # (B, S, W)
    x = (image_f - fill).to(torch.bfloat16).reshape(b, h, w * c)
    y = torch.matmul(wy, x)                                       # (B, S, W·C)
    y = y.reshape(b, s, w, c).transpose(2, 3).reshape(b, s * c, w)
    out = torch.matmul(y, wx.transpose(1, 2))                     # (B, S·C, S)
    out = out.reshape(b, s, c, s).permute(0, 1, 3, 2)
    return out.to(torch.float32) + fill


_RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322),
            (0.211, -0.523, 0.312))
_YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


def _photometric(img: torch.Tensor, brightness, contrast, saturation, hue):
    """Brightness, contrast, saturation and hue (a rotation of the YIQ
    chroma plane) on (B, S, S, 3) images in [0, 1], per-image (B,) draws."""
    img = img + brightness[:, None, None, None]
    mean = img.mean(dim=(1, 2), keepdim=True)
    img = (img - mean) * contrast[:, None, None, None] + mean
    gray = img.mean(dim=-1, keepdim=True)
    img = gray + (img - gray) * saturation[:, None, None, None]
    dev = img.device
    rgb2yiq = torch.tensor(_RGB2YIQ, dtype=torch.float32, device=dev)
    yiq2rgb = torch.tensor(_YIQ2RGB, dtype=torch.float32, device=dev)
    cos, sin = torch.cos(hue), torch.sin(hue)
    one, zero = torch.ones_like(cos), torch.zeros_like(cos)
    rot = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, cos, -sin], -1),
        torch.stack([zero, sin, cos], -1),
    ], dim=-2)                                                    # (B, 3, 3)
    m = torch.matmul(torch.matmul(yiq2rgb, rot), rgb2yiq)
    img = torch.matmul(img, m.transpose(1, 2)[:, None])
    return torch.clamp(img, 0.0, 1.0)


def _augment(draws: AugmentDraws, images_u8, boxes, labels, mask,
             cfg: AugmentConfig):
    """The reference's `_augment_one`, batched, at given draws."""
    img = images_u8.to(torch.float32) / 255.0
    rect = _sample_crop_rect(draws, boxes, mask, cfg)
    out = _resample(img, rect, cfg.out_size, cfg.mean_fill)
    del img
    boxes, labels, mask = _transform_boxes(rect, boxes, labels, mask)

    flip = draws.flip_u < cfg.flip_prob
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    flipped = torch.stack(
        [1.0 - boxes[..., 2], boxes[..., 1], 1.0 - boxes[..., 0], boxes[..., 3]],
        dim=-1,
    )
    boxes = torch.where(
        flip[:, None, None], torch.where(mask[..., None], flipped, 0.0), boxes)

    out = _photometric(out, draws.brightness, draws.contrast,
                       draws.saturation, draws.hue)
    out = (out - cfg.norm_mean) / cfg.norm_std
    return out, boxes, labels, mask


def augment_batch(gen: torch.Generator, images_u8: torch.Tensor,
                  boxes: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, cfg: AugmentConfig = AugmentConfig(),
                  shard: tuple[int, int] = (0, 1)):
    """Batched augment on the images' device: images_u8 (B, H, W, 3) uint8,
    padded GT (B, M, 4) / (B, M) / (B, M), draws from `gen` → (images (B, S,
    S, 3) f32 normalized, boxes, labels, mask).

    `shard` (index, count): the batch is rows [index·B, (index+1)·B) of a
    global batch of count·B; the draws are the global batch's and this
    shard takes its rows, so `count` shards given one generator state
    augment as one process augments the whole batch."""
    index, count = shard
    b = images_u8.shape[0]
    draws = draw_augment(gen, b * count, cfg, images_u8.device)
    if count > 1:
        draws = AugmentDraws(*(t[index * b:(index + 1) * b] for t in draws))
    return _augment(draws, images_u8, boxes, labels, mask, cfg)


def yuv420_to_rgb_batch(y_u8: torch.Tensor, uv_u8: torch.Tensor) -> torch.Tensor:
    """Planar YUV 4:2:0 → f32 RGB in [0, 1], batched, on the planes'
    device: y (B, S, S) uint8 luma, uv (B, S/2, S/2, 2) uint8 interleaved
    CbCr → (B, S, S, 3). Nearest chroma upsample and the BT.601 full-range
    matrix libjpeg uses, in the reference's order of f32 operations."""
    yf = y_u8.to(torch.float32)
    uvf = uv_u8.to(torch.float32) - 128.0
    uvf = uvf.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cb, cr = uvf[..., 0], uvf[..., 1]
    r = yf + 1.402 * cr
    g = yf - 0.344136 * cb - 0.714136 * cr
    b = yf + 1.772 * cb
    return torch.clip(torch.stack([r, g, b], dim=-1) / 255.0, 0.0, 1.0)


def preprocess_eval_batch(
    images_u8: torch.Tensor | tuple[torch.Tensor, torch.Tensor],
    out_size: int,
    norm_mean: float = 0.5,
    norm_std: float = 0.5,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB, or a (y, uv) YUV 4:2:0 pair from the yuv420
    wire (`yuv420_to_rgb_batch`) → (B, S, S, 3) f32 normalized, NHWC. An
    input already at (S, S) skips the resize: a pure normalize.

    The reference resizes with `jax.image.resize(..., "linear")`, which
    antialiases on downscale (a triangle filter widened by the scale);
    `F.interpolate(bilinear, antialias=True, align_corners=False)` is the
    same separable triangle filter with the same normalization, and the
    result comes back in channels_last memory, i.e. a contiguous NHWC view.
    """
    if isinstance(images_u8, (tuple, list)):
        img = yuv420_to_rgb_batch(*images_u8)
    else:
        img = images_u8.to(torch.float32) / 255.0
    b, h, w, c = img.shape
    if (h, w) != (out_size, out_size):
        img = F.interpolate(
            img.permute(0, 3, 1, 2),
            size=(out_size, out_size),
            mode="bilinear",
            antialias=True,
            align_corners=False,
        ).permute(0, 2, 3, 1)
    return (img - norm_mean) / norm_std
