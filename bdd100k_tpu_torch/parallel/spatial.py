"""Spatial partitioning: one image's convolutions across the ranks of a
process group (counterpart of bdd100k_tpu/parallel/spatial.py).

The latency mode: batch-1 full-frame inference, where data parallelism
cannot help because one image is in flight. Each rank holds one tile of
the frame: H rows of it when the input size divides by the world size,
else a tile of the 2-D (nh, nw) grid of `spatial_mesh_factors` (300 px on
8 ranks → (4, 2), 75 × 150 tiles), rank r at grid place divmod(r, nw).

The reference annotates its input's sharding and lets GSPMD derive the
halo exchanges. Here they are written by hand. Before every layer whose
window is wider than 1 (`Conv`, `DepthwiseConv3x3`, `max_pool_same`),
each rank sends its neighbours the boundary rows, columns and, on the 2-D
grid, corners they read, and receives theirs, in one `batch_isend_irecv`
round of point-to-point messages (a gloo group carries CUDA tensors
through host copies); a block off the image's edge is the pad value, 0
for a conv, −inf for a max pool, which is what flax's SAME pads give.
The layer then runs on the extended tile without padding of its own and
yields exactly its share of the output map.

Which share: output row o belongs to the rank that holds input row o·s,
so a tile of input rows [r0, r1) yields output rows [⌈r0/s⌉, ⌈r1/s⌉) and
reads rows [⌈r0/s⌉·s − lo, (⌈r1/s⌉ − 1)·s − lo + k) with flax's SAME
(lo, hi) pads — asymmetric at stride 2, so what a tile needs from above
and below depends on the parity of its first row, and a tile may need
fewer of its own rows (those it crops) than it holds. Columns alike.
Deeper maps tile unevenly (150 rows over 2 → 75, then 38 and 37). Where a
map no longer tiles — a tile would be empty, or a halo wider than the
neighbour that sends it — or a layer pads VALID, the ranks all-gather the
map and go on replicated, the counterpart of GSPMD's re-tiling.

The stride-1 depthwise layers run their module, the hand CUDA kernel on
the card, on the tile with its one-pixel halo: the kernel pads its own
SAME border around that, and the output's border, which read that pad, is
cropped. Stride-2 depthwise and dense convs run `F.conv2d` unpadded on
the extended tile. BatchNorm (eval), ReLU, L2Norm and 1×1 convs act on
the tile as it is. The feature maps are gathered before the heads, so the
heads, the decode and NMS (its kernel) run replicated and every rank
returns the same `Detections`.

    init_distributed("cuda")          # parallel/mesh.py, under torchrun
    fn = make_spatial_infer_fn(bundle, dist.group.WORLD)
    det = fn(fn.tile(images_u8))   # images (N, S, S, 3), pre-resized

Quantized models (`config.quant` other than "none") are not split: their
dynamic activation scales are maxima over the whole map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from bdd100k_tpu_torch.models import mobilenet
from bdd100k_tpu_torch.models.detector import DetectorBundle
from bdd100k_tpu_torch.models.layers import Conv, DepthwiseConv3x3, max_pool_same
from bdd100k_tpu_torch.models.mobilenet import MobileNetBackbone
from bdd100k_tpu_torch.models.ssd import SSDDetector
from bdd100k_tpu_torch.models.vgg import VGG16Backbone
from bdd100k_tpu_torch.ops.depthwise import same_pads
from bdd100k_tpu_torch.ops.nms import Detections


def spatial_mesh_factors(size: int, n_shards: int) -> tuple[int, int]:
    """(nh, nw) with nh·nw = n_shards and size divisible by both — the 2-D
    H×W tiling used when 1-D row tiling doesn't divide (300 on 8 → (4, 2)).
    Prefers the tallest valid nh. Raises ValueError when no factorization
    tiles."""
    for nh in sorted(
        (f for f in range(1, n_shards + 1) if n_shards % f == 0),
        reverse=True,
    ):
        nw = n_shards // nh
        if size % nh == 0 and size % nw == 0:
            return nh, nw
    raise ValueError(
        f"image size {size} not divisible over {n_shards} devices by any "
        f"H×W factorization; pick a mesh the input tiles over"
    )


@dataclass(frozen=True)
class Layout:
    """How the grid cuts one map: the row bounds of its nh tile rows and
    the column bounds of its nw tile columns (each nh + 1 / nw + 1 long,
    from 0 to the map's size)."""

    rows: tuple[int, ...]
    cols: tuple[int, ...]

    def box(self, i: int, j: int) -> tuple[int, int, int, int]:
        """Tile (i, j)'s rows [r0, r1) and columns [c0, c1)."""
        return self.rows[i], self.rows[i + 1], self.cols[j], self.cols[j + 1]


@dataclass(frozen=True)
class Tile:
    """A map held tile by tile: this rank's tile (N, C, h, w) and the
    layout of the whole."""

    t: torch.Tensor
    layout: Layout


def _halos(bounds: tuple[int, ...], k: int, s: int, lo: int):
    """One dim of a window layer (extent k, stride s, SAME pad lo before)
    over tiles cut at `bounds` → (output bounds, rows each tile needs
    before its own, after its own), negative where it crops its own; None
    where the dim no longer tiles: an empty output tile, or a halo wider
    than the neighbour that would send it."""
    n = len(bounds) - 1
    out = tuple(-(-b // s) for b in bounds)
    before, after = [], []
    for t in range(n):
        o0, o1 = out[t], out[t + 1]
        if o1 <= o0:
            return None
        top = bounds[t] - (o0 * s - lo)
        bot = (o1 - 1) * s - lo + k - bounds[t + 1]
        if (t > 0 and top > bounds[t] - bounds[t - 1]) or (
                t < n - 1 and bot > bounds[t + 2] - bounds[t + 1]):
            return None
        before.append(top)
        after.append(bot)
    return out, before, after


class _Grid:
    """This rank's place in the group's (nh, nw) grid, its neighbours, and
    the two exchanges: halos and all-gathers."""

    def __init__(self, group, nh: int, nw: int):
        self.group = group
        self.nh, self.nw = nh, nw
        self.n = nh * nw
        if self.n > 1:
            self.rank = dist.get_rank(group)
            self.stage = dist.get_backend(group) == "gloo"
        else:
            self.rank, self.stage = 0, False
        self.i, self.j = divmod(self.rank, nw)
        self.routes: list[tuple[str, str]] = []

    def _peer(self, i: int, j: int) -> int:
        return dist.get_global_rank(self.group, i * self.nw + j) \
            if self.group not in (None, dist.group.WORLD) else i * self.nw + j

    def _p2p(self, sends: list, recvs: list) -> list[torch.Tensor]:
        """Post every send and receive in one round → the received blocks.
        sends: (peer, tag, tensor); recvs: (peer, tag, shape, like)."""
        if not sends and not recvs:
            return []
        host = torch.device("cpu")
        ops, bufs = [], []
        for peer, tag, t in sends:
            t = t.contiguous()
            ops.append(dist.P2POp(dist.isend, t.to(host) if self.stage else t,
                                  peer, self.group, tag))
        for peer, tag, shape, like in recvs:
            buf = torch.empty(shape, dtype=like.dtype,
                              device=host if self.stage else like.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [b.to(like.device) for b, (_, _, _, like) in zip(bufs, recvs)]

    def extend(self, x: Tile, rows, cols, pad: float) -> torch.Tensor:
        """This rank's tile with the halo `rows` = (before, after) per tile
        row and `cols` likewise, from its eight neighbours (blocks off the
        grid filled with `pad`), cropped where a halo is negative."""
        t = x.t
        n, c, h, w = t.shape
        i, j = self.i, self.j

        def span(own, halos, k):  # rows (cols) of block −1, 0, +1 of tile k
            return {-1: max(halos[0][k], 0), 0: own, 1: max(halos[1][k], 0)}

        blocks = {(0, 0): t}
        sends, recvs, keys = [], [], []
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                if (a, b) == (0, 0):
                    continue
                tag = (a + 1) * 3 + (b + 1)
                # what the neighbour at (i − a, j − b) reads from this tile
                # as its block (a, b): its halo's rows and columns, taken
                # from this tile's far side
                si, sj = i - a, j - b
                if 0 <= si < self.nh and 0 <= sj < self.nw:
                    rr, cc = span(h, rows, si)[a], span(w, cols, sj)[b]
                    if rr and cc:
                        r0 = h - rr if a == -1 else 0
                        c0 = w - cc if b == -1 else 0
                        sends.append((self._peer(si, sj), tag,
                                      t[:, :, r0:r0 + rr, c0:c0 + cc]))
                shape = (n, c, span(h, rows, i)[a], span(w, cols, j)[b])
                ri, rj = i + a, j + b
                if 0 <= ri < self.nh and 0 <= rj < self.nw and shape[2] and shape[3]:
                    recvs.append((self._peer(ri, rj), tag, shape, t))
                    keys.append((a, b))
                else:
                    blocks[(a, b)] = torch.full(shape, pad, dtype=t.dtype,
                                                device=t.device)
        blocks.update(zip(keys, self._p2p(sends, recvs)))
        ext = torch.cat([torch.cat([blocks[(a, b)] for b in (-1, 0, 1)], dim=3)
                         for a in (-1, 0, 1)], dim=2)
        ext = ext[:, :, max(-rows[0][i], 0):ext.shape[2] - max(-rows[1][i], 0),
                  max(-cols[0][j], 0):ext.shape[3] - max(-cols[1][j], 0)]
        return ext.contiguous(memory_format=torch.channels_last)

    def gather(self, x: Tile) -> torch.Tensor:
        """The whole map on every rank, from every rank's tile."""
        lay = x.layout
        if self.n == 1:
            return x.t
        t = x.t
        n, c = t.shape[:2]
        mh = max(b - a for a, b in zip(lay.rows, lay.rows[1:]))
        mw = max(b - a for a, b in zip(lay.cols, lay.cols[1:]))
        padded = F.pad(t, (0, mw - t.shape[3], 0, mh - t.shape[2])).contiguous()
        if self.stage:
            padded = padded.cpu()
        parts = [torch.empty_like(padded) for _ in range(self.n)]
        dist.all_gather(parts, padded, group=self.group)
        out = torch.empty((n, c, lay.rows[-1], lay.cols[-1]), dtype=t.dtype,
                          device=t.device)
        for r, part in enumerate(parts):
            r0, r1, c0, c1 = lay.box(*divmod(r, self.nw))
            out[:, :, r0:r1, c0:c1] = part[:, :, :r1 - r0, :c1 - c0]
        return out.contiguous(memory_format=torch.channels_last)


class _Walk:
    """The detector's forward over tiles: each windowed layer exchanges
    halos, or gathers and runs replicated from there on."""

    def __init__(self, grid: _Grid):
        self.grid = grid

    def local(self, fn: Callable, x):
        """An op that reads one position: on the tile as it is."""
        return Tile(fn(x.t), x.layout) if isinstance(x, Tile) else fn(x)

    def gather(self, x) -> torch.Tensor:
        return self.grid.gather(x) if isinstance(x, Tile) else x

    def window(self, name: str, x, k: int, s: int, pad: float = 0.0):
        """(the extended tile, the output's layout) for a SAME window of
        extent k and stride s; None where the map is (now) replicated."""
        if not isinstance(x, Tile):
            return None
        lay = x.layout
        plan_h = _halos(lay.rows, k, s, same_pads(lay.rows[-1], k, s)[0])
        plan_w = _halos(lay.cols, k, s, same_pads(lay.cols[-1], k, s)[0])
        if plan_h is None or plan_w is None:
            self.grid.routes.append((name, "gathered"))
            return None
        self.grid.routes.append((name, "tiled"))
        ext = self.grid.extend(x, plan_h[1:], plan_w[1:], pad)
        return ext, Layout(plan_h[0], plan_w[0])

    def conv(self, name: str, mod, x):
        """`Conv` or `DepthwiseConv3x3` on a tile or the replicated map."""
        if isinstance(mod, DepthwiseConv3x3):
            k, s, d, same = 3, mod.stride, 1, True
        elif isinstance(mod, Conv):
            k, s, d, same = mod.kernel_size[0], mod.stride[0], mod.dilation[0], mod.same
        else:
            raise TypeError(f"{name}: no spatial route for {type(mod).__name__}")
        if isinstance(x, Tile) and k == 1 and s == 1:
            return self.local(mod, x)
        if isinstance(x, Tile) and not same:
            self.grid.routes.append((name, "gathered"))
            x = self.gather(x)
        ke = (k - 1) * d + 1
        got = self.window(name, x, ke, s)
        if got is None:
            return mod(self.gather(x))
        ext, lay = got
        if isinstance(mod, DepthwiseConv3x3) and s == 1:
            # the kernel pads its own SAME border: crop what read it
            y = mod(ext)[:, :, 1:-1, 1:-1]
        else:
            w = mod.weight.to(mod.dtype)
            b = None if getattr(mod, "bias", None) is None else mod.bias.to(mod.dtype)
            groups = ext.shape[1] if isinstance(mod, DepthwiseConv3x3) else mod.groups
            y = F.conv2d(ext.to(mod.dtype), w, b, s, 0, d, groups)
        return Tile(y, lay)

    def convbn(self, name: str, mod, x):
        """`ConvBN`: the conv, then BatchNorm and ReLU6 where it lies."""
        y = self.conv(name, mod.Conv_0, x)
        return self.local(lambda t: F.relu6(mod.BatchNorm_0(t).to(mod.dtype)), y)

    def max_pool(self, name: str, x, window: int, stride: int):
        got = self.window(name, x, window, stride, float("-inf"))
        if got is None:
            return max_pool_same(self.gather(x), window, stride)
        ext, lay = got
        return Tile(F.max_pool2d(ext, window, stride), lay)

    # --------------------------------------------------------- the models

    def mobilenet(self, bb: MobileNetBackbone, x) -> list:
        x = self.convbn("stem", bb.stem, x)
        taps = []
        for name, _, _ in mobilenet._BLOCKS:
            blk = getattr(bb, name)
            x = self.convbn(f"{name}.pw", blk.pw,
                            self.convbn(f"{name}.dw", blk.dw, x))
            if name in mobilenet._TAPS:
                taps.append(x)
        return taps

    def vgg(self, bb: VGG16Backbone, x) -> list:
        def block(i, x):
            blk = getattr(bb, f"block{i}")
            for j in range(blk.num_convs):
                x = self.local(F.relu, self.conv(f"block{i}.conv{j + 1}",
                                                 getattr(blk, f"conv{j + 1}"), x))
            return x

        for i in (1, 2, 3):
            x = self.max_pool(f"pool{i}", block(i, x), 2, 2)
        x = block(4, x)
        tap8 = self.local(bb.conv4_3_norm, x)
        x = block(5, self.max_pool("pool4", x, 2, 2))
        x = self.max_pool("pool5", x, 3, 1)
        x = self.local(F.relu, self.conv("fc6", bb.fc6, x))
        tap16 = self.local(F.relu, self.conv("fc7", bb.fc7, x))
        return [tap8, tap16]

    def detector(self, model, x) -> tuple[torch.Tensor, torch.Tensor]:
        bb = model.backbone
        taps = (self.mobilenet(bb, x) if isinstance(bb, MobileNetBackbone)
                else self.vgg(bb, x))
        feats = list(taps)
        if isinstance(model, SSDDetector):
            y = taps[-1]
            for i in range(len(model.feature_maps) - model.n_taps):
                stage = getattr(model, f"extra{i + 1}")
                y = self.convbn(f"extra{i + 1}.down", stage.down,
                                self.convbn(f"extra{i + 1}.squeeze",
                                            stage.squeeze, y))
                feats.append(y)
        # the heads run replicated, on the gathered maps
        outs = [getattr(model, f"head{i}")(self.gather(f))
                for i, f in enumerate(feats)]
        return (torch.cat([o[0] for o in outs], dim=1),
                torch.cat([o[1] for o in outs], dim=1))


def make_spatial_infer_fn(
    bundle: DetectorBundle,
    group=None,
    norm_mean: float = 0.5,
    norm_std: float = 0.5,
) -> Callable:
    """fn(tile) -> Detections, one frame's convs split over the ranks of
    `group` (the default group; without `torch.distributed` initialised,
    one rank).

    `fn.tile(images)` cuts a full (N, S, S, 3) batch into this rank's tile
    (the counterpart of the reference's `fn.input_sharding`); `fn.grid`
    is (nh, nw). The tile is uint8 or pre-normalized float, of a frame
    pre-resized to the model's S×S (a resize here would read rows across
    tiles); uint8 is normalized tile by tile. Every rank returns the same
    `Detections`. `fn.routes` lists, after a call, each windowed layer and
    whether it ran "tiled" or "gathered"."""
    if bundle.config.quant != "none":
        raise ValueError(
            f"spatial infer runs the float model; quant={bundle.config.quant!r} "
            "scales activations by maxima over the whole map")
    size = bundle.config.image_size
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    nh, nw = (n, 1) if size % n == 0 else spatial_mesh_factors(size, n)
    if not dist.is_initialized():
        group = None
    grid = _Grid(group, nh, nw)
    start = Layout(tuple(size * a // nh for a in range(nh + 1)),
                   tuple(size * b // nw for b in range(nw + 1)))
    r0, r1, c0, c1 = start.box(grid.i, grid.j)

    def tile(images: torch.Tensor) -> torch.Tensor:
        return images[:, r0:r1, c0:c1]

    def fn(images: torch.Tensor) -> Detections:
        assert tuple(images.shape[1:3]) == (r1 - r0, c1 - c0), (
            f"spatial infer needs pre-resized {size}×{size} input, cut by "
            f"fn.tile to ({r1 - r0}, {c1 - c0}), got {tuple(images.shape)}")
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
            images = (images - norm_mean) / norm_std
        grid.routes.clear()
        with torch.inference_mode():
            x = Tile(images.permute(0, 3, 1, 2), start)
            loc, cls = _Walk(grid).detector(bundle.model, x)
            return bundle.postprocess(loc, cls)

    fn.tile = tile
    fn.grid = (nh, nw)
    fn.routes = grid.routes
    return fn
