"""The port's depthwise conv against the JAX reference, on the CPU.

* the plain stride-1 version (the CUDA kernel's plain version) against
  `_fwd_pallas(..., interpret=True)` and `_dw_xla`, in f32 and bf16;
* stride 2 — a grouped F.conv2d with flax's asymmetric SAME pad — against
  `_dw_xla` at even and odd sizes;
* the backward of the stride-1 autograd Function `DepthwiseS1` — dx (the
  forward's plain version on the flipped filter) and dk (the filter
  gradient's plain version) — against `jax.grad` through the reference's
  custom VJP `_dw3x3_s1(..., interpret=True)` and through XLA, including
  heights that do not divide the Pallas kernel's 16-row tile, and the
  plain filter gradient against `_fgrad_pallas` directly.

Tolerances: the plain version repeats the Pallas kernel's f32 tap order,
so against it f32 agrees to 1e-6 relative to the output's scale (XLA:CPU
may still fuse a multiply-add) and bf16 to one bf16 ulp (the two round the
same f32 sum once, give or take that fusion); XLA's conv sums in its own
order, 1e-5 relative. dk sums B·H·W products per tap, in another order on
each side: 1e-5 relative to its scale (the reference's own test allows
1e-4 against XLA).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdd100k_tpu.ops.pallas_depthwise import (
    _dw3x3_s1,
    _dw_xla,
    _fgrad_pallas,
    _fwd_pallas,
)
from bdd100k_tpu_torch.ops import depthwise

SHAPES = [(2, 8, 8, 8), (1, 5, 7, 16), (2, 3, 3, 8), (1, 10, 10, 32)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    k = (0.3 * rng.randn(3, 3, 1, shape[-1])).astype(np.float32)
    return x, k


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_stride1_plain_matches_pallas_and_xla_f32(shape):
    x, k = _inputs(shape)
    got = depthwise.depthwise3x3_s1_plain(
        torch.from_numpy(x), torch.from_numpy(k.reshape(3, 3, -1))
    ).numpy()
    _close(got, _fwd_pallas(jnp.asarray(x), jnp.asarray(k.reshape(3, 3, -1)),
                            interpret=True), 1e-6)
    _close(got, _dw_xla(jnp.asarray(x), jnp.asarray(k)), 1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_stride1_plain_matches_pallas_bf16(shape):
    x, k = _inputs(shape, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    kb = torch.from_numpy(k.reshape(3, 3, -1)).to(torch.bfloat16)
    got = depthwise.depthwise3x3_s1_plain(xb, kb)
    assert got.dtype == torch.bfloat16
    want = _fwd_pallas(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(k.reshape(3, 3, -1), jnp.bfloat16),
                       interpret=True)
    assert want.dtype == jnp.bfloat16
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    # one bf16 ulp of the output, plus a floor for sums that cancel
    np.testing.assert_array_less(
        np.abs(got - want), 2.0 ** -7 * np.abs(want) + 1e-6 * np.abs(want).max() + 1e-12
    )


@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (10, 9), (5, 6)])
def test_stride2_matches_xla(hw):
    x, k = _inputs((2, *hw, 16), seed=2)
    got = depthwise.depthwise_conv3x3(
        torch.from_numpy(x), torch.from_numpy(k), (2, 2)
    ).numpy()
    want = np.asarray(_dw_xla(jnp.asarray(x), jnp.asarray(k), (2, 2)))
    assert got.shape == want.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 16)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("size,pads", [(300, (0, 1)), (150, (0, 1)), (75, (1, 1)),
                                       (38, (0, 1)), (19, (1, 1)), (10, (0, 1)),
                                       (5, (1, 1))])
def test_same_pads_of_the_flagship(size, pads):
    assert depthwise.same_pads(size, 3, 2) == pads
    assert depthwise.same_pads(size, 3, 1) == (1, 1)
    assert depthwise.same_pads(size, 1, 1) == (0, 0)


GRAD_SHAPES = [(2, 8, 8, 8), (2, 20, 9, 8), (1, 17, 6, 16), (3, 5, 7, 8)]


@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_stride1_backward_matches_jax(shape):
    b, h, w, c = shape
    x, k = _inputs(shape, seed=4)
    g = np.random.RandomState(5).randn(*shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = depthwise.depthwise_conv3x3(xt, kt, (1, 1))
    (y * torch.from_numpy(g)).sum().backward()
    assert depthwise.LAUNCHES == {"depthwise3x3_s1": 0, "depthwise3x3_s1_fgrad": 0}

    gj = jnp.asarray(g)
    dx_p, dk_p = jax.grad(
        lambda x, k: jnp.sum(_dw3x3_s1(x, k, True) * gj), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(k.reshape(3, 3, c)))
    dx_x, dk_x = jax.grad(
        lambda x, k: jnp.sum(_dw_xla(x, k) * gj), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(k))
    _close(xt.grad.numpy(), dx_p, 1e-6)
    _close(xt.grad.numpy(), dx_x, 1e-5)
    _close(kt.grad.numpy().reshape(3, 3, c), dk_p, 1e-5)
    _close(kt.grad.numpy(), dk_x, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fgrad_plain_matches_pallas(dtype):
    """(3, 17, 9, 8): 17 rows leave a remainder after the Pallas kernel's
    16-row tile, which that kernel must not count twice."""
    x, _ = _inputs((3, 17, 9, 8), seed=6)
    g = np.random.RandomState(7).randn(3, 17, 9, 8).astype(np.float32)
    xt, gt = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
    got = depthwise.depthwise3x3_s1_fgrad_plain(xt, gt)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _fgrad_pallas(jnp.asarray(x, jdt), jnp.asarray(g, jdt), interpret=True)
    _close(got.numpy(), want, 1e-5)


def test_backward_takes_a_non_contiguous_gradient():
    """The gradient reaching the NHWC view may be laid out NCHW; the
    Function makes it contiguous and gives what a contiguous one gives."""
    x, k = _inputs((2, 6, 5, 8), seed=8)
    g = np.random.RandomState(9).randn(2, 8, 6, 5).astype(np.float32)  # NCHW
    grads = []
    for gg in (torch.from_numpy(g).permute(0, 2, 3, 1),
               torch.from_numpy(g).permute(0, 2, 3, 1).contiguous()):
        xt = torch.from_numpy(x).requires_grad_()
        kt = torch.from_numpy(k).requires_grad_()
        depthwise.depthwise_conv3x3(xt, kt).backward(gg)
        grads.append((xt.grad, kt.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0, atol=0)


# ------------------------------------------------- the kernels' launch plan
# csrc/depthwise.cu cannot run here; what surrounds it — how `_plan` cuts a
# shape into work and what each block of the kernels takes
# (`_work_items`, the Python mirror of `Tiling::item`) — is checked at the
# main path's shapes, the tiny configs' and edge shapes.

# the stride-1 layers of SSD-MobileNet-300 at width 1.0 (H = W, C), at the
# serving batch 8 and the train batch 32
FLAGSHIP = [(b, hw, hw, c) for b in (8, 32)
            for hw, c in ((150, 32), (75, 128), (38, 256), (19, 512), (10, 1024))]
# ssd_tiny_64 / yolo_tiny_64: 64² input, width 0.25
TINY = [(4, hw, hw, c) for hw, c in ((32, 8), (16, 32), (8, 64), (4, 128), (2, 256))]
# one-pixel maps, ragged bands and tiles, chunks that do not divide C
EDGE = [(2, 1, 1, 8), (3, 2, 3, 16), (2, 5, 7, 24), (1, 19, 19, 8), (2, 33, 17, 40)]
PLAN_SHAPES = FLAGSHIP + TINY + EDGE
PLAN_IDS = ["x".join(map(str, s)) for s in PLAN_SHAPES]


def _plans(shape):
    for kernel in ("fwd", "fgrad"):
        for itemsize in (2, 4):
            yield depthwise._plan(*shape, itemsize, kernel)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_plan_covers_every_output_once(shape):
    """Every output (b, i, j, 8-channel group) lies in exactly one work
    item of one block, for both kernels and both types."""
    b, h, w, c = shape
    for plan in _plans(shape):
        count = np.zeros((b, h, w, c // 8), np.int32)
        for items in depthwise._work_items(plan).values():
            for bi, i0, j0, c0 in items:
                assert 0 <= bi < b and i0 < h and j0 < w and c0 < c
                count[bi, i0:i0 + plan.th, j0:j0 + plan.tw,
                      c0 // 8:(c0 + plan.cb) // 8] += 1
        assert (count == 1).all(), plan


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_plan_partitions_items_between_blocks(shape):
    """Each (spatial item, chunk) goes to one block, every block takes a
    contiguous balanced range (sizes differ by at most one, none empty),
    and dk's partials are one a block along the spatial items."""
    for plan in _plans(shape):
        blocks = depthwise._work_items(plan)
        assert set(blocks) == {(p, ch) for p in range(plan.parts)
                               for ch in range(plan.chunks)}
        every = [it for items in blocks.values() for it in items]
        assert len(every) == len(set(every)) == plan.n_spatial * plan.chunks
        sizes = {len(items) for items in blocks.values()}
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        for ch in range(plan.chunks):  # one chunk's blocks see every item once
            spatial = [it[:3] for p in range(plan.parts) for it in blocks[(p, ch)]]
            assert len(spatial) == len(set(spatial)) == plan.n_spatial


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_plan_fits_a_block(shape):
    """Threads within the kernels' launch bound, whole thread strips,
    and the ring's shared memory within the 227 KB a block may use."""
    for plan in _plans(shape):
        assert plan.threads <= depthwise.MAX_THREADS
        assert plan.th == plan.strips * plan.rows and plan.cb % plan.vec == 0
        assert plan.cb % depthwise.CHANNEL_ALIGN == 0
        assert plan.smem <= depthwise.SMEM_LIMIT
        boxes = sum(depthwise._r128(np.prod(box) * plan.itemsize)
                    for box in plan.boxes)
        assert plan.smem >= plan.stages * boxes + depthwise.RING
        assert 1 <= plan.stages <= depthwise.MAX_STAGES


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_plan_tma_boxes_are_legal(shape):
    """cuTensorMapEncodeTiled takes boxes of at most 256 per dim whose
    inner dim is a multiple of 16 bytes."""
    for plan in _plans(shape):
        for box in plan.boxes:
            assert all(1 <= d <= 256 for d in box), box
            assert box[0] * plan.itemsize % 16 == 0, box


def test_plan_takes_the_full_width_of_narrow_maps():
    """Maps up to 40 wide are one tile wide; wider ones split evenly."""
    for w in (1, 10, 19, 38, 40):
        assert depthwise._plan(8, w, w, 64, 2).tw == w
    assert depthwise._plan(8, 75, 75, 128, 2).tw == 25
    assert depthwise._plan(8, 150, 150, 32, 2).tw == 30
