"""The port's matcher, mining and SSD loss against the JAX reference, on
the CPU.

* the oracle `ops/matching.encode_targets` and the matcher route
  `ops/matcher.encode_targets` (which takes the oracle for CPU tensors)
  against JAX `encode_targets` and `pallas_encode_targets(interpret=True)`,
  at the full 8732 SSD300 anchors, B=2, over random padded GT, two GTs
  claiming one anchor, an image with no GT, a GT equal to an anchor, an
  IoU exactly at the 0.5 threshold, tiny boxes, a zero-area GT (its best
  anchor is anchor 0), a GT over the whole image, one valid GT at the last
  index, and M = 1;
* the kernel's launch plan (`matcher._plan`) deals every
  anchor of SSD300, SSD512 and the tiny config to one thread slot, within
  the kernel's limits, and refuses what it cannot take; the port's SSD512
  anchors equal the reference's;
* `hard_negative_mask` with tied losses (the stable sort's order);
* `ssd_loss` on the same logits and match, and `encode_boxes`.

Tolerances: `matched_gt`, `positive` and `cls_targets` are equal to the
JAX oracle's (the IoU is the same f32 operations in the same order on both
sides, and the decisions are discrete). The reference's own Pallas kernel,
run interpreted on the CPU, rounds some IoUs an ulp away from its oracle:
with a GT equal to an anchor box, two anchors whose oracle IoU is
0.49999994 come out positive there. Against Pallas the port is therefore
held equal wherever the reference's two routes agree, and the anchors
where they do not must lie within 2 f32 ulps of the threshold. `loc_targets` go through `log`, which the two
libraries round to within an ulp, so rtol 1e-5 / atol 1e-6 — the bound
the reference's own Pallas-vs-oracle test uses. The losses sum over 8732
anchors in other orders: rtol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdd100k_tpu.models import losses as jax_losses
from bdd100k_tpu.ops import boxes as jax_boxes
from bdd100k_tpu.ops import matching as jax_matching
from bdd100k_tpu.ops import mining as jax_mining
from bdd100k_tpu.ops.anchors import ssd_anchors as jax_ssd_anchors
from bdd100k_tpu.ops.pallas_matcher import pallas_encode_targets
from bdd100k_tpu_torch.models import losses
from bdd100k_tpu_torch.ops import boxes, matcher, matching, mining
from bdd100k_tpu_torch.ops.anchors import ssd_anchors

# The suite runs these files beside JAX workers (pytest -n 6): two torch
# threads keep them from contending with those for every core.
torch.set_num_threads(2)

ANCHORS = ssd_anchors()                      # (8732, 4) center, f32
M = 16


def _random_gt(rng, b=2, m=M, n_real=(7, 3)):
    gtb = np.zeros((b, m, 4), np.float32)
    gtl = np.zeros((b, m), np.int32)
    gtm = np.zeros((b, m), bool)
    for i, n in enumerate(n_real):
        cxy = rng.uniform(0.1, 0.9, (n, 2))
        wh = rng.uniform(0.02, 0.5, (n, 2))
        gtb[i, :n] = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
        gtl[i, :n] = rng.randint(1, 11, n)
        gtm[i, :n] = True
        # padding rows hold garbage: only the mask may keep them out
        gtb[i, n:] = rng.rand(m - n, 4)
        gtl[i, n:] = rng.randint(1, 11, m - n)
    return gtb, gtl, gtm


def _anchor_corners(idx):
    return boxes.center_to_corner(ANCHORS[idx]).numpy()


def _iou_half_gt():
    """A GT whose f32 IoU with some anchor is exactly 0.5: the anchor's
    corners with x2 moved out by the anchor's width, taken where the
    oracle's arithmetic lands exactly on 0.5."""
    for a in range(0, ANCHORS.shape[0], 7):
        x1, y1, x2, y2 = _anchor_corners(a)
        gt = np.asarray([x1, y1, x2 + (x2 - x1), y2], np.float32)
        if gt[2] > 1.0:
            continue
        iou = boxes.iou_pairwise(torch.from_numpy(gt[None]),
                                 boxes.center_to_corner(ANCHORS[a:a + 1]))
        if float(iou[0, 0]) == 0.5:
            return gt
    raise AssertionError("no anchor gives an IoU of exactly 0.5")


def _case(name, seed=0):
    rng = np.random.RandomState(seed)
    if name == "m1":                 # one GT row; the second image has none
        return _random_gt(rng, m=1, n_real=(1, 0))
    gtb, gtl, gtm = _random_gt(rng)
    if name == "duplicate_claim":    # two GTs, one box: one best anchor
        gtb[0, 1] = gtb[0, 0]
        gtl[0, 1] = (gtl[0, 0] % 10) + 1
    elif name == "empty_image":
        gtm[1] = False
    elif name == "gt_is_anchor":     # IoU 1 with one anchor, ties elsewhere
        gtb[0, 0] = _anchor_corners(4000)
        gtb[0, 1] = _anchor_corners(4001)
    elif name == "iou_half":
        gtb[0, 2] = _iou_half_gt()
    elif name == "tiny_boxes":       # below every anchor's size: forced only
        c = rng.uniform(0.1, 0.9, (M, 2)).astype(np.float32)
        gtb[1] = np.concatenate([c, c + 0.004], -1)
        gtm[1] = True
    elif name == "no_overlap":       # zero area: IoU 0 everywhere, anchor 0
        gtb[0, 6] = [0.5, 0.5, 0.5, 0.5]
    elif name == "whole_image":      # overlaps every anchor: nothing culls it
        gtb[:, 0] = [0.0, 0.0, 1.0, 1.0]
    elif name == "single_gt_last_index":
        gtm[:] = False
        gtm[:, M - 1] = True
        gtb[:, M - 1] = [[0.2, 0.3, 0.45, 0.7], [0.6, 0.1, 0.9, 0.35]]
    return gtb, gtl, gtm


CASES = ["random", "duplicate_claim", "empty_image", "gt_is_anchor",
         "iou_half", "tiny_boxes", "no_overlap", "whole_image",
         "single_gt_last_index", "m1"]


def _assert_match_equal(got, want, loc_exact=False):
    for field in ("matched_gt", "positive", "cls_targets"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)), np.asarray(getattr(want, field)),
            err_msg=field)
    loc_got = np.asarray(got.loc_targets)
    loc_want = np.asarray(want.loc_targets)
    if loc_exact:
        np.testing.assert_array_equal(loc_got, loc_want)
    else:
        np.testing.assert_allclose(loc_got, loc_want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_oracle_matches_jax_and_pallas(case):
    gtb, gtl, gtm = _case(case)
    got = matcher.encode_targets(
        torch.from_numpy(gtb), torch.from_numpy(gtl), torch.from_numpy(gtm),
        ANCHORS, 0.5)
    assert matcher.LAUNCHES["encode_targets"] == 0  # the CPU route
    janc = jnp.asarray(jax_ssd_anchors())
    np.testing.assert_array_equal(np.asarray(janc), ANCHORS.numpy())
    args = (jnp.asarray(gtb), jnp.asarray(gtl), jnp.asarray(gtm), janc, 0.5)
    want = jax_matching.encode_targets(*args)
    _assert_match_equal(got, want)
    pallas = pallas_encode_targets(*args, interpret=True)
    agree = np.asarray(want.positive) == np.asarray(pallas.positive)
    for field in ("matched_gt", "positive", "cls_targets"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field))[agree],
            np.asarray(getattr(pallas, field))[agree], err_msg=field)
    np.testing.assert_allclose(got.loc_targets.numpy()[agree],
                               np.asarray(pallas.loc_targets)[agree],
                               rtol=1e-5, atol=1e-6)
    if not agree.all():
        iou = boxes.iou_pairwise(torch.from_numpy(gtb),
                                 boxes.center_to_corner(ANCHORS))
        iou = torch.where(torch.from_numpy(gtm)[..., None], iou, -1.0)
        best = iou.amax(dim=1).numpy()[~agree]
        assert np.abs(best - 0.5).max() <= 2 * 2.0 ** -24, best
    pos = got.positive.numpy()
    if case == "duplicate_claim":   # the higher GT takes the shared anchor
        assert (got.matched_gt.numpy()[0][pos[0]] != 0).all()
    if case == "empty_image":
        assert not pos[1].any() and (got.cls_targets.numpy()[1] == 0).all()
    if case == "no_overlap":        # the zero-area GT (image 0's last) takes anchor 0
        assert pos[0, 0] and got.matched_gt.numpy()[0, 0] == 6
    if case == "single_gt_last_index":
        assert (got.matched_gt.numpy() == M - 1).all() and pos.any(axis=1).all()
    if case == "m1":
        assert pos[0].any() and not pos[1].any()
    if case == "tiny_boxes":        # only the forced claims are positive
        iou = boxes.iou_pairwise(torch.from_numpy(gtb[1]),
                                 boxes.center_to_corner(ANCHORS))
        claimed = set(np.argmax(iou.numpy(), axis=1))
        assert set(np.flatnonzero(pos[1])) == claimed


def test_oracle_route_equals_oracle():
    gtb, gtl, gtm = (torch.from_numpy(a) for a in _case("random", seed=3))
    _assert_match_equal(matcher.encode_targets(gtb, gtl, gtm, ANCHORS),
                        matching.encode_targets(gtb, gtl, gtm, ANCHORS),
                        loc_exact=True)


def test_encode_boxes_matches_jax():
    rng = np.random.RandomState(1)
    gt, _, _ = _random_gt(rng, b=1, m=64, n_real=(64,))
    anc = ANCHORS[:64].numpy()
    got = boxes.encode_boxes(torch.from_numpy(gt[0]), torch.from_numpy(anc))
    want = jax_boxes.encode_boxes(jnp.asarray(gt[0]), jnp.asarray(anc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        boxes.corner_to_center(torch.from_numpy(gt[0])).numpy(),
        np.asarray(jax_boxes.corner_to_center(jnp.asarray(gt[0]))))


@pytest.mark.parametrize("min_negatives", [0, 1])
def test_hard_negative_mask_with_ties(min_negatives):
    rng = np.random.RandomState(2)
    # few distinct loss values: most negatives tie with others
    loss = rng.randint(0, 4, (3, 500)).astype(np.float32) * 0.25
    pos = rng.rand(3, 500) < 0.03
    pos[2] = False                   # no positives: min_negatives decides
    got = mining.hard_negative_mask(torch.from_numpy(loss), torch.from_numpy(pos),
                                    3.0, min_negatives)
    want = jax_mining.hard_negative_mask(jnp.asarray(loss), jnp.asarray(pos),
                                         3.0, min_negatives)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0 or min_negatives == 0


def test_ssd_loss_matches_jax():
    gtb, gtl, gtm = _case("random", seed=5)
    rng = np.random.RandomState(5)
    a = ANCHORS.shape[0]
    loc = rng.randn(2, a, 4).astype(np.float32)
    cls = (2.0 * rng.randn(2, a, 11)).astype(np.float32)
    match = matching.encode_targets(torch.from_numpy(gtb), torch.from_numpy(gtl),
                                    torch.from_numpy(gtm), ANCHORS)
    jmatch = jax_matching.encode_targets(jnp.asarray(gtb), jnp.asarray(gtl),
                                         jnp.asarray(gtm), jnp.asarray(ANCHORS.numpy()))
    loc_t = torch.from_numpy(loc).requires_grad_()
    cls_t = torch.from_numpy(cls).requires_grad_()
    got = losses.ssd_loss(loc_t, cls_t, match, 3.0)
    want = jax_losses.ssd_loss(jnp.asarray(loc), jnp.asarray(cls), jmatch, 3.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)
    # the gradients too: mining carries none, as the reference's stop_gradient
    got.total.backward()
    jg = jax.grad(lambda l, c: jax_losses.ssd_loss(l, c, jmatch, 3.0).total,
                  argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(cls))
    np.testing.assert_allclose(loc_t.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(cls_t.grad.numpy(), np.asarray(jg[1]), rtol=1e-5, atol=1e-8)


def test_smooth_l1_matches_jax():
    x = np.linspace(-3, 3, 101, dtype=np.float32)
    np.testing.assert_array_equal(losses.smooth_l1(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_losses.smooth_l1(jnp.asarray(x))))


ANCHOR_COUNTS = {"ssd300": 8732, "ssd512": 24564, "ssd_tiny_64": 368}


def _anchor_owners(plan, a):
    """(A, 4): the (block, warp, lane, k) that holds each anchor, by the
    kernel's arithmetic (csrc/matcher.cu: anchor 32k + lane of chunk
    block + blocks · warp)."""
    ids = np.arange(a)
    chunk = ids // (32 * plan.per_thread)
    within = ids % (32 * plan.per_thread)
    return np.stack([chunk % plan.blocks, chunk // plan.blocks, within % 32,
                     within // 32], axis=1)


@pytest.mark.parametrize("a", [*ANCHOR_COUNTS.values(), 1, 31, 33, 257, 9216,
                               9217, 32768],
                         ids=[*ANCHOR_COUNTS, "1", "31", "33", "257", "9216",
                              "9217", "32768"])
def test_matcher_plan_deals_every_anchor_once(a):
    """Every anchor has one (block, warp, lane, k) slot, inside the block's
    threads and the kernel's instantiations; shared memory fits."""
    plan = matcher._plan(a, 100)
    owners = _anchor_owners(plan, a)
    assert plan.per_thread in matcher.MAX_THREADS
    assert plan.threads % 32 == 0
    assert plan.threads <= matcher.MAX_THREADS[plan.per_thread]
    assert 1 <= plan.blocks <= matcher.CLUSTER
    assert plan.smem <= matcher.SMEM_LIMIT
    assert owners[:, 0].max() < plan.blocks
    assert owners[:, 1].max() < plan.threads // 32
    assert owners[:, 2].max() < 32 and owners[:, 3].max() < plan.per_thread
    slots = {tuple(o) for o in owners}
    assert len(slots) == a
    # a warp's anchors are consecutive: its box covers one strip of a map
    chunk = (owners[:, 0] + plan.blocks * owners[:, 1]).astype(np.int64)
    assert (np.diff(chunk) >= 0).all()


def test_matcher_plan_of_the_configs():
    """SSD300's plan is the one the kernel's register bound was set for
    (two 576-thread blocks an SM); SSD512 and the tiny config fit too."""
    assert matcher._plan(8732, 100) == matcher.Plan(8, 2, 576, 100 * (28 + 8 * 18)
                                                    + 4 * 576 * 2)
    assert matcher._plan(24564, 100).per_thread == 4
    assert matcher._plan(368, 100).threads == 64


def test_matcher_plan_refuses_with_reason():
    with pytest.raises(ValueError, match="takes at most 32768"):
        matcher._plan(32769, 100)
    with pytest.raises(ValueError, match="shared memory"):
        matcher._plan(8732, 2000)
    with pytest.raises(ValueError, match="M ≥ 1"):
        matcher._plan(8732, 0)


def test_ssd512_anchors_match_jax():
    from bdd100k_tpu.ops.anchors import SSD512_FEATURE_MAPS as JAX_SSD512
    from bdd100k_tpu_torch.ops.anchors import SSD512_FEATURE_MAPS

    got = ssd_anchors(SSD512_FEATURE_MAPS).numpy()
    assert got.shape == (ANCHOR_COUNTS["ssd512"], 4)
    np.testing.assert_array_equal(got, np.asarray(jax_ssd_anchors(JAX_SSD512)))
