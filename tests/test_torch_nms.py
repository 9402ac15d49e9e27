"""The port's NMS against the JAX reference, on the CPU.

* the plain greedy (`greedy_keep_mask`, the CUDA kernel's plain version)
  is bit-equal to the reference oracle `greedy_keep_mask` and to
  `pallas_greedy_suppress(..., interpret=True)`, on hypothesis-drawn and
  adversarial inputs (greedy-trap chains among them) and at K = 1 and K
  not a multiple of 32;
* `postprocess` agrees with the JAX `postprocess` on random logits at the
  tiny config and at 8732 anchors, against the reference's dense and
  anchor-pruned preselects (its guard taken and refused) and on tied
  scores: valid and classes equal, boxes and scores within 1e-6
  (ulp-level: XLA and PyTorch round exp and the softmax sum differently);
* on the same f32 scores, the port's preselect candidates are bit-equal
  to the reference's (its pruned route with the guard held and refused,
  and its dense route on ties).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.configuration import set_hypothesis_home_dir, storage_directory
from hypothesis.extra.numpy import arrays

from bdd100k_tpu.configs.detector_configs import SSD_MOBILENET_300 as JAX_SSD300
from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
from bdd100k_tpu.ops import nms as jax_nms
from bdd100k_tpu.ops.anchors import ssd_anchors as jax_ssd_anchors
from bdd100k_tpu.ops.pallas_nms import pallas_greedy_suppress
from bdd100k_tpu.ops.postprocess import postprocess as jax_postprocess
from bdd100k_tpu_torch.configs import SSD_MOBILENET_300, tiny_test_config
from bdd100k_tpu_torch.ops import nms
from bdd100k_tpu_torch.ops.anchors import ssd_anchors
from bdd100k_tpu_torch.ops.postprocess import postprocess

B, C, K = 2, 3, 40
THR = 0.45
# box coordinates on a coarse grid: draws hit duplicates, shared edges,
# zero-area boxes and IoUs exactly on simple fractions
GRID = [i / 20 for i in range(21)]


@pytest.fixture(autouse=True, scope="module")
def _hypothesis_writes_to_tmp(tmp_path_factory):
    """Hypothesis caches source constants under its home directory (the
    working directory by default); keep that inside pytest's tmp dirs."""
    previous = storage_directory(intent_to_write=False)
    set_hypothesis_home_dir(tmp_path_factory.mktemp("hypothesis"))
    yield
    set_hypothesis_home_dir(previous)


def _port_keep(boxes, valid):
    return nms.greedy_keep_mask(
        torch.from_numpy(boxes), torch.from_numpy(valid), THR
    ).numpy()


def _ref_keeps(boxes, valid):
    oracle = np.stack([
        np.stack([
            np.asarray(jax_nms.greedy_keep_mask(
                jnp.asarray(boxes[i, j]), jnp.asarray(valid[i, j]), THR
            ))
            for j in range(boxes.shape[1])
        ])
        for i in range(boxes.shape[0])
    ])
    kernel = np.asarray(pallas_greedy_suppress(
        jnp.asarray(boxes), jnp.asarray(valid), THR, interpret=True
    ))
    return oracle, kernel


def _check(boxes, valid):
    got = _port_keep(boxes, valid)
    oracle, kernel = _ref_keeps(boxes, valid)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, kernel)


@settings(max_examples=12, deadline=None, database=None)
@given(
    corners=arrays(np.float32, (B, C, K, 4), elements=st.sampled_from(GRID)),
    valid=arrays(np.bool_, (B, C, K)),
)
def test_plain_greedy_bit_equal_hypothesis(corners, valid):
    # sort each box's corners so most are proper boxes; inverted ones
    # (zero area after clamping) stay possible through equal values
    x = np.sort(corners[..., 0::2], axis=-1)
    y = np.sort(corners[..., 1::2], axis=-1)
    boxes = np.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)
    _check(boxes.astype(np.float32), valid)


def _adversarial():
    rng = np.random.RandomState(3)
    cxy = rng.uniform(0.05, 0.95, (B, C, K, 2))
    wh = rng.uniform(0.02, 0.4, (B, C, K, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
    boxes = boxes.astype(np.float32)
    cases = {}
    dup = boxes.copy()
    dup[..., 1::2, :] = dup[..., 0::2, :]
    cases["duplicates"] = (dup, np.ones((B, C, K), bool))
    edge = boxes.copy()  # IoU exactly 0.45 (kept) and just above (killed)
    edge[..., 0, :] = [0.0, 0.0, 1.0, 1.0]
    edge[..., 1, :] = [0.0, 0.0, 0.45, 1.0]
    edge[..., 2, :] = [0.0, 0.0, 0.46, 1.0]
    cases["iou_on_threshold"] = (edge, np.ones((B, C, K), bool))
    zero = boxes.copy()
    zero[..., ::3, 2] = zero[..., ::3, 0]
    zero[..., 1::5, :] = zero[..., 1::5, :1]
    cases["zero_area"] = (zero, np.ones((B, C, K), bool))
    inval = rng.rand(B, C, K) > 0.5
    inval[:, 0] = False
    inval[1] = False
    cases["all_invalid_rows"] = (boxes, inval)
    jit = rng.normal(0, 0.02, (B, C, K, 4)).astype(np.float32)
    cases["clustered"] = (
        np.clip(np.float32([0.3, 0.3, 0.6, 0.6]) + jit, 0, 1),
        np.ones((B, C, K), bool),
    )
    cases["greedy_trap"] = (_trap_rows(rng, K), np.ones((B, C, K), bool))
    return cases


# greedy-trap chains a < b < c, inside one 32-candidate word and across
# words: a suppresses b (IoU 0.5), b overlaps c above the threshold (IoU
# 0.5), a and c do not (IoU 0.2), so c survives under the greedy rule
TRAPS = ((0, 1, 2), (30, 33, 39))


def _trap_rows(rng, k, traps=TRAPS):
    """(B, C, k, 4) small random boxes at y > 0.25, away from the chains,
    each laid in a strip of its own below y = 0.25."""
    cxy = rng.uniform([0.05, 0.3], [0.95, 0.95], (B, C, k, 2))
    wh = rng.uniform(0.02, 0.1, (B, C, k, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
    for strip, chain in enumerate(traps):
        y = 0.12 * strip
        if chain[-1] < k:
            for pos, x1 in zip(chain, (0.0, 0.2, 0.4)):
                boxes[..., pos, :] = [x1, y, x1 + 0.6, y + 0.1]
    return boxes.astype(np.float32)


@pytest.mark.parametrize("case", sorted(_adversarial()))
def test_plain_greedy_bit_equal_adversarial(case):
    boxes, valid = _adversarial()[case]
    _check(boxes, valid)
    if case == "iou_on_threshold":
        keep = _port_keep(boxes, valid)
        assert keep[..., 1].all() and not keep[..., 2].any()
    if case == "greedy_trap":
        keep = _port_keep(boxes, valid)
        for a, b, c in TRAPS:
            assert keep[..., a].all() and not keep[..., b].any() and keep[..., c].all()


# K as the kernel takes it, unpadded: one candidate, ragged last words
@pytest.mark.parametrize("k", [1, 31, 37, 65])
def test_plain_greedy_bit_equal_at_k(k):
    rng = np.random.RandomState(k)
    cxy = rng.uniform(0.05, 0.95, (B, C, k, 2))
    wh = rng.uniform(0.02, 0.5, (B, C, k, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
    _check(boxes.astype(np.float32), rng.rand(B, C, k) > 0.2)
    if k >= 3:  # a chain at the row's head, and one ending on its last candidate
        trap = _trap_rows(rng, k, ((0, 1, 2), (k - 3, k - 2, k - 1)))
        _check(trap, np.ones((B, C, k), bool))


def _assert_same_detections(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    # invalid slots carry whichever zero-score box the top-k reached first,
    # on which the reference's own NMS backends differ; only valid ones count
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=0, atol=1e-6)


def _logits(rng, b, a, kind):
    loc = rng.normal(0, 1, (b, a, 4)).astype(np.float32)
    if kind == "random":       # dense: every anchor clears the threshold
        cls = rng.normal(0, 2, (b, a, 11))
    elif kind == "sparse":     # trained-like: few anchors above 0.01
        cls = rng.normal(0, 1, (b, a, 11))
        cls[..., 0] += 9.0
        hot = rng.rand(b, a) < 0.05
        cls[hot, 1:] += rng.uniform(6, 12, (hot.sum(), 10))
    else:                      # tied: every anchor copies one of 6 rows
        # (ties between identical rows are bit-exact in any implementation,
        # so the (score desc, anchor asc) order is what is under test)
        protos = rng.normal(0, 2, (6, 11))
        cls = protos[rng.randint(0, 6, (b, a))]
    return loc, cls.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "sparse", "tied"])
@pytest.mark.parametrize("config", ["tiny", "ssd300"])
def test_postprocess_matches_jax(config, kind):
    if config == "tiny":
        cfg, jcfg = tiny_test_config("ssd"), jax_tiny("ssd")
    else:
        cfg, jcfg = SSD_MOBILENET_300, JAX_SSD300
    rng = np.random.RandomState(0)
    a = cfg.num_anchors
    loc, cls = _logits(rng, 2, a, kind)
    want = jax_postprocess(
        jnp.asarray(loc), jnp.asarray(cls),
        jax_ssd_anchors(jcfg.feature_maps), jcfg.postprocess,
    )
    got = postprocess(
        torch.from_numpy(loc), torch.from_numpy(cls),
        ssd_anchors(cfg.feature_maps), cfg.postprocess,
    )
    assert int(got.valid.sum()) > 0
    _assert_same_detections(got, want)


@pytest.mark.parametrize("kind", ["random", "sparse", "tied"])
def test_postprocess_matches_jax_dense_preselect(kind):
    """The JAX reference's dense preselect (prune_m=0) against the port's
    one preselect, at 8732 anchors."""
    rng = np.random.RandomState(4)
    loc, cls = _logits(rng, 2, SSD_MOBILENET_300.num_anchors, kind)
    want = jax_postprocess(
        jnp.asarray(loc), jnp.asarray(cls),
        jax_ssd_anchors(JAX_SSD300.feature_maps),
        dataclasses.replace(JAX_SSD300.postprocess, prune_m=0),
    )
    got = postprocess(
        torch.from_numpy(loc), torch.from_numpy(cls), ssd_anchors(),
        SSD_MOBILENET_300.postprocess,
    )
    _assert_same_detections(got, want)


@pytest.mark.parametrize("kind,prune_m", [
    ("sparse", 2048),  # the reference's pruned route, its guard held
    ("random", 2048),  # its guard refused: the reference's dense route
    # ties straddling k: the reference's own caveat (bdd100k_tpu/ops/
    # nms.py:287-293) lets its pruned route admit any member of the tie,
    # so the (score desc, anchor asc) order is held against the dense one
    ("tied", 0),
])
def test_preselect_candidates_bit_equal_jax(kind, prune_m):
    """On the same f32 scores the port's preselect gives the reference's
    candidates bit for bit."""
    rng = np.random.RandomState(5)
    a = SSD_MOBILENET_300.num_anchors
    loc, cls = _logits(rng, 2, a, kind)
    e = np.exp(cls - cls.max(-1, keepdims=True))
    scores = (e / e.sum(-1, keepdims=True))[..., 1:].astype(np.float32)
    boxes = np.sort(rng.uniform(0, 1, (2, a, 4)), -1).astype(np.float32)
    cfg = JAX_SSD300.postprocess
    if prune_m:  # the guard: fewer than M anchors above the threshold
        above = (scores > cfg.score_threshold).any(-1).sum(-1)
        assert bool((above < prune_m).all()) == (kind == "sparse")
    want = jax_nms._preselect_candidates(
        jnp.asarray(boxes), jnp.asarray(scores), cfg.score_threshold,
        cfg.per_class_topk, "exact", prune_m,
    )
    got = nms._preselect_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        cfg.score_threshold, cfg.per_class_topk,
    )
    valid = np.asarray(want[2])
    assert valid.any()
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy()[valid], np.asarray(want[0])[valid])


def test_approx_preselect_raises_with_reason():
    with pytest.raises(ValueError, match="approx_max_k"):
        nms.batched_class_nms(
            torch.zeros(1, 10, 4), torch.zeros(1, 10, 2), preselect="approx"
        )
