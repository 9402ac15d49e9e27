"""Class-wise NMS with exact greedy semantics (mirror of
bdd100k_tpu/ops/nms.py: the oracle, the preselect, the finalize and the
kernel route).

Candidates are ordered by (score desc, anchor index asc) — the order the
reference's `lax.top_k` and `_reorder_tied_runs` produce — through stable
sorts, so keep decisions and slots match the reference's bit for bit.

The greedy suppression is the op `bdd100k_tpu_torch::greedy_suppress`
(`torch.library`, so an exported program calls it by name): the
hand-written CUDA kernel `csrc/nms.cu` on CUDA tensors, the plain greedy
on CPU tensors. The kernel replaces
bdd100k_tpu/ops/pallas_nms.py::pallas_greedy_suppress. Its bound on the
card is tiny either way — the K(K−1)/2 IoUs of a row are ~14 f32 ops each
and a candidate is 18 bytes, ~0.1 µs of work for B=8, C=10, K=100 — so
what costs time is latency: the sequential greedy chain, with fewer rows
than SMs at serving sizes. A call is one launch on the inputs as they are
(K ≤ 256, the ragged last word masked in the kernel, nothing padded or
copied when they are contiguous). One block takes one (image, class) row:
its 32 warps build the upper triangle of the IoU-above-threshold bit
matrix once, one (row, 32-candidate word) pair a warp and a ballot a
word, then one warp resolves the greedy order word by word: inside a word
in registers, across words by one OR over the warp.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bdd100k_tpu_torch.ops import boxes as box_ops
from bdd100k_tpu_torch.utils import cuda_build

LAUNCHES = {"greedy_suppress": 0}
_MAX_K = 256  # the kernel's row: eight 32-candidate words in shared memory


class Detections(NamedTuple):
    """Fixed-slot detection output (validity-masked)."""

    boxes: torch.Tensor    # (..., max_det, 4) corner format
    scores: torch.Tensor   # (..., max_det)
    classes: torch.Tensor  # (..., max_det) int32, 1..C (0 in invalid slots)
    valid: torch.Tensor    # (..., max_det) bool


def _threshold(iou_threshold: float) -> float:
    """The threshold rounded to f32, as the reference compares f32 IoUs
    with it (a Python float compares exactly in an f32 tensor op)."""
    return float(np.float32(iou_threshold))


def greedy_keep_mask(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """The oracle: (..., K, 4) score-descending corner boxes, (..., K) bool
    valid → (..., K) bool keep. Candidate i survives iff it is valid and no
    surviving j < i overlaps it with IoU > threshold. This is the plain
    version of the CUDA kernel; batch dims are carried along."""
    k = boxes.shape[-2]
    iou = box_ops.iou_pairwise(boxes, boxes)
    idx = torch.arange(k, device=boxes.device)
    earlier = idx[None, :] < idx[:, None]                     # (i, j): j < i
    edge = (iou > _threshold(iou_threshold)) & earlier
    keep = valid.clone()
    for i in range(k):
        killed = (edge[..., i, :] & keep).any(dim=-1)
        keep[..., i] &= ~killed
    return keep


def greedy_suppress_cuda(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float = 0.45
) -> torch.Tensor:
    """The CUDA kernel: boxes (B, C, K, 4) f32, valid (B, C, K) bool on the
    card, 1 ≤ K ≤ 256 → keep (B, C, K) bool, in one launch. Contiguous
    inputs are passed as they are; others are copied once."""
    if not boxes.is_cuda or not valid.is_cuda:
        raise ValueError("greedy_suppress_cuda needs CUDA tensors")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"greedy_suppress_cuda takes f32 boxes and bool valid, got "
            f"{boxes.dtype} and {valid.dtype}"
        )
    if boxes.dim() != 4 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:-1]:
        raise ValueError(
            f"shapes: boxes (B, C, K, 4) and valid (B, C, K), got "
            f"{tuple(boxes.shape)} and {tuple(valid.shape)}"
        )
    b, c, k, _ = boxes.shape
    if k > _MAX_K:
        raise ValueError(f"greedy_suppress_cuda takes K ≤ {_MAX_K}, got {k}")
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    if boxes.data_ptr() % 16:
        raise ValueError("greedy_suppress_cuda reads a box as 16 aligned bytes; "
                         "the boxes' storage offset breaks that")
    keep = torch.empty((b, c, k), dtype=torch.bool, device=boxes.device)
    if b * c == 0 or k == 0:
        return keep
    lib = cuda_build.kernel_library("nms")
    err = lib.greedy_suppress(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b * c, k,
        _threshold(iou_threshold),
        torch.cuda.current_stream(boxes.device).cuda_stream,
    )
    cuda_build.check(err, "greedy_suppress")
    LAUNCHES["greedy_suppress"] += 1
    return keep


# The op the paths call, registered with the dispatcher (not
# `torch.library.custom_op`, whose first call imports TorchDynamo, ~1.5 s a
# process, and whose calls cost ~15 µs more of host time than this one's)
_LIB = torch.library.Library("bdd100k_tpu_torch", "FRAGMENT")
_LIB.define("greedy_suppress(Tensor boxes, Tensor valid, float iou_threshold)"
            " -> Tensor")
_LIB.impl("greedy_suppress", greedy_keep_mask, "CPU")
_LIB.impl("greedy_suppress", greedy_suppress_cuda, "CUDA")


@torch.library.register_fake("bdd100k_tpu_torch::greedy_suppress", lib=_LIB)
def _(boxes, valid, iou_threshold):
    return valid.new_empty(valid.shape)


def greedy_suppress(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float = 0.45
) -> torch.Tensor:
    """Batched keep mask through the op `bdd100k_tpu_torch::greedy_suppress`
    (one node of an exported graph): the CUDA kernel for CUDA tensors, the
    plain greedy for CPU tensors; no other device has an implementation."""
    return torch.ops.bdd100k_tpu_torch.greedy_suppress(boxes, valid,
                                                       float(iou_threshold))


def _sorted_desc(scores: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort the last axis by (score desc, position asc) — lax.top_k's order."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)


def _gather_boxes(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """boxes (B, N, 4), idx (B, C, k) anchor ids → (B, C, k, 4)."""
    b, c, k = idx.shape
    flat = torch.gather(boxes, 1, idx.reshape(b, c * k, 1).expand(-1, -1, 4))
    return flat.reshape(b, c, k, 4)


def _preselect_candidates(
    boxes: torch.Tensor,
    class_scores: torch.Tensor,
    score_threshold: float,
    per_class_topk: int,
    preselect: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class top-k preselect → (cand_boxes (B, C, k, 4), top_scores
    (B, C, k), valid (B, C, k)), score-descending within each
    (image, class), ties by anchor index ascending.

    One stable sort over every anchor. The reference's anchor-pruned
    route (`_preselect_pruned`, top-M anchors first behind an exactness
    guard) answers the cost of a full sort on the TPU; on the H100 the
    dense sort is the faster of the two, pruning's guard being a host sync
    (chip_smoke.py's `preselect` phase times both), so it is not ported."""
    if preselect != "exact":
        raise ValueError(
            f"preselect={preselect!r}: only 'exact' is ported — the "
            "reference's 'approx' is lax.approx_max_k, a TPU PartialReduce "
            "with no torch counterpart"
        )
    b, n, num_classes = class_scores.shape
    k = min(per_class_topk, n)
    scores_bcn = class_scores.transpose(1, 2)
    scores_bcn = torch.where(scores_bcn > score_threshold, scores_bcn, 0.0)
    top_scores, idx = _sorted_desc(scores_bcn)
    top_scores, idx = top_scores[..., :k], idx[..., :k]
    return _gather_boxes(boxes, idx), top_scores, top_scores > 0.0


def _finalize_detections(
    cand_boxes: torch.Tensor,
    top_scores: torch.Tensor,
    keep: torch.Tensor,
    max_detections: int,
) -> Detections:
    """Cross-class top-k over kept candidates → fixed `Detections` slots."""
    b, num_classes, k, _ = cand_boxes.shape
    class_ids = torch.arange(
        1, num_classes + 1, dtype=torch.int32, device=cand_boxes.device
    )[None, :, None].expand(b, -1, k)
    flat_boxes = cand_boxes.reshape(b, -1, 4)
    flat_scores = torch.where(keep, top_scores, 0.0).reshape(b, -1)
    flat_classes = class_ids.reshape(b, -1)
    if flat_scores.shape[1] < max_detections:  # tiny inputs: pad candidates
        pad = max_detections - flat_scores.shape[1]
        flat_boxes = F.pad(flat_boxes, (0, 0, 0, pad))
        flat_scores = F.pad(flat_scores, (0, pad))
        flat_classes = F.pad(flat_classes, (0, pad))
    out_scores, sel = _sorted_desc(flat_scores)
    out_scores, sel = out_scores[:, :max_detections], sel[:, :max_detections]
    out_valid = out_scores > 0.0
    return Detections(
        boxes=torch.gather(flat_boxes, 1, sel[..., None].expand(-1, -1, 4)),
        scores=out_scores,
        classes=torch.where(
            out_valid, torch.gather(flat_classes, 1, sel), 0
        ).to(torch.int32),
        valid=out_valid,
    )


def batched_class_nms(
    boxes: torch.Tensor,
    class_scores: torch.Tensor,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.01,
    per_class_topk: int = 200,
    max_detections: int = 200,
    preselect: str = "exact",
) -> Detections:
    """boxes (B, N, 4) corner, class_scores (B, N, C) → `Detections`.

    The counterpart of `batched_class_nms_pallas`: preselect, greedy
    suppression (the CUDA kernel for CUDA tensors, the plain greedy for
    CPU tensors), finalize."""
    cand_boxes, top_scores, valid = _preselect_candidates(
        boxes, class_scores, score_threshold, per_class_topk, preselect
    )
    keep = greedy_suppress(cand_boxes, valid, iou_threshold)
    return _finalize_detections(cand_boxes, top_scores, keep, max_detections)
