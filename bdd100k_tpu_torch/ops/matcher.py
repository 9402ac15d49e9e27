"""The fused matcher (counterpart of
bdd100k_tpu/ops/pallas_matcher.py::pallas_encode_targets).

For CUDA tensors it runs the hand-written kernel `csrc/matcher.cu`, which
replaces the TPU kernel `_matcher_kernel` (pallas_matcher.py:48-196): IoU,
both best-match reductions with their tie rules, the forced claims and
the SSD encode, never writing the (B, M, A) IoU tensor the oracle builds.
For CPU tensors it runs the oracle `ops/matching.py::encode_targets`, the
kernel's plain version. `matched_gt`, `positive` and `cls_targets` equal
the oracle's bit for bit; `loc_targets` agree to the ulp of the card's
`logf`.

Its bound is the IoUs of the real GT rows with every anchor (~16 f32
operations each with the divide; 3.7 µs at B=32, 1783 real rows, 8732
anchors on an H100) against 33 bytes written an anchor (2.8 µs). A call
is one launch and allocates only its outputs: one thread-block cluster an
image, whose blocks take the anchors in chunks dealt round them (`_plan`),
keep each anchor's best match in registers from the match to the encode,
skip exactly the GTs that miss a warp's anchors, and meet in distributed
shared memory for the per-GT best anchor and the forced claims.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bdd100k_tpu_torch.ops import boxes as box_ops
from bdd100k_tpu_torch.ops import matching
from bdd100k_tpu_torch.ops.matching import MatchResult
from bdd100k_tpu_torch.utils import cuda_build

LAUNCHES = {"encode_targets": 0}

CLUSTER = 8            # blocks an image: the portable cluster size
# anchors a thread (the kernel's instantiations) → threads a block (its
# launch bound, which leaves each the registers it needs)
MAX_THREADS = {1: 1024, 2: 576, 4: 768, 8: 512}
SMEM_LIMIT = 231424    # dynamic shared bytes a block may take (226 KB)


class Plan(NamedTuple):
    """How the kernel deals an image's A anchors: in chunks of 32 ×
    `per_thread` consecutive anchors, chunk c to block c % `blocks` of the
    image's cluster and to warp c // `blocks` there; `threads` a block,
    `smem` dynamic shared bytes (the M GT rows, their keys for the block
    and for each warp, one claim slot an anchor of the block)."""

    blocks: int
    per_thread: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=None)
def _plan(a: int, m: int) -> Plan:
    """The launch plan for A anchors and M GT rows: the fewest anchors a
    thread whose chunks, dealt to eight blocks (fewer when there are fewer
    chunks), fit each block's threads. Raises for a shape the kernel
    cannot take, saying why."""
    if a < 1 or m < 1:
        raise ValueError(f"the matcher kernel needs A ≥ 1 and M ≥ 1, got A={a}, M={m}")
    for apt, most in MAX_THREADS.items():
        chunks = -(-a // (32 * apt))
        blocks = min(CLUSTER, chunks)
        threads = 32 * -(-chunks // blocks)
        if threads <= most:
            break
    else:
        raise ValueError(
            f"A={a} anchors: a cluster of {CLUSTER} blocks of {most} threads "
            f"with {apt} anchors a thread takes at most {CLUSTER * most * apt}")
    smem = m * (28 + 8 * (threads // 32)) + 4 * threads * apt
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"M={m} GT rows and {threads * apt} anchors a block need {smem} bytes "
            f"of shared memory, more than the {SMEM_LIMIT} a block may take")
    return Plan(blocks, apt, threads, smem)


def encode_targets_cuda(
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    anchors_center: torch.Tensor,
    match_threshold: float = 0.5,
) -> MatchResult:
    """The CUDA kernel: gt_boxes (B, M, 4) f32, gt_labels (B, M) int32,
    gt_mask (B, M) bool, anchors_center (A, 4) f32, all contiguous on the
    card, M ≥ 1 → MatchResult (int64 matched_gt and cls_targets, bool
    positive, f32 loc_targets), in one launch."""
    tensors = (gt_boxes, gt_labels, gt_mask, anchors_center)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("encode_targets_cuda needs CUDA tensors")
    if (gt_boxes.dtype, gt_labels.dtype, gt_mask.dtype, anchors_center.dtype) != (
            torch.float32, torch.int32, torch.bool, torch.float32):
        raise TypeError(
            "encode_targets_cuda takes f32 boxes, int32 labels, bool mask and "
            f"f32 anchors, got {[t.dtype for t in tensors]}"
        )
    if gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4 or anchors_center.dim() != 2 \
            or anchors_center.shape[-1] != 4 \
            or gt_labels.shape != gt_boxes.shape[:2] \
            or gt_mask.shape != gt_boxes.shape[:2]:
        raise ValueError(
            "shapes: gt_boxes (B, M, 4), gt_labels and gt_mask (B, M), anchors "
            f"(A, 4); got {[tuple(t.shape) for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("encode_targets_cuda needs contiguous tensors")
    if gt_boxes.data_ptr() % 16 or anchors_center.data_ptr() % 16:
        raise ValueError("encode_targets_cuda reads a box as 16 aligned bytes; "
                         "a storage offset breaks that")
    b, m, _ = gt_boxes.shape
    a = anchors_center.shape[0]
    plan = _plan(a, m)
    dev = gt_boxes.device
    matched = torch.empty((b, a), dtype=torch.int64, device=dev)
    positive = torch.empty((b, a), dtype=torch.bool, device=dev)
    cls = torch.empty((b, a), dtype=torch.int64, device=dev)
    loc = torch.empty((b, a, 4), dtype=torch.float32, device=dev)
    lib = cuda_build.kernel_library("matcher")
    err = lib.encode_targets(
        gt_boxes.data_ptr(), gt_labels.data_ptr(), gt_mask.data_ptr(),
        anchors_center.data_ptr(), matched.data_ptr(), positive.data_ptr(),
        cls.data_ptr(), loc.data_ptr(), b, m, a, *plan,
        # the threshold and variances as the f32 values the oracle compares
        # and multiplies with
        float(np.float32(match_threshold)),
        float(np.float32(box_ops.VARIANCE_CENTER)),
        float(np.float32(box_ops.VARIANCE_SIZE)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(err, "encode_targets")
    LAUNCHES["encode_targets"] += 1
    return MatchResult(matched, positive, cls, loc)


def encode_targets(
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    anchors_center: torch.Tensor,
    match_threshold: float = 0.5,
) -> MatchResult:
    """Batched matcher: the CUDA kernel for CUDA tensors, the oracle for
    CPU tensors."""
    if gt_boxes.is_cuda:
        return encode_targets_cuda(
            gt_boxes, gt_labels, gt_mask, anchors_center, match_threshold)
    if gt_boxes.device.type != "cpu":
        raise ValueError(f"no matcher route for device {gt_boxes.device}")
    return matching.encode_targets(
        gt_boxes, gt_labels, gt_mask, anchors_center, match_threshold)
