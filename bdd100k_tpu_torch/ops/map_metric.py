"""VOC-style mAP@IoU evaluator — a numpy copy of bdd100k_tpu/ops/map_metric.py
(the port imports nothing of the JAX package).

Behavior spec: per-class AP at IoU 0.5 over the val set — score-ranked
greedy matching, precision/recall curve, interpolated AP, mean over classes.
The reference does this on host in `eval.py`; we keep the *accumulation* on
host too (it is tiny — only fixed detection slots cross the boundary after
the on-device postprocess, SURVEY.md §3.5), in NumPy for exactness.

Supports both all-point interpolation (VOC2010+/COCO-style, default) and the
legacy 11-point interpolation (VOC2007-style) for parity flexibility.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, corner format: a (M,4), b (N,4) -> (M,N)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), dtype=np.float64)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def average_precision(
    recalls: np.ndarray, precisions: np.ndarray, eleven_point: bool = False
) -> float:
    """AP from a PR curve (recalls ascending)."""
    if eleven_point:
        ap = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            mask = recalls >= t
            ap += (precisions[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    # All-point: envelope precision, integrate over recall steps.
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class DetectionEvaluator:
    """Accumulates per-image detections + GT, computes per-class AP and mAP.

    Usage (shapes may carry validity padding from the fixed-slot postprocess):
        ev = DetectionEvaluator(num_classes=10)
        ev.add_image(det_boxes, det_scores, det_classes, gt_boxes, gt_labels)
        result = ev.compute(iou_threshold=0.5)
    Classes are 1..num_classes (0 = background, never passed in).
    """

    def __init__(self, num_classes: int, class_names: list[str] | None = None):
        self.num_classes = num_classes
        self.class_names = class_names
        self._dets = defaultdict(list)   # cls -> list[(img_id, score, box)]
        self._gts = defaultdict(list)    # (img_id, cls) -> list[box]
        self._gt_count = defaultdict(int)  # cls -> total GT boxes
        self._next_img = 0

    def add_image(
        self,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        det_classes: np.ndarray,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        det_valid: np.ndarray | None = None,
        gt_mask: np.ndarray | None = None,
    ) -> None:
        img_id = self._next_img
        self._next_img += 1
        det_boxes = np.asarray(det_boxes, dtype=np.float64)
        det_scores = np.asarray(det_scores, dtype=np.float64)
        det_classes = np.asarray(det_classes, dtype=np.int64)
        keep = det_scores > 0 if det_valid is None else np.asarray(det_valid, bool)
        for box, score, cls in zip(
            det_boxes[keep], det_scores[keep], det_classes[keep]
        ):
            self._dets[int(cls)].append((img_id, float(score), box))
        gt_boxes = np.asarray(gt_boxes, dtype=np.float64)
        gt_labels = np.asarray(gt_labels, dtype=np.int64)
        if gt_mask is not None:
            m = np.asarray(gt_mask, bool)
            gt_boxes, gt_labels = gt_boxes[m], gt_labels[m]
        for box, cls in zip(gt_boxes, gt_labels):
            self._gts[(img_id, int(cls))].append(box)
            self._gt_count[int(cls)] += 1

    @property
    def num_images(self) -> int:
        """Images added, merged shards included."""
        return self._next_img

    def to_arrays(self) -> dict:
        """Serialize the accumulated state to flat numpy arrays (npz-able).

        Used by multi-host eval (SURVEY.md §2.8 "Collective-aware input"):
        each host evaluates its dataset shard, serializes, and host 0 merges
        all shards with `merge_arrays` before the single mAP computation."""
        det_rows = [
            (img_id, cls, score, box)
            for cls, lst in self._dets.items()
            for (img_id, score, box) in lst
        ]
        gt_rows = [
            (img_id, cls, box)
            for (img_id, cls), lst in self._gts.items()
            for box in lst
        ]
        return {
            "num_images": np.int64(self._next_img),
            "det_img": np.asarray([r[0] for r in det_rows], np.int64),
            "det_cls": np.asarray([r[1] for r in det_rows], np.int64),
            "det_score": np.asarray([r[2] for r in det_rows], np.float64),
            "det_box": (
                np.stack([r[3] for r in det_rows])
                if det_rows else np.zeros((0, 4), np.float64)
            ),
            "gt_img": np.asarray([r[0] for r in gt_rows], np.int64),
            "gt_cls": np.asarray([r[1] for r in gt_rows], np.int64),
            "gt_box": (
                np.stack([r[2] for r in gt_rows])
                if gt_rows else np.zeros((0, 4), np.float64)
            ),
        }

    def merge_arrays(self, arrs: dict) -> None:
        """Fold a `to_arrays` blob into this evaluator; image ids from the
        blob are offset past this evaluator's images so shards never
        collide."""
        off = self._next_img
        for img_id, cls, score, box in zip(
            arrs["det_img"], arrs["det_cls"], arrs["det_score"],
            np.asarray(arrs["det_box"], np.float64),
        ):
            self._dets[int(cls)].append((int(img_id) + off, float(score), box))
        for img_id, cls, box in zip(
            arrs["gt_img"], arrs["gt_cls"],
            np.asarray(arrs["gt_box"], np.float64),
        ):
            self._gts[(int(img_id) + off, int(cls))].append(box)
            self._gt_count[int(cls)] += 1
        self._next_img += int(arrs["num_images"])

    def compute(
        self, iou_threshold: float = 0.5, eleven_point: bool = False
    ) -> dict:
        """Returns {"mAP": float, "per_class": {cls_id_or_name: AP}}."""
        per_class = {}
        for cls in range(1, self.num_classes + 1):
            n_gt = self._gt_count.get(cls, 0)
            dets = self._dets.get(cls, [])
            if n_gt == 0:
                # No GT for this class: convention — skip from the mean
                # (matches VOC tooling) unless there are false positives.
                per_class[cls] = None if not dets else 0.0
                continue
            if not dets:
                per_class[cls] = 0.0
                continue
            dets = sorted(dets, key=lambda d: -d[1])
            tp = np.zeros(len(dets))
            # Group detections per image (their global-score order is
            # preserved within each group, and greedy matching never crosses
            # images) so each image computes ONE det×GT IoU matrix instead
            # of one per detection — the difference between seconds and
            # minutes on a 10k-image val set.
            by_img: dict[int, list[int]] = defaultdict(list)
            for i, (img_id, _score, _box) in enumerate(dets):
                by_img[img_id].append(i)
            for img_id, det_idx in by_img.items():
                gts = self._gts.get((img_id, cls), [])
                if not gts:
                    continue  # all stay fp
                boxes = np.stack([dets[i][2] for i in det_idx])
                ious = _iou_matrix(boxes, np.stack(gts))  # (d, g)
                used = np.zeros(len(gts), bool)
                for row, i in enumerate(det_idx):
                    best = int(np.argmax(ious[row]))
                    if ious[row, best] >= iou_threshold and not used[best]:
                        tp[i] = 1
                        used[best] = True
            fp = 1.0 - tp
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            recalls = ctp / n_gt
            precisions = ctp / np.maximum(ctp + cfp, 1e-12)
            per_class[cls] = average_precision(recalls, precisions, eleven_point)

        valid_aps = [v for v in per_class.values() if v is not None]
        result_classes = {}
        for cls, ap in per_class.items():
            key = (
                self.class_names[cls - 1]
                if self.class_names and cls - 1 < len(self.class_names)
                else cls
            )
            result_classes[key] = ap
        return {
            "mAP": float(np.mean(valid_aps)) if valid_aps else 0.0,
            "per_class": result_classes,
        }

    def compute_range(
        self,
        iou_thresholds: tuple[float, ...] | None = None,
        eleven_point: bool = False,
    ) -> dict:
        """COCO-style mAP averaged over an IoU-threshold range.

        Default range = COCO's [.50:.05:.95]. Matching is redone per
        threshold on the already-accumulated host arrays (tiny — only the
        fixed detection slots ever crossed the device boundary). Returns
        {"mAP": mean over thresholds, "per_iou": {"0.50": mAP, ...}}.
        """
        if iou_thresholds is None:
            iou_thresholds = tuple(np.round(np.arange(0.50, 0.96, 0.05), 2))
        per_iou = {
            f"{t:.2f}": self.compute(t, eleven_point)["mAP"]
            for t in iou_thresholds
        }
        return {
            "mAP": float(np.mean(list(per_iou.values()))),
            "per_iou": per_iou,
        }
