"""Serving: `Predictor` answers requests of raw uint8 frames with
`Detections` (mirror of bdd100k_tpu/infer.py::Predictor).

One request: pad the frames to the fixed batch, copy them to the device,
resize + normalize there (`preprocess_eval_batch`), run the detector in its
working type, decode, score and NMS on the device, and bring back only the
fixed detection slots. `dispatch` launches a batch without waiting, `fetch`
brings it back; `__call__` does both.

Slice 1 keeps the device-side resize and the rgb wire; `host_resize`, the
yuv420 wire and int8 come with later slices.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from bdd100k_tpu_torch.configs.detector_configs import (
    DetectorConfig,
    apply_yolo_priors,
    get_config,
)
from bdd100k_tpu_torch.data.augment import preprocess_eval_batch
from bdd100k_tpu_torch.models.detector import DetectorBundle, build_detector
from bdd100k_tpu_torch.ops.nms import Detections
from bdd100k_tpu_torch.utils.weights import restore_eval_weights


class Predictor:
    """Forward + postprocess at a fixed batch size, padding-safe."""

    def __init__(self, bundle: DetectorBundle, batch_size: int = 1,
                 host_resize: bool = False, wire: str = "rgb",
                 quant: str = "none"):
        if host_resize:
            raise NotImplementedError("host_resize is not ported yet")
        if wire != "rgb":
            raise NotImplementedError(f"the {wire} wire is not ported yet")
        if quant != "none":
            raise NotImplementedError(f"quant={quant!r} is not ported yet")
        self.bundle = bundle
        self.batch_size = batch_size
        self.device = bundle.anchors.device

    def _to_device(self, frames_u8: np.ndarray) -> torch.Tensor:
        n = frames_u8.shape[0]
        if n > self.batch_size:
            raise ValueError(f"{n} frames > batch size {self.batch_size}")
        if n < self.batch_size:  # pad to the fixed batch shape
            pad = np.repeat(frames_u8[-1:], self.batch_size - n, axis=0)
            frames_u8 = np.concatenate([frames_u8, pad], axis=0)
        t = torch.from_numpy(np.ascontiguousarray(frames_u8))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def logits(self, frames_u8: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Padded batch → (loc (B, A, 4), cls (B, A, C+1)) f32 on the device."""
        images = preprocess_eval_batch(
            self._to_device(frames_u8), self.bundle.config.image_size
        )
        return self.bundle.apply(images)

    def dispatch(self, frames_u8: np.ndarray) -> tuple[Detections, int]:
        """Run one batch on the device → (device Detections, n) without
        the copy back."""
        n = frames_u8.shape[0]
        with torch.inference_mode():
            loc, cls = self.logits(frames_u8)
            det = self.bundle.postprocess(loc, cls)
        return det, n

    @staticmethod
    def fetch(det: Detections, n: int) -> Detections:
        """Device Detections → numpy Detections for the first n frames."""
        return Detections(*(t[:n].cpu().numpy() for t in det))

    def __call__(self, frames_u8: np.ndarray) -> Detections:
        """frames (N ≤ batch_size, H, W, 3) uint8 → host Detections for N."""
        det, n = self.dispatch(frames_u8)
        return self.fetch(det, n)


def load_predictor(
    config: str | DetectorConfig,
    ckpt: str | Path,
    batch_size: int = 1,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    yolo_priors: str | Path | None = None,
) -> Predictor:
    """A `Predictor` for `config` with the weights of `ckpt`: a .npz
    artifact (strict: every key, every shape; another recorded config name
    warns) or a run directory of the port's trainer, its latest
    checkpoint. `yolo_priors` replaces a YOLO config's anchor priors with
    a fitted set (`apply_yolo_priors`), which the weights must have been
    trained with. `device` defaults to CUDA and raises without it; the CPU
    runs only when asked for."""
    cfg = get_config(config) if isinstance(config, str) else config
    if yolo_priors:
        cfg = apply_yolo_priors(cfg, yolo_priors)
    if not Path(ckpt).exists():
        raise FileNotFoundError(f"no weights at {ckpt}")
    bundle = build_detector(cfg, dtype=dtype, device=device)
    restore_eval_weights(bundle.model, ckpt, expect_config=cfg.name)
    return Predictor(bundle, batch_size)
