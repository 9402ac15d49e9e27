"""Per-step metrics as JSON lines plus stdout lines, and image summaries
in TensorBoard (mirror of bdd100k_tpu/utils/metrics.py).

Scalars go to `<run_dir>/<name>.jsonl` and stdout. Images (drawn
detections) go to TensorBoard event files under `<run_dir>/tb` through
`torch.utils.tensorboard` when it imports, and nowhere otherwise, as the
reference logs them only when a TensorBoard writer is importable. The
writer is made at the first image: importing it can take seconds.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


def _tensorboard_writer(log_dir: Path):
    """A SummaryWriter on `log_dir`, or None when TensorBoard does not
    import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # noqa: BLE001 — absent or broken: no image summaries
        return None
    return SummaryWriter(str(log_dir))


class MetricsLogger:
    def __init__(self, run_dir: str | Path, name: str = "train",
                 stdout: bool = True, write_files: bool = True):
        """`write_files=False` for every rank but 0 of a multi-process run:
        it keeps its stdout lines and writes neither the JSONL nor
        TensorBoard, so one writer owns the files."""
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._file = (open(self.run_dir / f"{name}.jsonl", "a", buffering=1)
                      if write_files else None)
        self.stdout = stdout
        self._t0 = time.monotonic()
        # made at the first image; False when unavailable or not the writer
        self._tb = None if write_files else False

    def log(self, step: int, metrics: dict) -> None:
        """One record {step, t (seconds since the logger started), the
        scalar metrics}."""
        scalars = {k: float(v) for k, v in metrics.items()}
        rec = {"step": int(step), "t": time.monotonic() - self._t0, **scalars}
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
        if self.stdout:
            body = " ".join(f"{k}={v:.5g}" for k, v in scalars.items())
            print(f"step {step}: {body}", flush=True)

    def image(self, step: int, name: str, image: np.ndarray) -> None:
        """Log an HWC uint8 image summary; nothing when TensorBoard does
        not import."""
        if self._tb is None:
            self._tb = _tensorboard_writer(self.run_dir / "tb") or False
        if self._tb:
            self._tb.add_image(name, np.asarray(image), int(step), dataformats="HWC")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._tb:
            self._tb.close()
