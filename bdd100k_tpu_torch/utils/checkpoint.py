"""Keep-N checkpoints and restore-latest (counterpart of
bdd100k_tpu/utils/checkpoint.py, which wraps orbax).

The format is the port's own: one `torch.save` file per step,
`ckpt_<step>.pt`, holding {step, model (params and BN statistics),
optimizer, ema}. It is not the reference's orbax layout and neither side
reads the other's. A file is written under a temporary name and renamed,
so a crash never leaves a half-written latest checkpoint.

In a multi-process run (`parallel/mesh.py`) rank 0 writes and every rank
waits for it at a barrier; every rank restores, from the same directory.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from bdd100k_tpu_torch.parallel import mesh

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def all_steps(self) -> list[int]:
        return sorted(
            int(m.group(1)) for p in self.directory.iterdir()
            if (m := _NAME.match(p.name))
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Write the state at `step` and drop all but the newest `keep`
        (rank 0), then wait at the barrier (every rank)."""
        if mesh.data_rank() == 0:
            payload = {
                "step": step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "ema": state.ema_params,
            }
            path = self.directory / f"ckpt_{step}.pt"
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in self.all_steps()[:-self.keep]:
                (self.directory / f"ckpt_{old}.pt").unlink(missing_ok=True)
        mesh.barrier()

    def restore_latest(self, state) -> int:
        """Load the newest checkpoint into `state` in place → its step, or
        0 (state untouched) when there is none."""
        step = self.latest_step()
        if step is None:
            return 0
        device = next(state.model.parameters()).device
        payload = torch.load(self.directory / f"ckpt_{step}.pt",
                             map_location=device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        if state.ema_params is not None:
            ema = payload["ema"]
            if ema is None:  # saved without EMA: start the shadow here
                ema = [p.detach().clone() for p in state.model.parameters()]
            for dst, src in zip(state.ema_params, ema):
                dst.copy_(src)
        state.step = int(payload["step"])
        return state.step
