"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """`device` as a torch.device; a CUDA device without CUDA is an error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: bdd100k_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain versions on the CPU"
        )
    return device


@contextlib.contextmanager
def strict_f32(enabled: bool = True):
    """f32 means f32: with `enabled`, TF32 is off in cuDNN and matmuls for
    the block, and both flags are restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if enabled:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
