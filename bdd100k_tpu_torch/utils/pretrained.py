"""Pretrained-backbone import (counterpart of bdd100k_tpu/utils/pretrained.py).

Three sources seed a detector's backbone before training:
* an `.npz` transplant: a bare file keyed by flax paths relative to
  `params/backbone` (`save_params_npz`, or an ImageNet file prepared in
  that layout), or a full detector artifact (`utils/weights.py` layout),
  whose backbone params and BatchNorm statistics are taken, so a backbone
  trained under one head (SSD) seeds another (YOLO);
* torchvision's `vgg16` state_dict (`features.N.weight/bias`) for
  VGG16Backbone's conv1_1…conv5_3 (fc6/fc7 keep their init, as in the
  reference's SSD recipe);
* HuggingFace transformers' MobileNetV1 state_dict (the stem and the 26
  alternating depthwise/pointwise layers, with or without the classifier's
  `mobilenet_v1.` prefix) for MobileNetBackbone, BatchNorm statistics
  included.

Every source is first put in the reference's flat flax paths (conv kernels
HWIO), then mapped onto the port's modules through `utils/weights.py`'s
key mapping, so a file seeds the same tensors here as in the reference.
As there, a path the model does not have is ignored, a path it has keeps
its init unless the file holds it, and a shape that differs raises.
`.pth`/`.bin` files load with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from bdd100k_tpu_torch.utils.weights import (
    flax_from_state_dict,
    read_detector_npz,
    state_dict_from_flax,
)

BACKBONE = "backbone"


def _prefix(model: torch.nn.Module) -> str:
    """'backbone/' for a detector, '' for a bare backbone module."""
    names = dict(model.named_children())
    return f"{BACKBONE}/" if BACKBONE in names else ""


def merge_flax(model: torch.nn.Module, params: Mapping[str, np.ndarray],
               stats: Mapping[str, np.ndarray] | None = None,
               prefix: str = "") -> int:
    """Copy flat flax `params` and `batch_stats` (paths relative to
    `prefix`, kernels HWIO) into `model` in place → the number of tensors
    written. Paths the model lacks are skipped; a shape mismatch raises."""
    flat_p = {prefix + k: np.asarray(v) for k, v in params.items()}
    flat_s = {prefix + k: np.asarray(v) for k, v in (stats or {}).items()}
    target = model.state_dict()
    written = 0
    with torch.no_grad():
        for key, value in state_dict_from_flax(flat_p, flat_s).items():
            if key.endswith("num_batches_tracked") or key not in target:
                continue
            dst = target[key]
            if tuple(value.shape) != tuple(dst.shape):
                raise ValueError(f"shape mismatch at {key}: file "
                                 f"{tuple(value.shape)} vs model {tuple(dst.shape)}")
            dst.copy_(value.to(dst.dtype))
            written += 1
    return written


def save_params_npz(model: torch.nn.Module, path: str | Path) -> None:
    """Export the detector's backbone params to an npz keyed by flax path
    within the backbone, f32, HWIO kernels: the file the reference's
    `save_params_npz(params, path, subtree="backbone")` writes."""
    params, _ = flax_from_state_dict(model.state_dict())
    head = f"{BACKBONE}/"
    np.savez(path, **{k[len(head):]: v for k, v in params.items()
                      if k.startswith(head)})


def load_params_npz(model: torch.nn.Module, path: str | Path) -> int:
    """Merge an npz keyed by flax path within the backbone into the model's
    params → the number of tensors written."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return merge_flax(model, flat, prefix=_prefix(model))


def load_backbone_any_npz(model: torch.nn.Module, path: str | Path) -> int:
    """Seed the backbone from an npz in either layout (module docstring):
    a bare transplant, or a full artifact whose `params/backbone/*` and
    `batch_stats/backbone/*` are taken → the number of tensors written."""
    with np.load(path) as z:
        files = [k for k in z.files if k != "__meta__"]
    if not any(k.startswith("params/") for k in files):
        return load_params_npz(model, path)
    params, stats, _ = read_detector_npz(path)
    head = f"{BACKBONE}/"
    bb = {k[len(head):]: v for k, v in params.items() if k.startswith(head)}
    if not bb:
        raise ValueError(f"{path} has no params/backbone/* entries")
    bb_stats = {k[len(head):]: v for k, v in stats.items() if k.startswith(head)}
    # a backbone without BatchNorm (VGG16) takes no statistics: the key
    # decides, not whether the file has any
    has_stats = any(k.endswith("running_mean") for k in model.state_dict()
                    if k.startswith(_prefix(model).replace("/", ".")))
    return merge_flax(model, bb, bb_stats if has_stats else None,
                      prefix=_prefix(model))


def _array(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t).astype(np.float32)


# torchvision vgg16 `features` conv indices, in order conv1_1..conv5_3
_TORCH_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_BLOCK_LAYOUT = (("block1", 2), ("block2", 2), ("block3", 3),
                     ("block4", 3), ("block5", 3))


def convert_torch_vgg16(state_dict: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """torchvision vgg16 state_dict → flat {backbone-relative flax path:
    array}, kernels (O, I, H, W) → (H, W, I, O)."""
    flat: dict[str, np.ndarray] = {}
    idx = iter(_TORCH_VGG16_CONV_IDX)
    for block, n_convs in _VGG_BLOCK_LAYOUT:
        for ci in range(n_convs):
            i = next(idx)
            flat[f"{block}/conv{ci + 1}/kernel"] = np.transpose(
                _array(state_dict[f"features.{i}.weight"]), (2, 3, 1, 0))
            flat[f"{block}/conv{ci + 1}/bias"] = _array(state_dict[f"features.{i}.bias"])
    return flat


# MobileNetBackbone's blocks in HF layer order: layer.{2k} is block k's
# depthwise conv, layer.{2k+1} its pointwise conv
_MOBILENET_BLOCKS = tuple(f"ds{k + 1}" for k in range(13))


def convert_torch_mobilenet_v1(
    state_dict: Mapping[str, Any],
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """HF MobileNetV1 state_dict (bare, or a classifier's with keys under
    `mobilenet_v1.`) → (flat params, flat batch_stats), backbone-relative
    flax paths: `stem/Conv_0/kernel`, `ds3/dw/BatchNorm_0/scale`, …"""
    sd = {(k[len("mobilenet_v1."):] if k.startswith("mobilenet_v1.") else k): v
          for k, v in state_dict.items()}
    params: dict[str, np.ndarray] = {}
    stats: dict[str, np.ndarray] = {}

    def take(src: str, dst: str) -> None:
        params[f"{dst}/Conv_0/kernel"] = np.transpose(
            _array(sd[f"{src}.convolution.weight"]), (2, 3, 1, 0))
        params[f"{dst}/BatchNorm_0/scale"] = _array(sd[f"{src}.normalization.weight"])
        params[f"{dst}/BatchNorm_0/bias"] = _array(sd[f"{src}.normalization.bias"])
        stats[f"{dst}/BatchNorm_0/mean"] = _array(sd[f"{src}.normalization.running_mean"])
        stats[f"{dst}/BatchNorm_0/var"] = _array(sd[f"{src}.normalization.running_var"])

    take("conv_stem", "stem")
    for k, block in enumerate(_MOBILENET_BLOCKS):
        take(f"layer.{2 * k}", f"{block}/dw")
        take(f"layer.{2 * k + 1}", f"{block}/pw")
    return params, stats


def _torch_state_dict(path: str | Path) -> Mapping[str, Any]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def import_torch_vgg16(model: torch.nn.Module, path: str | Path) -> int:
    """Seed VGG16Backbone's convs (a detector's, or a bare backbone) from
    a torchvision vgg16 `.pth` → the number of tensors written."""
    return merge_flax(model, convert_torch_vgg16(_torch_state_dict(path)),
                      prefix=_prefix(model))


def import_torch_mobilenet_v1(model: torch.nn.Module, path: str | Path) -> int:
    """Seed MobileNetBackbone (a detector's, or a bare backbone) from an HF
    MobileNetV1 `.bin`/`.pth`, BatchNorm statistics included → the number
    of tensors written."""
    params, stats = convert_torch_mobilenet_v1(_torch_state_dict(path))
    return merge_flax(model, params, stats, prefix=_prefix(model))
