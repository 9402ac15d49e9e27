"""The reference's single-file weights artifact (.npz), read with numpy
alone, and the mapping of flax trees onto the port's modules.

Format (bdd100k_tpu/utils/weights.py): flat `params/<path>` and
`batch_stats/<path>` keys, fp16 params, f32 batch stats, a JSON
`__meta__` record (optional). The mapping fills every parameter and buffer of
the port, so `model.load_state_dict(sd)` (strict) consumes every key and
checks every shape.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_META_KEY = "__meta__"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        out: dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _torch_key(path: str, leaf_names: Mapping[str, str]) -> str:
    *mods, leaf = path.split("/")
    if leaf not in leaf_names:
        raise ValueError(f"unmapped leaf {leaf!r} at {path!r}")
    return ".".join(mods + [leaf_names[leaf]])


def state_dict_from_flax(
    params: Any, batch_stats: Any
) -> dict[str, torch.Tensor]:
    """Flax `params` and `batch_stats` trees (nested or flat '/'-joined
    dicts of numpy arrays) → the port's state_dict, f32.

    Conv kernels HWIO → OIHW (a depthwise (3, 3, 1, C) → (C, 1, 3, 3));
    BN scale/bias/mean/var → weight/bias/running_mean/running_var, with
    `num_batches_tracked` 0 (flax keeps no such count).
    """
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        key = _torch_key(path, {"kernel": "weight", "scale": "weight", "bias": "bias"})
        a = np.asarray(arr, np.float32)
        if path.endswith("/kernel"):
            a = a.transpose(3, 2, 0, 1)
        sd[key] = torch.from_numpy(np.array(a, order="C"))
    for path, arr in _flatten(batch_stats or {}).items():
        key = _torch_key(path, {"mean": "running_mean", "var": "running_var"})
        sd[key] = torch.from_numpy(np.asarray(arr, np.float32).copy())
        if key.endswith("running_mean"):
            sd[key[: -len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0, dtype=torch.long)
            )
    return sd


def flax_from_state_dict(
    sd: Mapping[str, torch.Tensor],
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """The inverse of `state_dict_from_flax`: the port's state_dict → flat
    '/'-joined flax (`params`, `batch_stats`) dicts of f32 numpy arrays.

    4-D weights are conv kernels (OIHW → HWIO, a depthwise (C, 1, 3, 3) →
    (3, 3, 1, C)); a 1-D `weight` is a BatchNorm scale; `num_batches_tracked`
    has no flax counterpart and is dropped."""
    params: dict[str, np.ndarray] = {}
    stats: dict[str, np.ndarray] = {}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        a = t.detach().to(torch.float32).cpu().numpy()
        path = "/".join(mods)
        if leaf == "weight" and a.ndim == 4:
            params[f"{path}/kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif leaf == "weight":
            params[f"{path}/scale"] = a
        elif leaf == "bias":
            params[f"{path}/bias"] = a
        elif leaf == "running_mean":
            stats[f"{path}/mean"] = a
        elif leaf == "running_var":
            stats[f"{path}/var"] = a
        elif leaf != "num_batches_tracked":
            raise ValueError(f"unmapped state_dict key {key!r}")
    return params, stats


def read_detector_npz(path: str | Path) -> tuple[dict, dict, dict]:
    """→ (flat params, flat batch_stats, meta), keys relative to their
    collection, dtypes as stored."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = {}
    if _META_KEY in flat:
        meta = json.loads(bytes(flat.pop(_META_KEY).tobytes()).decode())
    params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    stats = {
        k[len("batch_stats/"):]: v
        for k, v in flat.items()
        if k.startswith("batch_stats/")
    }
    unknown = [k for k in flat if not k.startswith(("params/", "batch_stats/"))]
    if unknown:
        raise ValueError(f"unrecognized keys in {path}: {unknown[:5]}")
    return params, stats, meta


def load_detector_npz(
    path: str | Path, expect_config: str | None = None
) -> tuple[dict[str, torch.Tensor], dict]:
    """Read an artifact → (the port's state_dict, meta).

    As the reference's `load_into_state` (bdd100k_tpu/utils/weights.py:
    169-174): an artifact with no `__meta__` or no recorded config loads;
    one recorded for another config than `expect_config` loads with a
    warning. Keys and shapes stay strict through `load_state_dict`."""
    params, stats, meta = read_detector_npz(path)
    if expect_config and meta.get("config") not in (None, expect_config):
        warnings.warn(
            f"weights artifact was exported for config {meta.get('config')!r} "
            f"but loading into {expect_config!r} (shapes checked, postprocess "
            "constants are the config's)",
            stacklevel=2,
        )
    return state_dict_from_flax(params, stats), meta
