"""The reference's single-file weights artifact (.npz), read and written
with numpy alone, the mapping of flax trees onto the port's modules, and
the one restore function of the eval entry points.

Format (bdd100k_tpu/utils/weights.py): flat `params/<path>` and
`batch_stats/<path>` keys, fp16 params, f32 batch stats, a JSON
`__meta__` record (optional; `config`, `step`, `source` "params" or
"ema"). The mapping fills every parameter and buffer of the port, so
`model.load_state_dict(sd)` (strict) consumes every key and checks every
shape. An artifact the port writes loads in the reference's
`load_into_state`, and the reference's loads here.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_META_KEY = "__meta__"
FORMAT_VERSION = 1


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


def quant_state_from_flax(quant: Any) -> dict[str, torch.Tensor]:
    """The reference's `quant` collection (nested or flat '/'-joined: each
    static-int8 layer's `act_amax`, and `out_amax` where it emits codes) →
    the port's quant state, {"<module path>.act_amax": f32 scalar}
    (`models/quant.load_quant_state` sets it on a model). The params are
    the same in every quant mode, so nothing else changes."""
    out = {}
    for path, arr in _flatten(quant).items():
        *mods, leaf = path.split("/")
        if leaf not in ("act_amax", "out_amax"):
            raise ValueError(f"unmapped quant leaf {leaf!r} at {path!r}")
        out[".".join(mods + [leaf])] = torch.tensor(float(arr),
                                                    dtype=torch.float32)
    return out


def flax_from_quant_state(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: the port's quant state → the reference's nested
    `quant` collection of f32 numpy scalars."""
    tree: dict = {}
    for key, t in state.items():
        *mods, leaf = key.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.asarray(t.detach().cpu(), np.float32)
    return tree


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


def save_detector_npz(
    path: str | Path,
    state_dict: Mapping[str, torch.Tensor],
    *,
    config_name: str,
    step: int = 0,
    source: str = "params",
    param_dtype=np.float16,
) -> dict:
    """Write the port's state_dict as a single-file artifact → its meta.

    As the reference's `save_detector_npz`: floating-point params at
    `param_dtype` (fp16 by default), batch statistics in f32, and
    `__meta__` with the config name, the step and `source`, the
    provenance ("params", or "ema" for an EMA shadow's weights)."""
    params, stats = flax_from_state_dict(state_dict)
    flat: dict[str, np.ndarray] = {}
    for k, v in params.items():
        flat[f"params/{k}"] = (v.astype(param_dtype)
                               if np.issubdtype(v.dtype, np.floating) else v)
    for k, v in stats.items():
        flat[f"batch_stats/{k}"] = np.asarray(v, np.float32)
    meta = {
        "format_version": FORMAT_VERSION,
        "config": config_name,
        "step": int(step),
        "source": source,
        "param_dtype": np.dtype(param_dtype).name,
    }
    flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                    np.uint8).copy()
    np.savez_compressed(path, **flat)
    return meta


def restore_eval_weights(
    model: torch.nn.Module,
    path: str | Path,
    *,
    ema: bool = False,
    expect_config: str | None = None,
) -> int:
    """Load eval weights into `model` in place → the step they were saved
    at (reference: bdd100k_tpu/utils/weights.py::restore_eval_weights).

    A path ending in .npz is an artifact: strict keys and shapes; with
    `ema` it must have been exported from an EMA shadow. Anything else is
    a run directory of the port's trainer (`utils/checkpoint.py`): the
    latest `ckpt_<step>.pt` gives the params and BatchNorm statistics, and
    with `ema` its EMA shadow replaces the params. A directory with no
    checkpoint leaves the model as it is and gives step 0, as the
    reference's restore does."""
    if str(path).endswith(".npz"):
        sd, meta = load_detector_npz(path, expect_config=expect_config)
        if ema and meta.get("source") != "ema":
            raise SystemExit(
                f"--ema requested but {path} was exported from "
                f"source={meta.get('source', 'unknown')!r}; re-export with "
                "python -m bdd100k_tpu_torch.scripts.export_weights --ema")
        model.load_state_dict(sd)
        return int(meta.get("step", 0))
    from bdd100k_tpu_torch.utils.checkpoint import CheckpointManager

    if not Path(path).is_dir():
        return 0
    ckpt = CheckpointManager(path)
    step = ckpt.latest_step()
    if step is None:
        return 0
    device = next(model.parameters()).device
    payload = torch.load(ckpt.directory / f"ckpt_{step}.pt",
                         map_location=device, weights_only=True)
    model.load_state_dict(payload["model"])
    if ema:
        shadow = payload["ema"]
        if shadow is None:
            raise SystemExit(
                f"--ema requested but checkpoint step {step} has no "
                "ema_params shadow — it was trained without --ema_decay")
        with torch.no_grad():
            for p, e in zip(model.parameters(), shadow, strict=True):
                p.copy_(e)
    return int(payload["step"])
