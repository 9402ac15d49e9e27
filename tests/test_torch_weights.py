"""The reference's .npz artifacts load strictly into the port: every key
consumed, every parameter and buffer filled. The recorded config is read
as the reference's `load_into_state` reads it: missing is fine, another
name warns and loads."""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from bdd100k_tpu_torch.configs import SSD_MOBILENET_300
from bdd100k_tpu_torch.models.detector import build_detector
from bdd100k_tpu_torch.utils.weights import (
    flax_from_state_dict,
    load_detector_npz,
    read_detector_npz,
    state_dict_from_flax,
)

ROOT = Path(__file__).resolve().parent.parent
ARTIFACTS = sorted((ROOT / "artifacts").glob("ssd_mobilenet_300_*.npz"))


def test_both_artifacts_are_present():
    assert [p.name for p in ARTIFACTS] == [
        "ssd_mobilenet_300_synth4kds.npz", "ssd_mobilenet_300_synth9k.npz"
    ]


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.name)
def test_artifact_covers_the_model_exactly(path):
    params, stats, meta = read_detector_npz(path)
    sd, meta2 = load_detector_npz(path, expect_config="ssd_mobilenet_300")
    assert meta == meta2 and meta["config"] == "ssd_mobilenet_300"
    model = build_detector(SSD_MOBILENET_300, device="cpu").model
    own = model.state_dict()
    assert set(sd) == set(own)
    n_bn = sum(k.endswith("running_mean") for k in own)
    # every npz key maps to one port key; BN adds num_batches_tracked
    assert len(params) + len(stats) + n_bn == len(own)
    model.load_state_dict(sd)
    # values arrive: a depthwise kernel (3, 3, 1, C) → (C, 1, 3, 3)
    dwk = params["backbone/ds1/dw/Conv_0/kernel"].astype(np.float32)
    np.testing.assert_array_equal(
        model.backbone.ds1.dw.Conv_0.weight.detach().numpy(),
        dwk.transpose(3, 2, 0, 1),
    )
    pwk = params["head0/conf/kernel"].astype(np.float32)  # HWIO → OIHW
    np.testing.assert_array_equal(
        model.head0.conf.weight.detach().numpy(), pwk.transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(
        model.extra1.down.BatchNorm_0.running_var.numpy(),
        stats["extra1/down/BatchNorm_0/var"],
    )


_DROP_CONFIG = object()


def _rewrite(src: Path, dst: Path, drop=None, add=None, config=None):
    """`src` re-saved with key `drop` left out, a key `add` added, or the
    recorded config set to `config` (`_DROP_CONFIG`: removed)."""
    with np.load(src) as z:
        flat = {k: z[k] for k in z.files}
    if drop:
        del flat[drop]
    if add:
        flat[add] = np.zeros((1, 1, 8, 8), np.float16)
    if config:
        meta = json.loads(bytes(flat["__meta__"].tobytes()))
        if config is _DROP_CONFIG:
            del meta["config"]
        else:
            meta["config"] = config
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(dst, **flat)
    return dst


@pytest.mark.parametrize("mangle,error,match", [
    (dict(drop="params/backbone/ds3/pw/Conv_0/kernel"), RuntimeError, "Missing key"),
    (dict(drop="batch_stats/extra2/down/BatchNorm_0/mean"), RuntimeError, "Missing key"),
    (dict(add="params/extra9/squeeze/Conv_0/kernel"), RuntimeError, "Unexpected key"),
], ids=["param", "batch_stat", "extra_key"])
def test_strict_restore_refuses_a_mismatch(tmp_path, mangle, error, match):
    path = _rewrite(ARTIFACTS[-1], tmp_path / "mangled.npz", **mangle)
    with pytest.raises(error, match=match):
        sd, _ = load_detector_npz(path, expect_config="ssd_mobilenet_300")
        build_detector(SSD_MOBILENET_300, device="cpu").model.load_state_dict(sd)


def _same_state(sd, want):
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("mangle", [dict(drop="__meta__"),
                                    dict(config=_DROP_CONFIG)],
                         ids=["no_meta", "no_config"])
def test_artifact_without_a_recorded_config_loads(tmp_path, mangle):
    """The reference's reader takes a missing `__meta__` and its loader a
    missing config (bdd100k_tpu/utils/weights.py:89-90, 169-174)."""
    want, _ = load_detector_npz(ARTIFACTS[-1], expect_config="ssd_mobilenet_300")
    path = _rewrite(ARTIFACTS[-1], tmp_path / "bare.npz", **mangle)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sd, meta = load_detector_npz(path, expect_config="ssd_mobilenet_300")
    assert "config" not in meta
    _same_state(sd, want)
    build_detector(SSD_MOBILENET_300, device="cpu").model.load_state_dict(sd)


def test_config_name_mismatch_warns_and_loads(tmp_path):
    """Another recorded config name: the reference warns and loads, shapes
    still checked (bdd100k_tpu/utils/weights.py:169-174)."""
    want, _ = load_detector_npz(ARTIFACTS[-1])
    path = _rewrite(ARTIFACTS[-1], tmp_path / "other.npz", config="ssd_vgg16_512")
    with pytest.warns(UserWarning, match="exported for config 'ssd_vgg16_512'"):
        sd, meta = load_detector_npz(path, expect_config="ssd_mobilenet_300")
    assert meta["config"] == "ssd_vgg16_512"
    _same_state(sd, want)
    build_detector(SSD_MOBILENET_300, device="cpu").model.load_state_dict(sd)


def test_shape_mismatch_is_refused():
    sd, _ = load_detector_npz(ARTIFACTS[-1])
    sd["head0.loc.bias"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        build_detector(SSD_MOBILENET_300, device="cpu").model.load_state_dict(sd)


def test_flax_round_trip_over_the_artifact():
    """flax → state_dict → flax gives back every params and batch_stats
    leaf of the committed artifact (as f32), with its flax layout."""
    params, stats, _ = read_detector_npz(ARTIFACTS[-1])
    back_params, back_stats = flax_from_state_dict(
        state_dict_from_flax(params, stats))
    assert set(back_params) == set(params) and set(back_stats) == set(stats)
    for k, v in params.items():
        np.testing.assert_array_equal(back_params[k], v.astype(np.float32), err_msg=k)
    for k, v in stats.items():
        np.testing.assert_array_equal(back_stats[k], v.astype(np.float32), err_msg=k)
    assert back_params["backbone/ds1/dw/Conv_0/kernel"].shape == (3, 3, 1, 32)
