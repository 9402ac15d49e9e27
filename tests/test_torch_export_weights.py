"""The port's weights exporter, `python -m
bdd100k_tpu_torch.scripts.export_weights`, against the JAX reference, on
the CPU.

A 2-step run of the port's trainer at `ssd_tiny_64` with an EMA shadow is
exported with and without `--ema`, in fp16 and f32. Each artifact must
hold the keys, dtypes, values and meta that the reference's
`save_detector_npz` writes for the same tensors (the checkpoint's params,
or its EMA shadow, and its BatchNorm statistics); it must load in the
reference's `load_into_state` and give the port's logits (f32 within
1e-5; fp16 within 1e-4, the port's model holding the same fp16-rounded
weights); and the port's `restore_eval_weights(ema=True)` must take the
EMA export and refuse the params export.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bdd100k_tpu_torch import train as port_train  # noqa: E402
from bdd100k_tpu_torch.configs import tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.scripts import export_weights  # noqa: E402
from bdd100k_tpu_torch.utils import weights as port_weights  # noqa: E402

from test_torch_evaluate import _flax_tree  # noqa: E402

torch.set_num_threads(2)

LABELS = ROOT / "tests" / "fixtures" / "synth_val_seed1" / "labels" / "val.json"
IMAGES = LABELS.parent.parent / "images" / "val"
LOGIT_ATOL = {"float32": 1e-5, "float16": 1e-4}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("run")
    port_train.main(["--config", "ssd_tiny_64", "--labels", str(LABELS),
                     "--image_dir", str(IMAGES), "--decode_size", "64",
                     "--batch_size", "4", "--max_boxes", "16",
                     "--total_steps", "2", "--warmup_steps", "0",
                     "--log_every", "1", "--num_workers", "2",
                     "--ema_decay", "0.9", "--ckpt_dir", str(d), "--device", "cpu"])
    return d


def _export(run_dir: Path, out: Path, ema: bool, dtype: str) -> dict:
    return export_weights.main(["--ckpt_dir", str(run_dir), "--config", "ssd_tiny_64",
                                "--out", str(out), "--dtype", dtype, "--device", "cpu",
                                *(["--ema"] if ema else [])])


def _checkpoint_weights(run_dir: Path, ema: bool) -> dict[str, torch.Tensor]:
    """The run's latest state_dict, its params replaced by the EMA shadow
    with `ema`."""
    payload = torch.load(run_dir / "ckpt_2.pt", weights_only=True)
    sd = dict(payload["model"])
    if ema:
        model = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                               device="cpu").model
        names = [k for k, _ in model.named_parameters()]
        sd.update(zip(names, payload["ema"], strict=True))
    return sd


def _read(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "params"])
@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_export_matches_the_reference_and_loads_there(run_dir, tmp_path, ema, dtype):
    from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
    from bdd100k_tpu.configs.train_configs import TrainConfig as JaxTrainConfig
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.parallel.train_step import create_train_state
    from bdd100k_tpu.utils.weights import load_into_state
    from bdd100k_tpu.utils.weights import save_detector_npz as ref_save

    out = tmp_path / "port.npz"
    meta = _export(run_dir, out, ema, dtype)
    source = "ema" if ema else "params"
    assert meta == {"format_version": 1, "config": "ssd_tiny_64", "step": 2,
                    "source": source, "param_dtype": dtype}
    # the reference's writer on the same tensors
    params, stats = port_weights.flax_from_state_dict(_checkpoint_weights(run_dir, ema))
    ref_path = tmp_path / "ref.npz"
    ref_meta = ref_save(ref_path, _flax_tree(params), _flax_tree(stats),
                        config_name="ssd_tiny_64", step=2, source=source,
                        param_dtype=np.dtype(dtype))
    assert ref_meta == meta
    got, want = _read(out), _read(ref_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k == "__meta__":
            assert json.loads(got[k].tobytes()) == json.loads(want[k].tobytes())
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the reference loads it and gives the port's logits
    jb = jax_build(jax_tiny("ssd"), dtype=jnp.float32)
    state = create_train_state(jb, JaxTrainConfig(), jax.random.PRNGKey(0))
    state, step = load_into_state(state, out, ema=ema, expect_config="ssd_tiny_64")
    assert step == 2
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    loc, cls = jb.model.apply({"params": state.params, "batch_stats": state.batch_stats},
                              jnp.asarray(x), train=False)
    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32, device="cpu")
    assert port_weights.restore_eval_weights(bundle.model, out, ema=ema) == 2
    with torch.inference_mode():
        ploc, pcls = bundle.model(torch.from_numpy(x))
    np.testing.assert_allclose(ploc.numpy(), np.asarray(loc), rtol=0, atol=LOGIT_ATOL[dtype])
    np.testing.assert_allclose(pcls.numpy(), np.asarray(cls), rtol=0, atol=LOGIT_ATOL[dtype])


def test_restore_eval_weights_takes_the_ema_export_only(run_dir, tmp_path):
    ema_out, params_out = tmp_path / "ema.npz", tmp_path / "params.npz"
    _export(run_dir, ema_out, True, "float32")
    _export(run_dir, params_out, False, "float32")
    model = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                           device="cpu").model
    assert port_weights.restore_eval_weights(model, ema_out, ema=True) == 2
    # the EMA export is the checkpoint's shadow, as the run directory gives it
    from_dir = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                              device="cpu").model
    port_weights.restore_eval_weights(from_dir, run_dir, ema=True)
    for a, b in zip(model.state_dict().values(), from_dir.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(SystemExit, match="bdd100k_tpu_torch.scripts.export_weights --ema"):
        port_weights.restore_eval_weights(model, params_out, ema=True)


def test_export_refuses_a_run_without_a_checkpoint_or_an_ema(run_dir, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no checkpoint found"):
        _export(empty, tmp_path / "a.npz", False, "float16")
    plain = tmp_path / "plain"
    port_train.main(["--config", "ssd_tiny_64", "--synthetic", "4", "--batch_size", "4",
                     "--total_steps", "1", "--warmup_steps", "0", "--device", "cpu",
                     "--ckpt_dir", str(plain)])
    with pytest.raises(SystemExit, match="trained without --ema_decay"):
        _export(plain, tmp_path / "b.npz", True, "float16")


def test_exporter_needs_cuda_unless_asked_for_the_cpu(run_dir, tmp_path, monkeypatch):
    """The exporter is an entry point: it builds the detector on the card
    by default and raises without one; `--device cpu` is the tests' way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_weights.main(["--ckpt_dir", str(run_dir), "--config", "ssd_tiny_64",
                             "--out", str(tmp_path / "a.npz")])
    assert not (tmp_path / "a.npz").exists()


def test_evaluate_cli_reads_the_ema_export_in_f32(run_dir, tmp_path, capsys):
    """The exported artifact through `python -m bdd100k_tpu_torch.evaluate
    --ema --dtype float32`, as chip_smoke's export_weights phase runs it on
    the card: the f32 model restores the export's step and evaluates."""
    from bdd100k_tpu_torch import evaluate

    out = tmp_path / "ema.npz"
    _export(run_dir, out, True, "float32")
    capsys.readouterr()
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    result = evaluate.main(["--config", "ssd_tiny_64", "--ckpt_dir", str(out), "--ema",
                            "--synthetic", "8", "--batch_size", "4",
                            "--dtype", "float32", "--device", "cpu"])
    assert "restored step 2 (EMA weights)" in capsys.readouterr().out
    assert result["num_images"] == 8 and np.isfinite(result["mAP"])
    # f32 turns TF32 off for the eval only, and leaves the process as it was
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags
