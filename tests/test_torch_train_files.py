"""Training from JPEG files in the port, against the JAX reference, on the
CPU.

* the train loader: the first 3 shuffled batches of the port's
  `make_loader` byte-equal to the reference's for seed 0, at decode_size
  512 on the yuv420 and rgb wires (the decode pool) and without a
  decode_size (full-resolution decodes, 4 JPEGs), and a resume's
  `skip_steps` landing on the reference's batch;
* the train step's yuv420 branch: the planes rebuilt into uint8 RGB equal
  to the reference's conversion, and a step on the planes equal to a step
  on that RGB;
* `train.main` at `ssd_tiny_64` from `--labels/--image_dir`: the wire it
  prints, finite losses, a resume; the flags of later slices refused with
  their ROADMAP items; `--synthetic_dir`; `--profile_steps`;
  `--checkify` and `--debug_nans` on a NaN learning rate;
  `--image_summary_every` with and without TensorBoard.

Why the step is not compared draw for draw with the reference's: the
augment's random draws come from JAX's PRNG there and from a torch
generator here, so the two steps crop and flip the same batch
differently. The loader's bytes are held exact here instead, and
tests/test_torch_train.py holds the step itself on a fixed batch.
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "tests") not in sys.path:
    sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_ref_pool import ref_pool  # noqa: E402
from bdd100k_tpu_torch import train as port_train  # noqa: E402
from bdd100k_tpu_torch.configs import tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.data import pipeline as port_pipeline  # noqa: E402
from bdd100k_tpu_torch.data.native_decode import NativeDecoder  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.parallel import train_step  # noqa: E402
from bdd100k_tpu_torch.configs import TrainConfig  # noqa: E402

torch.set_num_threads(2)

SYNTH = ROOT / "tests" / "fixtures" / "synth_val_seed1"
LABELS = SYNTH / "labels" / "val.json"
IMAGES = SYNTH / "images" / "val"


def _files_argv(ckpt: Path, *extra: str, steps: int = 2) -> list[str]:
    return ["--config", "ssd_tiny_64", "--labels", str(LABELS), "--image_dir",
            str(IMAGES), "--decode_size", "64", "--batch_size", "4",
            "--max_boxes", "16", "--total_steps", str(steps),
            "--warmup_steps", "0", "--log_every", "1", "--num_workers", "2",
            "--ckpt_dir", str(ckpt), "--device", "cpu", *extra]


def _log(run_dir: Path) -> dict[int, dict]:
    return {r["step"]: r for r in map(
        json.loads, (run_dir / "train.jsonl").read_text().splitlines())}


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("size,wire", [(512, "yuv420"), (512, "rgb"), (None, "rgb")],
                         ids=["512-yuv420", "512-rgb", "full-rgb"])
def test_train_loader_matches_reference_loader(size, wire):
    from bdd100k_tpu.data.pipeline import DetectionDataset as RefDataset
    from bdd100k_tpu.data.pipeline import make_loader as ref_loader

    n, batch = (16, 4) if size else (4, 2)
    ds = port_pipeline.DetectionDataset.from_bdd100k(LABELS, IMAGES, decode_size=size)
    ref_ds = RefDataset.from_bdd100k(LABELS, IMAGES, decode_size=size)
    ds.records, ref_ds.records = ds.records[:n], ref_ds.records[:n]
    assert port_pipeline.resolve_wire("auto", ds) == wire or wire == "rgb"
    kw = dict(shuffle=True, seed=0, num_workers=2, wire_format=wire)
    native = dict(native_decode=size is not None)
    if size is not None:
        ref_pool()  # the reference's loader takes its pool, however it was built
    got = port_pipeline.make_loader(ds, batch, **kw)
    want = ref_loader(ref_ds, batch, **native, **kw)
    ref_batches = [next(want) for _ in range(3)]
    for w in ref_batches:
        g = next(got)
        for a, b in zip(jax.tree_util.tree_leaves(tuple(g)),
                        jax.tree_util.tree_leaves(tuple(w))):
            np.testing.assert_array_equal(a, b)
    got.close()
    # a run resumed at step 2 starts on the third batch
    resumed = next(port_pipeline.make_loader(ds, batch, skip_steps=2, **kw))
    for a, b in zip(jax.tree_util.tree_leaves(tuple(resumed)),
                    jax.tree_util.tree_leaves(tuple(ref_batches[2]))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ step


def _planes(n: int = 4, size: int = 64):
    jpegs = [p.read_bytes() for p in sorted(IMAGES.glob("*.jpg"))[:n]]
    dec = NativeDecoder(2)
    try:
        return dec.decode_batch_yuv420(jpegs, size)
    finally:
        dec.close()


def test_yuv420_rebuild_matches_reference():
    from bdd100k_tpu.data.augment import yuv420_to_rgb_batch as ref_fn

    y, uv = _planes()
    y[0, :4, :4] = 255  # both ends of the clip
    uv[0, :2, :2] = (255, 0)
    y[1, :4, :4] = 0
    uv[1, :2, :2] = (0, 255)
    got = train_step.yuv420_rgb_u8(torch.from_numpy(y), torch.from_numpy(uv))
    want = np.asarray((ref_fn(jnp.asarray(y), jnp.asarray(uv)) * 255.0 + 0.5)
                      .astype(jnp.uint8))
    assert got.dtype == torch.uint8 and got.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_train_step_takes_the_yuv420_wire():
    """A step on the (y, uv) planes equals a step on the uint8 RGB they
    rebuild to, from the same state and draws."""
    y, uv = _planes()
    rgb = train_step.yuv420_rgb_u8(torch.from_numpy(y), torch.from_numpy(uv))
    gt = (torch.tensor([[[0.1, 0.1, 0.6, 0.7]]]).repeat(4, 2, 1),
          torch.ones(4, 2, dtype=torch.int32),
          torch.tensor([[True, False]]).repeat(4, 1))
    out = []
    for images in ((torch.from_numpy(y), torch.from_numpy(uv)), rgb):
        bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                                device="cpu")
        state = train_step.create_train_state(
            bundle, TrainConfig(warmup_steps=0, total_steps=10))
        step = train_step.make_train_step(bundle, device="cpu")
        gen = torch.Generator().manual_seed(5)
        out.append({k: float(v) for k, v in step(state, gen, images, *gt).items()})
    assert out[0] == out[1]
    assert all(np.isfinite(v) for v in out[0].values())


# ------------------------------------------------------------------ trainer


def test_train_main_from_files_on_the_yuv420_wire_and_resume(tmp_path, capsys):
    run = tmp_path / "run"
    port_train.main(_files_argv(run, "--no_resume"))
    out = capsys.readouterr().out
    assert "dataset: 64 images" in out and "wire format: yuv420" in out
    assert "done at step 2" in out
    log = _log(run)
    assert sorted(log) == [1, 2]
    assert all(np.isfinite(v) for r in log.values() for v in r.values())
    port_train.main(_files_argv(run, steps=3))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done at step 3" in out
    assert sorted(_log(run)) == [1, 2, 3]


def test_train_main_at_full_resolution_on_the_rgb_wire(tmp_path, capsys):
    run = tmp_path / "run"
    argv = _files_argv(run, "--no_resume", steps=1)
    argv[argv.index("--decode_size") + 1] = "0"
    port_train.main(argv)
    out = capsys.readouterr().out
    assert "wire format: rgb" in out and "done at step 1" in out


def _one_rank_env(monkeypatch) -> None:
    """The environment torchrun gives a world of one rank."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("flags,item", [
    (["--records_dir", "shards"], "item 12"),
    (["--grain_workers", "2"], "item 12"),
    (["--multihost"], None),
    (["--mesh_data", "1"], None),
    (["--step_impl", "shard_map"], None),
    (["--multihost", "--step_impl", "shard_map"], None),
    (["--synthetic", "4"], None),
])
def test_train_refuses_flags_of_later_slices(tmp_path, monkeypatch, flags, item):
    """Only item 12's flags (record shards) are refused; item 11's
    (--multihost, --mesh_data, --step_impl: data parallelism) and item 14's
    (--synthetic without --synthetic_dir: the split written to the
    temporary directory) run."""
    if item is not None:
        with pytest.raises(SystemExit, match=item):
            port_train.main(_files_argv(tmp_path, *flags))
        assert not (tmp_path / "train.jsonl").exists()
        return
    import tempfile

    _one_rank_env(monkeypatch)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    port_train.main(_files_argv(tmp_path / "run", *flags))
    assert sorted(_log(tmp_path / "run")) == [1, 2]
    if "--synthetic" in flags:
        assert len(list((tmp_path / "tmp" / "bdd_synth" / "images" / "train")
                        .glob("*.jpg"))) == 4


def test_train_needs_a_data_source(tmp_path):
    with pytest.raises(SystemExit, match="need --labels"):
        port_train.main(["--config", "ssd_tiny_64", "--device", "cpu",
                         "--ckpt_dir", str(tmp_path)])


def _train_split(tmp_path: Path, n: int) -> Path:
    """A synthetic_dir with a `train` split: the committed val scenes'
    first n records and their JPEGs, linked."""
    d = tmp_path / "synth"
    (d / "labels").mkdir(parents=True)
    (d / "images" / "train").mkdir(parents=True)
    records = json.loads(LABELS.read_text())[:n]
    (d / "labels" / "train.json").write_text(json.dumps(records))
    for r in records:
        (d / "images" / "train" / r["name"]).symlink_to(IMAGES / r["name"])
    return d


def test_train_synthetic_dir_reads_the_split(tmp_path, capsys):
    """A complete split is read as it is; a short one is generated in
    place (the reference's ensure_synthetic_dataset), and a JPEG the
    labels name but the directory lacks fails the loader."""
    d = _train_split(tmp_path, 12)
    argv = ["--config", "ssd_tiny_64", "--synthetic", "8", "--synthetic_dir",
            str(d), "--decode_size", "64", "--batch_size", "4",
            "--max_boxes", "16", "--total_steps", "1", "--warmup_steps", "0",
            "--log_every", "1", "--num_workers", "2", "--device", "cpu",
            "--ckpt_dir", str(tmp_path / "run")]
    port_train.main(argv)
    out = capsys.readouterr().out
    assert "dataset: 8 images" in out and "wire format: yuv420" in out
    assert not list((d / "images" / "train").glob("synthetic_train_*"))
    # more scenes than the split holds: the seed-0 split is written
    port_train.main(argv[:2] + ["--synthetic", "13"] + argv[4:] + ["--no_resume"])
    assert "dataset: 13 images" in capsys.readouterr().out
    names = [r["name"] for r in json.loads((d / "labels" / "train.json").read_text())]
    assert names == [f"synthetic_train_{i:05d}.jpg" for i in range(13)]
    (d / "images" / "train" / names[0]).unlink()
    with pytest.raises(RuntimeError, match="input pipeline"):
        port_train.main(argv + ["--no_resume"])


def test_train_profile_steps_writes_a_trace(tmp_path, capsys):
    run = tmp_path / "run"
    port_train.main(_files_argv(run, "--no_resume", "--profile_steps", "0,2"))
    out = capsys.readouterr().out
    trace = run / "profile" / "trace_0_2.json"
    assert f"trace {trace}" in out and "2 steps, wall" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_train_checkify_names_the_step_of_a_non_finite_update(tmp_path):
    with pytest.raises(FloatingPointError,
                       match=r"step 1: non-finite updated parameter backbone\."):
        port_train.main(_files_argv(tmp_path / "a", "--lr", "nan", "--checkify"))
    # without the check the run goes on, its losses NaN from step 2
    port_train.main(_files_argv(tmp_path / "b", "--lr", "nan"))
    log = _log(tmp_path / "b")
    assert np.isfinite(log[1]["loss"]) and np.isnan(log[2]["loss"])


def test_train_debug_nans_raises_in_the_backward(tmp_path):
    with pytest.raises(RuntimeError, match="nan"):
        port_train.main(_files_argv(tmp_path, "--lr", "nan", "--debug_nans"))
    assert not torch.is_anomaly_enabled()  # restored on the way out


def test_image_summary_every_without_tensorboard(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    run = tmp_path / "rgb"
    port_train.main(_files_argv(run, "--wire", "rgb", "--image_summary_every", "1"))
    assert "done at step 2" in capsys.readouterr().out
    assert not (run / "tb").exists()
    port_train.main(_files_argv(tmp_path / "yuv", "--image_summary_every", "1"))
    assert "image summaries disabled with --wire yuv420" in capsys.readouterr().out


def test_image_summary_every_draws_into_tensorboard(tmp_path, monkeypatch):
    """With a SummaryWriter to hand, every N steps two drawn 64² frames."""
    calls = []

    class Writer:
        def __init__(self, log_dir):
            self.log_dir = log_dir

        def add_image(self, name, image, step, dataformats):
            calls.append((name, image.shape, image.dtype, step, dataformats))

        def close(self):
            calls.append("closed")

    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    port_train.main(_files_argv(tmp_path, "--wire", "rgb",
                                "--image_summary_every", "2", steps=4))
    shape = (64, 64, 3)
    assert calls == [(f"detections/{i}", shape, np.uint8, s, "HWC")
                     for s in (2, 4) for i in (0, 1)] + ["closed"]
