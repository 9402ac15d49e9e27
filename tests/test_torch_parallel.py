"""The port's data parallelism against the JAX reference, on the CPU, over
2 gloo processes (as tests/test_multihost.py runs 2 JAX processes).

* (a) the 2-rank pjit step (`make_train_step(group=)`) and the
  reference's `make_train_step(mesh=)` on a 2-device CPU mesh take the same
  float batch (global B=8, which bypasses the augment in both packages)
  from the same weights of `tiny_test_config()` (the port's seed-0 init,
  carried into the reference); after 2 steps
  the metrics, weights and BatchNorm statistics agree within f32 tolerance
  (below), against the committed `tests/fixtures/torch_ref_parallel_tiny.npz`;
* (b) the same for the 2-rank shard_map step against the reference's
  `make_shardmap_train_step` (local BatchNorm, pmeaned statistics);
* (c) 2 ranks equal 1 process at the same global batch for the pjit step
  with the augment on: the ranks share the global batch's draws;
* (d) `make_loader`'s per-rank index sequence equals the reference's for
  the same seed, process count and `skip_steps`;
* (e) `evaluate --multihost` over 2 ranks on 8 committed JPEGs gives the
  single-process mAP exactly;
* (f) rank 0 alone writes the log and the checkpoints, and a 2-rank run
  resumed from step 2 repeats the uninterrupted run's steps 3–4;
  `ensure_synthetic_dataset` under the group generates once on a shared
  directory and once a rank on directories that are not shared;
* (g) the refusals (a batch the process count does not divide, several
  processes without `--multihost`, a `--mesh_data` other than the world
  size) give the reference's messages.

Each multi-process case spawns 2 processes running this file with
`--worker`, with MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK set as torchrun
sets them and a timeout of its own, so a hung rendezvous fails in seconds.

The arithmetic of the collectives is held tightly on its own: BatchNorm
under `global_batch_statistics` over 2 ranks gives one process's output,
input gradient (times the rank count: each rank's backward carries every
rank's loss through the all-reduce) and rank-averaged parameter gradients
within 1e-5 of each tensor's largest element.

Tolerances of the whole steps (a–c), all measured on this fixture. Both
sides are f32 and sum convolutions and reductions in other orders, and
BatchNorm's fast variance E[x²] − E[x]² (flax's, kept by the port)
cancels catastrophically where a channel's mean dwarfs its spread, as at
the tiny model's 2×2 maps: the ordering noise grows there, and more at
step 1, after it has moved the weights. The reference itself, run on one
device and on its 2-device mesh, differs by 8.4e-4 in step 1's grad norm
and by 4.8e-2 of a tensor's largest 2-step update. Held: the losses at
rtol 5e-5 (measured at most 9.5e-6), the grad norm at 5e-3 (2.0e-3), each
tensor's 2-step update at 2.5e-1 of its largest element plus 4 ulps of the
weights (pjit 7.1e-3, shard_map 1.2e-1, one process against two ranks
5.8e-2), BatchNorm statistics at 1e-4 absolute (2.4e-5). Local against
global statistics, the semantic difference between the two steps, moves
the step-0 loss by 4.2e-3, the grad norm by 13 % and the statistics by
2.4e-2 (the port's shard_map step against the reference's pjit step), far
outside these.

Regenerate the fixture with `python tests/test_torch_parallel.py
--make-fixture` (the reference's two steps on a 2-device CPU mesh, ~30 s).
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bdd100k_tpu_torch.configs import TrainConfig, tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.data.augment import AugmentConfig  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.parallel import mesh  # noqa: E402
from bdd100k_tpu_torch.parallel import train_step  # noqa: E402
from bdd100k_tpu_torch.utils.weights import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)

torch.set_num_threads(2)

FIXTURES = ROOT / "tests" / "fixtures"
FIXTURE = FIXTURES / "torch_ref_parallel_tiny.npz"
SYNTH = FIXTURES / "synth_val_seed1"
ARTIFACT = ROOT / "artifacts" / "ssd_mobilenet_300_synth9k.npz"
WORLD = 2
GLOBAL_B = 8
STEPS = 2
STRIDE = 8  # every 8th element of each post-step tensor in the fixture
CFG = TrainConfig(batch_size=GLOBAL_B, max_boxes=8, learning_rate=1e-3,
                  warmup_steps=0, total_steps=100)
LOSS_RTOL = 5e-5
GRAD_NORM_RTOL = 5e-3
UPDATE_REL = 2.5e-1
STATS_ATOL = 1e-4
BN_RTOL = 1e-5
WORKER_TIMEOUT = 120  # seconds a spawned pair may take


def _float_batch(seed: int, b: int = GLOBAL_B, m: int = 8, size: int = 64):
    """A fixed preprocessed batch: images in [-1, 1], 1–4 GT boxes each."""
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        n = rng.randint(1, 5)
        cxy = rng.uniform(0.2, 0.8, (n, 2))
        wh = rng.uniform(0.1, 0.5, (n, 2))
        boxes[i, :n] = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
        labels[i, :n] = rng.randint(1, 11, n)
        mask[i, :n] = True
    return images, boxes, labels, mask


def _frame_batch(seed: int, b: int = GLOBAL_B, m: int = 8):
    """uint8 96×128 frames with one or two boxes each, for the augment."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, 96, 128, 3), dtype=np.uint8)
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    mask = np.zeros((b, m), bool)
    boxes[:, 0] = (0.25, 0.25, 0.7, 0.7)
    boxes[:, 1] = (0.1, 0.5, 0.4, 0.9)
    labels[:, :2] = rng.randint(1, 11, (b, 2))
    mask[:, :2] = True
    return images, boxes, labels, mask


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _init_weights() -> dict:
    """The port's seed-0 tiny SSD in flax's layout, flat: {"params/…",
    "stats/…"}, the weights both packages start from."""
    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                            device="cpu", seed=0)
    params, stats = flax_from_state_dict(bundle.model.state_dict())
    return {**{f"params/{k}": v for k, v in params.items()},
            **{f"stats/{k}": v for k, v in stats.items()}}


# ------------------------------------------------------------ spawning


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv: list[str], world: int = WORLD, env: dict | None = None,
           timeout: float = WORKER_TIMEOUT) -> list[str]:
    """Run `argv` (a command line) as `world` ranks of one gloo group →
    each rank's stdout. A rank that fails, or a pair that outlives the
    timeout, fails the test with the ranks' output."""
    port = _free_port()
    procs = []
    for rank in range(world):
        e = {**os.environ, **(env or {}), "MASTER_ADDR": "localhost",
             "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
             "RANK": str(rank), "LOCAL_RANK": "0", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(argv, env=e, cwd=ROOT, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"ranks did not finish in {timeout}s: {argv}\n"
                    + "\n".join(p.communicate()[0] for p in procs))
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks {bad} failed:\n" + "\n----\n".join(outs)
    return outs


def _worker(name: str, *args: str) -> list[str]:
    return [sys.executable, str(Path(__file__).resolve()), "--worker", name, *args]


# ------------------------------------------------------- the worker side


def _build(init_path: Path):
    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                            device="cpu")
    init = np.load(init_path)
    params = {k[len("params/"):]: init[k] for k in init.files if k.startswith("params/")}
    stats = {k[len("stats/"):]: init[k] for k in init.files if k.startswith("stats/")}
    bundle.model.load_state_dict(state_dict_from_flax(params, stats))
    return bundle


def _run_steps(bundle, make, batches, group, seeds=None) -> dict:
    """`len(batches)` steps of the step `make` builds → metrics per step
    and the final params and BatchNorm statistics, flat."""
    state = train_step.create_train_state(bundle, CFG)
    aug = AugmentConfig(out_size=64, num_trials=4)
    step = make(bundle, aug, device="cpu", group=group)
    out = {}
    gen = torch.Generator()
    for i, batch in enumerate(batches):
        if seeds is not None:
            gen.manual_seed(seeds[i])
        metrics = step(state, gen, *[torch.from_numpy(a) for a in batch])
        for k, v in metrics.items():
            out[f"metrics/{i}/{k}"] = np.float32(v)
    params, stats = flax_from_state_dict(bundle.model.state_dict())
    out.update({f"params/{k}": v for k, v in params.items()})
    out.update({f"stats/{k}": v for k, v in stats.items()})
    return out


def _rows(batch, rank: int, world: int):
    b = batch[0].shape[0] // world
    return tuple(a[rank * b:(rank + 1) * b] for a in batch)


def _batchnorm_case(rank: int, world: int, group) -> dict:
    """BatchNorm in train mode on rows [rank·4, rank·4 + 4) of an (8, 6, 5,
    5) input under global statistics (one process: rank 0 of 1, no group),
    a smooth loss, its backward → output, input gradient, parameter
    gradients (averaged over the ranks) and running statistics."""
    from bdd100k_tpu_torch.models.layers import BatchNorm, global_batch_statistics

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 6, 5, 5, generator=g) * 3 + 1
    w = torch.randn(6, 5, 5, generator=g)
    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
    b = 8 // world
    xr = x[rank * b:(rank + 1) * b].clone().requires_grad_(True)
    with global_batch_statistics(group):
        y = bn(xr)
    (y ** 3 * w).mean().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    if group is not None:
        train_step.mean_over_ranks_(grads, group)
    return {"bn/y": y.detach().numpy(), "bn/dx": xr.grad.numpy(),
            "bn/dscale": grads[0].numpy(), "bn/dbias": grads[1].numpy(),
            "bn/mean": bn.running_mean.numpy(), "bn/var": bn.running_var.numpy()}


def worker_steps(init_path: str, out_dir: str) -> None:
    """(a)–(c): each rank runs the pjit step, the shard_map step and the
    pjit step with the augment on, each for 2 steps on its rows, from the
    same weights, and the BatchNorm case, and saves what it ends with."""
    from bdd100k_tpu_torch.parallel.shard_map_step import make_shardmap_train_step

    torch.set_num_threads(1)
    mesh.init_distributed("cpu")
    rank, group = mesh.data_rank(), mesh.train_group()
    out = _batchnorm_case(rank, WORLD, group)
    floats = [_rows(_float_batch(s), rank, WORLD) for s in range(STEPS)]
    frames = [_rows(_frame_batch(s), rank, WORLD) for s in range(STEPS)]
    for name, make, batches, seeds in (
            ("pjit", train_step.make_train_step, floats, None),
            ("shard_map", make_shardmap_train_step, floats, None),
            ("augment", train_step.make_train_step, frames, [42, 43])):
        res = _run_steps(_build(Path(init_path)), make, batches, group, seeds)
        out.update({f"{name}/{k}": v for k, v in res.items()})
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    mesh.shutdown()


def worker_ensure(base: str) -> None:
    """`ensure_synthetic_dataset` under the group on one shared directory,
    then on a directory of each rank's own (as two machines' /tmp) → the
    generations each made, as JSON."""
    from bdd100k_tpu_torch.data import synthetic

    mesh.init_distributed("cpu")
    rank = mesh.data_rank()
    calls = []
    real = synthetic.generate_synthetic_dataset

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    synthetic.generate_synthetic_dataset = counted
    made = {}
    for case, d in (("shared", Path(base) / "shared"),
                    ("per_rank", Path(base) / "per_rank" / f"rank{rank}")):
        calls.clear()
        synthetic.ensure_synthetic_dataset(d, num_images=2, seed=0)
        made[case] = len(calls)
    print(json.dumps({"rank": rank, **made}))
    mesh.shutdown()


def worker_main(module: str, *argv: str) -> None:
    """A package entry point's `main(argv)` on this rank, its result (if a
    dict) printed as the last line."""
    import importlib

    torch.set_num_threads(1)
    result = importlib.import_module(module).main(list(argv))
    if isinstance(result, dict):
        print(json.dumps(result))


# ------------------------------------------------------------ (a)–(c)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Both ranks' results of `worker_steps`, and the initial weights."""
    d = tmp_path_factory.mktemp("steps")
    init = _init_weights()
    np.savez(d / "init.npz", **init)
    _spawn(_worker("steps", str(d / "init.npz"), str(d)))
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, d / "init.npz", init


def _hold(got: dict, want: dict, init: dict, stride: int = 1) -> None:
    """`got` (whole tensors) against `want` (whole, or every `stride`-th
    element of each post-step tensor) at the module's tolerances."""
    for i in range(STEPS):
        for k in ("loss", "conf_loss", "loc_loss", "grad_norm"):
            np.testing.assert_allclose(
                got[f"metrics/{i}/{k}"], want[f"metrics/{i}/{k}"],
                rtol=GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL,
                err_msg=f"step {i} {k}")
    params = [k for k in init if k.startswith("params/")]
    assert params
    for k in params:
        old = init[k].ravel()[::stride]
        w = np.asarray(want[k]).ravel()
        upd = (w[::stride] if w.size == init[k].size else w) - old
        # an update of a few ulps is f32's rounding of the new weight
        ulps = 4 * np.finfo(np.float32).eps * np.abs(old).max()
        np.testing.assert_allclose(got[k].ravel()[::stride] - old, upd, rtol=0,
                                   atol=UPDATE_REL * np.abs(upd).max() + ulps,
                                   err_msg=k)
    for k in (k for k in init if k.startswith("stats/")):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=STATS_ATOL,
                                   err_msg=k)


def _prefixed(d, prefix: str) -> dict:
    return {k[len(prefix):]: d[k] for k in d if k.startswith(prefix)}


def test_global_batch_statistics_match_one_process(rank_results):
    """BatchNorm's all-reduced statistics and their gradients, 2 ranks
    against one process on the whole batch."""
    ranks, _, _ = rank_results
    one = _batchnorm_case(0, 1, None)
    for r, got in enumerate(ranks):
        rows = slice(r * 4, r * 4 + 4)
        want = {"bn/y": one["bn/y"][rows], "bn/dx": WORLD * one["bn/dx"][rows],
                **{k: one[k] for k in ("bn/dscale", "bn/dbias", "bn/mean", "bn/var")}}
        for k, v in want.items():  # within 1e-5 of each tensor's scale
            np.testing.assert_allclose(got[k], v, rtol=0,
                                       atol=BN_RTOL * np.abs(v).max(), err_msg=k)


@pytest.mark.parametrize("impl", ["pjit", "shard_map"])
def test_two_rank_step_matches_the_reference_mesh_step(rank_results, impl):
    """(a) pjit and (b) shard_map: both ranks end with the same weights, and
    those are the reference's on its 2-device mesh."""
    ranks, _, init = rank_results
    for k, v in ranks[0].items():
        if k.startswith(impl + "/"):
            np.testing.assert_array_equal(v, ranks[1][k], err_msg=k)
    _hold(_prefixed(ranks[0], impl + "/"), _prefixed(np.load(FIXTURE), impl + "/"),
          init, STRIDE)


def test_two_ranks_equal_one_process_with_the_augment_on(rank_results):
    """(c) the pjit step with the augment: 2 ranks of 4 rows equal one
    process of 8, the draws shared through the global batch's rows."""
    ranks, init_path, init = rank_results
    one = _run_steps(_build(init_path), train_step.make_train_step,
                     [_frame_batch(s) for s in range(STEPS)], None, [42, 43])
    _hold(_prefixed(ranks[0], "augment/"), one, init)


# ------------------------------------------------------------------ (d)


class _IndexDataset:
    """Image i is a 2×2 frame of value i: a batch names its indices."""

    decode_size = None

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {"image": np.full((2, 2, 3), i, np.uint8),
                "boxes": np.zeros((1, 4), np.float32),
                "labels": np.zeros(1, np.int32), "mask": np.zeros(1, bool)}


@pytest.mark.parametrize("n,count,skip", [(20, 2, 0), (21, 2, 3), (23, 3, 5),
                                          (10, 1, 4)])
def test_loader_shards_as_the_reference(n, count, skip):
    from itertools import islice

    from bdd100k_tpu.data.pipeline import make_loader as ref_loader

    from bdd100k_tpu_torch.data.pipeline import InMemoryDataset, make_loader

    frames = np.arange(n, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 2, 2, 3), np.uint8)
    port_ds = InMemoryDataset(frames, [np.zeros((1, 4), np.float32)] * n,
                              [np.ones(1, np.int32)] * n, max_boxes=1)
    for index in range(count):
        kw = dict(shuffle=True, seed=7, skip_steps=skip,
                  process_index=index, process_count=count)
        want = [b.images[:, 0, 0, 0].tolist() for b in islice(
            ref_loader(_IndexDataset(n), 3, num_workers=1, **kw), 9)]
        got = [b.images[:, 0, 0, 0].tolist() for b in islice(
            make_loader(port_ds, 3, **kw), 9)]
        assert got == want, (index, count)


# ------------------------------------------------------------------ (e)


def test_evaluate_multihost_gives_the_single_process_map(tmp_path):
    from bdd100k_tpu_torch import evaluate as port_eval

    argv = ["--synthetic", "8", "--synthetic_dir", str(SYNTH), "--ckpt_dir",
            str(ARTIFACT), "--batch_size", "4", "--num_workers", "1",
            "--dtype", "float32", "--device", "cpu"]
    one = port_eval.main(argv)
    outs = _spawn(_worker("main", "bdd100k_tpu_torch.evaluate", *argv,
                          "--multihost", "--sync_dir", str(tmp_path / "sync")))
    for out in outs:
        merged = json.loads(out.strip().splitlines()[-1])
        assert merged["mAP"] == one["mAP"]
        assert merged["per_class"] == one["per_class"]
        assert merged["num_images"] == 8 and merged["num_hosts"] == WORLD
    assert sorted(p.name for p in (tmp_path / "sync").iterdir()) == [
        "result.json", "shard_0.npz", "shard_1.npz"]
    shards = [np.load(tmp_path / "sync" / f"shard_{r}.npz") for r in range(WORLD)]
    assert [int(s["num_images"]) for s in shards] == [4, 4]


# ------------------------------------------------------------------ (f)


def _train_argv(run: Path, data: Path, steps: int) -> list[str]:
    return ["--config", "ssd_tiny_64", "--synthetic", "8", "--synthetic_dir",
            str(data), "--decode_size", "64", "--batch_size", "4",
            "--max_boxes", "16", "--total_steps", str(steps),
            "--warmup_steps", "0", "--log_every", "1", "--checkpoint_every", "2",
            "--num_workers", "1", "--ema_decay", "0.9", "--ckpt_dir", str(run),
            "--device", "cpu", "--multihost"]


def _log(run: Path) -> dict:
    recs = [json.loads(line) for line in (run / "train.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == sorted({r["step"] for r in recs})  # one writer
    return {r["step"]: r["loss"] for r in recs}


def test_two_rank_training_writes_once_and_resumes(tmp_path):
    """Rank 0 alone writes train.jsonl and the checkpoints; both ranks log
    to stdout. A second 2-rank run given only the step-2 checkpoint resumes
    there and repeats steps 3–4 of the uninterrupted run."""
    data, whole, part = tmp_path / "data", tmp_path / "whole", tmp_path / "part"
    outs = _spawn(_worker("main", "bdd100k_tpu_torch.train",
                          *_train_argv(whole, data, 4)))
    for out in outs:
        assert "data axis: 2 process(es)" in out and "done at step 4" in out
        assert "step 4: loss=" in out
    assert sorted(p.name for p in whole.glob("ckpt_*.pt")) == ["ckpt_2.pt", "ckpt_4.pt"]
    assert not list(whole.glob("*.tmp"))
    want = _log(whole)
    assert sorted(want) == [1, 2, 3, 4]
    part.mkdir()
    shutil.copy(whole / "ckpt_2.pt", part)
    outs = _spawn(_worker("main", "bdd100k_tpu_torch.train",
                          *_train_argv(part, data, 4)))
    for out in outs:
        assert "resumed from step 2" in out
    assert _log(part) == {3: want[3], 4: want[4]}
    a = torch.load(whole / "ckpt_4.pt", weights_only=True)
    b = torch.load(part / "ckpt_4.pt", weights_only=True)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k


@pytest.fixture(scope="module")
def ensured(tmp_path_factory):
    d = tmp_path_factory.mktemp("ensure")
    outs = _spawn(_worker("ensure", str(d)))
    return d, {r["rank"]: r for r in (json.loads(o.strip().splitlines()[-1])
                                      for o in outs)}


@pytest.mark.parametrize("case", ["shared", "per_rank"])
def test_ensure_synthetic_dataset_under_a_process_group(ensured, case):
    """shared: rank 0 generates and rank 1 finds the split after the
    barrier; per rank: each rank's directory is generated once, by it."""
    base, got = ensured
    assert [got[r][case] for r in range(WORLD)] == (
        [1, 0] if case == "shared" else [1, 1])
    dirs = ([base / "shared"] if case == "shared" else
            [base / "per_rank" / f"rank{r}" for r in range(WORLD)])
    for d in dirs:
        assert len(json.loads((d / "labels" / "train.json").read_text())) == 2
        assert len(list((d / "images" / "train").glob("*.jpg"))) == 2
        assert not list(d.glob(".gen_lock_*"))


# ------------------------------------------------------------------ (g)


def test_refusals_give_the_reference_messages(tmp_path, monkeypatch):
    from bdd100k_tpu_torch import evaluate as port_eval
    from bdd100k_tpu_torch import train as port_train

    # bdd100k_tpu/train.py:269-275, at a world of 2
    monkeypatch.setattr(mesh, "data_size", lambda: 2)
    with pytest.raises(SystemExit, match=r"^--batch_size 3 must be divisible "
                                         r"by the process count 2$"):
        port_train.main(["--config", "ssd_tiny_64", "--synthetic", "4",
                         "--batch_size", "3", "--device", "cpu",
                         "--synthetic_dir", str(tmp_path / "d"),
                         "--ckpt_dir", str(tmp_path / "run")])
    monkeypatch.undo()
    # bdd100k_tpu/evaluate.py:333-341: several processes, no --multihost
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=r"^multiple processes detected.*run "
                                         r"eval with --multihost \(per-rank "
                                         r"shards \+ merged mAP\) or on a "
                                         r"single process$"):
        port_eval.main(["--synthetic", "4", "--synthetic_dir", str(SYNTH),
                        "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE")
    # the reference's mesh refuses to need more devices than it has
    for main, extra in ((port_train.main, ["--config", "ssd_tiny_64"]),
                        (port_eval.main, [])):
        with pytest.raises(SystemExit, match="--mesh_data 4 .* 1 process"):
            main(extra + ["--mesh_data", "4", "--synthetic", "4", "--device",
                          "cpu", "--synthetic_dir", str(SYNTH),
                          "--ckpt_dir", str(tmp_path / "run")])


# ------------------------------------------------------------- fixture


def make_fixture() -> None:
    """The reference's pjit and shard_map steps on a 2-device CPU mesh, 2
    steps each from `_init_weights()`, on the global float batches."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from bdd100k_tpu.configs import TrainConfig as JaxTrainConfig
    from bdd100k_tpu.configs.detector_configs import tiny_test_config as jax_tiny
    from bdd100k_tpu.models.detector import build_detector as jax_build
    from bdd100k_tpu.parallel.mesh import make_mesh
    from bdd100k_tpu.parallel.shard_map_step import make_shardmap_train_step
    from bdd100k_tpu.parallel.train_step import create_train_state, make_train_step

    init = _init_weights()

    def tree(prefix):
        return unflatten_dict({tuple(k[len(prefix):].split("/")): jnp.asarray(v)
                               for k, v in init.items() if k.startswith(prefix)})

    m = make_mesh(num_data=WORLD, devices=jax.devices()[:WORLD])
    cfg = JaxTrainConfig(**{f: getattr(CFG, f) for f in (
        "batch_size", "max_boxes", "learning_rate", "warmup_steps", "total_steps")})
    out = {}
    for impl, make in (("pjit", make_train_step),
                       ("shard_map", make_shardmap_train_step)):
        bundle = jax_build(jax_tiny("ssd"), dtype=jnp.float32)
        state = create_train_state(bundle, cfg, jax.random.PRNGKey(0))
        params = tree("params/")
        state = state.replace(params=params, batch_stats=tree("stats/"),
                              opt_state=state.tx.init(params))
        step = make(bundle, mesh=m, donate=False)
        for i in range(STEPS):
            batch = [jnp.asarray(a) for a in _float_batch(i)]
            state, metrics = step(state, jax.random.PRNGKey(1 + i), *batch)
            for k, v in jax.device_get(metrics).items():
                out[f"{impl}/metrics/{i}/{k}"] = np.float32(v)
        for k, v in _flat(jax.device_get(state.params)).items():
            out[f"{impl}/params/{k}"] = v.ravel()[::STRIDE]
        for k, v in _flat(jax.device_get(state.batch_stats)).items():
            out[f"{impl}/stats/{k}"] = v
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        name, rest = sys.argv[i + 1], sys.argv[i + 2:]
        {"steps": worker_steps, "ensure": worker_ensure,
         "main": worker_main}[name](*rest)
    elif "--make-fixture" in sys.argv:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")
        make_fixture()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
