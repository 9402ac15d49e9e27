"""The port's spatial partitioning (`bdd100k_tpu_torch/parallel/spatial.py`,
halos exchanged by hand) against the reference's single-device program,
on the CPU, over gloo ranks (mirror of tests/test_spatial.py, which runs
GSPMD's derived halos on 8 fake devices).

* `spatial_mesh_factors` on the reference test's cases, and 64 px over 3
  ranks refused.
* Over 8 ranks spawned once for the module (this file run as `--worker`,
  the env torchrun sets, a timeout of its own): the tiny SSD at 64 px
  (1-D rows, grid (8, 1)) and at 60 px (the (4, 2) grid, halos in both
  dims and corners) give the reference's `make_eval_step` detections on
  the same weights (its seed-0 init, carried over by
  `utils/weights.state_dict_from_flax`): scores and boxes within 1e-5,
  classes and valid equal; so do the tiny YOLO over 4 of the ranks and
  VGG16-SSD at full width on a 64² geometry over 2 (its max pools tiled
  with −inf halos).
  Every rank returns the same detections, and the stride-1 depthwise
  layers took the tiled route (their module on the tile with its halo).
* In one process (a world of one: every halo is pad) the spatial
  function equals the port's own detector exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

from bdd100k_tpu_torch.configs import get_config, tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.ops.anchors import make_ssd_feature_maps  # noqa: E402
from bdd100k_tpu_torch.parallel.spatial import (  # noqa: E402
    make_spatial_infer_fn,
    spatial_mesh_factors,
)
from bdd100k_tpu_torch.utils.weights import state_dict_from_flax  # noqa: E402

torch.set_num_threads(2)

WORLD = 8
WORKER_TIMEOUT = 120  # seconds the 8 ranks may take together
ATOL = 1e-5
FIELDS = ("boxes", "scores", "classes", "valid")
# case → (model, image size, ranks, image seed)
CASES = {"ssd64": ("ssd", 64, 8, 0), "ssd60": ("ssd", 60, 8, 1),
         "yolo64": ("yolo", 64, 4, 2), "vgg64": ("vgg", 64, 2, 3)}
STRIDE1_DW = ("ds1", "ds3", "ds5", "ds7", "ds8", "ds9", "ds10", "ds11", "ds13")


def _config(model: str, size: int, jax_side: bool = False):
    """The tiny SSD or YOLO at `size`, or VGG16-SSD at full width on a 64²
    geometry (tests/test_torch_quant_models.py's)."""
    if jax_side:
        from bdd100k_tpu.configs.detector_configs import get_config as gc
        from bdd100k_tpu.configs.detector_configs import tiny_test_config as tc
        from bdd100k_tpu.ops.anchors import make_ssd_feature_maps as fm
    else:
        gc, tc, fm = get_config, tiny_test_config, make_ssd_feature_maps
    if model == "vgg":
        return dataclasses.replace(gc("ssd_vgg16_512"), name="ssd_vgg16_64",
                                   image_size=size,
                                   feature_maps=fm((8, 4, 2, 1), (4, 6, 6, 4)))
    cfg = tc(model)
    if size != cfg.image_size:
        cfg = dataclasses.replace(cfg, name=f"{model}_tiny_{size}", image_size=size)
    return cfg


def _images(size: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 255, (2, size, size, 3), np.uint8)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


# ------------------------------------------------------ the worker side


def _port_bundle(case: str, weights):
    head, size, _, _ = CASES[case]
    bundle = build_detector(_config(head, size), dtype=torch.float32, device="cpu")
    pre = f"{case}/"
    params = {k[len(pre + "params/"):]: weights[k] for k in weights.files
              if k.startswith(pre + "params/")}
    stats = {k[len(pre + "stats/"):]: weights[k] for k in weights.files
             if k.startswith(pre + "stats/")}
    bundle.model.load_state_dict(state_dict_from_flax(params, stats))
    return bundle


def worker(init_path: str, out_dir: str) -> None:
    """One rank: every case, its detections and routes to `out_dir`."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    groups = {n: dist.new_group(list(range(n))) for n in (2, 3, 4)}
    weights = np.load(init_path)  # each case reads its own keys
    out, routes = {}, {}
    for case, (head, size, n, seed) in CASES.items():
        group = dist.group.WORLD if n == WORLD else groups[n]
        if rank >= n:
            continue
        fn = make_spatial_infer_fn(_port_bundle(case, weights), group)
        det = fn(fn.tile(torch.from_numpy(_images(size, seed))))
        out.update({f"{case}/{k}": getattr(det, k).numpy() for k in FIELDS})
        routes[case] = dict(grid=fn.grid, routes=list(fn.routes))
    refused = None
    if rank < 3:
        try:
            make_spatial_infer_fn(_port_bundle("ssd64", weights), groups[3])
        except ValueError as e:
            refused = str(e)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    (Path(out_dir) / f"rank{rank}.json").write_text(
        json.dumps(dict(routes=routes, refused=refused)))
    dist.destroy_process_group()


# ------------------------------------------------------ the test side


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference(case: str):
    """The reference's seed-0 f32 tiny model → (its flat weights, its
    single-device `make_eval_step` detections on the case's images)."""
    import jax
    import jax.numpy as jnp

    from bdd100k_tpu.models.detector import build_detector as ref_build
    from bdd100k_tpu.parallel.train_step import make_eval_step

    head, size, _, seed = CASES[case]
    bundle = ref_build(_config(head, size, jax_side=True), dtype=jnp.float32)
    variables = bundle.init(jax.random.PRNGKey(0))
    params, stats = variables["params"], variables.get("batch_stats", {})
    det = make_eval_step(bundle)(params, stats, jnp.asarray(_images(size, seed)))
    weights = {**{f"{case}/params/{k}": v for k, v in _flat(params).items()},
               **{f"{case}/stats/{k}": v for k, v in _flat(stats).items()}}
    return weights, {k: np.asarray(getattr(det, k)) for k in FIELDS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's outputs and the 8 ranks' results (spawned once)."""
    d = tmp_path_factory.mktemp("spatial")
    weights, refs = {}, {}
    for case in CASES:
        w, refs[case] = _reference(case)
        weights.update(w)
    np.savez(d / "init.npz", **weights)
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(WORLD), "RANK": str(rank), "LOCAL_RANK": "0",
               "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(d / "init.npz"), str(d)],
            env=env, cwd=ROOT, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"ranks did not finish in {WORKER_TIMEOUT}s:\n"
                    + "\n".join(p.communicate()[0] for p in procs))
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks {bad} failed:\n" + "\n----\n".join(outs)
    results = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    meta = [json.loads((d / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return refs, results, meta, weights


def test_spatial_mesh_factors():
    assert spatial_mesh_factors(300, 8) == (4, 2)  # the flagship case
    assert spatial_mesh_factors(64, 8) == (8, 1)
    assert spatial_mesh_factors(60, 8) == (4, 2)
    assert spatial_mesh_factors(512, 4) == (4, 1)
    with pytest.raises(ValueError, match="not divisible"):
        spatial_mesh_factors(64, 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spatial_infer_matches_the_reference(ranks, case):
    refs, results, meta, _ = ranks
    n = CASES[case][2]
    ref = refs[case]
    got = {k: results[0][f"{case}/{k}"] for k in FIELDS}
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=ATOL)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=ATOL)
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    for r in range(1, n):  # every rank returns the same detections
        for k in FIELDS:
            np.testing.assert_array_equal(results[r][f"{case}/{k}"], got[k])
    assert all(f"{case}/scores" not in results[r] for r in range(n, WORLD))


def test_grids_are_the_references(ranks):
    meta = ranks[2]
    grids = {c: tuple(meta[0]["routes"][c]["grid"]) for c in CASES}
    assert grids == {"ssd64": (8, 1), "ssd60": (4, 2), "yolo64": (4, 1),
                     "vgg64": (2, 1)}


def test_vgg_pools_run_tiled(ranks):
    """VGG16-SSD at 64² over 2 ranks: every 2×2 pool and pool5 (3×3, −inf
    halos) runs tiled down to the 4-row map; fc6's dilation-6 window
    (halos of 6 rows) outgrows the 2-row tiles there, so it gathers."""
    routes = dict(map(tuple, ranks[2][0]["routes"]["vgg64"]["routes"]))
    assert all(routes[f"pool{i}"] == "tiled" for i in range(1, 6)), routes
    assert routes["fc6"] == "gathered"


def test_depthwise_layers_took_the_tiled_route(ranks):
    """64 px over 8 ranks: the stride-1 depthwise layers on the 32, 16
    and 8-row maps (ds1, ds3, ds5) run tiled; from ds6's 4-row map a tile
    would be empty, so the ranks gather and the rest runs replicated. On
    the (4, 2) grid every stride-1 layer down to ds11 (the 4×4 map) runs
    tiled."""
    meta = ranks[2]
    for case, tiled in (("ssd64", STRIDE1_DW[:3]), ("ssd60", STRIDE1_DW[:8])):
        routes = dict(map(tuple, meta[0]["routes"][case]["routes"]))
        assert all(routes[f"{b}.dw"] == "tiled" for b in tiled), (case, routes)
        assert "gathered" in routes.values()
        assert all(tuple(map(tuple, m["routes"][case]["routes"]))
                   == tuple(map(tuple, meta[0]["routes"][case]["routes"]))
                   for m in meta[:CASES[case][2]])


def test_64px_over_3_ranks_is_refused(ranks):
    meta = ranks[2]
    for r in range(3):
        assert "not divisible over 3 devices" in meta[r]["refused"]


def test_one_rank_equals_the_detector():
    """Without a process group the function runs as one rank: each halo
    is the image's pad, and the result is the detector's own, bit for bit."""
    bundle = build_detector(tiny_test_config("ssd"), dtype=torch.float32,
                            device="cpu")
    images = torch.from_numpy(_images(64, 3))
    fn = make_spatial_infer_fn(bundle)
    assert fn.grid == (1, 1)
    assert torch.equal(fn.tile(images), images)
    det = fn(images)
    from bdd100k_tpu_torch.data.augment import preprocess_eval_batch

    with torch.inference_mode():
        loc, cls = bundle.model(preprocess_eval_batch(images, 64))
        want = bundle.postprocess(loc, cls)
    for k in FIELDS:
        assert torch.equal(getattr(det, k), getattr(want, k)), k
    assert all(route == "tiled" for name, route in fn.routes
               if name.endswith(".dw"))
    with pytest.raises(AssertionError, match="pre-resized 64×64"):
        fn(images[:, :32])


def test_quantized_models_are_refused():
    cfg = dataclasses.replace(tiny_test_config("ssd"), quant="int8")
    bundle = build_detector(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="float model"):
        make_spatial_infer_fn(bundle)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(*sys.argv[i + 1:i + 3])
    else:
        sys.exit(pytest.main([__file__, "-q"]))
