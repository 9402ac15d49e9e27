"""Device time of one greedy-NMS call and one matcher call on the card,
split into the kernels each call launches.

    python -m bdd100k_tpu_torch.ops.split_times [--tree DIR ...] [--out PATH]

For each tree given (a checkout of this repository; by default this one),
in a process of its own, it imports that tree's `bdd100k_tpu_torch` and
times `nms.greedy_suppress_cuda` on `chip_smoke.py`'s timed NMS inputs
(B=8, C=10, K=100 and K=200, every candidate valid) and
`matcher.encode_targets_cuda` on its timed matcher inputs (B=32, M=100,
the 8732 SSD300 anchors): the whole call by CUDA-graph replay
(`utils/timing.graph_time_ms`), and each kernel the call launches by its
device time in a `torch.profiler` trace of 50 eager calls. Beside them it
times the launch floor, a one-element in-place add. The inputs come from
this checkout's `chip_smoke.py`, so every tree sees the same data. Trees
run in the order given: `--tree OLD --tree . --tree . --tree OLD` compares
two revisions on one card. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
CALLS = 50  # eager calls in the profiled window


def kernel_times(torch, fn) -> dict:
    """name → device ms and launches per call of fn, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = out.setdefault(ev.name[:80], [0.0, 0])
            k[0] += ev.time_range.elapsed_us() / 1e3
            k[1] += 1
    return {n: dict(ms=t / CALLS, launches=c / CALLS) for n, (t, c) in out.items()}


def measure(tree: Path) -> dict:
    """Every timing of one tree, in this process: the tree's package comes
    first on the path, this checkout (for `chip_smoke`) second."""
    sys.path[0:1] = [str(tree), str(ROOT)]  # not this script's own directory
    import torch

    import chip_smoke
    from bdd100k_tpu_torch.ops import matcher, matching, nms
    from bdd100k_tpu_torch.ops.anchors import ssd_anchors
    from bdd100k_tpu_torch.utils.timing import graph_time_ms

    if not Path(nms.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {nms.__file__}, not the tree {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"tree": str(tree), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi.splitlines()[0]}
    one = torch.zeros(1, device="cuda")
    out["launch_floor_ms"] = graph_time_ms(lambda: one.add_(1.0))
    # chip_smoke's phase_kernel_nms draws its checked cases, then the timed
    # boxes, from one RandomState(0), K=100 first
    rng = np.random.RandomState(0)
    for k in (100, 200):
        chip_smoke.nms_cases(rng, 8, 10, k)
        bx = torch.from_numpy(chip_smoke.nms_cases(rng, 8, 10, k)[0][1]).cuda()
        vd = torch.ones(bx.shape[:-1], dtype=torch.bool, device="cuda")
        keep = nms.greedy_suppress_cuda(bx, vd, 0.45)
        if not torch.equal(keep.cpu(), nms.greedy_keep_mask(bx.cpu(), vd.cpu(), 0.45)):
            raise AssertionError(f"NMS keep mask differs from the plain greedy, K={k}")
        fn = lambda: nms.greedy_suppress_cuda(bx, vd, 0.45)  # noqa: E731
        out[f"nms_k{k}"] = dict(call_ms=graph_time_ms(fn), kept=int(keep.sum()),
                                kernels=kernel_times(torch, fn))
    anchors = ssd_anchors().cuda()
    cases, _ = chip_smoke.matcher_cases(torch, anchors, np.random.RandomState(0))
    _, gtb, gtl, gtm = cases[0]
    args = [torch.from_numpy(a).cuda() for a in (gtb, gtl, gtm)] + [anchors]
    got, want = matcher.encode_targets_cuda(*args), matching.encode_targets(*args)
    for field in ("matched_gt", "positive", "cls_targets"):
        if not torch.equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"matcher {field} differs from the oracle")
    fn = lambda: matcher.encode_targets_cuda(*args)  # noqa: E731
    out["matcher"] = dict(call_ms=graph_time_ms(fn), real_gt_rows=int(gtm.sum()),
                          kernels=kernel_times(torch, fn))
    from bdd100k_tpu_torch.utils import cuda_build

    # ptxas's registers and spills, where the tree's build asks for them
    out["ptxas"] = {n: [ln.strip() for ln in cuda_build.BUILD_LOGS.get(n, "").splitlines()
                        if "registers" in ln or "spill" in ln] for n in ("nms", "matcher")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path,
                    help="a checkout of this repository (repeatable; default: this one)")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "split_times.json")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.one.resolve())), flush=True)
        return 0
    rows = []
    for tree in args.tree or [ROOT]:
        run = subprocess.run([sys.executable, __file__, "--one", str(tree.resolve())],
                             capture_output=True, text=True, check=False)
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            raise RuntimeError(f"split_times failed on {tree}")
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
