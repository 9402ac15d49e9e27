"""Sweep launch plans of the depthwise kernels on the card.

    python -m bdd100k_tpu_torch.ops.depthwise_sweep [--out PATH]

For the forward kernel at batch 8 and 32 and the filter gradient's first
pass at batch 32, bf16, at the stride-1 layer shapes of SSD-MobileNet-300,
times every plan of a grid — channel chunk, rows a thread, thread strips,
ring depth, persistent blocks — with CUDA-graph replays, holds each
against the plain version, and prints, per shape, the five fastest plans
beside the one `depthwise._plan` picks. Every result goes to one JSON
file. This is how `_plan`'s rule was chosen (PERF.md). Needs one card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from bdd100k_tpu_torch.ops import depthwise as dw
from bdd100k_tpu_torch.utils import cuda_build
from bdd100k_tpu_torch.utils.timing import graph_time_ms

# (H = W, C) of the nine stride-1 layers at 300×300, width 1.0
LAYERS = ((150, 32), (75, 128), (38, 256), (19, 512), (10, 1024))
CASES = (("fwd", 8), ("fwd", 32), ("fgrad", 32))  # (kernel, batch)


def launch(lib, plan: dw.Plan, x, other, out) -> None:
    fn = lib.dw3x3_s1_fgrad_bf16 if plan.kernel == "fgrad" else lib.dw3x3_s1_bf16
    err = fn(x.data_ptr(), other.data_ptr(), out.data_ptr(), *x.shape, plan.tw,
             plan.th, plan.rows, plan.cb, plan.stages, plan.parts, plan.smem,
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, f"sweep {plan}")


def grid(kernel: str, b: int, h: int, w: int, c: int):
    """Every plan of the grid that fits a block."""
    tw = dw._plan(b, h, w, c, 2, kernel).tw
    for cb in (32, 64):
        if c % cb or cb // 8 * tw > dw.MAX_THREADS:
            continue
        for rows in dw.ROWS:
            for strips in range(1, min(4, dw.MAX_THREADS // (cb // 8 * tw)) + 1):
                th = rows * strips
                if (strips - 1) * rows >= h:
                    continue
                threads = cb // 8 * tw * strips
                chunks = c // cb
                n_spatial = b * -(-h // th) * -(-w // tw)
                for stages in (2, 3, 4):
                    smem = dw._smem(kernel, tw, th, cb, 2, threads, stages)
                    if smem > dw.SMEM_LIMIT:
                        continue
                    per_sm = dw._blocks_per_sm(smem, threads)
                    for q in (1, 2, 4):  # quarters of the blocks that fit
                        parts = max(1, min(n_spatial, dw.SMS * per_sm * q // 4 // chunks))
                        yield dw.Plan(kernel, b, h, w, c, 2, 8, cb, tw, th, rows,
                                      stages, parts, smem)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/depthwise_sweep.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("depthwise_sweep needs a CUDA card")
    lib = cuda_build.kernel_library("depthwise")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for kernel, b in CASES:
        for hw, c in LAYERS:
            shape = (b, hw, hw, c)
            x, g = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            k = (torch.randn((3, 3, c), generator=gen, device="cuda") * 0.3).bfloat16()
            if kernel == "fgrad":
                ref = dw.depthwise3x3_s1_fgrad_plain(x, g)
            else:
                ref = dw.depthwise3x3_s1_plain(x.float(), k.float())
            rows = []
            seen = set()
            for plan in [dw._plan(*shape, 2, kernel), *grid(kernel, *shape)]:
                if plan in seen:
                    continue
                seen.add(plan)
                if kernel == "fgrad":
                    out = torch.empty((plan.parts, 9, c), device="cuda")
                    launch(lib, plan, x, g, out)
                    err = float((dw.fgrad_sum_cuda(out) - ref).abs().max())
                    ok = err <= 2e-5 * float(ref.abs().max())
                    ms = graph_time_ms(lambda: launch(lib, plan, x, g, out), reps=15)
                else:
                    out = torch.empty_like(x)
                    launch(lib, plan, x, k, out)
                    err = float((out.float() - ref).abs().max())
                    ok = err <= 2.0 ** -7 * float(ref.abs().max())
                    ms = graph_time_ms(lambda: launch(lib, plan, x, k, out), reps=15)
                if not ok:
                    raise AssertionError(f"{plan}: max|Δ| {err}")
                fields = {f: getattr(plan, f) for f in
                          ("cb", "th", "rows", "stages", "parts", "smem")}
                rows.append(dict(kernel=kernel, shape=list(shape), ms=ms,
                                 threads=plan.threads, chosen=len(rows) == 0,
                                 **fields))
            results += rows
            ranked = sorted(rows, key=lambda r: r["ms"])
            print(json.dumps(dict(kernel=kernel, shape=list(shape), plans=len(rows),
                                  chosen=rows[0], fastest=ranked[:5])), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
