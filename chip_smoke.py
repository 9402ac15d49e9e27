#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`bdd100k_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from `bdd100k_tpu_torch/csrc`,
holds each against its plain PyTorch version at the shapes the main paths
give it, then drives the main paths of three model families at full width.
SSD-MobileNet-300: serving (the committed trained artifact, through
`load_predictor`), eval (`python -m bdd100k_tpu_torch.evaluate` from the
64 committed seed-1 JPEGs to mAP, through the decode pool built from
`native/decode_pool.cc`, held against the JAX fixture) and training (the
`bdd100k_tpu_torch.train` trainer at batch 32 from the seeded init, with a
checkpoint, a resume, and an eval of its own run directory).
YOLO-MobileNet-384: the four kernels again at its shapes (the depthwise
forward at B=8 and 32, dx and dk at B=64, the matcher at B=64 on its 9072
anchors), serving on its trained artifact, eval of both committed YOLO
artifacts with the priors each was trained with against their JAX
fixture, an f32 train step against the CPU and the trainer at batch 64.
VGG16-SSD512 (BASELINE config 2): its f32 serving path against the CPU on
two JPEGs at 512, serving in bf16 at b1 and b32 on both wires with the
host resize on and off, NMS at K=200 on its own eval candidates at B=32
and b1, eval of its committed artifact against its JAX fixture (f32 and
the bf16 CLI), the matcher at B=32 on its 24564 anchors and the trainer
at batch 32. Then the serving CLI, `python -m bdd100k_tpu_torch.infer`,
as subprocesses for all three families, its printed detections held to
the reference CLI's f32 lines in `tests/fixtures/torch_ref_infer_cli.json`,
and the full-resolution JPEG decode held to PIL's pixels. Then training
from JPEG files: SSD300 at B=32 from the 64 committed JPEGs at
--decode_size 512 on the yuv420 wire, its backbone seeded from the
committed artifact, with an EMA shadow and a torch.profiler window (the
card's busy share), again at full resolution on the rgb wire, and
VGG16-SSD512 seeded from a torchvision-layout .pth; the weights exporter
on the first run (its artifact equal to the EMA shadow in fp16) and an
f32 eval of that artifact; progressive JPEGs and PIL's bicubic resize of
non-720p frames held to the reference's sha256s in
`tests/fixtures/decode_repairs/ref_sha256.json`.
Each path is checked to have run through its kernels and to give the
right output. NMS and the matcher are also held bit-equal at the edges of
what they take (K from 1 to 256, greedy-trap chains; zero-area and
whole-image GTs, M = 1, SSD512's, the tiny config's and YOLO's anchors),
each call one launch, beside the launch floor of the card. Each phase
prints one JSON line; any failure raises, so the exit code is not 0.
The second-to-last lines are the kernel table (`{"kernels": [...]}`) and
the card's name and power limit as nvidia-smi gives them; the last line is
`{"ok": true, "device": {...}}`.

Needs one CUDA card. Imports nothing of JAX and nothing of `bdd100k_tpu`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parent
ARTIFACT = ROOT / "artifacts" / "ssd_mobilenet_300_synth9k.npz"
CONFIG = "ssd_mobilenet_300"
VGG_CONFIG = "ssd_vgg16_512"
VGG_ARTIFACT = ROOT / "artifacts" / "ssd_vgg16_512_synth9k.npz"

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
RUNS = ROOT / "runs" / "chip_smoke"   # checkpoints and logs of the train phases

REPS = 30   # timed graph replays per measurement (median reported)
INNER = 10  # calls captured in one graph


PHASE_LOG = ROOT / "chiprun_out" / "chip_smoke.jsonl"  # every phase line, whole


def emit(phase: str, **fields) -> None:
    """Print one phase's JSON line, with the script's seconds so far, and
    append it to PHASE_LOG."""
    line = json.dumps({"phase": phase, "at_s": time.perf_counter() - T_IMPORT,
                       **fields})
    print(line, flush=True)
    with PHASE_LOG.open("a") as f:
        f.write(line + "\n")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Device time of one call of fn, in ms: INNER calls are captured in a
    CUDA graph, so the host's launch overhead is out of the measurement,
    and the median over REPS replays (CUDA events) is divided by INNER."""
    from bdd100k_tpu_torch.utils.timing import graph_time_ms

    return graph_time_ms(fn, REPS, INNER)


# ------------------------------------------------------------------ NMS


def nms_cases(rng: np.random.RandomState, b: int, c: int, k: int):
    """(name, boxes (B, C, K, 4) f32, valid (B, C, K) bool) test cases."""

    def random_boxes(n, lo=0.02, hi=0.4):
        cxy = rng.uniform(0.05, 0.95, (n, 2))
        wh = rng.uniform(lo, hi, (n, 2))
        return np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)

    def batch(fn):
        return np.stack(
            [np.stack([fn() for _ in range(c)]) for _ in range(b)]
        ).astype(np.float32)

    cases = []
    boxes = batch(lambda: random_boxes(k))
    cases.append(("random", boxes, rng.rand(b, c, k) > 0.2))
    # clustered boxes: long suppression chains
    def clustered():
        centre = rng.uniform(0.3, 0.7, 2)
        jit = rng.normal(0, 0.02, (k, 4))
        base = np.concatenate([centre - 0.1, centre + 0.1])
        return np.clip(base + jit, 0, 1)
    cases.append(("clustered", batch(clustered), np.ones((b, c, k), bool)))
    dup = boxes.copy()
    dup[:, :, 1::2] = dup[:, :, 0::2][:, :, : dup[:, :, 1::2].shape[2]]
    cases.append(("duplicates", dup, np.ones((b, c, k), bool)))
    # IoU exactly on the threshold: inter 0.45, union 1 → IoU == 0.45 in
    # f32, which must NOT suppress; a hair more must
    edge = boxes.copy()
    edge[:, :, 0] = [0.0, 0.0, 1.0, 1.0]
    edge[:, :, 1] = [0.0, 0.0, 0.45, 1.0]
    edge[:, :, 2] = [0.0, 0.0, 0.46, 1.0]
    cases.append(("iou_on_threshold", edge, np.ones((b, c, k), bool)))
    zero = boxes.copy()
    zero[:, :, ::3, 2] = zero[:, :, ::3, 0]          # zero width
    zero[:, :, 1::5] = zero[:, :, 1::5, :1]          # a point
    cases.append(("zero_area", zero, np.ones((b, c, k), bool)))
    inval = rng.rand(b, c, k) > 0.5
    inval[:, 0] = False                               # all-invalid rows
    inval[0] = False                                  # an all-invalid image
    cases.append(("all_invalid_rows", boxes, inval))
    return cases


def nms_bound_ms(b: int, c: int, k: int) -> tuple[float, str]:
    """Least time for the suppression: bytes (boxes f32 + valid + keep, one
    byte each) against the IoU work (14 f32 ops a pair j < i, 5 an area)."""
    nbytes = b * c * k * (16 + 1 + 1)
    ops = b * c * (k * (k - 1) // 2 * 14 + 5 * k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nms_trap_row(rng: np.random.RandomState, k: int, at: tuple[int, int, int]):
    """One row of K candidates with a greedy-trap chain at positions
    a < b < c: a suppresses b (IoU 0.5), b overlaps c above the threshold
    (IoU 0.5) and a and c do not (IoU 0.2), so c survives. The other
    candidates are small boxes at y > 0.25, away from the chain."""
    cxy = rng.uniform([0.05, 0.3], [0.95, 0.95], (k, 2))
    wh = rng.uniform(0.02, 0.1, (k, 2))
    row = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
    for pos, x1 in zip(at, (0.0, 0.2, 0.4)):
        row[pos] = [x1, 0.0, x1 + 0.6, 0.1]
    return row.astype(np.float32)


def nms_edge_cases(rng: np.random.RandomState, k: int):
    """(name, boxes, valid, trap positions or None) held bit-equal to the
    plain greedy at K ∈ NMS_EDGE_K: chip_smoke's six cases (K ≥ 3) at
    B=2, C=3, greedy-trap chains (inside a word, and across words where K
    allows) and a single row; at K=1, random boxes and validity."""
    cases = []
    if k >= 3:
        cases += [(n, bx, vd, None) for n, bx, vd in nms_cases(rng, 2, 3, k)]
        chains = [(0, 1, 2)] + ([(30, 33, k - 1)] if k > 34 else [])
        for at in chains:
            bx = np.stack([np.stack([nms_trap_row(rng, k, at) for _ in range(3)])
                           for _ in range(2)])
            cases.append((f"greedy_trap_{at}", bx, np.ones((2, 3, k), bool), at))
    else:
        bx = nms_cases(rng, 2, 3, 3)[0][1][..., :k, :]
        cases.append(("random", np.ascontiguousarray(bx), rng.rand(2, 3, k) > 0.3, None))
    bx, vd = nms_cases(rng, 1, 1, max(k, 3))[0][1:]
    cases.append(("single_row", np.ascontiguousarray(bx[..., :k, :]),
                  np.ascontiguousarray(vd[..., :k]), None))
    return cases


NMS_EDGE_K = (1, 37, 100, 200, 256)
EVAL_BATCH = 32  # the reference eval's default batch
# (B, K) at C=10: serving's b8 at the config's K=100 and at 200, and eval's
NMS_SHAPES = ((8, 100), (8, 200), (EVAL_BATCH, 100))


def nms_call(torch, nms, bx, vd) -> "torch.Tensor":
    """One kernel call, held to one launch."""
    launched = nms.LAUNCHES["greedy_suppress"]
    keep = nms.greedy_suppress_cuda(bx, vd, 0.45)
    if nms.LAUNCHES["greedy_suppress"] - launched != 1:
        raise AssertionError("an NMS call is not one launch")
    return keep


def phase_kernel_nms(torch, nms) -> dict:
    rng = np.random.RandomState(0)
    out = {"max_abs_err": 0.0}
    for b, k in NMS_SHAPES:
        launched = nms.LAUNCHES["greedy_suppress"]
        c = 10
        for name, boxes, valid in nms_cases(rng, b, c, k):
            bx = torch.from_numpy(boxes).cuda()
            vd = torch.from_numpy(valid).cuda()
            keep = nms_call(torch, nms, bx, vd)
            torch.cuda.synchronize()
            want = nms.greedy_keep_mask(
                torch.from_numpy(boxes), torch.from_numpy(valid), 0.45)
            bad = int((keep.cpu() != want).sum())
            out["max_abs_err"] = max(out["max_abs_err"], float(bad > 0))
            if bad:
                raise AssertionError(f"NMS kernel disagrees with the plain greedy: "
                                     f"{bad} keep bits, K={k}, case {name}")
            if name == "iou_on_threshold" and not (
                    bool(want[..., 1].all()) and not bool(want[..., 2].any())):
                raise AssertionError("threshold case did not exercise IoU == thr")
        # time at the random case
        bx = torch.from_numpy(nms_cases(rng, b, c, k)[0][1]).cuda()
        vd = torch.ones((b, c, k), dtype=torch.bool, device="cuda")
        ms = time_ms(torch, lambda: nms.greedy_suppress_cuda(bx, vd, 0.45))
        plain_ms = time_ms(torch, lambda: nms.greedy_keep_mask(bx, vd, 0.45))
        bound, by = nms_bound_ms(b, c, k)
        out[k if b == 8 else f"b{b}"] = dict(ms=ms, plain_ms=plain_ms,
                                             bound_ms=bound, bound_by=by)
        emit("kernel_nms", B=b, C=c, K=k, cases=6, keep_bits_equal=True,
             launches=nms.LAUNCHES["greedy_suppress"] - launched,
             launches_per_call=1,
             kept=int(nms.greedy_suppress_cuda(bx, vd, 0.45).sum()),
             kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    # K as the kernel takes it (no padding): ragged words, one candidate,
    # a full 256, greedy-trap chains and single rows
    rng = np.random.RandomState(1)
    names = {}
    for k in NMS_EDGE_K:
        for name, boxes, valid, trap in nms_edge_cases(rng, k):
            keep = nms_call(torch, nms, torch.from_numpy(boxes).cuda(),
                            torch.from_numpy(valid).cuda()).cpu()
            want = nms.greedy_keep_mask(torch.from_numpy(boxes),
                                        torch.from_numpy(valid), 0.45)
            if not torch.equal(keep, want):
                raise AssertionError(f"NMS kernel disagrees with the plain greedy: "
                                     f"K={k}, case {name}")
            if trap and not (bool(want[..., trap[0]].all())
                             and not bool(want[..., trap[1]].any())
                             and bool(want[..., trap[2]].all())):
                raise AssertionError(f"greedy-trap case {name} did not keep a and c")
            names.setdefault(k, []).append(name)
    emit("kernel_nms_edges", K=list(NMS_EDGE_K), cases=names, keep_bits_equal=True,
         launches_per_call=1)
    return out


def phase_nms_path_inputs(torch, nms, captures, phase="kernel_nms_path_inputs",
                          sizes=(1, 8)) -> dict:
    """The kernel on a path's own candidates, as `phase_path_f32` (or the
    eval) recorded them (the batch's first `sizes` images: a b8 batch, and
    its first image as a b1 request would give them), beside the plain
    greedy's time; keep bits held equal."""
    cap = captures[0]
    out = {}
    for bs in sizes:
        bx = cap["boxes"][:bs].contiguous()
        vd = cap["valid"][:bs].contiguous()
        thr = cap["iou_threshold"]
        keep = nms_call(torch, nms, bx, vd)
        if not torch.equal(keep.cpu(), nms.greedy_keep_mask(bx.cpu(), vd.cpu(), thr)):
            raise AssertionError(f"NMS on the path's b{bs} candidates disagrees")
        b, c, k = vd.shape
        bound, by = nms_bound_ms(b, c, k)
        out[f"b{bs}"] = dict(
            B=b, C=c, K=k, valid=int(vd.sum()), kept=int(keep.sum()),
            kernel_ms=time_ms(torch, lambda: nms.greedy_suppress_cuda(bx, vd, thr)),
            plain_ms=time_ms(torch, lambda: nms.greedy_keep_mask(bx, vd, thr)),
            bound_ms=bound, bound_by=by)
    emit(phase, keep_bits_equal=True, **out)
    return out


# ------------------------------------------------------------ depthwise

# the nine stride-1 depthwise layers at 300×300, width 1.0:
# (layers, H = W, C)
DW_SHAPES = (("ds1", 1, 150, 32), ("ds3", 1, 75, 128), ("ds5", 1, 38, 256),
             ("ds7-11", 5, 19, 512), ("ds13", 1, 10, 1024))
DW_BATCH = 8
BF16_RTOL = 2.0 ** -7   # one bf16 ulp of the output
# held against the plain versions too, untimed: one-pixel maps, ragged
# bands and tiles, chunks that do not divide C, and the depthwise shapes
# of ssd_tiny_64 / yolo_tiny_64 (64² input, width 0.25)
DW_EDGE_SHAPES = ((2, 1, 1, 8), (3, 2, 3, 16), (2, 5, 7, 24), (1, 19, 19, 8),
                  (2, 33, 17, 40), (4, 32, 32, 8), (4, 16, 16, 32),
                  (4, 8, 8, 64), (4, 4, 4, 128), (4, 2, 2, 256))


def dw_bound_ms(b, h, w, c, itemsize) -> tuple[float, str]:
    nbytes = (2 * b * h * w * c + 9 * c) * itemsize
    ops = 18 * b * h * w * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_dw_forward(torch, dw, x32, k32, what: str) -> tuple[float, float, float]:
    """The forward kernel against its plain version on the same inputs, f32
    and bf16 → (f32 max|Δ|, its tolerance, bf16 max|Δ| against the plain
    bf16 version); raises beyond tolerance."""
    # f32: max|Δ| ≤ 1e-5·max|ref|
    y32 = dw.depthwise3x3_s1_cuda(x32, k32)
    ref32 = dw.depthwise3x3_s1_plain(x32, k32)
    err32 = float((y32 - ref32).abs().max())
    tol32 = 1e-5 * float(ref32.abs().max())
    if not err32 <= tol32:
        raise AssertionError(f"depthwise f32 {what}: max|Δ| {err32} > {tol32}")
    # bf16: against the f32 plain result on the same bf16 inputs, within
    # one bf16 ulp of the output (rtol 2^-7); the 1e-5·max|ref| floor
    # covers outputs that cancel to near zero, where f32 order matters
    xb, kb = x32.to(torch.bfloat16), k32.to(torch.bfloat16)
    yb = dw.depthwise3x3_s1_cuda(xb, kb)
    refb = dw.depthwise3x3_s1_plain(xb.float(), kb.float())
    excess = ((yb.float() - refb).abs()
              - (BF16_RTOL * refb.abs() + 1e-5 * refb.abs().max()))
    if float(excess.max()) > 0:
        raise AssertionError(f"depthwise bf16 {what}: beyond one ulp by "
                             f"{float(excess.max())}")
    plainb = dw.depthwise3x3_s1_plain(xb, kb)
    return err32, tol32, float((yb.float() - plainb.float()).abs().max())


def dw_layer_times(torch, dw, x, k, c: int) -> dict:
    """The forward kernel, its plain version and cuDNN's grouped conv on
    one input → their ms, the bound and the ratios."""
    import torch.nn.functional as F

    xn = x.permute(0, 3, 1, 2)                      # channels_last view
    wn = k.permute(2, 0, 1).unsqueeze(1).contiguous()
    b, h, w, _ = x.shape
    ms = time_ms(torch, lambda: dw.depthwise3x3_s1_cuda(x, k))
    lib_ms = time_ms(torch, lambda: F.conv2d(xn, wn, None, 1, 1, 1, c))
    bound, by = dw_bound_ms(b, h, w, c, x.element_size())
    return dict(kernel_ms=ms,
                plain_ms=time_ms(torch, lambda: dw.depthwise3x3_s1_plain(x, k)),
                library_ms=lib_ms, bound_ms=bound, bound_by=by,
                kernel_over_bound=ms / bound, kernel_over_library=ms / lib_ms)


def dw_forward_layers(torch, dw, gen, shapes, b: int, phase: str) -> dict:
    """The forward at each stride-1 layer of `shapes` at batch b, in bf16
    and f32, against its plain version (f32 within 1e-5·max, bf16 within
    one ulp) and timed beside cuDNN; one line each → bf16 totals over the
    nine layers."""
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                  max_abs_err=0.0)
    for name, layers, hw, c in shapes:
        launched = dw.LAUNCHES["depthwise3x3_s1"]
        x32 = torch.randn((b, hw, hw, c), generator=gen, device="cuda")
        k32 = torch.randn((3, 3, c), generator=gen, device="cuda") * 0.3
        err32, tol32, errb = check_dw_forward(torch, dw, x32, k32, f"{phase} {name}")
        launches = dw.LAUNCHES["depthwise3x3_s1"] - launched
        row = {dtype: dw_layer_times(torch, dw, x, k, c) for dtype, x, k in (
            ("bf16", x32.to(torch.bfloat16), k32.to(torch.bfloat16)), ("f32", x32, k32))}
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            totals[key] += layers * row["bf16"]["kernel_ms" if key == "ms" else key]
        totals["max_abs_err"] = max(totals["max_abs_err"], errb)
        emit(phase, layer=name, layers=layers, shape=[b, hw, hw, c],
             f32_max_abs_err=err32, f32_tol=tol32,
             bf16_max_abs_err_vs_plain_bf16=errb, bf16_within_one_ulp=True,
             launches=launches, bf16_plan=plan_fields(dw._plan(b, hw, hw, c, 2)),
             f32_plan=plan_fields(dw._plan(b, hw, hw, c, 4)), **row)
    return totals


def phase_kernel_depthwise(torch, dw) -> dict:
    """The forward at the edge shapes, then at the nine SSD300 layers at
    B=8 (serving) and B=32 (eval) → bf16 totals (B=32's under "b32")."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    edge_err = 0.0
    for shape in DW_EDGE_SHAPES:
        x32 = torch.randn(shape, generator=gen, device="cuda")
        k32 = torch.randn((3, 3, shape[-1]), generator=gen, device="cuda") * 0.3
        _, _, errb = check_dw_forward(torch, dw, x32, k32, f"edge {shape}")
        edge_err = max(edge_err, errb)
    emit("kernel_depthwise_edges", shapes=[list(s) for s in DW_EDGE_SHAPES],
         dtypes=["f32", "bf16"], within_tolerance=True,
         bf16_max_abs_err_vs_plain_bf16=edge_err)
    totals = dw_forward_layers(torch, dw, gen, DW_SHAPES, DW_BATCH, "kernel_depthwise")
    totals["max_abs_err"] = max(totals["max_abs_err"], edge_err)
    totals["b32"] = dw_forward_layers(torch, dw, gen, DW_SHAPES, EVAL_BATCH,
                                      "kernel_depthwise_b32")
    return totals


def plan_fields(plan) -> dict:
    return dict(tw=plan.tw, th=plan.th, rows=plan.rows, cb=plan.cb,
                threads=plan.threads, chunks=plan.chunks, parts=plan.parts,
                items=plan.n_spatial * plan.chunks, smem=plan.smem)


def dw_bwd_bound_ms(b, h, w, c, itemsize) -> tuple[float, str]:
    """dx moves what the forward moves; dk reads x and g once and writes
    (3, 3, C) f32, against 18 flops per element pair."""
    nbytes = 2 * b * h * w * c * itemsize + 9 * c * 4
    ops = 18 * b * h * w * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


BWD_BATCH = 32       # the train step's batch
DK_RTOL = 2e-5       # of max|dk|: B·H·W f32 products summed in another order


def check_dw_backward(torch, dw, x32, g32, k32, what: str) -> dict:
    """dx (the forward kernel on g with the filter flipped) and dk against
    their plain versions on the same inputs, bf16 and f32, and dk the same
    bits on a second call → per type {dx_max_abs_err, dx_tol,
    dk_max_abs_err, dk_tol}; raises beyond tolerance."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        x, g, k = x32.to(dtype), g32.to(dtype), k32.to(dtype)
        kf = k.flip(0, 1).contiguous()
        dx = dw.depthwise3x3_s1_cuda(g, kf)
        dk = dw.depthwise3x3_s1_fgrad_cuda(x, g)
        dk_again = dw.depthwise3x3_s1_fgrad_cuda(x, g)
        # plain versions on the same inputs, in f32
        dx_ref = dw.depthwise3x3_s1_plain(g.float(), kf.float())
        dk_ref = dw.depthwise3x3_s1_fgrad_plain(x, g)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            dx_tol = 1e-5 * float(dx_ref.abs().max())
            dx_err = float((dx - dx_ref).abs().max())
            ok = dx_err <= dx_tol
        else:  # one bf16 ulp of the output, as the forward's check
            excess = ((dx.float() - dx_ref).abs()
                      - (BF16_RTOL * dx_ref.abs() + 1e-5 * dx_ref.abs().max()))
            dx_err = float((dx.float() - dx_ref).abs().max())
            dx_tol = None
            ok = float(excess.max()) <= 0
        if not ok:
            raise AssertionError(f"dx {tag} {what}: max|Δ| {dx_err}")
        dk_err = float((dk - dk_ref).abs().max())
        dk_tol = DK_RTOL * float(dk_ref.abs().max())
        if not dk_err <= dk_tol:
            raise AssertionError(f"dk {tag} {what}: max|Δ| {dk_err} > {dk_tol}")
        if not torch.equal(dk, dk_again):
            raise AssertionError(f"dk {tag} {what}: two calls differ")
        out[tag] = dict(dx_max_abs_err=dx_err, dx_tol=dx_tol,
                        dk_max_abs_err=dk_err, dk_tol=dk_tol)
    return out


def phase_kernel_depthwise_bwd(torch, dw, shapes=DW_SHAPES, b=BWD_BATCH,
                               edges=DW_EDGE_SHAPES,
                               phase="kernel_depthwise_bwd") -> dict:
    """dx and dk against their plain versions at the nine stride-1 layer
    shapes at the train step's batch, and at the edge shapes, bf16 and
    f32, dk the same bits on two calls; times in bf16, the main path's
    type, with cuDNN's grouped conv (dx) and its weight gradient
    `torch.nn.grad.conv2d_weight` (dk) as the library yardsticks, and dk's
    two passes timed apart."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    totals = {"dx": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0),
              "dk": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                         partials_ms=0.0, sum_ms=0.0),
              "max_abs_err": 0.0}
    edge_err = 0.0
    for shape in edges:
        x32, g32 = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
        k32 = torch.randn((3, 3, shape[-1]), generator=gen, device="cuda") * 0.3
        errs = check_dw_backward(torch, dw, x32, g32, k32, f"edge {shape}")
        edge_err = max(edge_err, *(e["dk_max_abs_err"] for e in errs.values()))
    if edges:
        emit("kernel_depthwise_bwd_edges", shapes=[list(s) for s in edges],
             dtypes=["bf16", "f32"], within_tolerance=True, dk_bit_equal_twice=True,
             dk_max_abs_err=edge_err)
    totals["max_abs_err"] = edge_err
    for name, layers, hw, c in shapes:
        x32 = torch.randn((b, hw, hw, c), generator=gen, device="cuda")
        g32 = torch.randn((b, hw, hw, c), generator=gen, device="cuda")
        k32 = torch.randn((3, 3, c), generator=gen, device="cuda") * 0.3
        row = check_dw_backward(torch, dw, x32, g32, k32, f"{phase} {name}")
        for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            x, g, k = x32.to(dtype), g32.to(dtype), k32.to(dtype)
            kf = k.flip(0, 1).contiguous()
            totals["max_abs_err"] = max(totals["max_abs_err"], row[tag]["dk_max_abs_err"])
            times = dict(
                dx_ms=time_ms(torch, lambda: dw.depthwise3x3_s1_cuda(g, kf)),
                dk_ms=time_ms(torch, lambda: dw.depthwise3x3_s1_fgrad_cuda(x, g)))
            if dtype == torch.bfloat16:
                part = dw.fgrad_partials_cuda(x, g)
                xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
                wf = kf.permute(2, 0, 1).unsqueeze(1).contiguous()
                times.update(
                    dk_partials_ms=time_ms(torch, lambda: dw.fgrad_partials_cuda(x, g)),
                    dk_sum_ms=time_ms(torch, lambda: dw.fgrad_sum_cuda(part)),
                    dx_plain_ms=time_ms(torch, lambda: dw.depthwise3x3_s1_plain(g, kf)),
                    dk_plain_ms=time_ms(
                        torch, lambda: dw.depthwise3x3_s1_fgrad_plain(x, g)),
                    dx_library_ms=time_ms(
                        torch, lambda: F.conv2d(gn, wf, None, 1, 1, 1, c)),
                    dk_library_ms=time_ms(
                        torch, lambda: torch.nn.grad.conv2d_weight(
                            xn, (c, 1, 3, 3), gn, 1, 1, 1, c)))
                bound, by = dw_bwd_bound_ms(b, hw, hw, c, x.element_size())
                fwd_bound, _ = dw_bound_ms(b, hw, hw, c, x.element_size())
                for piece, bnd in (("dx", fwd_bound), ("dk", bound)):
                    t = totals[piece]
                    t["ms"] += layers * times[f"{piece}_ms"]
                    t["plain_ms"] += layers * times[f"{piece}_plain_ms"]
                    t["library_ms"] += layers * times[f"{piece}_library_ms"]
                    t["bound_ms"] += layers * bnd
                    times[f"{piece}_over_bound"] = times[f"{piece}_ms"] / bnd
                    times[f"{piece}_over_library"] = (times[f"{piece}_ms"]
                                                      / times[f"{piece}_library_ms"])
                totals["dk"]["partials_ms"] += layers * times["dk_partials_ms"]
                totals["dk"]["sum_ms"] += layers * times["dk_sum_ms"]
                times.update(dx_bound_ms=fwd_bound, dk_bound_ms=bound, bound_by=by,
                             dx_plan=plan_fields(dw._plan(b, hw, hw, c, 2)),
                             dk_plan=plan_fields(dw._plan(b, hw, hw, c, 2, "fgrad")))
            row[tag].update(times)
        emit(phase, layer=name, layers=layers,
             shape=[b, hw, hw, c], dx_tolerance="f32: 1e-5·max|ref|; bf16: one "
             "bf16 ulp of the output", dk_tolerance=f"{DK_RTOL}·max|ref|",
             dk_bit_equal_twice=True, **row)
    return totals


def ptxas_report(log: str) -> list[dict]:
    """Per kernel of a `-Xptxas -v` build log: registers, shared memory
    (static bytes) and spill bytes."""
    import re

    out, name, spill = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = dict(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(dict(kernel=name, registers=int(m.group(1)),
                            static_smem=int(smem.group(1)) if smem else 0, **spill))
            name = None
    return out


# -------------------------------------------------------------- matcher

MATCH_B, MATCH_M = 32, 100


def matcher_cases(torch, anchors, rng, b: int = MATCH_B):
    """(name, gt_boxes (B, M, 4), gt_labels (B, M) int32, gt_mask (B, M))
    numpy cases at M=100 against an anchor set (SSD300's 8732 at B=32 on
    the SSD path, YOLO's 9072 at B=64 on the YOLO path) → (cases, the
    anchor of each GT whose IoU with it is exactly 0.5)."""
    from bdd100k_tpu_torch.ops import boxes as box_ops

    m = MATCH_M
    corners = box_ops.center_to_corner(anchors.cpu()).numpy()

    def random_gt():
        gtb = np.zeros((b, m, 4), np.float32)
        gtl = np.zeros((b, m), np.int32)
        gtm = np.zeros((b, m), bool)
        for i in range(b):
            n = rng.randint(1, m)
            cxy = rng.uniform(0.05, 0.95, (n, 2))
            wh = rng.uniform(0.01, 0.6, (n, 2))
            gtb[i, :n] = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
            gtl[i, :n] = rng.randint(1, 11, n)
            gtm[i, :n] = True
            gtb[i, n:] = rng.rand(m - n, 4)        # padding holds garbage
            gtl[i, n:] = rng.randint(1, 11, m - n)
        return gtb, gtl, gtm

    cases = [("random", *random_gt())]
    gtb, gtl, gtm = random_gt()
    gtb[:, 1], gtm[:, :2] = gtb[:, 0], True       # two GTs, one box
    cases.append(("duplicate_claim", gtb, gtl, gtm))
    gtb, gtl, gtm = random_gt()
    gtm[::3] = False                              # images with no GT
    cases.append(("empty_images", gtb, gtl, gtm))
    gtb, gtl, gtm = random_gt()
    ids = rng.choice(len(corners), (b, 4), replace=False)
    gtb[:, :4], gtm[:, :4] = corners[ids], True   # GT = anchor: IoU ties
    cases.append(("gt_is_anchor", gtb, gtl, gtm))
    gtb, gtl, gtm = random_gt()
    half, half_anchor = [], []
    all_corners = torch.from_numpy(corners)
    for a in range(0, len(corners), 5):           # f32 IoU exactly 0.5
        x1, y1, x2, y2 = corners[a]
        gt = np.asarray([x1, y1, x2 + (x2 - x1), y2], np.float32)
        if gt[2] > 1.0:
            continue
        ious = box_ops.iou_pairwise(torch.from_numpy(gt[None]), all_corners)[0]
        # another anchor beats 0.5, so the GT's forced claim goes there and
        # anchor a is left to the threshold (IoU > 0.5, not >=)
        if float(ious[a]) == 0.5 and float(ious.max()) > 0.5:
            half.append(gt)
            half_anchor.append(a)
        if len(half) == b:
            break
    gtb[:len(half), 0], gtm[:len(half), 0] = half, True
    cases.append(("iou_half", gtb, gtl, gtm))
    gtb, gtl, gtm = random_gt()
    c = rng.uniform(0.05, 0.9, (b, m, 2)).astype(np.float32)
    gtb = np.concatenate([c, c + 0.003], -1)      # far below every anchor
    cases.append(("tiny_boxes", gtb, gtl, gtm))
    return cases, half_anchor


def matcher_edge_cases(rng, corners: np.ndarray, b: int = 8, m: int = MATCH_M):
    """(name, gt_boxes, gt_labels, gt_mask) numpy cases against one anchor
    set (its corners given): random padded GT; a zero-area GT, whose best
    anchor is anchor 0 (`no_overlap`); a GT over the whole image, which no
    warp can cull; M = 1; one valid GT, the last index."""
    def random_gt(rows):
        gtb = np.zeros((b, rows, 4), np.float32)
        gtl = rng.randint(1, 11, (b, rows)).astype(np.int32)
        gtm = np.zeros((b, rows), bool)
        for i in range(b):
            n = rng.randint(1, rows + 1)
            cxy = rng.uniform(0.05, 0.95, (n, 2))
            wh = rng.uniform(0.01, 0.6, (n, 2))
            gtb[i, :n] = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 1)
            gtm[i, :n] = True
            gtb[i, n:] = rng.rand(rows - n, 4)
        return gtb, gtl, gtm

    cases = [("random", *random_gt(m))]
    gtb, gtl, gtm = random_gt(m)
    last = gtm.sum(1) - 1                       # each image's last valid GT
    gtb[np.arange(b), last] = [0.5, 0.5, 0.5, 0.5]
    cases.append(("no_overlap", gtb, gtl, gtm))
    gtb, gtl, gtm = random_gt(m)
    gtb[:, 0], gtm[:, 0] = [0.0, 0.0, 1.0, 1.0], True
    cases.append(("whole_image", gtb, gtl, gtm))
    gtb, gtl, gtm = random_gt(1)
    gtm[::4] = False                            # some images with no GT
    cases.append(("m1", gtb, gtl, gtm))
    gtb, gtl, gtm = random_gt(m)
    gtm[:] = False
    gtm[:, m - 1] = True
    gtb[:, m - 1] = corners[rng.choice(len(corners), b)] * np.float32(1.5) - 0.1
    cases.append(("single_gt_last_index", np.clip(gtb, 0, 1), gtl, gtm))
    return cases


def matcher_bound_ms(gtm: np.ndarray, a: int) -> tuple[float, str, float, float]:
    """The IoUs this data needs (real GT rows × anchors, ~16 f32 ops each
    with the divide) against the bytes: GT in (21 B a row), anchors in,
    per anchor 8 + 1 + 8 + 16 bytes out → (bound, what bounds it, the
    bytes bound, the operations bound)."""
    real = int(gtm.sum())
    ops = real * a * 16
    nbytes = gtm.size * 21 + a * 16 + gtm.shape[0] * a * 33
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def matcher_call(torch, matcher, args):
    """One kernel call, held to one launch."""
    launched = matcher.LAUNCHES["encode_targets"]
    got = matcher.encode_targets_cuda(*args)
    if matcher.LAUNCHES["encode_targets"] - launched != 1:
        raise AssertionError("a matcher call is not one launch")
    return got


def check_match(torch, got, want, what: str) -> float:
    """Discrete outputs bit-equal, loc within rtol 1e-5, atol 1e-6 →
    loc max|Δ|."""
    for field in ("matched_gt", "positive", "cls_targets"):
        bad = int((getattr(got, field) != getattr(want, field)).sum())
        if bad:
            raise AssertionError(f"matcher {field} differs at {bad} anchors, {what}")
    if not torch.allclose(got.loc_targets, want.loc_targets, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"matcher loc_targets beyond rtol 1e-5, atol 1e-6, {what}")
    return float((got.loc_targets - want.loc_targets).abs().max())


def hold_matcher_cases(torch, matcher, matching, anchors, rng, b: int):
    """`matcher_cases` at batch b through the kernel, one launch each,
    held to the oracle → (cases, the IoU-0.5 GTs' anchors, how many of
    those the oracle leaves negative, loc max|Δ|); raises when none is."""
    cases, half_anchor = matcher_cases(torch, anchors, rng, b)
    loc_err = 0.0
    half_negative = 0
    for name, gtb, gtl, gtm in cases:
        args = [torch.from_numpy(a).cuda() for a in (gtb, gtl, gtm)] + [anchors]
        got = matcher_call(torch, matcher, args)
        want = matching.encode_targets(*args)
        torch.cuda.synchronize()
        if name == "iou_half":
            # anchors the oracle leaves negative at IoU exactly 0.5: only
            # the strict threshold decides them
            half_negative = int(sum(not bool(want.positive[i, a])
                                    for i, a in enumerate(half_anchor)))
        loc_err = max(loc_err, check_match(torch, got, want, f"case {name}, B={b}"))
    if half_negative == 0:
        raise AssertionError("no anchor at IoU exactly 0.5 is left to the threshold")
    return cases, half_anchor, half_negative, loc_err


def hold_matcher_edges(torch, matcher, matching, sets: dict, rng, b: int = 8):
    """`matcher_edge_cases` at batch b against each named anchor set,
    through the kernel, held to the oracle → (case names, each set's A and
    plan, loc max|Δ|)."""
    from bdd100k_tpu_torch.ops import boxes as box_ops

    loc_err = 0.0
    edges, names = {}, []
    for set_name, anc in sets.items():
        corners = box_ops.center_to_corner(anc.cpu()).numpy()
        for name, gtb, gtl, gtm in matcher_edge_cases(rng, corners, b=b):
            names.append(f"{set_name} {name}")
            args = [torch.from_numpy(a).cuda() for a in (gtb, gtl, gtm)] + [anc]
            got = matcher_call(torch, matcher, args)
            want = matching.encode_targets(*args)
            loc_err = max(loc_err, check_match(torch, got, want, f"{set_name} {name}"))
            if name == "no_overlap" and not bool(
                    (want.matched_gt[:, 0].cpu().numpy() == gtm.sum(1) - 1).all()):
                raise AssertionError("a zero-area GT did not take anchor 0")
        edges[set_name] = dict(A=int(anc.shape[0]), plan=matcher._plan(
            int(anc.shape[0]), MATCH_M)._asdict())
    return names, edges, loc_err


def phase_kernel_matcher(torch, matcher, matching, anchors) -> dict:
    from bdd100k_tpu_torch.configs import tiny_test_config
    from bdd100k_tpu_torch.ops.anchors import SSD512_FEATURE_MAPS, ssd_anchors

    cases, half_anchor, half_negative, loc_err = hold_matcher_cases(
        torch, matcher, matching, anchors, np.random.RandomState(0), MATCH_B)
    # the edge cases against SSD300's, SSD512's and ssd_tiny_64's anchors
    sets = {"ssd300": anchors, "ssd512": ssd_anchors(SSD512_FEATURE_MAPS).cuda(),
            "ssd_tiny_64": ssd_anchors(tiny_test_config("ssd").feature_maps).cuda()}
    names, edges, edge_err = hold_matcher_edges(torch, matcher, matching, sets,
                                                np.random.RandomState(1))
    loc_err = max(loc_err, edge_err)
    emit("kernel_matcher_edges", cases=names, anchor_sets=edges,
         discrete_outputs_bit_equal=True, launches_per_call=1)
    name, gtb, gtl, gtm = cases[0]
    args = [torch.from_numpy(a).cuda() for a in (gtb, gtl, gtm)] + [anchors]
    first, again = matcher_call(torch, matcher, args), matcher_call(torch, matcher, args)
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError("two matcher calls differ")
    ms = time_ms(torch, lambda: matcher.encode_targets_cuda(*args))
    plain_ms = time_ms(torch, lambda: matching.encode_targets(*args))
    bound, by, bytes_ms, ops_ms = matcher_bound_ms(gtm, anchors.shape[0])
    a512 = sets["ssd512"]
    args512 = [torch.from_numpy(a).cuda() for a in (gtb, gtl, gtm)] + [a512]
    ms512 = time_ms(torch, lambda: matcher.encode_targets_cuda(*args512))
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               max_abs_err=loc_err)
    emit("kernel_matcher", B=MATCH_B, M=MATCH_M, A=int(anchors.shape[0]),
         cases=[c[0] for c in cases], iou_half_gts=len(half_anchor),
         iou_half_left_negative=half_negative,
         discrete_outputs_bit_equal=True, loc_tolerance="rtol 1e-5, atol 1e-6",
         loc_max_abs_err=loc_err, real_gt_rows_timed=int(gtm.sum()),
         two_calls_bit_equal=True, launches_per_call=1,
         plan=matcher._plan(int(anchors.shape[0]), MATCH_M)._asdict(),
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
         bytes_bound_ms=bytes_ms, operations_bound_ms=ops_ms,
         ssd512_A=int(a512.shape[0]), ssd512_kernel_ms=ms512,
         ssd512_bound_ms=matcher_bound_ms(gtm, a512.shape[0])[0])
    return out


def phase_launch_floor(torch) -> float:
    """A one-element in-place add through `time_ms`: the least a graph
    node costs on this card, the floor under every one-launch kernel."""
    one = torch.zeros(1, device="cuda")
    ms = time_ms(torch, lambda: one.add_(1.0))
    emit("launch_floor", op="one-element in-place add", ms=ms)
    return ms


# ----------------------------------------------------------------- path


def confident_agree(a, b, n: int, thr: float = 0.3, tol: float = 1e-3) -> None:
    """Every detection of `a` above `thr` has a detection of `b` with the
    same class, box and score within `tol`."""
    for i in range(n):
        for j in np.flatnonzero(a.valid[i] & (a.scores[i] > thr)):
            m = ((b.classes[i] == a.classes[i, j]) & b.valid[i]
                 & (np.abs(b.boxes[i] - a.boxes[i, j]).max(-1) < tol)
                 & (np.abs(b.scores[i] - a.scores[i, j]) < tol))
            if not m.any():
                raise AssertionError(f"image {i}: detection {j} "
                                     f"(class {a.classes[i, j]}, score "
                                     f"{a.scores[i, j]:.4f}) has no match")


def dw_layers(config: str) -> int:
    """Depthwise kernel launches in one forward: the nine stride-1 layers
    of MobileNet; VGG16 has none."""
    return 0 if config == VGG_CONFIG else 9


def phase_path_f32(torch, infer, nms, dw, frames, config=CONFIG, artifact=ARTIFACT,
                   phase="path_f32", batch=8) -> list:
    """The serving path in f32 on the card against the same port on the
    CPU: logits within 2e-3, confident detections agreeing both ways, the
    config's depthwise launches and 1 NMS launch a batch, and NMS's keep
    masks on the path's own candidates equal to the plain greedy's → those
    candidates."""
    pred = infer.load_predictor(config, artifact, batch_size=batch, device="cuda",
                                dtype=torch.float32)
    cpu = infer.load_predictor(config, artifact, batch_size=batch, device="cpu",
                               dtype=torch.float32)
    batches = [frames[i:i + batch] for i in range(0, len(frames), batch)]
    # record what the path hands the suppression: `batched_class_nms` looks
    # `greedy_suppress` up as a module global, so this wrapper sits on the
    # real path and changes nothing in the package
    captures, dets = [], []
    suppress = nms.greedy_suppress

    def recording_suppress(boxes, valid, iou_threshold):
        keep = suppress(boxes, valid, iou_threshold)
        captures.append(dict(boxes=boxes, valid=valid, keep=keep,
                             iou_threshold=iou_threshold))
        return keep

    nms.LAUNCHES["greedy_suppress"] = 0
    dw.LAUNCHES["depthwise3x3_s1"] = 0
    nms.greedy_suppress = recording_suppress
    try:
        for fb in batches:
            det, n = pred.dispatch(fb)
            dets.append(pred.fetch(det, n))
    finally:
        nms.greedy_suppress = suppress
    launches = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                    depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
    if launches != dict(greedy_suppress=len(batches),
                        depthwise3x3_s1=dw_layers(config) * len(batches)):
        raise AssertionError(f"{phase} launches {launches} for {len(batches)} batches")
    # the NMS kernel inside the real path: its keep mask equals the plain
    # greedy on a CPU copy of the inputs the path handed it
    if len(captures) != len(batches):
        raise AssertionError(f"{len(captures)} suppressions for {len(batches)} batches")
    for cap in captures:
        want = nms.greedy_keep_mask(cap["boxes"].cpu(), cap["valid"].cpu(),
                                    cap["iou_threshold"])
        if not torch.equal(cap["keep"].cpu(), want):
            raise AssertionError("path NMS keep mask differs from the plain greedy")
    # logits against the same port on the CPU (cuDNN's and the CPU's f32
    # summation orders differ; TF32 is off)
    max_err = 0.0
    for fb in batches:
        with torch.inference_mode():
            loc, cls = pred.logits(fb)
            rloc, rcls = cpu.logits(fb)
        max_err = max(max_err, float((loc.cpu() - rloc).abs().max()),
                      float((cls.cpu() - rcls).abs().max()))
        if not (torch.isfinite(loc).all() and torch.isfinite(cls).all()):
            raise AssertionError("non-finite logits")
    if max_err > 2e-3:
        raise AssertionError(f"f32 logits differ from the CPU by {max_err}")
    for fb, det in zip(batches, dets):
        ref = cpu(fb)
        assert det.boxes.shape == (len(fb), 200, 4) and np.isfinite(det.boxes).all()
        confident_agree(det, ref, len(fb))
        confident_agree(ref, det, len(fb), thr=0.31)
    emit(phase, config=config, weights=artifact.name, frames=len(frames),
         frame_shape=list(frames.shape[1:]), batches=len(batches), launches=launches,
         nms_keep_bits_equal_in_path=True, logits_max_abs_err_vs_cpu=max_err,
         logits_atol=2e-3, confident_detections_agree=True)
    return captures


SERVE_REQUESTS = 256  # per batch size, after warm-up: a window of seconds
SERVE_WARMUP = 10


def latency_stats(lat_ms: list[float], wall_s: list[float], bs: int) -> dict:
    """Percentiles of one batch size's request latencies, its throughput
    over the whole window, and the throughput of each quarter of the window
    (the spread within this run)."""
    q = len(lat_ms) // 4
    quarters = [bs * q / sum(wall_s[i * q:(i + 1) * q]) for i in range(4)]
    return dict(
        requests=len(lat_ms),
        p10_ms=float(np.percentile(lat_ms, 10)),
        p50_ms=float(np.percentile(lat_ms, 50)),
        p90_ms=float(np.percentile(lat_ms, 90)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        max_ms=float(np.max(lat_ms)),
        imgs_per_s=bs * len(lat_ms) / sum(wall_s),
        imgs_per_s_by_quarter=quarters,
    )


def phase_path_bf16(torch, infer, nms, dw, map_metric, frames, gt_boxes, gt_labels,
                    config=CONFIG, artifact=ARTIFACT, phase="path_bf16"):
    """The serving main path in bf16: SERVE_REQUESTS requests at b1 and at
    b8 after SERVE_WARMUP, each through `Predictor.__call__` → (launches,
    latency stats)."""
    preds = {bs: infer.load_predictor(config, artifact, batch_size=bs, device="cuda")
             for bs in (1, 8)}
    requests = {bs: [np.take(frames, range(bs * r, bs * r + bs), axis=0, mode="wrap")
                     for r in range(SERVE_REQUESTS)]
                for bs in (1, 8)}
    for bs, p in preds.items():  # warm-up, outside the counted run
        for r in requests[bs][:SERVE_WARMUP]:
            p(r)
    torch.cuda.synchronize()
    # the main path: counts to 0 just before, read just after
    nms.LAUNCHES["greedy_suppress"] = 0
    dw.LAUNCHES["depthwise3x3_s1"] = 0
    lat, outs = {1: [], 8: []}, {1: [], 8: []}
    for bs, p in preds.items():
        for r in requests[bs]:
            t0 = time.perf_counter()
            outs[bs].append(p(r))  # ends in the copy back: a sync
            lat[bs].append((time.perf_counter() - t0) * 1e3)
    launches = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                    depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
    n_req = sum(len(v) for v in requests.values())
    if launches != dict(greedy_suppress=n_req, depthwise3x3_s1=9 * n_req):
        raise AssertionError(f"{phase} launches {launches} for {n_req} requests")
    for bs in (1, 8):
        for det, r in zip(outs[bs], requests[bs]):
            if det.boxes.shape != (len(r), 200, 4) or not np.isfinite(det.boxes).all():
                raise AssertionError("bad detections")
            if not det.valid.any():
                raise AssertionError("a request came back with no detections")
    ev = map_metric.DetectionEvaluator(num_classes=10)
    dets8 = outs[8][:2]  # requests 0 and 1 cover the 16 scenes in order
    for d, base in zip(dets8, (0, 8)):
        for i in range(8):
            ev.add_image(d.boxes[i], d.scores[i], d.classes[i],
                         gt_boxes[base + i], gt_labels[base + i],
                         det_valid=d.valid[i])
    m = ev.compute(iou_threshold=0.5)
    stats = {f"b{bs}": latency_stats(lat[bs], [t / 1e3 for t in lat[bs]], bs)
             for bs in (1, 8)}
    emit(phase, config=config, weights=artifact.name, launches=launches,
         map50_16_scenes=float(m["mAP"]),
         frame="720x1280 uint8 rgb", warmup_requests=SERVE_WARMUP, **stats)
    return launches, stats


PRUNE_M = 2048  # the reference's flagship setting (bdd100k_tpu/ops/postprocess.py:56)


def preselect_pruned(torch, nms, boxes, scores, score_threshold, k):
    """The reference's anchor-pruned preselect (bdd100k_tpu/ops/nms.py:310),
    which the port does not carry: the top-M anchors by best score first,
    then the per-class sort over those, exact when the M-th best is 0 in
    every image — a guard read on the host. Here only to be timed."""
    zeroed = torch.where(scores > score_threshold, scores, 0.0)
    top_m, anchor_idx = torch.topk(zeroed.amax(dim=-1), PRUNE_M, dim=-1)
    if not bool((top_m[:, -1] <= 0.0).all()):
        return nms._preselect_candidates(boxes, zeroed, 0.0, k), False
    anchor_idx = torch.sort(anchor_idx, dim=-1).values
    ps = torch.gather(zeroed, 1, anchor_idx[..., None].expand(-1, -1, zeroed.shape[-1]))
    top, pos = nms._sorted_desc(ps.transpose(1, 2))
    top, pos = top[..., :k], pos[..., :k]
    ids = torch.gather(anchor_idx[:, None, :].expand(-1, pos.shape[1], -1), -1, pos)
    return (nms._gather_boxes(boxes, ids), top, top > 0.0), True


def phase_preselect(torch, infer, nms, frames) -> None:
    """The port's dense preselect (one stable sort of every anchor per
    (image, class)) against the reference's anchor-pruned one, on the
    path's own bf16 scores at b1 and b8. Each call is timed on the host
    clock through a device sync, as a request sees it."""
    from bdd100k_tpu_torch.ops import boxes as box_ops
    from bdd100k_tpu_torch.ops.postprocess import compute_scores

    out = {}
    for bs in (1, 8):
        p = infer.load_predictor(CONFIG, ARTIFACT, batch_size=bs, device="cuda")
        cfg = p.bundle.config.postprocess
        with torch.inference_mode():
            loc, cls = p.logits(frames[:bs])
            boxes = box_ops.clip_boxes(box_ops.decode_boxes(
                loc.float(), p.bundle.anchors, cfg.variances))
            scores = compute_scores(cls.float(), cfg.score_mode)
            thr, k = cfg.score_threshold, cfg.per_class_topk
            routes = {
                "dense": lambda: (nms._preselect_candidates(boxes, scores, thr, k),
                                  None),
                "pruned": lambda: preselect_pruned(torch, nms, boxes, scores, thr, k),
            }
            row, results = {}, {}
            for route, call in routes.items():
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
                times = []
                for _ in range(100):
                    t0 = time.perf_counter()
                    results[route] = call()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                row[f"{route}_p50_ms"] = float(np.median(times))
                row[f"{route}_p90_ms"] = float(np.percentile(times, 90))
            (d, _), (q, guard) = results["dense"], results["pruned"]
            if not (torch.equal(d[1], q[1]) and torch.equal(d[2], q[2])):
                raise AssertionError("pruned and dense preselects disagree")
        out[f"b{bs}"] = dict(row, pruned_guard_held=guard)
    emit("preselect", **out)


# ------------------------------------------------------------ eval: JPEG → mAP

SYNTH_DIR = ROOT / "tests" / "fixtures" / "synth_val_seed1"
EVAL_FIXTURE = ROOT / "tests" / "fixtures" / "torch_ref_eval_synth9k.npz"
EVAL_SCENES = 64
DECODE_PASSES = 10
EVAL_F32_MAP_TOL = 0.002   # the decode route alone moves the reference by this
EVAL_BF16_MAP_TOL = 0.01   # bf16 against the f32 fixture
# what the reference's run_eval writes to --out with --coco_map
EVAL_OUT_KEYS = {"mAP", "per_class", "coco", "images_per_sec", "num_images"}


def phase_probe_host() -> int:
    """Facts about the host, for the JPEG decode: cores, the C++ compiler,
    libjpeg's header and library, the toolkit's nvJPEG. Passes whatever it
    finds → the core count the decode pool uses."""
    import glob
    import os
    import re
    import shutil

    def run(cmd):
        try:
            return subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=60).stdout
        except OSError as e:
            return f"({e})"

    include = ["/usr/include", "/usr/include/x86_64-linux-gnu", "/usr/local/include"]
    libdirs = ["/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib64",
               "/usr/local/lib"]
    jconfig = [p for d in include for p in glob.glob(f"{d}/jconfig.h")]
    version = None
    for p in jconfig:
        m = re.search(r"#define\s+JPEG_LIB_VERSION\s+(\d+)", Path(p).read_text())
        version = version or (m and int(m.group(1)))
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nproc = len(os.sched_getaffinity(0))
    emit("probe_host", nproc=nproc, cpu_count=os.cpu_count(),
         gxx=(run(["g++", "--version"]).splitlines() or [None])[0]
         if shutil.which("g++") else None,
         jpeglib_h=[d for d in include if Path(d, "jpeglib.h").exists()],
         jconfig_h=jconfig, jpeg_lib_version=version,
         libjpeg_so=sorted(p for d in libdirs for p in glob.glob(f"{d}/libjpeg.so*")),
         ldconfig_jpeg=[l.strip() for l in run(["ldconfig", "-p"]).splitlines()
                        if "jpeg" in l],
         nvjpeg_so=sorted(glob.glob(f"{cuda}/lib64/libnvjpeg.so*")),
         nvjpeg_h=Path(cuda, "include", "nvjpeg.h").exists(),
         decode_route="native/decode_pool.cc linked with the port's own "
                      "decoder bdd100k_tpu_torch/csrc/jpeg (libjpeg-turbo's "
                      "integer arithmetic), built by g++; no system libjpeg")
    return nproc


def phase_decode(nproc: int) -> float:
    """Build the decode pool and decode the 64 committed JPEGs to 300²,
    held to the sha256 of the reference's decode in the fixture (and to
    the first four images' pixels) → the pool's imgs/s with `nproc`
    workers over DECODE_PASSES passes."""
    from bdd100k_tpu_torch.data.native_decode import NativeDecoder
    from bdd100k_tpu_torch.utils import host_build

    import hashlib

    t0 = time.perf_counter()
    lib = host_build.build()
    build_s = time.perf_counter() - t0
    ref = np.load(EVAL_FIXTURE)
    names = [r["name"] for r in
             json.loads((SYNTH_DIR / "labels" / "val.json").read_text())]
    jpegs = [(SYNTH_DIR / "images" / "val" / n).read_bytes() for n in names]
    dec = NativeDecoder(nproc)
    try:
        images = dec.decode_batch(jpegs, 300)
        digests = [hashlib.sha256(im.tobytes()).hexdigest() for im in images]
        match = sum(d == w.decode() for d, w in zip(digests, ref["image_sha256"]))
        err4 = int(np.abs(images[:4].astype(int) - ref["images_first4"]).max())
        t0 = time.perf_counter()
        for _ in range(DECODE_PASSES):
            dec.decode_batch(jpegs, 300)
        rate = DECODE_PASSES * len(jpegs) / (time.perf_counter() - t0)
    finally:
        dec.close()
    emit("decode", library=str(lib.relative_to(ROOT)), build_s=build_s,
         jpegs=len(jpegs), size=300, sha256_match_reference=f"{match}/{len(jpegs)}",
         first4_max_abs_diff=err4, workers=nproc, passes=DECODE_PASSES,
         imgs_per_s=rate)
    if match != len(jpegs) or err4:
        raise AssertionError(f"decode differs from the reference's: {match}/"
                             f"{len(jpegs)} images equal, first four max|Δ| {err4}")
    return rate


def load_fixture(pair: str | None = None, path: Path = EVAL_FIXTURE) -> dict:
    """An eval fixture (SSD300's by default), or one YOLO artifact/priors
    pair's part of the YOLO-384 fixture, as a dict of arrays."""
    if pair is None:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    with np.load(YOLO_EVAL_FIXTURE) as z:
        return {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(pair + "/")}


def fixture_detections(ref: dict):
    return types.SimpleNamespace(boxes=ref["boxes"], scores=ref["scores"],
                                 classes=ref["classes"], valid=ref["valid"])


def eval_config(config: str, priors: Path | None):
    from bdd100k_tpu_torch.configs import apply_yolo_priors, get_config

    cfg = get_config(config)
    return apply_yolo_priors(cfg, priors) if priors else cfg


def phase_eval_f32(torch, nms, dw, nproc: int, decode_rate: float,
                   config=CONFIG, artifact=ARTIFACT, priors=None, pair=None,
                   phase="eval_f32", fixture=EVAL_FIXTURE,
                   keep_captures=False) -> dict:
    """`run_eval` on the card in f32 (TF32 off) over the 64 JPEGs at b32,
    decoded at the config's image size, through its kernels, against the
    JAX f32 fixture: confident detections agree both ways and mAP@0.5
    within EVAL_F32_MAP_TOL; the depthwise kernel runs the config's layers
    a batch and NMS once; NMS's keep masks on the path's own candidates
    equal the plain greedy's → the NMS timing on the first batch's
    candidates, the launches, the mAP (and, with `keep_captures`, the
    candidates of every batch)."""
    from bdd100k_tpu_torch import evaluate
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.utils.weights import restore_eval_weights

    cfg = eval_config(config, priors)
    bundle = build_detector(cfg, dtype=torch.float32, device="cuda")
    restore_eval_weights(bundle.model, artifact, expect_config=config)
    dataset = evaluate.load_dataset(types.SimpleNamespace(
        synthetic=EVAL_SCENES, synthetic_dir=str(SYNTH_DIR), max_boxes=100),
        cfg.image_size)
    args = types.SimpleNamespace(batch_size=EVAL_BATCH, num_workers=nproc,
                                 wire="rgb", iou_threshold=0.5, coco_map=True,
                                 dump_detections=None)
    # record the detections leaving the eval step and what the path hands
    # the suppression; both are looked up as module globals, so the
    # wrappers sit on the real path and change nothing in the package
    dets, captures = [], []
    make_step, suppress = evaluate.make_eval_step, nms.greedy_suppress

    def recording_step(b):
        step = make_step(b)

        def run(images):
            dets.append(step(images))
            return dets[-1]

        return run

    def recording_suppress(boxes, valid, iou_threshold):
        keep = suppress(boxes, valid, iou_threshold)
        captures.append(dict(boxes=boxes, valid=valid, keep=keep,
                             iou_threshold=iou_threshold))
        return keep

    torch.cuda.synchronize()
    nms.LAUNCHES["greedy_suppress"] = 0
    dw.LAUNCHES["depthwise3x3_s1"] = 0
    evaluate.make_eval_step, nms.greedy_suppress = recording_step, recording_suppress
    try:
        result = evaluate.run_eval(bundle, dataset, args)
    finally:
        evaluate.make_eval_step, nms.greedy_suppress = make_step, suppress
    launches = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                    depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
    batches = -(-EVAL_SCENES // EVAL_BATCH)
    if launches != dict(greedy_suppress=batches,
                        depthwise3x3_s1=dw_layers(config) * batches):
        raise AssertionError(f"{phase} launches {launches} for {batches} batches")
    for cap in captures:
        want = nms.greedy_keep_mask(cap["boxes"].cpu(), cap["valid"].cpu(),
                                    cap["iou_threshold"])
        if not torch.equal(cap["keep"].cpu(), want):
            raise AssertionError("eval NMS keep mask differs from the plain greedy")
    det = types.SimpleNamespace(**{
        f: torch.cat([getattr(d, f) for d in dets]).cpu().numpy()[:EVAL_SCENES]
        for f in ("boxes", "scores", "classes", "valid")})
    ref = load_fixture(pair, fixture)
    want = fixture_detections(ref)
    if det.boxes.shape != (EVAL_SCENES, 200, 4) or not np.isfinite(det.boxes).all():
        raise AssertionError("bad eval detections")
    confident_agree(want, det, EVAL_SCENES)
    confident_agree(det, want, EVAL_SCENES, thr=0.31)
    map_diff = result["mAP"] - float(ref["map50"])
    cap = captures[0]
    bx, vd, thr = cap["boxes"], cap["valid"], cap["iou_threshold"]
    b, c, k = vd.shape
    bound, by = nms_bound_ms(b, c, k)
    nms_path = dict(B=b, C=c, K=k, valid=int(vd.sum()), kept=int(cap["keep"].sum()),
                    kernel_ms=time_ms(torch, lambda: nms.greedy_suppress_cuda(bx, vd, thr)),
                    plain_ms=time_ms(torch, lambda: nms.greedy_keep_mask(bx, vd, thr)),
                    bound_ms=bound, bound_by=by)
    emit(phase, config=config, weights=artifact.name,
         priors=priors.name if priors else "config default",
         decode_size=cfg.image_size, scenes=EVAL_SCENES, batch=EVAL_BATCH,
         batches=batches, launches=launches, map50=result["mAP"],
         fixture_map50=float(ref["map50"]),
         map50_diff=map_diff, map50_tol=EVAL_F32_MAP_TOL,
         coco_map=result["coco"]["mAP"], fixture_coco_map=float(ref["coco_map"]),
         confident_detections_agree=True, nms_keep_bits_equal_in_path=True,
         nms_on_eval_candidates=nms_path,
         images_per_sec=result["images_per_sec"], decode_imgs_per_s=decode_rate)
    if not abs(map_diff) <= EVAL_F32_MAP_TOL:
        raise AssertionError(f"{phase} mAP {result['mAP']} is {map_diff} from the "
                             f"fixture's {float(ref['map50'])}")
    out = dict(nms_path, launches=launches, map50=result["mAP"])
    return dict(out, captures=captures) if keep_captures else out


def run_quietly(fn, argv, log_path: Path):
    """`fn(argv)` with its stdout kept in a file → (its result, the stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    log_path.write_text(buf.getvalue())
    return result, buf.getvalue()


def phase_eval_bf16(torch, nms, dw, decode_rate: float, config=CONFIG,
                    artifact=ARTIFACT, priors=None, pair=None,
                    phase="eval_bf16", fixture=EVAL_FIXTURE) -> dict:
    """The eval main path: `python -m bdd100k_tpu_torch.evaluate` as a
    user types it, in bf16 on the card: mAP@0.5 within EVAL_BF16_MAP_TOL
    of the f32 fixture, the dump and --out written."""
    import os

    from bdd100k_tpu_torch import evaluate

    out_dir = RUNS / phase
    out_dir.mkdir(parents=True, exist_ok=True)
    dump, out = out_dir / "detections.json", out_dir / "result.json"
    argv = ["--config", config, "--synthetic", str(EVAL_SCENES),
            "--synthetic_dir", os.path.relpath(SYNTH_DIR),
            "--ckpt_dir", os.path.relpath(artifact),
            "--batch_size", str(EVAL_BATCH), "--coco_map",
            "--dump_detections", os.path.relpath(dump), "--out", os.path.relpath(out)]
    if priors:
        argv += ["--yolo_priors", os.path.relpath(priors)]
    torch.cuda.synchronize()
    # the main path: counts to 0 just before, read just after
    nms.LAUNCHES["greedy_suppress"] = 0
    dw.LAUNCHES["depthwise3x3_s1"] = 0
    t0 = time.perf_counter()
    result, _ = run_quietly(evaluate.main, argv, RUNS / f"{phase}_stdout.txt")
    wall = time.perf_counter() - t0
    launches = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                    depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
    batches = -(-EVAL_SCENES // EVAL_BATCH)
    if launches != dict(greedy_suppress=batches,
                        depthwise3x3_s1=dw_layers(config) * batches):
        raise AssertionError(f"{phase} launches {launches} for {batches} batches")
    ref = load_fixture(pair, fixture)
    entries = json.loads(dump.read_text())
    saved = json.loads(out.read_text())
    map_diff = result["mAP"] - float(ref["map50"])
    emit(phase, command="python -m bdd100k_tpu_torch.evaluate " + " ".join(argv),
         launches=launches, map50=result["mAP"], map50_diff_vs_f32_fixture=map_diff,
         map50_tol=EVAL_BF16_MAP_TOL, coco_map=result["coco"]["mAP"],
         images_per_sec=result["images_per_sec"], decode_imgs_per_s=decode_rate,
         wall_s=wall, dump_entries=len(entries), out_keys=sorted(saved))
    if not abs(map_diff) <= EVAL_BF16_MAP_TOL:
        raise AssertionError(f"{phase} mAP {result['mAP']} is {map_diff} from the "
                             f"f32 fixture's {float(ref['map50'])}")
    if len(entries) != EVAL_SCENES or not EVAL_OUT_KEYS <= set(saved):
        raise AssertionError(f"dump holds {len(entries)} images; --out keys "
                             f"{sorted(saved)}")
    return dict(launches=launches, map50=result["mAP"],
                images_per_sec=result["images_per_sec"], wall_s=wall)


EVAL_REPEAT = 8  # the 64 scenes 8 times over: 16 batches, 15 of them timed


def phase_eval_throughput(torch, nproc: int, decode_rate: float) -> dict:
    """The eval's steady state: `run_eval` in bf16 over the 64 scenes
    EVAL_REPEAT times over, without the dump or COCO, on each wire, beside
    the decode pool's own rate (the pool decodes each batch on the loader's
    thread while the card runs the one before)."""
    from bdd100k_tpu_torch import evaluate
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.utils.weights import restore_eval_weights

    bundle = build_detector(get_config(CONFIG), device="cuda")
    restore_eval_weights(bundle.model, ARTIFACT, expect_config=CONFIG)
    dataset = evaluate.load_dataset(types.SimpleNamespace(
        synthetic=EVAL_SCENES, synthetic_dir=str(SYNTH_DIR), max_boxes=100), 300)
    dataset.records = dataset.records * EVAL_REPEAT
    out = {}
    for wire in ("rgb", "yuv420"):
        args = types.SimpleNamespace(batch_size=EVAL_BATCH, num_workers=nproc,
                                     wire=wire, iou_threshold=0.5, coco_map=False,
                                     dump_detections=None)
        t0 = time.perf_counter()
        result = evaluate.run_eval(bundle, dataset, args)
        out[wire] = dict(images_per_sec=result["images_per_sec"], map50=result["mAP"],
                         wall_s=time.perf_counter() - t0)
        if result["num_images"] != len(dataset) or not np.isfinite(result["mAP"]):
            raise AssertionError(f"eval_throughput on {wire}: {result}")
    emit("eval_throughput", images=len(dataset), batch=EVAL_BATCH,
         timed_batches=len(dataset) // EVAL_BATCH - 1, dtype="bf16",
         decode_imgs_per_s=decode_rate, decode_workers=nproc, **out)
    return out


def phase_eval_own_ckpt(torch) -> None:
    """The trainer's own run directory (train_bf16's, 40 steps with an EMA
    shadow) evaluated through `restore_eval_weights`, its params and its
    EMA shadow: finite mAPs (40 steps from init learn little)."""
    import os

    from bdd100k_tpu_torch import evaluate

    run_dir = RUNS / "train"
    maps = {}
    for name, extra in (("params", []), ("ema", ["--ema"])):
        argv = ["--ckpt_dir", os.path.relpath(run_dir), "--synthetic", str(EVAL_SCENES),
                "--synthetic_dir", os.path.relpath(SYNTH_DIR),
                "--batch_size", str(EVAL_BATCH), *extra]
        result, stdout = run_quietly(evaluate.main, argv,
                                     RUNS / f"eval_own_{name}_stdout.txt")
        if f"restored step {TRAIN_STEPS}" not in stdout:
            raise AssertionError(f"eval of the run's {name} did not restore step "
                                 f"{TRAIN_STEPS}")
        maps[name] = dict(map50=result["mAP"], images_per_sec=result["images_per_sec"],
                          num_images=result["num_images"])
        if not np.isfinite(result["mAP"]):
            raise AssertionError(f"non-finite mAP for the run's {name}")
    emit("eval_own_ckpt", run_dir=str(run_dir.relative_to(ROOT)), step=TRAIN_STEPS,
         **maps)


# ---------------------------------------------------------------- train

TRAIN_BATCH = 32
TRAIN_SCENES = 64
TRAIN_STEPS = 40
TRAIN_WARMUP = 5     # steps left out of the step times
RESUME_AT = 20
TRAIN_EMA_DECAY = 0.999  # a shadow for eval_own_ckpt to evaluate
# f32 step, card against CPU (TF32 off). At the trained weights the step
# is ill-conditioned: on the CPU alone, a 1e-6 relative perturbation of the
# input images moves the gradient (the first step's momentum buffer, clipped
# g + wd·p) by 1.5e-2 in relative L2 over all parameters and by up to
# 0.23 of one tensor's largest element (extra2.down's kernel), as BatchNorm
# outputs cross ReLU6's edges and mined negatives swap. The phase measures
# that floor again in every run, per tensor as the larger of two perturbed
# CPU steps, and holds the card to fixed bounds over all parameters and to
# a multiple of each tensor's own floor.
F32_LOSS_RTOL = 1e-5
F32_GRAD_NORM_RTOL = 1e-3
F32_GRAD_REL_L2 = 5e-2       # ‖Δbuffer‖ / ‖buffer‖ over all parameters
F32_GRAD_MEDIAN_REL = 5e-2   # median over tensors of max|Δ| / max|buffer|
F32_GRAD_TENSOR_FLOORS = 3   # per tensor: max|Δ| / max|buffer| ≤ 3·its floor,
F32_GRAD_TENSOR_MIN = 5e-3   # the floor taken as at least this
F32_STATS_REL = 1e-4         # of the largest |running stat| of each tensor
PERTURB = 1e-6


def train_batch_f32(torch, frames, boxes, labels, size, n):
    """n frames preprocessed as the eval path does (a fixed float batch,
    which the train step takes without augment) and their padded GT."""
    from bdd100k_tpu_torch.data.augment import preprocess_eval_batch
    from bdd100k_tpu_torch.data.bdd100k import pad_ground_truth

    images = preprocess_eval_batch(torch.from_numpy(frames[:n]), size)
    gt = [pad_ground_truth(b, l, 100) for b, l in zip(boxes[:n], labels[:n])]
    return [images.contiguous()] + [torch.from_numpy(np.stack([g[j] for g in gt]))
                                    for j in range(3)]


def tensor_diffs(a: dict, b: dict) -> dict[str, float]:
    """Per tensor, max|a − b| / max|b|."""
    return {k: float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30))
            for k in b}


def buffer_diff(a: dict, b: dict) -> dict:
    """How far momentum buffers `a` are from `b`: relative L2 over all
    parameters, and per tensor max|Δ| / max|b| (median and worst)."""
    per = tensor_diffs(a, b)
    fa = np.concatenate([a[k].numpy().ravel() for k in b])
    fb = np.concatenate([b[k].numpy().ravel() for k in b])
    return dict(rel_l2=float(np.linalg.norm(fa - fb) / np.linalg.norm(fb)),
                median=float(np.median(list(per.values()))),
                worst=max((r, k) for k, r in per.items()))


def phase_train_f32(torch, frames, boxes, labels, config=CONFIG, artifact=ARTIFACT,
                    batch_size=8, phase="train_f32") -> None:
    """One f32 train step at full width on the artifact's weights: on the
    card with the kernels, on the CPU with their plain versions, and twice
    more on the CPU with the images perturbed by 1e-6 (the floor)."""
    from bdd100k_tpu_torch.configs import TrainConfig, get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.parallel import train_step
    from bdd100k_tpu_torch.utils.weights import load_detector_npz

    cfg = get_config(config)
    tcfg = TrainConfig(batch_size=batch_size, warmup_steps=0, total_steps=1000)
    sd, _ = load_detector_npz(artifact, expect_config=config)
    batch = train_batch_f32(torch, frames, boxes, labels, cfg.image_size, batch_size)
    perturbed = ("cpu_perturbed_0", "cpu_perturbed_1")
    out = {}
    for run, dev in (("card", "cuda"), ("cpu", "cpu")) + tuple((r, "cpu") for r in perturbed):
        bundle = build_detector(cfg, dtype=torch.float32, device=dev)
        bundle.model.load_state_dict(sd)
        state = train_step.create_train_state(bundle, tcfg)
        step = train_step.make_train_step(bundle, device=dev)
        images = batch[0]
        if run in perturbed:
            noise = torch.randn(images.shape, generator=torch.Generator().manual_seed(
                perturbed.index(run)))
            images = images * (1 + PERTURB * noise)
        metrics = step(state, None, *[t.to(dev) for t in [images] + batch[1:]])
        out[run] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            buffers={k: state.optimizer.state[p]["momentum_buffer"].cpu()
                     for k, p in bundle.model.named_parameters()},
            stats={k: v.cpu() for k, v in bundle.model.state_dict().items()
                   if k.endswith(("running_mean", "running_var"))})
    card, cpu = out["card"], out["cpu"]
    rel = {k: abs(card["metrics"][k] / cpu["metrics"][k] - 1)
           for k in ("loss", "conf_loss", "loc_loss", "grad_norm")}
    grad = buffer_diff(card["buffers"], cpu["buffers"])
    floor = buffer_diff(out[perturbed[0]]["buffers"], cpu["buffers"])
    card_per = tensor_diffs(card["buffers"], cpu["buffers"])
    floor_per = [tensor_diffs(out[r]["buffers"], cpu["buffers"]) for r in perturbed]
    # each tensor's card difference in units of its allowed bound
    tensor_ratio = {k: d / (F32_GRAD_TENSOR_FLOORS * max(
        F32_GRAD_TENSOR_MIN, *(f[k] for f in floor_per))) for k, d in card_per.items()}
    stats = max((float((card["stats"][k] - v).abs().max() / v.abs().max()), k)
                for k, v in cpu["stats"].items())
    emit(phase, batch=batch_size, config=config, weights=artifact.name,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         card=card["metrics"], cpu=cpu["metrics"], rel_diff=rel,
         grad_card_vs_cpu=grad, grad_floor_cpu_perturbed_1e6=floor,
         grad_tensors=len(card_per),
         # [diff / bound, tensor, diff, its floor] for the five nearest their bound
         worst_tensors=[[r, k, card_per[k], max(f[k] for f in floor_per)]
                        for r, k in sorted(((r, k) for k, r in tensor_ratio.items()),
                                           reverse=True)[:5]],
         worst_running_stat_rel_diff=stats,
         tolerances=dict(loss_rtol=F32_LOSS_RTOL, grad_norm_rtol=F32_GRAD_NORM_RTOL,
                         grad_rel_l2=F32_GRAD_REL_L2,
                         grad_median_rel=F32_GRAD_MEDIAN_REL,
                         grad_tensor=f"{F32_GRAD_TENSOR_FLOORS}·max(floor, "
                                     f"{F32_GRAD_TENSOR_MIN})",
                         stats_rel=F32_STATS_REL))
    if not (max(rel["loss"], rel["conf_loss"], rel["loc_loss"]) <= F32_LOSS_RTOL
            and rel["grad_norm"] <= F32_GRAD_NORM_RTOL
            and grad["rel_l2"] <= F32_GRAD_REL_L2
            and grad["median"] <= F32_GRAD_MEDIAN_REL
            and max(tensor_ratio.values()) <= 1.0
            and stats[0] <= F32_STATS_REL):
        raise AssertionError(f"{phase}: the f32 train step on the card differs from "
                             "the CPU's")


def read_log(path: Path) -> dict[int, dict]:
    return {r["step"]: r for r in map(json.loads, path.read_text().splitlines())}


def run_trainer(train_mod, argv, log_path: Path) -> str:
    """`bdd100k_tpu_torch.train.main(argv)` with its stdout kept in a file
    (the step lines would crowd this script's output) → that stdout."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_mod.main(argv)
    log_path.write_text(buf.getvalue())
    return buf.getvalue()


def phase_train_bf16(torch, dw, matcher) -> dict:
    """The training main path: the driver at full width and batch 32 on 64
    rendered seed-0 train scenes (uint8 720p, augment on the card), 40
    steps from the seeded init with a checkpoint at step 20; then a second
    run given only that checkpoint resumes and ends at 40. The runs keep
    an EMA shadow, which `phase_eval_own_ckpt` evaluates."""
    import shutil

    from bdd100k_tpu_torch import train as train_mod

    shutil.rmtree(RUNS, ignore_errors=True)
    first, second = RUNS / "train", RUNS / "resume"
    argv = ["--config", CONFIG, "--synthetic", str(TRAIN_SCENES),
            "--batch_size", str(TRAIN_BATCH), "--total_steps", str(TRAIN_STEPS),
            "--warmup_steps", "0", "--log_every", "1",
            "--checkpoint_every", str(RESUME_AT), "--seed", "0",
            "--ema_decay", str(TRAIN_EMA_DECAY)]
    torch.cuda.synchronize()
    # the main path: counts to 0 just before, read just after
    dw.LAUNCHES.update(depthwise3x3_s1=0, depthwise3x3_s1_fgrad=0)
    matcher.LAUNCHES["encode_targets"] = 0
    t0 = time.perf_counter()
    out1 = run_trainer(train_mod, argv + ["--ckpt_dir", str(first), "--no_resume"],
                       RUNS / "train_stdout.txt")
    wall = time.perf_counter() - t0
    launches = dict(depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"],
                    depthwise3x3_s1_fgrad=dw.LAUNCHES["depthwise3x3_s1_fgrad"],
                    encode_targets=matcher.LAUNCHES["encode_targets"])
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    if per_step != dict(depthwise3x3_s1=18, depthwise3x3_s1_fgrad=9,
                        encode_targets=1):
        raise AssertionError(f"train launches per step {per_step}")
    if f"done at step {TRAIN_STEPS}" not in out1:
        raise AssertionError("the first run did not end at step 40")
    log = read_log(first / "train.jsonl")
    losses = {s: log[s]["loss"] for s in (1, 10, 20, 30, 40)}
    if not all(np.isfinite(v) for r in log.values() for v in r.values()):
        raise AssertionError("non-finite train metrics")
    t = [log[s]["t"] for s in range(1, TRAIN_STEPS + 1)]
    step_ms = [(b - a) * 1e3 for a, b in zip(t[TRAIN_WARMUP - 1:], t[TRAIN_WARMUP:])]
    imgs_per_s = TRAIN_BATCH * len(step_ms) / (sum(step_ms) / 1e3)

    second.mkdir(parents=True)
    shutil.copy(first / f"ckpt_{RESUME_AT}.pt", second)
    out2 = run_trainer(train_mod, argv + ["--ckpt_dir", str(second), "--resume"],
                       RUNS / "resume_stdout.txt")
    if f"resumed from step {RESUME_AT}" not in out2 or \
            f"done at step {TRAIN_STEPS}" not in out2:
        raise AssertionError("the resumed run did not resume at 20 and end at 40")
    log2 = read_log(second / "train.jsonl")
    if min(log2) != RESUME_AT + 1 or max(log2) != TRAIN_STEPS:
        raise AssertionError(f"the resumed run logged steps {sorted(log2)}")
    # the first resumed step sees the same weights, batch and draws as the
    # first run's step 21: its loss agrees to the card's run-to-run noise
    # (cuDNN may pick other algorithms), a different batch would move it by
    # O(1)
    step21 = abs(log2[RESUME_AT + 1]["loss"] / log[RESUME_AT + 1]["loss"] - 1)
    if step21 > 1e-2:
        raise AssertionError(f"resumed step {RESUME_AT + 1} loss differs by {step21}")
    stats = dict(p10_ms=float(np.percentile(step_ms, 10)),
                 p50_ms=float(np.percentile(step_ms, 50)),
                 p90_ms=float(np.percentile(step_ms, 90)),
                 imgs_per_s=imgs_per_s)
    emit("train_bf16", config=CONFIG, batch=TRAIN_BATCH, scenes=TRAIN_SCENES,
         steps=TRAIN_STEPS, timed_steps=len(step_ms), step_time=stats,
         loss_at=losses, launches=launches, launches_per_step=per_step,
         wall_s=wall, resumed_from=RESUME_AT,
         resumed_step21_loss_rel_diff=step21,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return dict(launches=launches, step_time=stats)


# kernel-name substrings → the layer that launched them
PROFILE_BUCKETS = (
    ("port kernels", ("dw3x3_s1", "match_encode")),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "wgrad",
                             "dgrad", "fprop", "nhwc", "nchw")),
    ("matmul", ("gemm", "cutlass", "sm90")),
    ("copy", ("memcpy", "memset", "copy")),
    ("reduction", ("reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def phase_train_profile(torch, frames, boxes, labels, config=CONFIG,
                        batch_size=TRAIN_BATCH, phase="train_profile") -> None:
    """Where a bf16 train step's device time goes: torch.profiler over 3
    steps (after 3 warm-up steps), kernel time summed by name and by the
    layer that launched it, against the window's wall time and against
    the wall time of 3 steps just before it without the profiler (which
    lengthens the steps it records)."""
    from torch.profiler import ProfilerActivity, profile

    from bdd100k_tpu_torch.configs import TrainConfig, get_config
    from bdd100k_tpu_torch.data.bdd100k import pad_ground_truth
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.parallel import train_step

    cfg = get_config(config)
    bundle = build_detector(cfg, device="cuda")
    state = train_step.create_train_state(
        bundle, TrainConfig(warmup_steps=0, total_steps=1000))
    step = train_step.make_train_step(bundle, device="cuda")
    idx = np.arange(batch_size) % len(frames)
    gt = [pad_ground_truth(boxes[i], labels[i], 100) for i in idx]
    batch = [torch.from_numpy(frames[idx]).cuda()] + [
        torch.from_numpy(np.stack([g[j] for g in gt])).cuda() for j in range(3)]
    gen = torch.Generator(device="cuda")
    for i in range(3):
        gen.manual_seed(i)
        step(state, gen, *batch)
    torch.cuda.synchronize()
    steps = 3
    t0 = time.perf_counter()
    for i in range(steps):
        gen.manual_seed(5 + i)
        step(state, gen, *batch)
    torch.cuda.synchronize()
    free_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            gen.manual_seed(10 + i)
            step(state, gen, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy = sum(v[0] for v in kernels.values())
    buckets = {name: 0.0 for name, _ in PROFILE_BUCKETS}
    buckets["other"] = 0.0
    for name, (ms, _) in kernels.items():
        low = name.lower()
        hit = next((b for b, keys in PROFILE_BUCKETS if any(k in low for k in keys)),
                   "other")
        buckets[hit] += ms / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    emit(phase, config=config, batch=batch_size, steps=steps,
         wall_ms_per_step=wall_ms / steps,
         device_kernel_ms_per_step=busy / steps,
         device_busy_share=busy / wall_ms if wall_ms else None,
         unprofiled_ms_per_step=free_ms / steps,
         device_busy_share_of_unprofiled_step=busy / free_ms if kernels else None,
         kernel_launches_per_step=sum(v[1] for v in kernels.values()) / steps,
         ms_per_step_by_layer=buckets,
         top_kernels=[dict(name=n[:90], ms_per_step=v[0] / steps,
                           launches_per_step=v[1] / steps) for n, v in top],
         note="profiler on: step times here carry its overhead; device "
              "events are CUPTI's" if kernels else "the profiler saw no "
              "device events on this machine: not measured")


def phase_overfit(torch, frames, boxes, labels) -> None:
    """tests/test_train.py's overfit check at full width on the card:
    batch 8, Adam at 5e-3, 30 steps on one batch of 720p frames, the same
    augment draws every step."""
    from bdd100k_tpu_torch.configs import TrainConfig, get_config
    from bdd100k_tpu_torch.data.bdd100k import pad_ground_truth
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.parallel import train_step

    cfg = get_config(CONFIG)
    tcfg = TrainConfig(batch_size=8, learning_rate=5e-3, warmup_steps=0,
                       total_steps=100, optimizer="adam", weight_decay=0.0)
    bundle = build_detector(cfg, device="cuda")
    state = train_step.create_train_state(bundle, tcfg)
    step = train_step.make_train_step(bundle, device="cuda")
    gt = [pad_ground_truth(b, l, 100) for b, l in zip(boxes[:8], labels[:8])]
    batch = [torch.from_numpy(frames[:8]).cuda()] + [
        torch.from_numpy(np.stack([g[j] for g in gt])).cuda() for j in range(3)]
    gen = torch.Generator(device="cuda")
    losses = []
    for _ in range(30):
        gen.manual_seed(42)
        losses.append(float(step(state, gen, *batch)["loss"]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    emit("overfit", batch=8, steps=30, optimizer="adam", lr=5e-3,
         mean_first5=first, mean_last5=last, ratio=last / first)
    if not (np.isfinite(losses).all() and last < 0.9 * first):
        raise AssertionError(f"overfit check failed: {losses}")


# ------------------------------------------------------------ YOLO-384

YOLO_CONFIG = "yolo_mobilenet_384"
# each committed YOLO artifact with the priors it was trained with
YOLO_PAIRS = {
    "synth9k": (ROOT / "artifacts" / "yolo_mobilenet_384_synth9k.npz", None),
    "synth4kds": (ROOT / "artifacts" / "yolo_mobilenet_384_synth4kds.npz",
                  ROOT / "artifacts" / "yolo_priors_synth4k.json"),
}
YOLO_EVAL_FIXTURE = ROOT / "tests" / "fixtures" / "torch_ref_eval_yolo384.npz"
# the nine stride-1 depthwise layers at 384×384, width 1.0: (layers, H = W, C)
YOLO_DW_SHAPES = (("ds1", 1, 192, 32), ("ds3", 1, 96, 128), ("ds5", 1, 48, 256),
                  ("ds7-11", 5, 24, 512), ("ds13", 1, 12, 1024))
YOLO_FWD_BATCHES = (8, EVAL_BATCH)   # serving's b8 and the eval's b32
YOLO_TRAIN_BATCH = 64                # BASELINE config 3's train step
YOLO_TRAIN_STEPS = 30
YOLO_TRAIN_SCENES = 64
YOLO_F32_BATCH = 4                   # the f32 step the CPU also runs


def phase_yolo_depthwise(torch, dw) -> dict:
    """The depthwise forward at YOLO-384's nine stride-1 layers at B=8 and
    B=32, then dx and dk at the train step's B=64, each against its plain
    version and timed beside cuDNN → bf16 totals over the nine layers."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {f"fwd_b{b}": dw_forward_layers(torch, dw, gen, YOLO_DW_SHAPES, b,
                                          f"yolo_kernel_depthwise_b{b}")
           for b in YOLO_FWD_BATCHES}
    bwd = phase_kernel_depthwise_bwd(torch, dw, YOLO_DW_SHAPES, YOLO_TRAIN_BATCH,
                                     edges=(), phase="yolo_kernel_depthwise_bwd")
    out.update(dx=bwd["dx"], dk=bwd["dk"], dk_max_abs_err=bwd["max_abs_err"],
               max_abs_err=max(t["max_abs_err"] for t in out.values()))
    return out


def phase_matcher_at(torch, matcher, matching, anchors, b: int, sets: dict,
                     phase: str) -> dict:
    """The matcher at B=b, M=100 on a family's own anchors (YOLO-384's
    9072, priors down to 0.02×0.03; VGG16-SSD512's 24564): chip_smoke's
    cases and the edge cases (zero-area, whole-image, M = 1 and last-index
    GTs) on each anchor set of `sets`, discrete outputs bit-equal to the
    oracle, one launch a call; timed beside the oracle, with its plan."""
    from bdd100k_tpu_torch.ops import boxes as box_ops

    rng = np.random.RandomState(3)
    cases, half_anchor, half_negative, loc_err = hold_matcher_cases(
        torch, matcher, matching, anchors, rng, b)
    names, _, edge_err = hold_matcher_edges(torch, matcher, matching, sets, rng, b)
    loc_err = max(loc_err, edge_err)
    name, gtb, gtl, gtm = cases[0]
    args = [torch.from_numpy(a).cuda() for a in (gtb, gtl, gtm)] + [anchors]
    first, again = matcher_call(torch, matcher, args), matcher_call(torch, matcher, args)
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError("two matcher calls differ")
    # positives that only a forced claim makes (best IoU ≤ the threshold)
    iou = box_ops.iou_pairwise(args[0], box_ops.center_to_corner(anchors))
    above = torch.where(args[2][..., None], iou, -1.0).amax(1) > 0.5
    forced = int((first.positive & ~above).sum())
    ms = time_ms(torch, lambda: matcher.encode_targets_cuda(*args))
    plain_ms = time_ms(torch, lambda: matching.encode_targets(*args))
    bound, by, bytes_ms, ops_ms = matcher_bound_ms(gtm, anchors.shape[0])
    emit(phase, B=b, M=MATCH_M, A=int(anchors.shape[0]),
         cases=[c[0] for c in cases], edge_cases=names,
         iou_half_gts=len(half_anchor), iou_half_left_negative=half_negative,
         discrete_outputs_bit_equal=True, loc_tolerance="rtol 1e-5, atol 1e-6",
         loc_max_abs_err=loc_err, real_gt_rows_timed=int(gtm.sum()),
         positives_timed=int(first.positive.sum()), forced_only_positives=forced,
         two_calls_bit_equal=True, launches_per_call=1,
         plan=matcher._plan(int(anchors.shape[0]), MATCH_M)._asdict(),
         kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
         bytes_bound_ms=bytes_ms, operations_bound_ms=ops_ms)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=loc_err)


def phase_trainer_bf16(torch, dw, matcher, config: str, batch: int, steps: int,
                       scenes: int, phase: str) -> dict:
    """A training main path: the trainer at full width on `scenes`
    rendered seed-0 train scenes (uint8 720p, augment to the config's size
    on the card), `steps` steps from the seeded init: finite losses, one
    matcher launch and the config's depthwise forward, dx and dk launches
    a step (9 + 9 + 9 for MobileNet, none for VGG16), step times and peak
    device memory."""
    import shutil

    from bdd100k_tpu_torch import train as train_mod

    run_dir = RUNS / phase
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--config", config, "--synthetic", str(scenes),
            "--batch_size", str(batch),
            "--total_steps", str(steps), "--warmup_steps", "0",
            "--log_every", "1", "--checkpoint_every", str(steps),
            "--seed", "0", "--ckpt_dir", str(run_dir), "--no_resume"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts to 0 just before, read just after
    dw.LAUNCHES.update(depthwise3x3_s1=0, depthwise3x3_s1_fgrad=0)
    matcher.LAUNCHES["encode_targets"] = 0
    t0 = time.perf_counter()
    out = run_trainer(train_mod, argv, RUNS / f"{phase}_stdout.txt")
    wall = time.perf_counter() - t0
    launches = dict(depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"],
                    depthwise3x3_s1_fgrad=dw.LAUNCHES["depthwise3x3_s1_fgrad"],
                    encode_targets=matcher.LAUNCHES["encode_targets"])
    per_step = {k: v / steps for k, v in launches.items()}
    n = dw_layers(config)
    if per_step != dict(depthwise3x3_s1=2 * n, depthwise3x3_s1_fgrad=n,
                        encode_targets=1):
        raise AssertionError(f"{phase} launches per step {per_step}")
    if f"done at step {steps}" not in out:
        raise AssertionError(f"the {phase} run did not end at step {steps}")
    log = read_log(run_dir / "train.jsonl")
    if not all(np.isfinite(v) for r in log.values() for v in r.values()):
        raise AssertionError(f"non-finite {phase} metrics")
    t = [log[s]["t"] for s in range(1, steps + 1)]
    step_ms = [(b - a) * 1e3 for a, b in zip(t[TRAIN_WARMUP - 1:], t[TRAIN_WARMUP:])]
    stats = dict(p10_ms=float(np.percentile(step_ms, 10)),
                 p50_ms=float(np.percentile(step_ms, 50)),
                 p90_ms=float(np.percentile(step_ms, 90)),
                 imgs_per_s=batch * len(step_ms) / (sum(step_ms) / 1e3))
    emit(phase, config=config, batch=batch, scenes=scenes, steps=steps,
         timed_steps=len(step_ms), step_time=stats,
         loss_at={s: log[s]["loss"] for s in (1, 5, 10, 20, steps) if s in log},
         launches=launches, launches_per_step=per_step, wall_s=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return dict(launches=launches, step_time=stats,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def run_yolo_phases(torch, infer, nms, dw, matcher, matching, map_metric,
                    nproc: int, decode_rate: float) -> dict:
    """Every YOLO-MobileNet-384 phase: the kernels at YOLO's shapes, then
    serving, eval (both artifact/priors pairs), training and a profile of
    its step → what the kernel table needs."""
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.data.synthetic import generate_synthetic_scenes
    from bdd100k_tpu_torch.ops import anchors as anchor_ops

    cfg = get_config(YOLO_CONFIG)
    anchors = anchor_ops.yolo_anchors(cfg.yolo_grids, cfg.yolo_priors).cuda()
    fitted = eval_config(YOLO_CONFIG, YOLO_PAIRS["synth4kds"][1])
    sets = {"yolo384": anchors,
            "yolo384_fitted": anchor_ops.yolo_anchors(
                fitted.yolo_grids, fitted.yolo_priors).cuda()}
    out = dict(dw=phase_yolo_depthwise(torch, dw),
               matcher=phase_matcher_at(torch, matcher, matching, anchors,
                                        YOLO_TRAIN_BATCH, sets, "yolo_kernel_matcher"))
    synth9k = YOLO_PAIRS["synth9k"][0]
    frames, gt_boxes, gt_labels = generate_synthetic_scenes(16, seed=1)
    captures = phase_path_f32(torch, infer, nms, dw, frames, YOLO_CONFIG, synth9k,
                              phase="yolo_path_f32")
    out["nms"] = phase_nms_path_inputs(torch, nms, captures,
                                       phase="yolo_kernel_nms_path_inputs")
    out["serve_launches"], _ = phase_path_bf16(
        torch, infer, nms, dw, map_metric, frames, gt_boxes, gt_labels,
        YOLO_CONFIG, synth9k, phase="yolo_path_bf16")
    out["eval_f32"], out["eval_bf16"] = {}, {}
    for pair, (artifact, priors) in YOLO_PAIRS.items():
        out["eval_f32"][pair] = phase_eval_f32(
            torch, nms, dw, nproc, decode_rate, YOLO_CONFIG, artifact, priors,
            pair, phase=f"yolo_eval_f32_{pair}")
    for pair, (artifact, priors) in YOLO_PAIRS.items():
        out["eval_bf16"][pair] = phase_eval_bf16(
            torch, nms, dw, decode_rate, YOLO_CONFIG, artifact, priors, pair,
            phase=f"yolo_eval_bf16_{pair}")
    train_frames, train_boxes, train_labels = generate_synthetic_scenes(
        YOLO_F32_BATCH, seed=0)
    phase_train_f32(torch, train_frames, train_boxes, train_labels, YOLO_CONFIG,
                    synth9k, YOLO_F32_BATCH, phase="yolo_train_f32")
    out["train"] = phase_trainer_bf16(torch, dw, matcher, YOLO_CONFIG,
                                      YOLO_TRAIN_BATCH, YOLO_TRAIN_STEPS,
                                      YOLO_TRAIN_SCENES, "yolo_train_bf16")
    phase_train_profile(torch, train_frames, train_boxes, train_labels, YOLO_CONFIG,
                        YOLO_TRAIN_BATCH, phase="yolo_train_profile")
    return out


# ------------------------------------------------------------ VGG16-SSD512

VGG_EVAL_FIXTURE = ROOT / "tests" / "fixtures" / "torch_ref_eval_vgg512.npz"
VGG_SIZE = 512
VGG_TRAIN_BATCH = 32   # BASELINE config 2's batch
VGG_TRAIN_STEPS = 10
VGG_TRAIN_SCENES = 64
VGG_B32_REQUESTS = 8   # b32 requests a serving mode, after warm-up
# (wire, host resize) of the serving modes
VGG_SERVE_MODES = (("rgb", False), ("yuv420", False), ("rgb", True), ("yuv420", True))
BF16_AGREE_TOL = 0.05  # bf16 against f32: scores and box corners
BF16_AGREE_THR = 0.5   # the detections held: score above this


def decode_jpegs(names: list[str], size: int | None, nproc: int) -> np.ndarray:
    """The named seed-1 JPEGs decoded by the pool at `size` (or at full
    resolution when None) → (N, H, W, 3) uint8."""
    from bdd100k_tpu_torch.data.native_decode import NativeDecoder, decode_full
    from bdd100k_tpu_torch.data.pipeline import FullResolutionPool

    jpegs = [(SYNTH_DIR / "images" / "val" / n).read_bytes() for n in names]
    if size is None:
        pool = FullResolutionPool(nproc)
        try:
            return np.stack(pool.map(decode_full, jpegs))
        finally:
            pool.close()
    dec = NativeDecoder(nproc)
    try:
        return dec.decode_batch(jpegs, size)
    finally:
        dec.close()


def jpeg_names() -> list[str]:
    return sorted(p.name for p in (SYNTH_DIR / "images" / "val").glob("*.jpg"))


def phase_vgg_decode512(nproc: int) -> None:
    """The pool's decode of the 64 JPEGs at 512², held to the sha256 of the
    reference's decode in the VGG fixture."""
    import hashlib

    ref = np.load(VGG_EVAL_FIXTURE)
    images = decode_jpegs(jpeg_names(), VGG_SIZE, nproc)
    digests = [hashlib.sha256(im.tobytes()).hexdigest() for im in images]
    match = sum(d == w.decode() for d, w in zip(digests, ref["image_sha256"]))
    emit("vgg_decode512", jpegs=len(digests), size=VGG_SIZE,
         sha256_match_reference=f"{match}/{len(digests)}")
    if match != len(digests):
        raise AssertionError(f"512² decode differs from the reference's: "
                             f"{match}/{len(digests)} equal")


def phase_vgg_path_bf16(torch, infer, nms, dw, frames, phase="vgg_path_bf16") -> dict:
    """The VGG16-SSD512 serving main path in bf16 through `Predictor`, in
    each of VGG_SERVE_MODES on the rendered 720p scenes: SERVE_REQUESTS
    requests at b1 (latency percentiles) and VGG_B32_REQUESTS at b32
    (BASELINE config 2's batch: imgs/s), after a warm-up; one NMS launch a
    request and no depthwise one. The confident detections of the first
    b32 request agree with the f32 path's on the same frames and mode
    (scores and corners within BF16_AGREE_TOL) → launches and stats."""
    n = len(frames)
    out, total = {}, dict(greedy_suppress=0, depthwise3x3_s1=0)
    for wire, host_resize in VGG_SERVE_MODES:
        mode = f"{wire}_host_resize_{'on' if host_resize else 'off'}"
        preds = {bs: infer.load_predictor(VGG_CONFIG, VGG_ARTIFACT, batch_size=bs,
                                          device="cuda", host_resize=host_resize,
                                          wire=wire)
                 for bs in (1, EVAL_BATCH)}
        if any(p.wire != wire for p in preds.values()):
            raise AssertionError(f"{mode}: the predictor took another wire")
        requests = {
            1: [frames[r % n][None] for r in range(SERVE_REQUESTS)],
            EVAL_BATCH: [np.take(frames, range(EVAL_BATCH * r, EVAL_BATCH * (r + 1)),
                                 axis=0, mode="wrap") for r in range(VGG_B32_REQUESTS)]}
        for bs, p in preds.items():  # warm-up, outside the counted run
            for r in requests[bs][:SERVE_WARMUP if bs == 1 else 2]:
                p(r)
        torch.cuda.synchronize()
        # the main path: counts to 0 just before, read just after
        nms.LAUNCHES["greedy_suppress"] = 0
        dw.LAUNCHES["depthwise3x3_s1"] = 0
        lat, outs = {1: [], EVAL_BATCH: []}, {1: [], EVAL_BATCH: []}
        for bs, p in preds.items():
            for r in requests[bs]:
                t0 = time.perf_counter()
                outs[bs].append(p(r))  # ends in the copy back: a sync
                lat[bs].append((time.perf_counter() - t0) * 1e3)
        launches = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                        depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
        n_req = sum(len(v) for v in requests.values())
        if launches != dict(greedy_suppress=n_req, depthwise3x3_s1=0):
            raise AssertionError(f"{phase} {mode} launches {launches} for {n_req} "
                                 "requests")
        for k in total:
            total[k] += launches[k]
        for bs in preds:
            for det, r in zip(outs[bs], requests[bs]):
                if det.boxes.shape != (len(r), 200, 4) or \
                        not np.isfinite(det.boxes).all() or not det.valid.any():
                    raise AssertionError(f"{phase} {mode}: bad detections")
        f32 = infer.load_predictor(VGG_CONFIG, VGG_ARTIFACT, batch_size=n, device="cuda",
                                   dtype=torch.float32, host_resize=host_resize,
                                   wire=wire)
        want = f32(frames)
        got = outs[EVAL_BATCH][0]
        confident_agree(want, got, n, thr=BF16_AGREE_THR, tol=BF16_AGREE_TOL)
        confident_agree(got, want, n, thr=BF16_AGREE_THR + BF16_AGREE_TOL,
                        tol=BF16_AGREE_TOL)
        out[mode] = dict(
            b1=latency_stats(lat[1], [t / 1e3 for t in lat[1]], 1),
            b32=latency_stats(lat[EVAL_BATCH], [t / 1e3 for t in lat[EVAL_BATCH]],
                              EVAL_BATCH),
            launches=launches)
        del preds, f32
        torch.cuda.empty_cache()
    emit(phase, config=VGG_CONFIG, weights=VGG_ARTIFACT.name,
         frame="720x1280 uint8 rgb", warmup_requests=SERVE_WARMUP,
         confident_vs_f32=dict(thr=BF16_AGREE_THR, tol=BF16_AGREE_TOL, agree=True),
         **out)
    return dict(launches=total, modes=out)


def run_vgg_phases(torch, infer, nms, dw, matcher, matching, nproc: int,
                   decode_rate: float) -> dict:
    """Every VGG16-SSD512 phase: the f32 serving path against the CPU on
    two JPEGs at 512, the bf16 serving main path, eval in f32 against the
    fixture and in bf16 through the CLI, NMS on the eval's own b32
    candidates, the matcher at B=32 on its 24564 anchors and the trainer
    at B=32 → what the kernel table needs."""
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.data.synthetic import generate_synthetic_scenes
    from bdd100k_tpu_torch.ops import anchors as anchor_ops

    phase_vgg_decode512(nproc)
    two = decode_jpegs(jpeg_names()[:2], VGG_SIZE, nproc)
    captures = phase_path_f32(torch, infer, nms, dw, two, VGG_CONFIG, VGG_ARTIFACT,
                              phase="vgg_path_f32", batch=2)
    out = {"nms_b2": phase_nms_path_inputs(torch, nms, captures,
                                           phase="vgg_kernel_nms_path_b2",
                                           sizes=(1, 2))}
    frames, _, _ = generate_synthetic_scenes(16, seed=1)
    out["serve"] = phase_vgg_path_bf16(torch, infer, nms, dw, frames)
    ev = phase_eval_f32(torch, nms, dw, nproc, decode_rate, VGG_CONFIG, VGG_ARTIFACT,
                        phase="vgg_eval_f32", fixture=VGG_EVAL_FIXTURE,
                        keep_captures=True)
    out["nms"] = phase_nms_path_inputs(torch, nms, ev.pop("captures"),
                                       phase="vgg_kernel_nms_path_inputs",
                                       sizes=(1, EVAL_BATCH))
    out["eval_f32"] = ev
    out["eval_bf16"] = phase_eval_bf16(torch, nms, dw, decode_rate, VGG_CONFIG,
                                       VGG_ARTIFACT, phase="vgg_eval_bf16",
                                       fixture=VGG_EVAL_FIXTURE)
    anchors = anchor_ops.ssd_anchors(get_config(VGG_CONFIG).feature_maps).cuda()
    out["matcher"] = phase_matcher_at(torch, matcher, matching, anchors,
                                      VGG_TRAIN_BATCH, {"ssd512": anchors},
                                      "vgg_kernel_matcher")
    out["train"] = phase_trainer_bf16(torch, dw, matcher, VGG_CONFIG, VGG_TRAIN_BATCH,
                                      VGG_TRAIN_STEPS, VGG_TRAIN_SCENES,
                                      "vgg_train_bf16")
    return out


# ------------------------------------------------------------ serving CLI

CLI_FIXTURE = ROOT / "tests" / "fixtures" / "torch_ref_infer_cli.json"
CLI_CONFIGS = {CONFIG: ARTIFACT, YOLO_CONFIG: YOLO_PAIRS["synth9k"][0],
               VGG_CONFIG: VGG_ARTIFACT}
# the directory sweep's modes: name → extra CLI flags
CLI_MODES = {"yuv420": [], "rgb": ["--wire", "rgb"],
             "host_resize_off": ["--host_resize", "off"]}
CLI_REPEAT = 8            # the bf16 sweeps: the 64 JPEGs 8 times over
CLI_LINE_TOL = 1e-3 + 1e-6  # one step of the printed third decimal
CLI_THRESHOLD = 0.4       # the CLI's --score_threshold default
CLI_TIE = 2e-3            # a score this close to the threshold may cross it
FULL_RES_PASSES = 5


def cli_lines_agree(got: dict, want: dict, names: list[str]) -> list[str]:
    """Per image, each line of one side has a line of the other of its
    class with score and corners within CLI_LINE_TOL; a line left over
    must sit within CLI_TIE of the threshold (a near-tie there, named in
    the result) → the near-ties."""
    ties = []
    for name in names:
        left = list(want.get(name, []))
        extra = []
        for cls, score, box in got.get(name, []):
            hit = [j for j, (c, s, b) in enumerate(left) if c == cls
                   and abs(s - score) <= CLI_LINE_TOL
                   and max(abs(p - q) for p, q in zip(b, box)) <= CLI_LINE_TOL]
            if hit:
                left.pop(hit[0])
            else:
                extra.append(("port", cls, score))
        extra += [("reference", c, s) for c, s, _ in left]
        for side, cls, score in extra:
            if abs(score - CLI_THRESHOLD) > CLI_TIE:
                raise AssertionError(f"{name}: {side} line {cls} {score} has no "
                                     "counterpart")
            ties.append(f"{name}: {side} {cls} {score}")
    return ties


def run_cli(argv: list[str], log_path: Path) -> tuple[str, float]:
    """`python -m bdd100k_tpu_torch.infer argv` as a subprocess → (its
    stdout, wall seconds); its output also goes to `log_path`."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "bdd100k_tpu_torch.infer", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    log_path.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"infer {' '.join(argv)} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    return proc.stdout, wall


def cli_rate(stdout: str, n: int) -> tuple[float, float | None]:
    """The imgs/sec of the CLI's last line, which must count `n` images:
    over the whole sweep, and after its first batch (None for one
    batch)."""
    last = stdout.strip().splitlines()[-1]
    if not last.startswith(f"{n} images in"):
        raise AssertionError(f"the sweep's last line is {last!r}, not {n} images")
    whole = float(last.split(" = ")[1].split()[0])
    steady = (float(last.split("; ")[1].split()[0]) if "; " in last else None)
    return whole, steady


def phase_infer_cli() -> dict:
    """`python -m bdd100k_tpu_torch.infer` as users run it, one subprocess
    each: for SSD300, YOLO-384 and VGG16-SSD512 on their synth9k
    artifacts, the 64 JPEGs at --batch_size 32 in f32 on the default
    (yuv420) wire, --wire rgb and --host_resize off, and --image on one
    JPEG at full resolution, their lines held to the reference CLI's f32
    lines in the fixture; then the bf16 main path (the CLI's default) over
    the 64 JPEGs CLI_REPEAT times over on each wire, for imgs/s; and
    --out_dir on 8 images."""
    import os

    from bdd100k_tpu_torch import infer

    ref = json.loads(CLI_FIXTURE.read_text())
    names = jpeg_names()
    images = os.path.relpath(SYNTH_DIR / "images" / "val")
    logs = RUNS / "infer_cli"
    logs.mkdir(parents=True, exist_ok=True)
    big = logs / "dir512"
    big.mkdir(exist_ok=True)
    for r in range(CLI_REPEAT):
        for n in names:
            link = big / f"r{r}_{n}"
            if not link.exists():
                link.symlink_to(SYNTH_DIR / "images" / "val" / n)
    out = {}
    for config, artifact in CLI_CONFIGS.items():
        base = ["--config", config, "--ckpt_dir", os.path.relpath(artifact)]
        row = {}
        for mode, extra in CLI_MODES.items():
            stdout, wall = run_cli(base + ["--image_dir", images, "--batch_size",
                                           str(EVAL_BATCH), "--dtype", "float32",
                                           *extra], logs / f"{config}_{mode}_f32.txt")
            cli_rate(stdout, len(names))  # the sweep counted every image
            got = infer.parse_detection_lines(stdout)
            want = ref["dir"][config][mode]
            ties = cli_lines_agree(got, infer.parse_detection_lines("\n".join(want)),
                                   names)
            row[mode] = dict(lines=sum(map(len, got.values())),
                             fixture_lines=len(want),
                             near_ties=ties, wall_s=wall)
        stdout, wall = run_cli(base + ["--image", os.path.join(images, names[0]),
                                       "--dtype", "float32"],
                               logs / f"{config}_single_f32.txt")
        ties = cli_lines_agree(infer.parse_detection_lines(stdout),
                               infer.parse_detection_lines(
                                   "\n".join(ref["single"][config])), names[:1])
        if "warm latency" not in stdout:
            raise AssertionError(f"{config} --image printed no warm latency")
        row["single_image"] = dict(near_ties=ties, wall_s=wall, latency_lines=[
            x for x in stdout.splitlines() if "latency" in x])
        for wire in ("yuv420", "rgb"):
            stdout, wall = run_cli(base + ["--image_dir", os.path.relpath(big),
                                           "--batch_size", str(EVAL_BATCH),
                                           "--wire", wire],
                                   logs / f"{config}_{wire}_bf16.txt")
            whole, steady = cli_rate(stdout, len(names) * CLI_REPEAT)
            row[f"bf16_{wire}"] = dict(images=len(names) * CLI_REPEAT, wall_s=wall,
                                       imgs_per_s=whole,
                                       imgs_per_s_after_first_batch=steady)
        out[config] = row
    eight = logs / "dir8"
    eight.mkdir(exist_ok=True)
    for n in names[:8]:
        if not (eight / n).exists():
            (eight / n).symlink_to(SYNTH_DIR / "images" / "val" / n)
    drawn = logs / "drawn"
    stdout, _ = run_cli(["--config", VGG_CONFIG, "--ckpt_dir",
                         os.path.relpath(VGG_ARTIFACT), "--image_dir",
                         os.path.relpath(eight), "--batch_size", "8",
                         "--out_dir", os.path.relpath(drawn)], logs / "out_dir.txt")
    pngs = sorted(drawn.glob("det_*.png"))
    if [p.name for p in pngs] != [f"det_{Path(n).stem}.png" for n in names[:8]] or \
            not all(p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs):
        raise AssertionError(f"--out_dir wrote {[p.name for p in pngs]}")
    emit("infer_cli", command="python -m bdd100k_tpu_torch.infer",
         scenes=len(names), batch=EVAL_BATCH, line_tol=CLI_LINE_TOL,
         threshold=CLI_THRESHOLD, near_tie_band=CLI_TIE, lines_agree=True,
         out_dir_pngs=len(pngs), **out)
    return out


def phase_full_res_decode(nproc: int) -> float:
    """`decode_full` on the 64 JPEGs at 1/1 through a `FullResolutionPool`
    of `nproc` threads: each sha256 equal to PIL's in the fixture → imgs/s
    over FULL_RES_PASSES passes."""
    import hashlib

    want = json.loads(CLI_FIXTURE.read_text())["full_res_sha256"]
    names = jpeg_names()
    images = decode_jpegs(names, None, nproc)
    match = sum(hashlib.sha256(im.tobytes()).hexdigest() == want[n]
                for im, n in zip(images, names))
    t0 = time.perf_counter()
    for _ in range(FULL_RES_PASSES):
        decode_jpegs(names, None, nproc)
    rate = FULL_RES_PASSES * len(names) / (time.perf_counter() - t0)
    emit("full_res_decode", jpegs=len(names), shape=list(images.shape[1:]),
         sha256_match_pil=f"{match}/{len(names)}", workers=nproc,
         passes=FULL_RES_PASSES, imgs_per_s=rate)
    if match != len(names):
        raise AssertionError(f"full-resolution decode: {match}/{len(names)} equal PIL")
    return rate


# ------------------------------------------------------ train from files

FILES_STEPS = 30          # train_files: SSD300 at B=32 from the 64 JPEGs
FILES_PROFILE = (10, 13)  # --profile_steps of train_files
FILES_DECODE = 512        # --decode_size of train_files (the yuv420 wire)
FILES_FULL_STEPS = 8      # train_files_full: --decode_size 0, the rgb wire
FILES_FULL_PROFILE = (4, 7)
VGG_PRE_STEPS = 5         # vgg_pretrained: ssd_vgg16_512 from a torchvision .pth
LOADER_BATCHES = 8        # batches timed for the loader's own rate
REPAIRS = ROOT / "tests" / "fixtures" / "decode_repairs"
# torchvision vgg16's `features` conv indices and their (in, out) channels
TV_VGG16 = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
            (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512),
            (21, 512, 512), (24, 512, 512), (26, 512, 512), (28, 512, 512))
TV_VGG16_NAMES = tuple(f"block{b}.conv{c}" for b, n in ((1, 2), (2, 2), (3, 3),
                                                      (4, 3), (5, 3))
                       for c in range(1, n + 1))


def files_argv(config: str, batch: int, steps: int, run_dir: Path,
               decode_size: int, nproc: int, *extra: str) -> list[str]:
    """The trainer's flags for a run from the 64 committed JPEGs and their
    labels, as a user types them."""
    import os

    return ["--config", config,
            "--labels", os.path.relpath(SYNTH_DIR / "labels" / "val.json"),
            "--image_dir", os.path.relpath(SYNTH_DIR / "images" / "val"),
            "--decode_size", str(decode_size), "--wire", "auto",
            "--batch_size", str(batch), "--total_steps", str(steps),
            "--warmup_steps", "0", "--log_every", "1",
            "--checkpoint_every", str(steps), "--seed", "0",
            "--num_workers", str(nproc), "--ckpt_dir", str(run_dir),
            "--no_resume", *extra]


def trace_busy(stdout: str) -> dict:
    """The trainer's `--profile_steps` window: its wall time (the line it
    prints) and the card's busy time in the trace it wrote (the union of
    kernel, memcpy and memset intervals) → busy share and what ran. The
    profiler lengthens the steps it records, so the callers also divide
    the busy time a step by an unprofiled step of the same run."""
    import re

    m = re.search(r"profile: steps (\d+)-(\d+), (\d+) steps, wall ([\d.]+) ms, "
                  r"trace (\S+)", stdout)
    if m is None:
        raise AssertionError("the trainer printed no profile line")
    steps, wall_ms, path = int(m.group(3)), float(m.group(4)), Path(m.group(5))
    if not path.is_file():
        raise AssertionError(f"no trace at {path}")
    events = json.loads(path.read_text())["traceEvents"]
    spans, kernels = [], 0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
            kernels += e.get("cat") == "kernel"
    busy_us, end = 0.0, -1e300
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return dict(trace=str(path.relative_to(ROOT)), trace_bytes=path.stat().st_size,
                steps=steps, wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                device_busy_ms_per_step=busy_us / 1e3 / steps,
                device_busy_share=(busy_us / 1e3) / wall_ms if spans else None,
                kernel_launches_per_step=kernels / steps,
                note=None if spans else "the trace holds no device events: "
                                        "busy share not measured")


def run_files_trainer(torch, dw, matcher, argv, phase: str, steps: int,
                      dw_per_step: int) -> tuple[str, dict, dict]:
    """Run the trainer in-process with the kernel counts set to 0 just
    before and read just after; hold the launches a step (the MobileNet
    configs' 9 + 9 depthwise forward and dx, 9 dk; one matcher launch) and
    finite metrics → (stdout, the log, the launches)."""
    from bdd100k_tpu_torch import train as train_mod

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dw.LAUNCHES.update(depthwise3x3_s1=0, depthwise3x3_s1_fgrad=0)
    matcher.LAUNCHES["encode_targets"] = 0
    out = run_trainer(train_mod, argv, RUNS / f"{phase}_stdout.txt")
    launches = dict(depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"],
                    depthwise3x3_s1_fgrad=dw.LAUNCHES["depthwise3x3_s1_fgrad"],
                    encode_targets=matcher.LAUNCHES["encode_targets"])
    per_step = {k: v / steps for k, v in launches.items()}
    if per_step != dict(depthwise3x3_s1=2 * dw_per_step,
                        depthwise3x3_s1_fgrad=dw_per_step, encode_targets=1):
        raise AssertionError(f"{phase} launches per step {per_step}")
    if f"done at step {steps}" not in out:
        raise AssertionError(f"the {phase} run did not end at step {steps}")
    run_dir = Path(argv[argv.index("--ckpt_dir") + 1])
    log = read_log(run_dir / "train.jsonl")
    if sorted(log) != list(range(1, steps + 1)) or not all(
            np.isfinite(v) for r in log.values() for v in r.values()):
        raise AssertionError(f"{phase}: missing or non-finite metrics")
    return out, log, launches


def step_stats(log: dict, batch: int, skip: set[int]) -> dict:
    """Host-clock step times between consecutive logged steps from
    TRAIN_WARMUP on, leaving out the steps in `skip` (a profiled window)."""
    steps = sorted(log)
    ms = [(log[b]["t"] - log[a]["t"]) * 1e3 for a, b in zip(steps, steps[1:])
          if a >= TRAIN_WARMUP - 1 and b not in skip]
    return dict(timed_steps=len(ms), p10_ms=float(np.percentile(ms, 10)),
                p50_ms=float(np.percentile(ms, 50)), p90_ms=float(np.percentile(ms, 90)),
                imgs_per_s=batch * len(ms) / (sum(ms) / 1e3))


def loader_rate(decode_size: int | None, wire: str, nproc: int) -> float:
    """The train loader alone, on the host: imgs/s of LOADER_BATCHES
    shuffled batches of TRAIN_BATCH from the 64 JPEGs."""
    from bdd100k_tpu_torch.data.pipeline import DetectionDataset, make_loader

    ds = DetectionDataset.from_bdd100k(SYNTH_DIR / "labels" / "val.json",
                                       SYNTH_DIR / "images" / "val",
                                       decode_size=decode_size)
    loader = make_loader(ds, TRAIN_BATCH, seed=0, num_workers=nproc, wire_format=wire)
    next(loader)  # the pool's start
    t0 = time.perf_counter()
    for _ in range(LOADER_BATCHES):
        next(loader)
    rate = LOADER_BATCHES * TRAIN_BATCH / (time.perf_counter() - t0)
    loader.close()
    return rate


def phase_train_files(torch, dw, matcher, nproc: int) -> dict:
    """Training from JPEG files, the slice's main path: `python -m
    bdd100k_tpu_torch.train` for SSD300 at full width and B=32 on the 64
    committed JPEGs at --decode_size 512 on the yuv420 wire (--wire auto),
    seeded from the committed SSD300 artifact's backbone, with an EMA
    shadow and a torch.profiler window. Holds the printed wire, the seeded
    backbone (an in-process `seed_backbone` of the same state against the
    artifact's tensors), finite losses, the trace and the launches."""
    import shutil

    from bdd100k_tpu_torch import train as train_mod
    from bdd100k_tpu_torch.configs import TrainConfig, get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.parallel import train_step
    from bdd100k_tpu_torch.utils.weights import load_detector_npz

    run_dir = RUNS / "train_files"
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = files_argv(CONFIG, TRAIN_BATCH, FILES_STEPS, run_dir, FILES_DECODE, nproc,
                      "--pretrained_backbone", str(ARTIFACT.relative_to(ROOT)),
                      "--ema_decay", str(TRAIN_EMA_DECAY),
                      "--profile_steps", ",".join(map(str, FILES_PROFILE)))
    t0 = time.perf_counter()
    out, log, launches = run_files_trainer(torch, dw, matcher, argv, "train_files",
                                           FILES_STEPS, dw_layers(CONFIG))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if "wire format: yuv420" not in out:
        raise AssertionError("train_files did not run on the yuv420 wire")
    if "seeded mobilenet backbone from" not in out:
        raise AssertionError("train_files did not seed its backbone")
    # the same seeding in-process, held to the artifact's tensors
    cfg = get_config(CONFIG)
    bundle = build_detector(cfg, device="cuda")
    state = train_step.create_train_state(bundle, TrainConfig(ema_decay=TRAIN_EMA_DECAY))
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        seeded = train_mod.seed_backbone(state, cfg, str(ARTIFACT))
    want, _ = load_detector_npz(ARTIFACT)
    got = bundle.model.state_dict()
    bb = [k for k in want if k.startswith("backbone.")
          and not k.endswith("num_batches_tracked")]
    differ = [k for k in bb if not torch.equal(got[k].cpu(), want[k])]
    ema_off = sum(not torch.equal(e, p) for e, p in
                  zip(state.ema_params, bundle.model.parameters()))
    if differ or seeded != len(bb) or ema_off:
        raise AssertionError(f"seeded backbone: {len(differ)} of {len(bb)} tensors "
                             f"differ from the artifact, {seeded} written, "
                             f"{ema_off} EMA tensors off the seeded weights")
    busy = trace_busy(out)
    skip = set(range(FILES_PROFILE[0] + 1, FILES_PROFILE[1] + 2))
    stats = step_stats(log, TRAIN_BATCH, skip)
    busy["device_busy_share_of_unprofiled_p50"] = (
        busy["device_busy_ms_per_step"] / stats["p50_ms"]
        if busy["device_busy_share"] is not None else None)
    busy["profiler_stretch"] = busy["wall_ms"] / busy["steps"] / stats["p50_ms"]
    decode = loader_rate(FILES_DECODE, "yuv420", nproc)
    per_step = {k: v / FILES_STEPS for k, v in launches.items()}
    emit("train_files", command="python -m bdd100k_tpu_torch.train " + " ".join(argv),
         config=CONFIG, batch=TRAIN_BATCH, steps=FILES_STEPS, wire="yuv420",
         decode_size=FILES_DECODE, step_time=stats, profiled_steps_left_out=sorted(skip),
         loss_at={s: log[s]["loss"] for s in (1, 10, 20, FILES_STEPS)},
         seeded_backbone_tensors=seeded, seeded_equal_artifact=True,
         ema_reanchored=True, profile=busy, launches=launches,
         launches_per_step=per_step, loader_decode_imgs_per_s=decode,
         decode_workers=nproc, peak_mem_gb=peak, wall_s=wall)
    return dict(launches=launches, step_time=stats, busy=busy, run_dir=run_dir,
                decode_imgs_per_s=decode)


def phase_train_files_full(torch, dw, matcher, nproc: int) -> dict:
    """The same trainer at --decode_size 0: full-resolution decodes of the
    720p JPEGs on `nproc` threads, the rgb wire, the augment's crop at
    native resolution; a profile window for the card's busy share."""
    import shutil

    run_dir = RUNS / "train_files_full"
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = files_argv(CONFIG, TRAIN_BATCH, FILES_FULL_STEPS, run_dir, 0, nproc,
                      "--profile_steps", ",".join(map(str, FILES_FULL_PROFILE)))
    out, log, launches = run_files_trainer(torch, dw, matcher, argv,
                                           "train_files_full", FILES_FULL_STEPS,
                                           dw_layers(CONFIG))
    if "wire format: rgb" not in out:
        raise AssertionError("train_files_full did not run on the rgb wire")
    busy = trace_busy(out)
    window = busy["steps"] * TRAIN_BATCH / (busy["wall_ms"] / 1e3)
    free = [(log[b]["t"] - log[b - 1]["t"]) * 1e3 for b in range(2, FILES_FULL_PROFILE[0] + 1)]
    free_p50 = float(np.median(free))
    busy["device_busy_share_of_unprofiled_p50"] = (
        busy["device_busy_ms_per_step"] / free_p50
        if busy["device_busy_share"] is not None else None)
    busy["profiler_stretch"] = busy["wall_ms"] / busy["steps"] / free_p50
    decode = loader_rate(None, "rgb", nproc)
    emit("train_files_full", command="python -m bdd100k_tpu_torch.train " + " ".join(argv),
         config=CONFIG, batch=TRAIN_BATCH, steps=FILES_FULL_STEPS, wire="rgb",
         decode_size=0, profile=busy, imgs_per_s_profiled_window=window,
         step_ms_before_profile=free,
         imgs_per_s_before_profile=TRAIN_BATCH * len(free) / (sum(free) / 1e3),
         loader_decode_imgs_per_s=decode, decode_workers=nproc, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return dict(launches=launches, busy=busy, decode_imgs_per_s=decode,
                imgs_per_s=window)


def phase_vgg_pretrained(torch, dw, matcher, nproc: int) -> dict:
    """ssd_vgg16_512 at B=32 from the same files for VGG_PRE_STEPS steps,
    seeded from a torchvision-layout vgg16 `.pth` this phase writes from
    seeded random tensors (nothing is downloaded); the seeded conv weights
    held equal to the file's."""
    import contextlib
    import io
    import shutil

    from bdd100k_tpu_torch import train as train_mod
    from bdd100k_tpu_torch.configs import TrainConfig, get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.parallel import train_step

    run_dir = RUNS / "vgg_pretrained"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    sd = {}
    for i, cin, cout in TV_VGG16:
        sd[f"features.{i}.weight"] = torch.from_numpy(
            (rng.randn(cout, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
        sd[f"features.{i}.bias"] = torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.01)
    pth = run_dir / "vgg16_torchvision_layout.pth"
    torch.save(sd, pth)
    argv = files_argv(VGG_CONFIG, VGG_TRAIN_BATCH, VGG_PRE_STEPS, run_dir / "run",
                      VGG_SIZE, nproc, "--pretrained_backbone", str(pth))
    out, log, launches = run_files_trainer(torch, dw, matcher, argv, "vgg_pretrained",
                                           VGG_PRE_STEPS, 0)
    if "seeded vgg16 backbone from" not in out or "(26 tensors)" not in out:
        raise AssertionError("vgg_pretrained did not seed its 13 convs")
    cfg = get_config(VGG_CONFIG)
    bundle = build_detector(cfg, device="cuda")
    state = train_step.create_train_state(bundle, TrainConfig())
    with contextlib.redirect_stdout(io.StringIO()):
        train_mod.seed_backbone(state, cfg, str(pth))
    got = bundle.model.state_dict()
    differ = [n for (i, _, _), n in zip(TV_VGG16, TV_VGG16_NAMES)
              if not (torch.equal(got[f"backbone.{n}.weight"].cpu(), sd[f"features.{i}.weight"])
                      and torch.equal(got[f"backbone.{n}.bias"].cpu(), sd[f"features.{i}.bias"]))]
    if differ:
        raise AssertionError(f"vgg_pretrained: seeded convs differ from the file: {differ}")
    times = [(log[b]["t"] - log[b - 1]["t"]) * 1e3 for b in range(2, VGG_PRE_STEPS + 1)]
    emit("vgg_pretrained", command="python -m bdd100k_tpu_torch.train " + " ".join(argv),
         config=VGG_CONFIG, batch=VGG_TRAIN_BATCH, steps=VGG_PRE_STEPS,
         seeded_convs_equal_file=len(TV_VGG16), step_ms=times,
         loss_at={s: log[s]["loss"] for s in (1, VGG_PRE_STEPS)}, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return dict(launches=launches)


def phase_export_weights(torch, nms, dw, files: dict) -> dict:
    """`python -m bdd100k_tpu_torch.scripts.export_weights --ema` on
    train_files' run: the artifact's params equal the checkpoint's EMA
    shadow cast to fp16, its statistics the checkpoint's, meta source
    "ema"; then `python -m bdd100k_tpu_torch.evaluate` of that artifact
    with --ema in f32 over the 64 JPEGs (NMS and the eval path on a
    port-trained artifact): a finite mAP."""
    import os

    from bdd100k_tpu_torch import evaluate
    from bdd100k_tpu_torch.scripts import export_weights
    from bdd100k_tpu_torch.utils.weights import flax_from_state_dict, read_detector_npz

    run_dir = files["run_dir"]
    out = RUNS / "train_files_ema.npz"
    meta, _ = run_quietly(export_weights.main,
                          ["--ckpt_dir", str(run_dir), "--config", CONFIG,
                           "--out", str(out), "--ema"], RUNS / "export_stdout.txt")
    payload = torch.load(run_dir / f"ckpt_{FILES_STEPS}.pt", map_location="cpu",
                         weights_only=True)
    sd = dict(payload["model"])
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.models.detector import build_detector

    names = [k for k, _ in build_detector(get_config(CONFIG),
                                          device="cpu").model.named_parameters()]
    sd.update(zip(names, payload["ema"], strict=True))
    want_p, want_s = flax_from_state_dict(sd)
    params, stats, fmeta = read_detector_npz(out)
    bad = [k for k in want_p if params[k].dtype != np.float16
           or not np.array_equal(params[k], want_p[k].astype(np.float16))]
    bad += [k for k in want_s if not np.array_equal(stats[k], want_s[k])]
    if bad or sorted(params) != sorted(want_p) or fmeta.get("source") != "ema" \
            or fmeta.get("step") != FILES_STEPS:
        raise AssertionError(f"export: {len(bad)} tensors differ from the EMA "
                             f"shadow, meta {fmeta}")
    argv = ["--config", CONFIG, "--ckpt_dir", os.path.relpath(out), "--ema",
            "--synthetic", str(EVAL_SCENES), "--synthetic_dir", os.path.relpath(SYNTH_DIR),
            "--batch_size", str(EVAL_BATCH), "--dtype", "float32"]
    torch.cuda.synchronize()
    nms.LAUNCHES["greedy_suppress"] = 0
    dw.LAUNCHES["depthwise3x3_s1"] = 0
    result, stdout = run_quietly(evaluate.main, argv, RUNS / "export_eval_stdout.txt")
    launches = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                    depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
    batches = -(-EVAL_SCENES // EVAL_BATCH)
    if launches != dict(greedy_suppress=batches, depthwise3x3_s1=9 * batches):
        raise AssertionError(f"export eval launches {launches}")
    if f"restored step {FILES_STEPS} (EMA weights)" not in stdout or \
            not np.isfinite(result["mAP"]):
        raise AssertionError(f"export eval: {result['mAP']}")
    emit("export_weights",
         command="python -m bdd100k_tpu_torch.scripts.export_weights "
                 f"--ckpt_dir {run_dir.relative_to(ROOT)} --config {CONFIG} "
                 f"--out {out.relative_to(ROOT)} --ema",
         meta=meta, artifact_bytes=out.stat().st_size, tensors=len(params) + len(stats),
         equal_ema_fp16=True, eval_command="python -m bdd100k_tpu_torch.evaluate "
         + " ".join(argv), eval_map50=result["mAP"],
         eval_images_per_sec=result["images_per_sec"], launches=launches)
    return dict(launches=launches, map50=result["mAP"])


def sha256(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def phase_decode_progressive(nproc: int) -> None:
    """The committed progressive JPEGs (4:2:0, 4:4:4, gray, restart
    markers) through the port's decodes: the pool at 300 rgb, 300 yuv420
    and 512, and `decode_full` at 1/1, each sha256 equal to the
    reference's decode (its native pool; PIL at 1/1) in the fixture."""
    from bdd100k_tpu_torch.data.native_decode import NativeDecoder, decode_full

    want = json.loads((REPAIRS / "ref_sha256.json").read_text())["decode_progressive"]
    dec = NativeDecoder(nproc)
    checked, bad = 0, []
    try:
        for name, rec in want.items():
            jpeg = (REPAIRS / f"{name}.jpg").read_bytes()
            got = {str(s): sha256(dec.decode_batch([jpeg], s)[0]) for s in (300, 512)}
            if "300_yuv420" in rec:
                y, uv = dec.decode_batch_yuv420([jpeg], 300)
                got["300_yuv420"] = [sha256(y[0]), sha256(uv[0])]
            got["full"] = sha256(decode_full(jpeg))
            checked += len(got)
            bad += [(name, k) for k in rec if got.get(k) != rec[k]]
        jpegs = [(REPAIRS / f"{n}.jpg").read_bytes() for n in want] * 8
        t0 = time.perf_counter()
        dec.decode_batch(jpegs, 300)
        rate = len(jpegs) / (time.perf_counter() - t0)
    finally:
        dec.close()
    emit("decode_progressive", jpegs=len(want), decodes_checked=checked,
         sha256_match_reference=f"{checked - len(bad)}/{checked}", mismatches=bad,
         pool_300_imgs_per_s=rate, workers=nproc)
    if bad:
        raise AssertionError(f"progressive decodes differ from the reference's: {bad}")


def phase_resize_bicubic() -> None:
    """The committed non-720p JPEGs (1920×1080, 640×480, 1280×800, and a
    640×360 upscale) through `DetectionDataset.decode_full` (the
    full-resolution decode plus PIL's bicubic resize to 720×1280): each
    sha256 equal to the reference's PIL route in the fixture. Times the
    whole call, and the decode and the resize of it apart."""
    from bdd100k_tpu_torch.data.host_resize import resize_bicubic
    from bdd100k_tpu_torch.data.native_decode import decode_full
    from bdd100k_tpu_torch.data.pipeline import DetectionDataset

    want = json.loads((REPAIRS / "ref_sha256.json").read_text())["resize_bicubic"]
    ds = DetectionDataset([], REPAIRS)
    rows = {}
    for name, digest in sorted(want.items()):
        jpeg = (REPAIRS / name).read_bytes()
        t0 = time.perf_counter()
        image = ds.decode_full(jpeg)
        t1 = time.perf_counter()
        full = decode_full(jpeg)
        t2 = time.perf_counter()
        resize_bicubic(full[None], 720, 1280)
        t3 = time.perf_counter()
        rows[name] = dict(shape=list(image.shape), ms=(t1 - t0) * 1e3,
                          decode_ms=(t2 - t1) * 1e3, resize_ms=(t3 - t2) * 1e3,
                          equal=sha256(image) == digest)
    emit("resize_bicubic", frames=rows,
         sha256_match_reference=f"{sum(r['equal'] for r in rows.values())}/{len(rows)}")
    if not all(r["equal"] for r in rows.values()):
        raise AssertionError(f"bicubic resizes differ from PIL's: {rows}")


def run_files_phases(torch, nms, dw, matcher, nproc: int) -> dict:
    """Slice 8's phases: training from JPEG files (yuv420 at 512 and full
    resolution), VGG16-SSD512 from a torchvision-layout backbone, the
    exporter and an eval of its artifact, and the decode repairs."""
    files = phase_train_files(torch, dw, matcher, nproc)
    full = phase_train_files_full(torch, dw, matcher, nproc)
    vgg = phase_vgg_pretrained(torch, dw, matcher, nproc)
    export = phase_export_weights(torch, nms, dw, files)
    phase_decode_progressive(nproc)
    phase_resize_bicubic()
    return dict(files=files, full=full, vgg=vgg, export=export)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    PHASE_LOG.parent.mkdir(exist_ok=True)
    PHASE_LOG.write_text("")
    from bdd100k_tpu_torch.data.synthetic import generate_synthetic_scenes
    from bdd100k_tpu_torch.ops import depthwise as dw
    from bdd100k_tpu_torch.ops import map_metric, matcher, matching
    from bdd100k_tpu_torch.ops import nms
    from bdd100k_tpu_torch.ops.anchors import ssd_anchors
    from bdd100k_tpu_torch import infer
    from bdd100k_tpu_torch.utils import cuda_build

    # phase 1: device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # phase 2: build
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: str(v.relative_to(ROOT)) for k, v in libs.items()},
         **{f"{name}_ptxas": ptxas_report(cuda_build.BUILD_LOGS.get(name, ""))
            for name in ("depthwise", "nms", "matcher")})

    # phases 3-6: each kernel against its plain version, and the launch floor
    floor_ms = phase_launch_floor(torch)
    nms_t = phase_kernel_nms(torch, nms)
    dw_t = phase_kernel_depthwise(torch, dw)
    bwd_t = phase_kernel_depthwise_bwd(torch, dw)
    match_t = phase_kernel_matcher(torch, matcher, matching, ssd_anchors().cuda())

    frames, gt_boxes, gt_labels = generate_synthetic_scenes(16, seed=1)
    # phase 5: the f32 path against the CPU, and NMS on its candidates
    captures = phase_path_f32(torch, infer, nms, dw, frames)
    nms_path = phase_nms_path_inputs(torch, nms, captures)
    # phase 6: serving in bf16 — the main path
    launches, _ = phase_path_bf16(torch, infer, nms, dw, map_metric,
                                  frames, gt_boxes, gt_labels)
    phase_preselect(torch, infer, nms, frames)

    # eval from JPEG files to mAP: the host's decode facts,
    # the decode pool against the reference's pixels, the f32 eval path
    # against the JAX fixture, then the bf16 main path through the CLI
    nproc = phase_probe_host()
    decode_rate = phase_decode(nproc)
    eval_nms = phase_eval_f32(torch, nms, dw, nproc, decode_rate)
    ev = phase_eval_bf16(torch, nms, dw, decode_rate)
    phase_eval_throughput(torch, nproc, decode_rate)

    # training: f32 against the CPU, then the bf16 main path
    # (the driver, with a resume), a profile of its step, the overfit check
    train_frames, train_boxes, train_labels = generate_synthetic_scenes(8, seed=0)
    phase_train_f32(torch, train_frames, train_boxes, train_labels)
    train = phase_train_bf16(torch, dw, matcher)
    phase_eval_own_ckpt(torch)
    phase_train_profile(torch, train_frames, train_boxes, train_labels)
    phase_overfit(torch, train_frames, train_boxes, train_labels)

    # YOLO-MobileNet-384: the same four kernels at YOLO's shapes, then its
    # serving, eval (both artifact/priors pairs) and training paths
    yolo = run_yolo_phases(torch, infer, nms, dw, matcher, matching, map_metric,
                           nproc, decode_rate)

    # VGG16-SSD512 (BASELINE config 2): serving, eval and training, NMS at
    # K=200 on its own candidates and the matcher on its 24564 anchors;
    # then the serving CLI of all three families, and the full-resolution
    # decode it uses for one image
    vgg = run_vgg_phases(torch, infer, nms, dw, matcher, matching, nproc,
                         decode_rate)
    cli = phase_infer_cli()
    full_res_rate = phase_full_res_decode(nproc)

    # training from JPEG files (slice 8): SSD300 on the yuv420 wire from a
    # pretrained backbone and at full resolution, VGG16-SSD512 from a
    # torchvision-layout backbone, the exporter and an eval of its
    # artifact, then the progressive decode and the bicubic resize
    files = run_files_phases(torch, nms, dw, matcher, nproc)

    # the kernel table; launches are those of the main paths: SSD300
    # serving 512 requests, eval 2 batches of 32, 40 train steps; YOLO-384
    # serving 512 requests, eval 2 batches of 32 for each of the two
    # artifacts, 30 train steps at B=64; VGG16-SSD512 serving 4 modes ×
    # (256 b1 + 16 b32 requests), eval 2 batches of 32, 10 train steps
    tl, el = train["launches"], ev["launches"]
    fl = {k: sum(files[p]["launches"].get(k, 0) for p in files)
          for k in ("depthwise3x3_s1", "depthwise3x3_s1_fgrad", "encode_targets",
                    "greedy_suppress")}
    vsl, vel = vgg["serve"]["launches"], vgg["eval_bf16"]["launches"]
    vtl = vgg["train"]["launches"]
    ysl, ytl = yolo["serve_launches"], yolo["train"]["launches"]
    yel = {k: sum(e["launches"][k] for e in yolo["eval_bf16"].values())
           for k in ("greedy_suppress", "depthwise3x3_s1")}
    ydw, ym, yn = yolo["dw"], yolo["matcher"], yolo["nms"]["b8"]

    def yolo_row(t: dict, shape: str) -> dict:
        return dict(shape=shape, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], library_ms=t.get("library_ms"))

    kernels = [
        dict(name="greedy_suppress", route="cuda",
             source="bdd100k_tpu_torch/csrc/nms.cu",
             replaces="bdd100k_tpu/ops/pallas_nms.py:124",
             launches=(launches["greedy_suppress"] + el["greedy_suppress"]
                       + ysl["greedy_suppress"] + yel["greedy_suppress"]
                       + vsl["greedy_suppress"] + vel["greedy_suppress"]
                       + fl["greedy_suppress"]),
             max_abs_err=nms_t["max_abs_err"],
             ms=nms_t[100]["ms"], plain_ms=nms_t[100]["plain_ms"],
             bound_ms=nms_t[100]["bound_ms"], bound_by=nms_t[100]["bound_by"],
             library_ms=None,
             yolo=yolo_row(dict(yn, ms=yn["kernel_ms"]),
                           "the YOLO b8 serving path's own candidates, C=10 K=100"),
             vgg=yolo_row(dict(vgg["nms"][f"b{EVAL_BATCH}"],
                               ms=vgg["nms"][f"b{EVAL_BATCH}"]["kernel_ms"]),
                          "VGG16-SSD512's own eval candidates, B=32 C=10 K=200"),
             vgg_b1=yolo_row(dict(vgg["nms"]["b1"], ms=vgg["nms"]["b1"]["kernel_ms"]),
                             "VGG16-SSD512's own candidates, B=1 C=10 K=200")),
        dict(name="depthwise3x3_s1", route="cuda",
             source="bdd100k_tpu_torch/csrc/depthwise.cu",
             replaces="bdd100k_tpu/ops/pallas_depthwise.py:219",
             launches=(launches["depthwise3x3_s1"] + el["depthwise3x3_s1"]
                       + tl["depthwise3x3_s1"] + ysl["depthwise3x3_s1"]
                       + yel["depthwise3x3_s1"] + ytl["depthwise3x3_s1"]
                       + fl["depthwise3x3_s1"]),
             max_abs_err=max(dw_t["max_abs_err"], ydw["max_abs_err"]), ms=dw_t["ms"],
             plain_ms=dw_t["plain_ms"], bound_ms=dw_t["bound_ms"],
             bound_by="bytes", library_ms=dw_t["library_ms"],
             yolo=yolo_row(ydw["fwd_b8"], "forward, 9 layers at 384², B=8 bf16"),
             yolo_b32=yolo_row(ydw["fwd_b32"], "forward, 9 layers, B=32 bf16"),
             yolo_dx=yolo_row(ydw["dx"], "dx, 9 layers, B=64 bf16")),
        dict(name="depthwise3x3_s1_fgrad", route="cuda",
             source="bdd100k_tpu_torch/csrc/depthwise.cu",
             replaces="bdd100k_tpu/ops/pallas_depthwise.py:242",
             launches=(tl["depthwise3x3_s1_fgrad"] + ytl["depthwise3x3_s1_fgrad"]
                       + fl["depthwise3x3_s1_fgrad"]),
             max_abs_err=max(bwd_t["max_abs_err"], ydw["dk_max_abs_err"]),
             ms=bwd_t["dk"]["ms"],
             plain_ms=bwd_t["dk"]["plain_ms"], bound_ms=bwd_t["dk"]["bound_ms"],
             bound_by="bytes", library_ms=bwd_t["dk"]["library_ms"],
             yolo=yolo_row(ydw["dk"], "9 layers at 384², B=64 bf16")),
        dict(name="encode_targets", route="cuda",
             source="bdd100k_tpu_torch/csrc/matcher.cu",
             replaces="bdd100k_tpu/ops/pallas_matcher.py:202",
             launches=(tl["encode_targets"] + ytl["encode_targets"]
                       + vtl["encode_targets"] + fl["encode_targets"]),
             max_abs_err=max(match_t["max_abs_err"], ym["max_abs_err"],
                             vgg["matcher"]["max_abs_err"]),
             ms=match_t["ms"], plain_ms=match_t["plain_ms"],
             bound_ms=match_t["bound_ms"], bound_by=match_t["bound_by"],
             library_ms=None,
             yolo=yolo_row(ym, "B=64 M=100 A=9072 YOLO anchors"),
             vgg=yolo_row(vgg["matcher"], "B=32 M=100 A=24564 SSD512 anchors")),
    ]
    emit("done", seconds=time.perf_counter() - t_start,
         launch_floor_ms=floor_ms,
         nms_k200=nms_t[200], nms_b32=nms_t["b32"], nms_path_inputs=nms_path,
         nms_eval_inputs=eval_nms, depthwise_fwd_b32=dw_t["b32"],
         depthwise_dx_b32_bf16=bwd_t["dx"],
         depthwise_dk_b32_bf16=bwd_t["dk"],
         yolo_depthwise=ydw, yolo_matcher=ym, yolo_nms=yn,
         yolo_eval={p: dict(f32=yolo["eval_f32"][p]["map50"],
                            bf16=yolo["eval_bf16"][p]["map50"])
                    for p in YOLO_PAIRS},
         yolo_train_step=yolo["train"]["step_time"],
         vgg_nms=vgg["nms"], vgg_matcher=vgg["matcher"],
         vgg_eval=dict(f32=vgg["eval_f32"]["map50"], bf16=vgg["eval_bf16"]["map50"]),
         vgg_train_step=vgg["train"]["step_time"],
         vgg_train_peak_mem_gb=vgg["train"]["peak_mem_gb"],
         cli_bf16_imgs_per_s={c: {w: r[f"bf16_{w}"]["imgs_per_s_after_first_batch"]
                                  for w in ("yuv420", "rgb")} for c, r in cli.items()},
         full_res_decode_imgs_per_s=full_res_rate,
         train_files_step=files["files"]["step_time"],
         train_files_busy_share=files["files"]["busy"]["device_busy_share"],
         train_files_full_busy_share=files["full"]["busy"]["device_busy_share"],
         train_files_busy_share_of_unprofiled_p50=files["files"]["busy"][
             "device_busy_share_of_unprofiled_p50"],
         train_files_full_busy_share_of_unprofiled_p50=files["full"]["busy"][
             "device_busy_share_of_unprofiled_p50"],
         export_eval_map50=files["export"]["map50"],
         note="kernel ms (SSD300 shapes): NMS at B=8 C=10 K=100 (one launch a "
              "call); depthwise forward summed over the 9 stride-1 layers at B=8 "
              "bf16, filter gradient at B=32 bf16; matcher at B=32 M=100 A=8732 "
              "(one launch a call); each row's `yolo` (and the depthwise row's "
              "`yolo_b32`, `yolo_dx`) gives YOLO-384's shapes as its `shape` "
              "says, and the NMS and matcher rows' `vgg` (and `vgg_b1`) "
              "VGG16-SSD512's; launches: SSD300 serving 512 requests + eval 2 "
              "batches + 40 train steps, YOLO-384 serving 512 requests + eval 2 "
              "batches for each of 2 artifacts + 30 train steps at B=64, "
              "VGG16-SSD512 serving 4 modes x (256 b1 + 16 b32 requests) + "
              "eval 2 batches + 10 train steps at B=32; training from JPEG "
              "files: SSD300 30 steps at 512 yuv420 + 8 at full resolution, "
              "VGG16-SSD512 5 steps, and the exported artifact's eval 2 "
              "batches")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
