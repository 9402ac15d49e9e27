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
`tests/fixtures/decode_repairs/ref_sha256.json`. Then int8 quant: six
quantized layers on the card against the CPU route (codes, int32
accumulators, outputs bit-equal), the int8 conv route's times beside
cuDNN's bf16 conv for every quantized layer of VGG16-SSD512 at B=32 and
SSD300 at B=8, the int8 evals of SSD300 (int8, int8_static) and
VGG16-SSD512 (int8_static, the requant pipeline) against the JAX fixture
`tests/fixtures/torch_ref_eval_int8.npz` in f32 and bf16, with the
depthwise and NMS kernels held to their plain versions on that path,
int8_static serving beside bf16, the serving CLI with --calib_images of
JPEGs and PNGs against the reference CLI's lines, the PNG decoder against
PIL's sha256s, and progressive JPEGs cut before their last scans against
the reference pool's smoothed decodes. Then slice 10: the JPEG encoder
on the 64 seed-1 renders against the committed JPEGs' sha256s (timed on
the card's host), `--synthetic 8` writing the reference's split and the
trainer taking 3 steps from it, `infer --out_dir` writing det_<name>.jpg
with the bytes of PIL's save of the reference's detections drawn, the
trainer under --multihost at a world of one rank on NCCL for both step
forms against the plain trainer (losses within 1e-6 in f32), two ranks on
this card over gloo against one process, and the eval over two ranks,
its merged mAP the single-process one. Then slice 11: the host cost of
calling each kernel through its `torch.library` op against its ctypes
wrapper; `python -m bdd100k_tpu_torch.export` of SSD300 (f32 and bf16,
for cuda and cpu), the f32 artifact loaded on the card against the
in-process f32 Predictor on the 64 JPEGs (the kernels' launches counted
over the artifact's runs), the bf16 artifacts served at b1 and b8 beside
the Predictor, the f32 artifact loaded on the CPU against the CPU
Predictor; `python -m bdd100k_tpu_torch.scripts.check_export_parity` on
an int8_static artifact calibrated on tests/fixtures/calib_mixed
(PARITY OK); and `parallel/spatial.py` (one frame's convs over tiles,
halos exchanged by hand) on two gloo ranks sharing this card and at a
world of one on NCCL, against the single-process Predictor at b1.
Phases that need other processes run this file again as `--worker`.
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
    seed-0 synthetic train scenes (`--synthetic 64`: the split the trainer
    writes as JPEGs into SYNTH_TRAIN_DIR, decoded at 720p, augment on the
    card), 40 steps from the seeded init with a checkpoint at step 20; then
    a second run given only that checkpoint resumes and ends at 40. The
    runs keep an EMA shadow, which `phase_eval_own_ckpt` evaluates."""
    import shutil

    from bdd100k_tpu_torch import train as train_mod

    shutil.rmtree(RUNS, ignore_errors=True)
    first, second = RUNS / "train", RUNS / "resume"
    argv = ["--config", CONFIG, "--synthetic", str(TRAIN_SCENES),
            "--synthetic_dir", str(SYNTH_TRAIN_DIR),
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
    seed-0 synthetic train scenes (the JPEG split in SYNTH_TRAIN_DIR,
    decoded at 720p, augment to the config's size on the card), `steps`
    steps from the seeded init: finite losses, one
    matcher launch and the config's depthwise forward, dx and dk launches
    a step (9 + 9 + 9 for MobileNet, none for VGG16), step times and peak
    device memory."""
    import shutil

    from bdd100k_tpu_torch import train as train_mod

    run_dir = RUNS / phase
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--config", config, "--synthetic", str(scenes),
            "--synthetic_dir", str(SYNTH_TRAIN_DIR), "--batch_size", str(batch),
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


def cli_lines_agree(got: dict, want: dict, names: list[str],
                    tol: float = CLI_LINE_TOL, tie: float = CLI_TIE) -> list[str]:
    """Per image, each line of one side has a line of the other of its
    class with score and corners within `tol`; a line left over must sit
    within `tie` of the threshold (a near-tie there, named in the result)
    → the near-ties."""
    ties = []
    for name in names:
        left = list(want.get(name, []))
        extra = []
        for cls, score, box in got.get(name, []):
            hit = [j for j, (c, s, b) in enumerate(left) if c == cls
                   and abs(s - score) <= tol
                   and max(abs(p - q) for p, q in zip(b, box)) <= tol]
            if hit:
                left.pop(hit[0])
            else:
                extra.append(("port", cls, score))
        extra += [("reference", c, s) for c, s, _ in left]
        for side, cls, score in extra:
            if abs(score - CLI_THRESHOLD) > tie:
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
    jpgs = sorted(drawn.glob("det_*"))  # det_<name>, JPEGs as the inputs are
    if [p.name for p in jpgs] != [f"det_{n}" for n in names[:8]] or \
            not all(p.read_bytes()[:3] == b"\xff\xd8\xff" for p in jpgs):
        raise AssertionError(f"--out_dir wrote {[p.name for p in jpgs]}")
    emit("infer_cli", command="python -m bdd100k_tpu_torch.infer",
         scenes=len(names), batch=EVAL_BATCH, line_tol=CLI_LINE_TOL,
         threshold=CLI_THRESHOLD, near_tie_band=CLI_TIE, lines_agree=True,
         out_dir_jpegs=len(jpgs), **out)
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


# ------------------------------------------------------------------ int8

INT8_FIXTURE = ROOT / "tests" / "fixtures" / "torch_ref_eval_int8.npz"
CALIB_DIR = ROOT / "tests" / "fixtures" / "calib_mixed"
PNG_DIR = ROOT / "tests" / "fixtures" / "png"
# the int8 evals at b32, each against its fixture entry: (config, quant,
# artifact, JPEGs); the reference's VGG512 fixture covers the first 8
INT8_EVALS = ((CONFIG, "int8", ARTIFACT, EVAL_SCENES),
              (CONFIG, "int8_static", ARTIFACT, EVAL_SCENES),
              (VGG_CONFIG, "int8_static", VGG_ARTIFACT, 8))
INT8_CONFIDENT = 0.4   # the fixture gate's confident detections
# their scores and corners, card against the CPU fixture: the frameworks'
# f32 sums flip a few codes and the flips cascade (up to 0.0175 measured
# between the port and the reference on the CPU,
# tests/test_torch_quant_eval.py); the CLI's int8 lines likewise
INT8_DET_TOL = 0.02
# VGG512's 8 images: the port's own mAP moves by 0.010 under 2 ulps of
# input noise (tests/test_torch_quant_eval.py), added to its tolerances
VGG_SUBSET_SPREAD = 0.010
INT8_TIMING_REPS = 3   # event-timed calls per layer in the int8 conv table


def int8_key(config: str, quant: str, n: int) -> str:
    return f"{config}_{quant}_{n}"


def event_ms(torch, fn, reps: int = INT8_TIMING_REPS) -> float:
    """Median device time of `fn` over `reps` calls after one warm-up,
    each between two CUDA events (for calls that allocate, which a graph
    capture would not take)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def quant_conv_from(torch, sd: dict, name: str, **kw):
    """A QuantConv (f32) with the artifact's weights of module `name`."""
    from bdd100k_tpu_torch.models.layers import QuantConv

    w = sd[f"{name}.weight"]
    o, i, k, _ = w.shape
    layer = QuantConv(i, o, k, bias=f"{name}.bias" in sd, dtype=torch.float32, **kw)
    with torch.no_grad():
        layer.weight.copy_(w)
        if layer.bias is not None:
            layer.bias.copy_(sd[f"{name}.bias"])
    return layer


def to_cuda(x):
    from bdd100k_tpu_torch.models.layers import Int8Act

    if isinstance(x, Int8Act):
        return Int8Act(*(None if t is None else t.cuda() for t in x))
    return x.cuda()


def phase_quant_layers(torch) -> dict:
    """Four quantized layers on the card against the same layers on the
    CPU over the same input: the codes, the int32 accumulators and the
    f32 outputs (or emitted codes) equal. SSD300's ds13 pointwise conv
    (dynamic and static, B=8), VGG512's block2 conv1 (K=576, static, emits
    codes), fc6 (dilation 6, on int8 codes, emits) and SSD300's last extra
    stage at b1 (a 1×1 conv on a 3×3 map, M=9, and a 3×3 VALID conv to
    1×1, M=1: `_int_mm`'s padded shapes)."""
    from bdd100k_tpu_torch.models.layers import Int8Act, _R127
    from bdd100k_tpu_torch.utils.weights import load_detector_npz

    ssd, _ = load_detector_npz(ARTIFACT)
    vgg, _ = load_detector_npz(VGG_ARTIFACT)
    g = torch.Generator().manual_seed(11)

    def act(*shape, hi=4.0):
        return torch.rand(*shape, generator=g) * hi

    codes = torch.randint(0, 128, (2, 512, 32, 32), generator=g).to(torch.int8)
    out_max = torch.tensor(6.35)
    cases = {
        "ssd300_ds13_pw_dynamic": (ssd, "backbone.ds13.pw.Conv_0", dict(),
                                   act(8, 1024, 10, 10, hi=6.0)),
        "ssd300_ds13_pw_static": (ssd, "backbone.ds13.pw.Conv_0",
                                  dict(static_act=True), act(8, 1024, 10, 10, hi=6.0)),
        "vgg512_block2_conv1_emit": (vgg, "backbone.block2.conv1",
                                     dict(static_act=True, emit_int8=True),
                                     act(2, 64, 256, 256)),
        "vgg512_fc6_dilated_emit": (vgg, "backbone.fc6",
                                    dict(static_act=True, emit_int8=True, dilation=6),
                                    Int8Act(codes, out_max * _R127, out_max)),
        "ssd300_extra3_squeeze_b1": (ssd, "extra3.squeeze.Conv_0",
                                     dict(static_act=True), act(1, 256, 3, 3, hi=6.0)),
        "ssd300_extra3_down_valid_b1": (ssd, "extra3.down.Conv_0",
                                        dict(static_act=True, padding="VALID"),
                                        act(1, 128, 3, 3, hi=6.0)),
    }
    rows = {}
    for name, (sd, module, kw, x) in cases.items():
        cpu = quant_conv_from(torch, sd, module, **kw)
        if cpu.static_act:  # calibrate on the CPU: both maxima from this input
            xf = x if not isinstance(x, Int8Act) else x.codes.float() * x.scale
            cpu.calibrating = True
            with torch.inference_mode():
                cpu(xf)
            cpu.calibrating = False
        gpu = quant_conv_from(torch, sd, module, **kw).cuda()
        gpu.load_state_dict(cpu.state_dict())
        for buf in ("act_amax", "out_amax"):
            if hasattr(cpu, buf):
                getattr(gpu, buf).copy_(getattr(cpu, buf))
        with torch.inference_mode():
            xq_c, s_c = cpu.quantize_input(x)
            xq_g, s_g = gpu.quantize_input(to_cuda(x))
            acc_c, sc_c = cpu.accumulate(x)
            acc_g, sc_g = gpu.accumulate(to_cuda(x))
            out_c, out_g = cpu(x), gpu(to_cuda(x))
        emitted = isinstance(out_c, Int8Act)
        oc = out_c.codes if emitted else out_c
        og = (out_g.codes if emitted else out_g).cpu()
        row = dict(
            module=module, input=list((x.codes if isinstance(x, Int8Act) else x).shape),
            acc_shape=list(acc_c.shape), k=int(cpu.weight[0].numel()),
            m=int(acc_c.shape[0] * acc_c.shape[2] * acc_c.shape[3]),
            codes_equal=bool(torch.equal(xq_c, xq_g.cpu())),
            scale_equal=bool(torch.equal(sc_c, sc_g.cpu())),
            acc_equal=bool(torch.equal(acc_c, acc_g.cpu())),
            max_abs_acc=int(acc_c.abs().max()),
            output="codes" if emitted else "f32",
            output_equal=bool(torch.equal(oc, og)),
            output_max_abs_err=float((oc.float() - og.float()).abs().max()))
        if emitted:
            row["emit_scale_equal"] = float(out_c.scale) == float(out_g.scale)
        rows[name] = row
    bad = [n for n, r in rows.items()
           if not all(v for k, v in r.items() if k.endswith("_equal"))]
    emit("quant_layers", layers=rows, all_equal=not bad)
    if bad:
        raise AssertionError(f"quantized layers differ from the CPU: {bad}")
    return rows


def quant_layer_shapes(torch, config: str, batch: int) -> list[tuple]:
    """(name, input NCHW shape, module) of every QuantConv in one int8
    forward of `config` at `batch` (zeros: only the shapes count)."""
    import dataclasses

    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.models.layers import Int8Act, QuantConv

    cfg = dataclasses.replace(get_config(config), quant="int8")
    bundle = build_detector(cfg, dtype=torch.bfloat16, device="cuda")
    seen = []
    hooks = []
    for name, m in bundle.model.named_modules():
        if isinstance(m, QuantConv):
            def pre(mod, args, name=name):
                x = args[0]
                x = x.codes if isinstance(x, Int8Act) else x
                seen.append((name, tuple(x.shape), mod))
            hooks.append(m.register_forward_pre_hook(pre))
    s = cfg.image_size
    with torch.inference_mode():
        bundle.model(torch.zeros(batch, s, s, 3, device="cuda"))
    for h in hooks:
        h.remove()
    return seen


def phase_int8_conv_times(torch) -> dict:
    """Each quantized layer of VGG16-SSD512 at B=32 and SSD300 at B=8: the
    int8 route (`int8_conv2d`: the unfold and `_int_mm`), `_int_mm` alone
    on the unfolded matrix, and cuDNN's bf16 conv of the same layer
    (channels_last, the working type's route), each the median of
    INT8_TIMING_REPS event-timed calls → the table and its sums."""
    import torch.nn.functional as F

    from bdd100k_tpu_torch.ops.depthwise import same_pads
    from bdd100k_tpu_torch.ops.int8_conv import int8_conv2d, int_mm, weight_matrix

    table = {}
    for config, batch in ((VGG_CONFIG, EVAL_BATCH), (CONFIG, 8)):
        rows = []
        for name, shape, mod in quant_layer_shapes(torch, config, batch):
            b, c, h, w = shape
            x_q = torch.randint(0, 128, shape, device="cuda", dtype=torch.int8)
            x_q = x_q.contiguous(memory_format=torch.channels_last)
            w_q, _ = mod.quantized_weight()
            o, _, k, _ = w_q.shape
            route_ms = event_ms(torch, lambda: int8_conv2d(
                x_q, w_q, mod.stride, mod.padding, mod.dilation))
            acc = int8_conv2d(x_q, w_q, mod.stride, mod.padding, mod.dilation)
            m_rows = acc.shape[0] * acc.shape[2] * acc.shape[3]
            del acc
            kk = k * k * c
            a = torch.randint(-127, 128, (m_rows, kk), device="cuda", dtype=torch.int8)
            wm = weight_matrix(w_q)
            mm_ms = event_ms(torch, lambda: int_mm(a, wm))
            del a
            xb = x_q.to(torch.bfloat16)
            wb = mod.weight.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            pad = (0, 0, 0, 0)
            if mod.padding == "SAME":
                ke = (k - 1) * mod.dilation + 1
                ph, pw = same_pads(h, ke, mod.stride), same_pads(w, ke, mod.stride)
                pad = (pw[0], pw[1], ph[0], ph[1])
            if pad[0] == pad[1] and pad[2] == pad[3]:
                conv = lambda: F.conv2d(xb, wb, None, mod.stride, (pad[2], pad[0]),
                                        mod.dilation)
            else:
                conv = lambda: F.conv2d(F.pad(xb, pad), wb, None, mod.stride, 0,
                                        mod.dilation)
            cudnn_ms = event_ms(torch, conv)
            del xb
            rows.append(dict(layer=name, input=list(shape), kernel=k,
                             stride=mod.stride, dilation=mod.dilation,
                             padding=mod.padding, m=m_rows, k=kk, n=o,
                             int8_route_ms=route_ms, int_mm_ms=mm_ms,
                             bf16_cudnn_ms=cudnn_ms))
        torch.cuda.empty_cache()
        table[f"{config}_b{batch}"] = dict(
            layers=rows, sum_int8_route_ms=sum(r["int8_route_ms"] for r in rows),
            sum_int_mm_ms=sum(r["int_mm_ms"] for r in rows),
            sum_bf16_cudnn_ms=sum(r["bf16_cudnn_ms"] for r in rows))
    emit("int8_conv_times", reps=INT8_TIMING_REPS, **table)
    return {k: {kk: v for kk, v in t.items() if kk != "layers"}
            for k, t in table.items()}


def phase_eval_int8(torch, nms, dw, nproc: int, dtype_name: str) -> dict:
    """`run_eval` of the int8 models on the card at b32: SSD300 int8 and
    int8_static over the 64 JPEGs, VGG16-SSD512 int8_static (the requant
    pipeline) over the first 8, each int8_static model calibrated as the
    CLI calibrates (the eval set's head), against the reference's f32 CPU
    fixture. In f32 (TF32
    off) the mAP@0.5 stays within EVAL_F32_MAP_TOL and the confident
    detections (score ≥ 0.4) agree both ways within INT8_DET_TOL; in bf16
    within EVAL_BF16_MAP_TOL (VGG512's 8 images: plus VGG_SUBSET_SPREAD). On the int8 path the NMS kernel's keep masks
    equal the plain greedy's on the path's own candidates, and (f32) the
    depthwise kernel is held to its plain version on the path's own
    inputs of the first batch; the launches are counted."""
    import dataclasses

    from bdd100k_tpu_torch import evaluate
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.utils.device import strict_f32
    from bdd100k_tpu_torch.utils.weights import restore_eval_weights

    phase = f"eval_int8_{'f32' if dtype_name == 'float32' else 'bf16'}"
    dtype = torch.float32 if dtype_name == "float32" else torch.bfloat16
    base_tol = EVAL_F32_MAP_TOL if dtype_name == "float32" else EVAL_BF16_MAP_TOL
    fx = np.load(INT8_FIXTURE)
    rows = {}
    for config, quant, artifact, n in INT8_EVALS:
        key = int8_key(config, quant, n)
        tol = base_tol + (VGG_SUBSET_SPREAD if n < EVAL_SCENES else 0.0)
        cfg = dataclasses.replace(get_config(config), quant=quant)
        dets, captures, dw_inputs = [], [], []
        make_step, suppress, dw_route = (evaluate.make_eval_step,
                                         nms.greedy_suppress, dw.depthwise3x3_s1)

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

        def recording_dw(x, k):
            if len(dw_inputs) < dw_layers(config):
                dw_inputs.append((x, k))
            return dw_route(x, k)

        with strict_f32(dtype_name == "float32"):
            bundle = build_detector(cfg, dtype=dtype, device="cuda")
            restore_eval_weights(bundle.model, artifact, expect_config=config)
            dataset = evaluate.load_dataset(types.SimpleNamespace(
                synthetic=n, synthetic_dir=str(SYNTH_DIR), max_boxes=100),
                cfg.image_size)
            args = types.SimpleNamespace(
                batch_size=EVAL_BATCH, num_workers=nproc, wire="rgb",
                iou_threshold=0.5, coco_map=False, dump_detections=None,
                calib_images=None, calib_batches=8)
            torch.cuda.synchronize()
            nms.LAUNCHES["greedy_suppress"] = 0
            dw.LAUNCHES["depthwise3x3_s1"] = 0
            evaluate.make_eval_step = recording_step
            nms.greedy_suppress, dw.depthwise3x3_s1 = recording_suppress, recording_dw
            try:
                t0 = time.perf_counter()
                result = evaluate.run_eval(bundle, dataset, args)
                wall = time.perf_counter() - t0
            finally:
                evaluate.make_eval_step = make_step
                nms.greedy_suppress, dw.depthwise3x3_s1 = suppress, dw_route
            launches = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                            depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
            batches = -(-n // EVAL_BATCH)
            # int8_static calibrates first: up to 8 batches of 8
            forwards = batches + (-(-min(n, 64) // 8) if quant == "int8_static" else 0)
            if launches != dict(greedy_suppress=batches,
                                depthwise3x3_s1=dw_layers(config) * forwards):
                raise AssertionError(f"{phase} {key} launches {launches}")
            for cap in captures:
                want = nms.greedy_keep_mask(cap["boxes"].cpu(), cap["valid"].cpu(),
                                            cap["iou_threshold"])
                if not torch.equal(cap["keep"].cpu(), want):
                    raise AssertionError(f"{phase} {key}: NMS keep mask differs")
            dw_err = None
            if dtype_name == "float32" and dw_inputs:
                dw_err = max(check_dw_forward(torch, dw, x.float(), k.float(),
                                              f"{key} layer {i}")[0]
                             for i, (x, k) in enumerate(dw_inputs))
        det = types.SimpleNamespace(**{
            f: torch.cat([getattr(d, f) for d in dets]).cpu().numpy()[:n]
            for f in ("boxes", "scores", "classes", "valid")})
        want = types.SimpleNamespace(**{f: fx[f"{key}/{f}"] for f in
                                        ("boxes", "scores", "classes", "valid")})
        if det.boxes.shape != (n, 200, 4) or not np.isfinite(det.boxes).all():
            raise AssertionError(f"{phase} {key}: bad detections")
        map_diff = result["mAP"] - float(fx[f"{key}/map50"])
        row = dict(config=config, quant=quant, weights=artifact.name, scenes=n,
                   map50=result["mAP"], fixture_map50=float(fx[f"{key}/map50"]),
                   map50_diff=map_diff, map50_tol=tol, launches=launches,
                   nms_keep_bits_equal_in_path=True,
                   depthwise_in_path_max_abs_err=dw_err, wall_s=wall,
                   images_per_sec=result["images_per_sec"],
                   calib_images_used=result.get("calib_images_used"))
        if quant == "int8_static":
            from bdd100k_tpu_torch.models.quant import quant_state

            names = [s.decode() for s in fx[f"{key}/quant_names"]]
            state = quant_state(bundle.model)
            rel = [abs(float(state[n]) - float(v)) / float(v)
                   for n, v in zip(names, fx[f"{key}/quant_values"])]
            row["calib_max_rel_diff_vs_fixture"] = max(rel)
        if dtype_name == "float32":
            confident_agree(want, det, n, thr=INT8_CONFIDENT, tol=INT8_DET_TOL)
            confident_agree(det, want, n, thr=INT8_CONFIDENT + 0.01, tol=INT8_DET_TOL)
            row["confident_detections_agree"] = True
        rows[key] = row
        if not abs(map_diff) <= tol:
            emit(phase, **rows)
            raise AssertionError(f"{phase} {key}: mAP {result['mAP']} is {map_diff} "
                                 "from the fixture's")
        del bundle
        torch.cuda.empty_cache()
    emit(phase, batch=EVAL_BATCH, **rows)
    return rows


INT8_SERVE = {"ssd300_b1": (CONFIG, ARTIFACT, 1, 64), "ssd300_b8": (CONFIG, ARTIFACT, 8, 32),
              "vgg512_b32": (VGG_CONFIG, VGG_ARTIFACT, EVAL_BATCH, 8)}
INT8_SERVE_WARMUP = 3


def phase_path_int8(torch, infer, nms, dw, frames) -> dict:
    """Serving in int8_static through `load_predictor(quant="int8_static",
    calib_images=...)` (calibrated on tests/fixtures/calib_mixed, JPEGs and
    PNGs, when the predictor is built), beside the bf16 predictor of the
    same config in the same run: SSD300 at b1 and b8, VGG16-SSD512 at b32,
    on 720p frames resized on the card. The int8 requests are the path's
    counted run (counts to 0 before, read after) → launches and rows."""
    rows, launches = {}, dict(greedy_suppress=0, depthwise3x3_s1=0)
    for name, (config, artifact, bs, n) in INT8_SERVE.items():
        requests = [np.take(frames, range(bs * r, bs * r + bs), axis=0, mode="wrap")
                    for r in range(n)]
        row = {}
        for mode in ("bf16", "int8_static"):
            kw = dict(quant="int8_static", calib_images=CALIB_DIR) \
                if mode != "bf16" else {}
            pred = infer.load_predictor(config, artifact, batch_size=bs,
                                        device="cuda", **kw)
            for r in requests[:INT8_SERVE_WARMUP]:
                pred(r)
            torch.cuda.synchronize()
            if mode != "bf16":
                nms.LAUNCHES["greedy_suppress"] = 0
                dw.LAUNCHES["depthwise3x3_s1"] = 0
            lat, outs = [], []
            for r in requests:
                t0 = time.perf_counter()
                outs.append(pred(r))
                lat.append((time.perf_counter() - t0) * 1e3)
            if mode != "bf16":
                got = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                           depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
                if got != dict(greedy_suppress=n, depthwise3x3_s1=dw_layers(config) * n):
                    raise AssertionError(f"path_int8 {name} launches {got}")
                for k in launches:
                    launches[k] += got[k]
            for det in outs:
                if not (np.isfinite(det.boxes).all() and det.valid.any()):
                    raise AssertionError(f"path_int8 {name} {mode}: bad detections")
            row[mode] = latency_stats(lat, [t / 1e3 for t in lat], bs)
            del pred
            torch.cuda.empty_cache()
        row["int8_over_bf16_p50"] = row["int8_static"]["p50_ms"] / row["bf16"]["p50_ms"]
        rows[name] = row
    emit("path_int8", calib_dir=str(CALIB_DIR.relative_to(ROOT)), launches=launches,
         frame="720x1280 uint8 rgb", **rows)
    return dict(rows, launches=launches)


def phase_infer_cli_int8() -> dict:
    """`python -m bdd100k_tpu_torch.infer --quant int8_static
    --calib_images tests/fixtures/calib_mixed` (two JPEGs, three PNGs)
    over the 64 JPEGs at b32 in f32: its lines equal the reference CLI's
    f32 lines in the fixture's "int8" part."""
    import os

    from bdd100k_tpu_torch import infer

    ref = json.loads(CLI_FIXTURE.read_text())["int8"]
    names = jpeg_names()
    logs = RUNS / "infer_cli"
    logs.mkdir(parents=True, exist_ok=True)
    stdout, wall = run_cli(["--config", CONFIG, "--ckpt_dir", os.path.relpath(ARTIFACT),
                            "--image_dir", os.path.relpath(SYNTH_DIR / "images" / "val"),
                            "--batch_size", str(EVAL_BATCH), "--dtype", "float32",
                            "--quant", "int8_static",
                            "--calib_images", os.path.relpath(CALIB_DIR)],
                           logs / "int8_static_calib_mixed_f32.txt")
    if "calibrated act scales on 8 frames" not in stdout:
        raise AssertionError("the CLI did not calibrate on the 8 frames")
    cli_rate(stdout, len(names))
    got = infer.parse_detection_lines(stdout)
    ties = cli_lines_agree(got, infer.parse_detection_lines(
        "\n".join(ref["dir_int8_static"])), names, tol=INT8_DET_TOL, tie=INT8_DET_TOL)
    row = dict(lines=sum(map(len, got.values())),
               fixture_lines=len(ref["dir_int8_static"]), near_ties=ties, wall_s=wall)
    emit("infer_cli_int8", config=CONFIG, calib_dir=str(CALIB_DIR.relative_to(ROOT)),
         **row)
    return row


def phase_png_decode() -> dict:
    """The committed PNGs (every colour type and depth, tRNS, Adam7, all
    five filters) through `decode_png`, each sha256 equal to PIL's
    convert("RGB") in the fixture; and the decode time of a 720p frame the
    port's own PNG writer wrote."""
    from bdd100k_tpu_torch.data.png import decode_png
    from bdd100k_tpu_torch.data.synthetic import generate_synthetic_scenes
    from bdd100k_tpu_torch.utils.viz import write_png

    want = json.loads((PNG_DIR / "pil_sha256.json").read_text())
    bad = [n for n, d in want.items()
           if sha256(decode_png((PNG_DIR / f"{n}.png").read_bytes())) != d]
    frame = generate_synthetic_scenes(1, seed=3)[0][0]
    path = RUNS / "frame_720p.png"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(path, frame)
    data = path.read_bytes()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = decode_png(data)
        times.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(got, frame):
        bad.append("frame_720p round trip")
    emit("png_decode", files=len(want),
         sha256_match_pil=f"{len(want) - len(bad)}/{len(want)}", mismatches=bad,
         frame_720p_bytes=len(data), frame_720p_decode_ms=float(np.median(times)))
    if bad:
        raise AssertionError(f"PNG decodes differ from PIL's: {bad}")
    return dict(decode_ms=float(np.median(times)))


SMOOTHING_CUTS = (("progressive_420", 0.05), ("progressive_420", 0.20),
                  ("progressive_420", 0.35), ("progressive_gray", 0.20),
                  ("progressive_444", 0.20), ("progressive_444", 0.43),
                  ("progressive_restart", 0.65))


def phase_decode_smoothing(nproc: int) -> None:
    """The committed progressive JPEGs cut before their last scans, where
    libjpeg-turbo smooths the coefficients still unrefined, through the
    pool at 300 rgb, 300 yuv420 and 512: each sha256 equal to the
    reference pool's in the fixture."""
    from bdd100k_tpu_torch.data.native_decode import NativeDecoder

    want = json.loads((REPAIRS / "ref_smoothing_sha256.json").read_text())
    dec = NativeDecoder(nproc)
    bad, checked = [], 0
    try:
        for name, share in SMOOTHING_CUTS:
            jpeg = (REPAIRS / f"{name}.jpg").read_bytes()
            key = f"{name}@{int(share * 100)}"
            cut = jpeg[:int(len(jpeg) * share)]
            got = {str(s): sha256(dec.decode_batch([cut], s)[0]) for s in (300, 512)}
            if "gray" not in name:
                y, uv = dec.decode_batch_yuv420([cut], 300)
                got["300_yuv420"] = [sha256(y[0]), sha256(uv[0])]
            checked += len(got)
            bad += [(key, k) for k in want[key] if got.get(k) != want[key][k]]
    finally:
        dec.close()
    emit("decode_smoothing", cuts=[f"{n}@{int(s * 100)}" for n, s in SMOOTHING_CUTS],
         sha256_match_reference=f"{checked - len(bad)}/{checked}", mismatches=bad)
    if bad:
        raise AssertionError(f"smoothed decodes differ from the reference's: {bad}")


def run_int8_phases(torch, infer, nms, dw, nproc: int, frames) -> dict:
    """Slice 9's phases: the int8 layers against the CPU, the int8 conv
    table, the int8 evals in f32 and bf16, int8 serving beside bf16, the
    CLI with --calib_images, then PNG decode and the smoothed progressive
    decodes."""
    layers = phase_quant_layers(torch)
    conv = phase_int8_conv_times(torch)
    ev32 = phase_eval_int8(torch, nms, dw, nproc, "float32")
    ev16 = phase_eval_int8(torch, nms, dw, nproc, "bfloat16")
    path = phase_path_int8(torch, infer, nms, dw, frames)
    cli = phase_infer_cli_int8()
    png = phase_png_decode()
    phase_decode_smoothing(nproc)
    return dict(layers=layers, conv=conv, eval_f32=ev32, eval_bf16=ev16,
                path=path, cli=cli, png=png)


# ----------------------------------------------------------- slice 10
# the JPEG encoder, the synthetic split written as the reference writes it,
# drawn outputs as JPEGs, and data parallelism over torch.distributed

JPEG_FIXTURE = ROOT / "tests" / "fixtures" / "torch_ref_jpeg_encode.json"
SYNTH_TRAIN_DIR = RUNS / "synth_train"  # the seed-0 train split the trainers write
DP_STEPS = 8              # dp_world1: steps a run, profiled 2-4
DP_PROFILE = (2, 4)
DP_TWO_B = 16             # dp_two_ranks: the global batch, 8 a rank
DP_TWO_STEPS = 3
DP_LOSS_RTOL = 1e-6       # dp_world1: a world of one computes the plain step
# dp_two_ranks: one process against two ranks, f32 with other summation
# orders. The first step sees the same weights and batch: its loss (the
# global BatchNorm statistics) and its grad norm (the all-reduced
# gradients, before the clip hides their scale; a sum for a mean would be
# off by 1.0) are held at DP_TWO_LOSS0_RTOL and DP_TWO_NORM0_RTOL, with
# room over the 7.4e-8 and 1.05e-4 measured on an H100 80GB HBM3 at
# 700 W. The grad norm moves more: f32
# BatchNorm's fast variance E[x²] − E[x]² cancels on SSD300's 1×1–5×5
# extra maps (16 values a channel at 1×1), and the backward through
# rsqrt(var + eps) carries that rounding. Later steps amplify it
# ~100-fold a step, so the 3-step losses and weights are held against a
# control: the same one process with its batch's two halves swapped, the
# same loss summed in another order. On that card the two ranks drifted
# 5.9× and 7.9× as far as the control in the step-2 and
# step-3 losses and 1.2× in the weights' L2 distance over the update's
# norm (0.126 against 0.108): the ranks' first-step rounding is larger
# than the swap's (which leaves the forward bit-equal), the growth alike
DP_TWO_LOSS0_RTOL = 1e-6
DP_TWO_NORM0_RTOL = 1e-3
DP_TWO_CONTROL = 16.0
DP_TWO_FLOOR = 1e-4
WORKER_TIMEOUT = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(worker_argv: list[str], world: int, log_stem: str,
                extra_env: dict | None = None) -> list[str]:
    """`python3 chip_smoke.py --worker ...` as `world` ranks (the env
    torchrun sets, every rank on this card: LOCAL_RANK 0) → each rank's
    stdout; a rank that fails or outlives WORKER_TIMEOUT raises, and every
    rank is stopped."""
    import os

    port = str(free_port())
    procs = []
    for rank in range(world):
        env = {**os.environ, **(extra_env or {}), "MASTER_ADDR": "localhost",
               "MASTER_PORT": port, "WORLD_SIZE": str(world), "RANK": str(rank),
               "LOCAL_RANK": "0"}
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker", *worker_argv],
            cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, out in enumerate(outs):
        (RUNS / f"{log_stem}_rank{rank}.txt").write_text(out)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{log_stem}: ranks {bad} failed:\n"
                             + "\n".join(outs[r][-3000:] for r in bad))
    return outs


def worker_report(out: str) -> dict:
    """The JSON line a worker prints last."""
    return json.loads(out.strip().splitlines()[-1])


def worker_module(argv: list[str]) -> int:
    """`--worker module M ARGS`: `M.main(ARGS)` as `python -m M ARGS` runs
    it, then one JSON line: the kernel launches this process made (its
    counts start at 0) and the mAP of a result. cuDNN is held to its
    deterministic algorithms, so two runs of one computation agree."""
    import importlib

    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    from bdd100k_tpu_torch.ops import depthwise as dw
    from bdd100k_tpu_torch.ops import matcher, nms

    result = importlib.import_module(argv[0]).main(argv[1:])
    report = {"launches": {**dw.LAUNCHES, **matcher.LAUNCHES, **nms.LAUNCHES}}
    if isinstance(result, dict):
        report["result"] = {k: result[k] for k in ("mAP", "num_images", "num_hosts")
                            if k in result}
    print(json.dumps(report), flush=True)
    return 0


def phase_jpeg_encode() -> dict:
    """The encoder on the card's host: the 64 seed-1 renders at quality 90
    give the committed fixture JPEGs (the reference's PIL bytes), all 64
    sha256s; each 720p encode timed."""
    import hashlib

    from bdd100k_tpu_torch.data.jpeg_encode import encode_jpeg
    from bdd100k_tpu_torch.data.synthetic import generate_synthetic_scenes

    t0 = time.perf_counter()
    frames, _, _ = generate_synthetic_scenes(EVAL_SCENES, seed=1)
    render_s = time.perf_counter() - t0
    encode_jpeg(frames[0], 90)  # builds the host library if it must
    ms, equal = [], 0
    for i, frame in enumerate(frames):
        t = time.perf_counter()
        data = encode_jpeg(frame, 90)
        ms.append((time.perf_counter() - t) * 1e3)
        want = (SYNTH_DIR / "images" / "val" / f"synthetic_val_{i:05d}.jpg").read_bytes()
        equal += hashlib.sha256(data).digest() == hashlib.sha256(want).digest()
    if equal != EVAL_SCENES:
        raise AssertionError(f"jpeg_encode: {equal}/{EVAL_SCENES} sha256s equal")
    stats = dict(p10=float(np.percentile(ms, 10)), p50=float(np.percentile(ms, 50)),
                 p90=float(np.percentile(ms, 90)), max=float(max(ms)))
    emit("jpeg_encode", frames=EVAL_SCENES, shape=list(frames.shape[1:]),
         quality=90, sha256_equal=equal, encode_ms=stats, render_s=render_s)
    return stats


def phase_synthetic_write(torch, dw, matcher, nproc: int) -> dict:
    """`ensure_synthetic_dataset` writes an 8-image seed-0 train split into
    a fresh directory, its files' sha256s the reference generator's; then
    the trainer (`python -m bdd100k_tpu_torch.train --synthetic 8
    --synthetic_dir <it>`, its main called in this process) trains SSD300
    at B=8 for 3 steps from those files."""
    import hashlib
    import shutil

    from bdd100k_tpu_torch.data.synthetic import ensure_synthetic_dataset

    d = RUNS / "synth_write"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    ensure_synthetic_dataset(d, num_images=8, seed=0)
    write_s = time.perf_counter() - t0
    want = json.loads(JPEG_FIXTURE.read_text())["synthetic_train_seed0_8_sha256"]
    got = {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
           for p in sorted(d.rglob("*")) if p.is_file()}
    if got != want:
        raise AssertionError(f"synthetic_write: files differ: "
                             f"{sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))}")
    steps = 3
    run_dir = RUNS / "synth_write_run"
    argv = ["--config", CONFIG, "--synthetic", "8", "--synthetic_dir", str(d),
            "--batch_size", "8", "--total_steps", str(steps), "--warmup_steps", "0",
            "--log_every", "1", "--checkpoint_every", str(steps), "--seed", "0",
            "--num_workers", str(nproc), "--ckpt_dir", str(run_dir), "--no_resume"]
    out, log, launches = run_files_trainer(torch, dw, matcher, argv,
                                           "synthetic_write", steps, 9)
    if "dataset: 8 images" not in out:
        raise AssertionError("synthetic_write: the trainer did not read 8 images")
    emit("synthetic_write", files=len(got), sha256_equal=len(got), write_s=write_s,
         train_steps=steps, batch=8, losses={s: log[s]["loss"] for s in log},
         launches=launches)
    return dict(launches=launches)


def phase_infer_out_jpeg() -> dict:
    """`python -m bdd100k_tpu_torch.infer --out_dir` (f32, TF32 off) on two
    committed JPEGs: each det_<name>.jpg equals, by sha256, PIL's
    quality-75 save of the reference CLI's f32 detections drawn."""
    import hashlib
    import shutil

    want = json.loads(JPEG_FIXTURE.read_text())["infer_out_sha256"]
    src, out = RUNS / "infer_out_in", RUNS / "infer_out"
    for p in (src, out):
        shutil.rmtree(p, ignore_errors=True)
    src.mkdir(parents=True)
    for name in want:
        shutil.copy(SYNTH_DIR / "images" / "val" / name, src / name)
    t0 = time.perf_counter()
    outs = spawn_ranks(["module", "bdd100k_tpu_torch.infer", "--config", CONFIG,
                        "--ckpt_dir", str(ARTIFACT), "--image_dir", str(src),
                        "--batch_size", "2", "--dtype", "float32",
                        "--out_dir", str(out)], 1, "infer_out_jpeg")
    wall = time.perf_counter() - t0
    launches = worker_report(outs[0])["launches"]
    got = {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(out.iterdir())}
    if got != {f"det_{n}": h for n, h in want.items()}:
        raise AssertionError(f"infer_out_jpeg: {got} against {want}")
    if launches["greedy_suppress"] < 1 or launches["depthwise3x3_s1"] < 9:
        raise AssertionError(f"infer_out_jpeg launches {launches}")
    emit("infer_out_jpeg", files=sorted(got), sha256_equal=len(got),
         launches=launches, wall_s=wall)
    return dict(launches=launches)


def trace_kernel_counts(trace: Path) -> dict:
    """Launches in a torch.profiler trace, by the port's kernel names."""
    names = {"depthwise3x3_s1": "dw3x3_s1_kernel",
             "depthwise3x3_s1_fgrad": "dw3x3_s1_fgrad_kernel",
             "encode_targets": "match_encode"}
    counts = dict.fromkeys(names, 0)
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for k, n in names.items():
                counts[k] += n in e.get("name", "")
    return counts


def dp_trainer_argv(run_dir: Path, nproc: int, *extra: str) -> list[str]:
    return ["--config", CONFIG, "--synthetic", str(TRAIN_SCENES),
            "--synthetic_dir", str(SYNTH_TRAIN_DIR), "--decode_size", "512",
            "--batch_size", str(TRAIN_BATCH), "--total_steps", str(DP_STEPS),
            "--warmup_steps", "0", "--log_every", "1",
            "--checkpoint_every", str(DP_STEPS), "--seed", "0",
            "--dtype", "float32", "--num_workers", str(nproc),
            "--profile_steps", ",".join(map(str, DP_PROFILE)),
            "--ckpt_dir", str(run_dir), "--no_resume", *extra]


def phase_dp_world1(torch, dw, matcher, nproc: int) -> dict:
    """The trainer under --multihost at a world of one rank on NCCL (a
    subprocess with the env torchrun sets), SSD300 B=32 in f32, once per
    --step_impl, against the plain trainer in this process from the same
    seed: the losses agree within DP_LOSS_RTOL (one rank's collectives
    change no value); each run's depthwise, dk and matcher launches a step
    from its torch.profiler trace and from the kernels' counts; the step
    and the card's busy time a step beside the plain run's."""
    plain_dir = RUNS / "dp_plain"
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        out, plain_log, plain_launches = run_files_trainer(
            torch, dw, matcher, dp_trainer_argv(plain_dir, nproc), "dp_plain",
            DP_STEPS, 9)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    skip = set(range(DP_PROFILE[0] + 1, DP_PROFILE[1] + 1))
    busy = trace_busy(out)
    runs = {"plain": dict(losses={s: plain_log[s]["loss"] for s in plain_log},
                          launches=plain_launches,
                          profiled=trace_kernel_counts(ROOT / busy["trace"]),
                          busy=busy, step=step_stats(plain_log, TRAIN_BATCH, skip))}
    for impl in ("pjit", "shard_map"):
        run_dir = RUNS / f"dp_{impl}"
        outs = spawn_ranks(["module", "bdd100k_tpu_torch.train",
                            *dp_trainer_argv(run_dir, nproc, "--multihost",
                                             "--step_impl", impl)],
                           1, f"dp_world1_{impl}")
        rep = worker_report(outs[0])
        log = read_log(run_dir / "train.jsonl")
        busy = trace_busy(outs[0])
        runs[impl] = dict(losses={s: log[s]["loss"] for s in log},
                          launches={k: rep["launches"][k] for k in plain_launches},
                          profiled=trace_kernel_counts(ROOT / busy["trace"]),
                          busy=busy, step=step_stats(log, TRAIN_BATCH, skip))
        if "data axis: 1 process(es)" not in outs[0]:
            raise AssertionError(f"dp_world1 {impl}: not a world of one rank")
    window = DP_PROFILE[1] - DP_PROFILE[0]
    for name, r in runs.items():
        per_step = {k: v / DP_STEPS for k, v in r["launches"].items()}
        traced = {k: v / window for k, v in r["profiled"].items()}
        want = dict(depthwise3x3_s1=18, depthwise3x3_s1_fgrad=9, encode_targets=1)
        if per_step != want or traced != want:
            raise AssertionError(f"dp_world1 {name}: launches a step {per_step}, "
                                 f"in the trace {traced}")
        if name != "plain":
            rel = max(abs(r["losses"][s] / plain_log[s]["loss"] - 1) for s in plain_log)
            r["loss_rel_diff_vs_plain"] = rel
            if not rel <= DP_LOSS_RTOL:
                raise AssertionError(f"dp_world1 {name}: losses differ from the "
                                     f"plain trainer's by {rel}")
    emit("dp_world1", config=CONFIG, batch=TRAIN_BATCH, steps=DP_STEPS,
         dtype="float32", backend="nccl", profiled_steps=list(DP_PROFILE),
         runs={k: dict(loss_at_1=v["losses"][1], loss_at_end=v["losses"][DP_STEPS],
                       loss_rel_diff_vs_plain=v.get("loss_rel_diff_vs_plain"),
                       launches=v["launches"], launches_in_trace=v["profiled"],
                       step_time=v["step"],
                       device_busy_ms_per_step=v["busy"]["device_busy_ms_per_step"],
                       device_busy_share=v["busy"]["device_busy_share"])
               for k, v in runs.items()},
         busy_overhead_vs_plain={k: runs[k]["busy"]["device_busy_ms_per_step"]
                                 / runs["plain"]["busy"]["device_busy_ms_per_step"] - 1
                                 for k in ("pjit", "shard_map")})
    return {k: dict(launches=v["launches"]) for k, v in runs.items()}


def dp_run(torch, rank: int, world: int, group, swap: bool = False) -> dict:
    """DP_TWO_STEPS pjit steps of SSD300 in f32 (TF32 off) on rows
    [rank·B/world, (rank+1)·B/world) of the fixed batch of DP_TWO_B,
    preprocessed to 300² floats (which bypass the augment, as the
    reference's step takes them: the augment's bf16 resample rounds rows
    differently at other batch sizes, and its shared draws are held on the
    CPU) → per-step losses, the final weights and BN statistics, the
    kernel launches and the step times. `swap` takes the batch's two
    halves in the other order."""
    from bdd100k_tpu_torch.configs import TrainConfig, get_config
    from bdd100k_tpu_torch.data.augment import AugmentConfig, preprocess_eval_batch
    from bdd100k_tpu_torch.data.pipeline import InMemoryDataset
    from bdd100k_tpu_torch.data.synthetic import generate_synthetic_scenes
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.ops import depthwise as dw
    from bdd100k_tpu_torch.ops import matcher
    from bdd100k_tpu_torch.parallel import train_step
    from bdd100k_tpu_torch.utils.device import strict_f32

    b = DP_TWO_B // world
    frames, *gt = InMemoryDataset(*generate_synthetic_scenes(DP_TWO_B, seed=0),
                                  max_boxes=100).batch(np.arange(DP_TWO_B))
    if swap:
        half = DP_TWO_B // 2
        frames, *gt = (np.concatenate([a[half:], a[:half]]) for a in (frames, *gt))
    with torch.no_grad():  # the whole batch on every rank, then its rows
        images = preprocess_eval_batch(torch.from_numpy(frames).cuda(), 300)
    batch = [images[rank * b:(rank + 1) * b].contiguous()] + [
        torch.from_numpy(np.ascontiguousarray(a[rank * b:(rank + 1) * b])).cuda()
        for a in gt]
    with strict_f32():
        bundle = build_detector(get_config(CONFIG), dtype=torch.float32,
                                device="cuda", seed=0)
        state = train_step.create_train_state(
            bundle, TrainConfig(batch_size=DP_TWO_B, warmup_steps=0, total_steps=100))
        step = train_step.make_train_step(bundle, AugmentConfig(out_size=300),
                                          device="cuda", group=group)
        gen = torch.Generator(device="cuda")
        torch.cuda.synchronize()
        dw.LAUNCHES.update(depthwise3x3_s1=0, depthwise3x3_s1_fgrad=0)
        matcher.LAUNCHES["encode_targets"] = 0
        losses, norms, ms = [], [], []
        for i in range(DP_TWO_STEPS):
            gen.manual_seed(100 + i)
            t0 = time.perf_counter()
            metrics = step(state, gen, *batch)
            losses.append(float(metrics["loss"]))  # a sync
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(metrics["grad_norm"]))
    launches = dict(depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"],
                    depthwise3x3_s1_fgrad=dw.LAUNCHES["depthwise3x3_s1_fgrad"],
                    encode_targets=matcher.LAUNCHES["encode_targets"])
    weights = {k: v.detach().float().cpu().numpy()
               for k, v in bundle.model.state_dict().items() if v.is_floating_point()}
    return dict(losses=losses, grad_norms=norms, step_ms=ms, launches=launches,
                weights=weights)


def worker_dp_rank(out_dir: str) -> int:
    """`--worker dp_rank DIR`: this rank of `dp_two_ranks`, on a gloo group
    on this card, its result to DIR/rank<r>.npz and its launches as JSON."""
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", init_method="env://")
    try:
        rank = dist.get_rank()
        r = dp_run(torch, rank, dist.get_world_size(), dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", losses=np.asarray(r["losses"]),
             grad_norms=np.asarray(r["grad_norms"]), step_ms=np.asarray(r["step_ms"]),
             **{f"w/{k}": v for k, v in r["weights"].items()})
    print(json.dumps({"launches": r["launches"]}), flush=True)
    return 0


def phase_dp_two_ranks(torch) -> dict:
    """Two ranks sharing this card over a gloo group (NCCL refuses two ranks
    on one device; gloo all-reduces CUDA tensors through the host):
    `make_train_step(group=)` in f32, SSD300, global B=16 split 8/8 (a
    preprocessed float batch), 3 steps, against one process at B=16 in
    this process. Both ranks end with the same weights; the first step's
    loss and grad norm equal the one process's within DP_TWO_LOSS0_RTOL
    and DP_TWO_NORM0_RTOL, and the later losses and the 3-step weights drift from it no further
    than the control's bound (DP_TWO_CONTROL, DP_TWO_FLOOR); the kernels
    launch on
    each rank. The step time is the host's gloo round trips', not a
    scaling number."""
    import shutil

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        init = dp_run(torch, 0, 1, None)  # the weights both start from: seed 0
        control = dp_run(torch, 0, 1, None, swap=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    d = RUNS / "dp_two_ranks"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    outs = spawn_ranks(["dp_rank", str(d)], 2, "dp_two_ranks")
    ranks = [np.load(d / f"rank{r}.npz") for r in range(2)]
    launches = [worker_report(o)["launches"] for o in outs]
    for r, lr in enumerate(launches):
        if {k: v / DP_TWO_STEPS for k, v in lr.items()} != dict(
                depthwise3x3_s1=18, depthwise3x3_s1_fgrad=9, encode_targets=1):
            raise AssertionError(f"dp_two_ranks rank {r} launches {lr}")
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.models.detector import build_detector

    start = {k: v.float().cpu().numpy() for k, v in build_detector(
        get_config(CONFIG), dtype=torch.float32, device="cpu", seed=0
    ).model.state_dict().items() if v.is_floating_point()}
    replica_equal = all(np.array_equal(ranks[0][f"w/{k}"], ranks[1][f"w/{k}"])
                        for k in init["weights"])

    def drift(weights: dict, losses) -> dict:
        """How far a run ended from the one process: each loss's relative
        difference, and the L2 distance of the weights (BatchNorm running
        statistics left out) over the L2 norm of the one process's update,
        with the worst tensors by the largest element's difference over
        the largest element of the update."""
        dist_sq = upd_sq = 0.0
        per_tensor = {}
        for k, one in init["weights"].items():
            upd = one - start[k]
            w = weights[k]
            per_tensor[k] = float(np.abs(w - one).max()) / (float(np.abs(upd).max()) + 1e-30)
            if not k.endswith(("running_mean", "running_var")):
                dist_sq += float(np.square(w.astype(np.float64) - one).sum())
                upd_sq += float(np.square(upd.astype(np.float64)).sum())
        return dict(loss_rel=[float(abs(a / b - 1)) for a, b in zip(losses, init["losses"])],
                    update_l2=(dist_sq / upd_sq) ** 0.5,
                    worst=sorted(per_tensor.items(), key=lambda kv: -kv[1])[:3],
                    median=float(np.median(list(per_tensor.values()))))

    two = drift({k: ranks[0][f"w/{k}"] for k in init["weights"]}, ranks[0]["losses"])
    ctl = drift(control["weights"], control["losses"])
    norm0_rel = abs(float(ranks[0]["grad_norms"][0]) / init["grad_norms"][0] - 1)
    emit("dp_two_ranks", config=CONFIG, global_batch=DP_TWO_B, steps=DP_TWO_STEPS,
         backend="gloo", dtype="float32", losses_one_process=init["losses"],
         losses_two_ranks=ranks[0]["losses"].tolist(),
         losses_control=control["losses"], grad_norm0_rel_diff=norm0_rel,
         two_ranks_drift=two,
         control_drift=ctl, replicas_equal=replica_equal,
         launches_per_rank=launches,
         step_ms_one_process=init["step_ms"],
         step_ms_two_ranks=[ranks[r]["step_ms"].tolist() for r in range(2)])
    if not replica_equal:
        raise AssertionError("dp_two_ranks: the ranks' weights differ")
    within = all(a <= DP_TWO_CONTROL * c + DP_TWO_FLOOR
                 for a, c in zip(two["loss_rel"] + [two["update_l2"]],
                                 ctl["loss_rel"] + [ctl["update_l2"]]))
    if (two["loss_rel"][0] > DP_TWO_LOSS0_RTOL or norm0_rel > DP_TWO_NORM0_RTOL
            or not within):
        raise AssertionError(f"dp_two_ranks: two ranks drift {two} from one "
                             f"process, the control {ctl}")
    return dict(launches={k: sum(lr[k] for lr in launches) for k in launches[0]})


def phase_eval_two_ranks(nproc: int) -> dict:
    """`python -m bdd100k_tpu_torch.evaluate --multihost` as two ranks on
    this card (their barriers on gloo; the eval has no collectives), f32,
    on the 64 committed JPEGs with a --sync_dir: every rank returns the
    merged mAP@0.5, which must equal the single-process f32 mAP of the
    JAX fixture exactly; NMS launches on both ranks."""
    import os
    import shutil

    sync = RUNS / "eval_sync"
    shutil.rmtree(sync, ignore_errors=True)
    want = float(load_fixture()["map50"])
    t0 = time.perf_counter()
    outs = spawn_ranks(["module", "bdd100k_tpu_torch.evaluate", "--multihost",
                        "--synthetic", str(EVAL_SCENES),
                        "--synthetic_dir", os.path.relpath(SYNTH_DIR),
                        "--ckpt_dir", str(ARTIFACT), "--dtype", "float32",
                        "--batch_size", str(EVAL_BATCH),
                        "--num_workers", str(max(nproc // 2, 1)),
                        "--sync_dir", str(sync)], 2, "eval_two_ranks")
    wall = time.perf_counter() - t0
    reps = [worker_report(o) for o in outs]
    for r, rep in enumerate(reps):
        res = rep["result"]
        if res["mAP"] != want or res["num_images"] != EVAL_SCENES or res["num_hosts"] != 2:
            raise AssertionError(f"eval_two_ranks rank {r}: {res}, want mAP {want}")
        if rep["launches"]["greedy_suppress"] < 1 or rep["launches"]["depthwise3x3_s1"] < 9:
            raise AssertionError(f"eval_two_ranks rank {r} launches {rep['launches']}")
    emit("eval_two_ranks", map50=reps[0]["result"]["mAP"], want=want,
         num_images=EVAL_SCENES, launches_per_rank=[r["launches"] for r in reps],
         wall_s=wall)
    keys = ("greedy_suppress", "depthwise3x3_s1")
    return dict(launches={k: sum(r["launches"][k] for r in reps) for k in keys})


def run_slice10_phases(torch, dw, matcher, nproc: int) -> dict:
    out = {"encode_ms": phase_jpeg_encode()}
    out["synthetic_write"] = phase_synthetic_write(torch, dw, matcher, nproc)
    out["infer_out_jpeg"] = phase_infer_out_jpeg()
    out["dp_world1"] = phase_dp_world1(torch, dw, matcher, nproc)
    out["dp_two_ranks"] = phase_dp_two_ranks(torch)
    out["eval_two_ranks"] = phase_eval_two_ranks(nproc)
    return out


# ------------------------------------------------------------------ slice 11

EXPORT_DIR = RUNS / "export"
EXPORT_ARTIFACTS = (("float32", 8), ("bfloat16", 8), ("bfloat16", 1))
EXPORT_TOL = 1e-5         # the f32 artifact against the in-process f32 Predictor
SPATIAL_FRAMES = 8        # spatial_ranks: batch-1 frames, each split over the ranks
# spatial_ranks: one frame's convs over tiles against the whole frame, f32
# with TF32 off: cuDNN may sum a tile's conv in another order than the
# whole map's, so scores and corners move by float noise, far below this
SPATIAL_TOL = 1e-4
DET_FIELDS = ("boxes", "scores", "classes", "valid")


def det_numpy(det) -> dict:
    """Detections (an artifact's dict of tensors, or a `Detections` of
    tensors or of numpy arrays) → {field: numpy array}."""
    out = {}
    for k in DET_FIELDS:
        v = det[k] if isinstance(det, dict) else getattr(det, k)
        out[k] = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    return out


def det_concat(dets: list[dict]) -> dict:
    return {k: np.concatenate([d[k] for d in dets]) for k in DET_FIELDS}


def det_compare(got: dict, want: dict, tol: float) -> dict:
    """Two detection sets of the same images → the largest |Δ| of each
    field, the slots whose class or validity differ, and whether they
    agree: slot by slot (classes and valid equal, floats within `tol`),
    or else detection by detection — as many valid detections an image,
    each with one of its class on the other side within `tol` — where two
    scores within `tol` of each other may have swapped slots."""
    diff = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max())
            for k in DET_FIELDS}
    slots = int(((got["classes"] != want["classes"])
                 | (got["valid"] != want["valid"])).sum())
    out = dict(max_abs_diff=diff, slots_differing=slots,
               bit_equal=all(np.array_equal(got[k], want[k]) for k in DET_FIELDS))
    if slots == 0 and diff["scores"] <= tol and diff["boxes"] <= tol:
        return dict(out, agree=True)
    ok = True
    for i in range(len(got["valid"])):
        if got["valid"][i].sum() != want["valid"][i].sum():
            ok = False
            break
        for a, b in ((got, want), (want, got)):
            for j in np.flatnonzero(a["valid"][i]):
                m = ((b["classes"][i] == a["classes"][i, j]) & b["valid"][i]
                     & (np.abs(b["boxes"][i] - a["boxes"][i, j]).max(-1) <= tol)
                     & (np.abs(b["scores"][i] - a["scores"][i, j]) <= tol))
                ok = ok and bool(m.any())
    return dict(out, agree=ok)


def serve_stats(torch, call, frames: np.ndarray, bs: int) -> dict:
    """SERVE_REQUESTS requests of `bs` frames each through `call` (host
    frames in, host detections out) after SERVE_WARMUP → latency stats."""
    reqs = [np.take(frames, range(bs * r, bs * r + bs), axis=0, mode="wrap")
            for r in range(SERVE_REQUESTS + SERVE_WARMUP)]
    for r in reqs[:SERVE_WARMUP]:
        call(r)
    torch.cuda.synchronize()
    lat = []
    for r in reqs[SERVE_WARMUP:]:
        t0 = time.perf_counter()
        call(r)
        lat.append((time.perf_counter() - t0) * 1e3)
    return latency_stats(lat, [t / 1e3 for t in lat], bs)


def artifact_call(torch, fn):
    """Host frames → the artifact on the card → host detections: the
    request a server of the artifact makes (pinned copy in, copy back)."""
    def call(frames: np.ndarray) -> dict:
        x = torch.from_numpy(frames).pin_memory().cuda(non_blocking=True)
        return det_numpy(fn(x))
    return call


def phase_export_artifact(torch, infer, nms, dw, nproc: int) -> dict:
    """`python -m bdd100k_tpu_torch.export` of SSD300 from the synth9k
    artifact for `cuda,cpu` (f32 B=8, bf16 B=8 and B=1), `load` on the
    card: the f32 artifact's detections on the 64 seed-1 JPEGs (the pool's
    300² decodes) against the in-process f32 Predictor's, with the kernels'
    launches counted over the artifact's runs (the artifact ran the ops'
    CUDA implementations, not their plain versions); the bf16 artifacts
    served at b1 and b8 beside the bf16 Predictor; the f32 artifact loaded
    on the CPU against the CPU Predictor on 8 frames, bit for bit."""
    from bdd100k_tpu_torch import export

    EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    frames = decode_jpegs(jpeg_names(), 300, nproc)
    paths, export_s = {}, {}
    for dtype, bs in EXPORT_ARTIFACTS:
        p = EXPORT_DIR / f"{CONFIG}_{dtype}_b{bs}.pt2"
        t0 = time.perf_counter()
        export.main(["--config", CONFIG, "--ckpt_dir", str(ARTIFACT), "--out",
                     str(p), "--batch_size", str(bs), "--dtype", dtype,
                     "--platforms", "cuda,cpu"])
        export_s[f"{dtype}_b{bs}"] = time.perf_counter() - t0
        paths[(dtype, bs)] = p
    sizes_mb = {f"{d}_b{b}": p.stat().st_size / 1e6 for (d, b), p in paths.items()}

    # the in-process models first: their launches are not the artifact's
    pred32 = infer.load_predictor(CONFIG, ARTIFACT, batch_size=8, device="cuda",
                                  dtype=torch.float32)
    want = det_concat([det_numpy(pred32(frames[i:i + 8]))
                       for i in range(0, len(frames), 8)])
    pred_serve = {bs: serve_stats(torch, infer.load_predictor(
        CONFIG, ARTIFACT, batch_size=bs, device="cuda"), frames, bs) for bs in (1, 8)}
    t0 = time.perf_counter()
    arts = {k: export.load(p, device="cuda") for k, p in paths.items()}
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # the artifact's path: counts to 0 just before, read just after
    nms.LAUNCHES["greedy_suppress"] = 0
    dw.LAUNCHES["depthwise3x3_s1"] = 0
    got = det_concat([artifact_call(torch, arts[("float32", 8)])(frames[i:i + 8])
                      for i in range(0, len(frames), 8)])
    art_serve = {bs: serve_stats(torch, artifact_call(torch, arts[("bfloat16", bs)]),
                                 frames, bs) for bs in (1, 8)}
    launches = dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                    depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"])
    calls = len(frames) // 8 + 2 * (SERVE_REQUESTS + SERVE_WARMUP)
    cmp = det_compare(got, want, EXPORT_TOL)

    # the same file on the CPU: the ops' plain versions, no launch
    art_cpu = export.load(paths[("float32", 8)], device="cpu")
    pred_cpu = infer.load_predictor(CONFIG, ARTIFACT, batch_size=8, device="cpu",
                                    dtype=torch.float32)
    before = dict(nms.LAUNCHES), dict(dw.LAUNCHES)
    got_cpu = det_numpy(art_cpu(torch.from_numpy(frames[:8])))
    cpu_launches_unchanged = before == (dict(nms.LAUNCHES), dict(dw.LAUNCHES))
    cmp_cpu = det_compare(got_cpu, det_numpy(pred_cpu(frames[:8])), 0.0)
    cmp_card_cpu = det_compare(got_cpu, {k: v[:8] for k, v in got.items()},
                               EXPORT_TOL)
    emit("export_artifact", config=CONFIG, weights=ARTIFACT.name,
         nvidia_smi=nvidia_smi_line(), export_s=export_s, load_s=load_s,
         size_mb=sizes_mb, launches=launches, artifact_calls=calls,
         f32_vs_predictor=cmp, cpu_vs_cpu_predictor=cmp_cpu,
         cpu_vs_card=cmp_card_cpu, cpu_launches_unchanged=cpu_launches_unchanged,
         frames="64 seed-1 JPEGs, pool decode at 300x300",
         serve_bf16={f"artifact_b{bs}": art_serve[bs] for bs in (1, 8)}
         | {f"predictor_b{bs}": pred_serve[bs] for bs in (1, 8)})
    if launches != dict(greedy_suppress=calls, depthwise3x3_s1=9 * calls):
        raise AssertionError(f"export_artifact launches {launches} for {calls} calls")
    if not cmp["agree"] or not got["valid"].any():
        raise AssertionError(f"export_artifact: the f32 artifact differs from the "
                             f"Predictor: {cmp}")
    if not (cmp_cpu["bit_equal"] and cpu_launches_unchanged):
        raise AssertionError(f"export_artifact on the CPU: {cmp_cpu}, launches "
                             f"unchanged {cpu_launches_unchanged}")
    return dict(launches=launches)


def phase_export_parity_int8() -> dict:
    """`python -m bdd100k_tpu_torch.scripts.check_export_parity` on SSD300
    int8_static calibrated on tests/fixtures/calib_mixed (2 JPEGs, 3
    PNGs), as a subprocess: it must print PARITY OK."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker", "module",
         "bdd100k_tpu_torch.scripts.check_export_parity",
         "--calib_images", str(CALIB_DIR.relative_to(ROOT)),
         "--ckpt", str(ARTIFACT.relative_to(ROOT)),
         "--out", str(EXPORT_DIR / "parity_int8_static.pt2")],
        cwd=ROOT, capture_output=True, text=True, timeout=WORKER_TIMEOUT)
    wall = time.perf_counter() - t0
    (RUNS / "export_parity_int8.txt").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0 or "PARITY OK" not in proc.stdout:
        raise AssertionError(f"check_export_parity exited {proc.returncode}:\n"
                             f"{(proc.stdout + proc.stderr)[-3000:]}")
    parity = next(l for l in proc.stdout.splitlines() if l.startswith("PARITY OK"))
    rep = worker_report(proc.stdout)
    emit("export_parity_int8", line=parity, launches=rep["launches"], wall_s=wall)
    return dict(launches=rep["launches"])


def spatial_run(torch, frames: np.ndarray, group) -> dict:
    """SSD300 f32 (TF32 off) from the synth9k artifact, split over the
    ranks of `group` by `make_spatial_infer_fn`, on each frame at batch 1
    (one warm-up frame first) → detections, each frame's ms, the launches,
    the grid and the layers' routes."""
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.ops import depthwise as dw
    from bdd100k_tpu_torch.ops import nms
    from bdd100k_tpu_torch.parallel.spatial import make_spatial_infer_fn
    from bdd100k_tpu_torch.utils.device import strict_f32
    from bdd100k_tpu_torch.utils.weights import restore_eval_weights

    with strict_f32():
        bundle = build_detector(get_config(CONFIG), dtype=torch.float32, device="cuda")
        restore_eval_weights(bundle.model, ARTIFACT, expect_config=CONFIG)
        fn = make_spatial_infer_fn(bundle, group)
        x = torch.from_numpy(frames).cuda()
        fn(fn.tile(x[:1]))
        torch.cuda.synchronize()
        nms.LAUNCHES["greedy_suppress"] = 0
        dw.LAUNCHES["depthwise3x3_s1"] = 0
        dets, ms = [], []
        for i in range(len(frames)):
            t0 = time.perf_counter()
            dets.append(det_numpy(fn(fn.tile(x[i:i + 1]))))
            ms.append((time.perf_counter() - t0) * 1e3)
    return dict(det=det_concat(dets), ms=ms, grid=fn.grid, routes=list(fn.routes),
                launches=dict(greedy_suppress=nms.LAUNCHES["greedy_suppress"],
                              depthwise3x3_s1=dw.LAUNCHES["depthwise3x3_s1"]))


def worker_spatial_rank(out_dir: str, backend: str) -> int:
    """`--worker spatial_rank DIR BACKEND`: this rank of `spatial_ranks`
    on a `BACKEND` group on this card, its detections and frame times to
    DIR/rank<r>.npz, its launches as JSON."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method="env://")
    try:
        rank = dist.get_rank()
        frames = np.load(Path(out_dir) / "frames.npy")
        r = spatial_run(torch, frames, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", ms=np.asarray(r["ms"]),
             **r["det"])
    print(json.dumps({"launches": r["launches"], "grid": r["grid"],
                      "routes": r["routes"]}), flush=True)
    return 0


def phase_spatial_ranks(torch, infer, nproc: int) -> dict:
    """`parallel/spatial.make_spatial_infer_fn` on SSD300 in f32: two gloo
    ranks sharing this card (300 rows → two tiles of 150, the halos
    through the host) and a world of one rank on NCCL, each on
    SPATIAL_FRAMES frames at batch 1, against the single-process f32
    Predictor at b1: classes and valid slots equal, scores and corners
    within SPATIAL_TOL (`det_compare`); every rank the same detections,
    NMS and the depthwise kernel launched on each. One card measures
    correctness only: the latency this mode is for needs several."""
    import shutil

    frames = decode_jpegs(jpeg_names()[:SPATIAL_FRAMES], 300, nproc)
    pred = infer.load_predictor(CONFIG, ARTIFACT, batch_size=1, device="cuda",
                                dtype=torch.float32)
    pred(frames[:1])
    want, pred_ms = [], []
    for i in range(len(frames)):
        t0 = time.perf_counter()
        want.append(det_numpy(pred(frames[i:i + 1])))
        pred_ms.append((time.perf_counter() - t0) * 1e3)
    want = det_concat(want)
    out, launches = {}, {}
    for name, world, backend in (("two_gloo_ranks", 2, "gloo"),
                                 ("world1_nccl", 1, "nccl")):
        d = RUNS / f"spatial_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        np.save(d / "frames.npy", frames)
        outs = spawn_ranks(["spatial_rank", str(d), backend], world, f"spatial_{name}")
        reps = [worker_report(o) for o in outs]
        ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
        same = all(np.array_equal(ranks[r][k], ranks[0][k])
                   for r in range(world) for k in DET_FIELDS)
        cmp = det_compare({k: ranks[0][k] for k in DET_FIELDS}, want, SPATIAL_TOL)
        routes = dict(map(tuple, reps[0]["routes"]))
        out[name] = dict(backend=backend, world=world, grid=reps[0]["grid"],
                         vs_predictor=cmp, ranks_equal=same,
                         launches_per_rank=[r["launches"] for r in reps],
                         frame_ms_p50=[float(np.median(r["ms"])) for r in ranks],
                         tiled_layers=sum(v == "tiled" for v in routes.values()),
                         gathered_at=[k for k, v in routes.items() if v == "gathered"])
        for k in ("greedy_suppress", "depthwise3x3_s1"):
            launches[k] = launches.get(k, 0) + sum(r["launches"][k] for r in reps)
        if not (cmp["agree"] and same):
            raise AssertionError(f"spatial_ranks {name}: {out[name]}")
        for r in reps:
            if r["launches"] != dict(greedy_suppress=SPATIAL_FRAMES,
                                     depthwise3x3_s1=9 * SPATIAL_FRAMES):
                raise AssertionError(f"spatial_ranks {name} launches {r['launches']}")
    emit("spatial_ranks", config=CONFIG, dtype="float32", frames=SPATIAL_FRAMES,
         tol=SPATIAL_TOL, predictor_b1_ms_p50=float(np.median(pred_ms)),
         nvidia_smi=nvidia_smi_line(), **out)
    return dict(launches=launches)


OP_CALLS = 2000  # op_dispatch: back-to-back calls a timing


def phase_op_dispatch(torch, nms, dw) -> None:
    """What the `torch.library` ops cost the host: OP_CALLS back-to-back
    calls of each kernel through its op and through its ctypes wrapper
    called directly (NMS at B=8 C=10 K=100, the depthwise forward at
    ds1's b1 shape in bf16), in turns (direct, op, op, direct), host µs a
    call to the final sync. These kernels take microseconds on the card,
    so the calls are host-bound and the difference is the op's dispatch.
    Launches made here compare routes: no path's count includes them."""
    g = torch.Generator(device="cuda").manual_seed(0)
    xy = torch.rand((8, 10, 100, 2), generator=g, device="cuda") * 0.7
    boxes = torch.cat([xy, xy + 0.05 + 0.25 * torch.rand(
        (8, 10, 100, 2), generator=g, device="cuda")], -1).contiguous()
    valid = torch.rand((8, 10, 100), generator=g, device="cuda") > 0.1
    x = torch.randn((1, 150, 150, 32), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((3, 3, 32), generator=g, device="cuda").to(torch.bfloat16)
    routes = {"nms_direct": lambda: nms.greedy_suppress_cuda(boxes, valid, 0.45),
              "nms_op": lambda: nms.greedy_suppress(boxes, valid, 0.45),
              "dw_direct": lambda: dw.depthwise3x3_s1_cuda(x, k),
              "dw_op": lambda: dw.depthwise3x3_s1(x, k)}

    def host_us(fn) -> float:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / OP_CALLS * 1e6

    out = {}
    for kind in ("nms", "dw"):
        order = ("direct", "op", "op", "direct")
        times = [host_us(routes[f"{kind}_{o}"]) for o in order]
        out[kind] = dict(direct_us=[times[0], times[3]], op_us=[times[1], times[2]])
    if not torch.equal(routes["nms_op"](), routes["nms_direct"]()) or not torch.equal(
            routes["dw_op"](), routes["dw_direct"]()):
        raise AssertionError("op_dispatch: an op and its wrapper disagree")
    emit("op_dispatch", calls=OP_CALLS, nvidia_smi=nvidia_smi_line(), **out)


def run_slice11_phases(torch, infer, nms, dw, nproc: int) -> dict:
    phase_op_dispatch(torch, nms, dw)
    return {"export_artifact": phase_export_artifact(torch, infer, nms, dw, nproc),
            "export_parity_int8": phase_export_parity_int8(),
            "spatial_ranks": phase_spatial_ranks(torch, infer, nproc)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--worker"]:  # a rank or subprocess of a phase below
        kind, rest = sys.argv[2], sys.argv[3:]
        return {"module": worker_module, "dp_rank": lambda a: worker_dp_rank(*a),
                "spatial_rank": lambda a: worker_spatial_rank(*a)}[kind](rest)
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

    # int8 quant (slice 9): the quantized layers on the card against the
    # CPU, the int8 conv route's times beside cuDNN's bf16 conv, the int8
    # evals of SSD300 and VGG16-SSD512 against the JAX fixture in f32 and
    # bf16 (the depthwise and NMS kernels held to their plain versions on
    # that path), int8_static serving beside bf16, the CLI with PNG
    # calibration frames; then PNG decode and the smoothed progressive
    # decodes
    int8 = run_int8_phases(torch, infer, nms, dw, nproc, frames)

    # slice 10: the JPEG encoder against the fixture JPEGs, the synthetic
    # split written and trained from, drawn outputs as JPEGs, the trainer
    # at a world of one rank on NCCL (both step forms) against the plain
    # trainer, two ranks over gloo on this card against one process, and
    # the sharded eval over two ranks
    s10 = run_slice10_phases(torch, dw, matcher, nproc)

    # slice 11: the serving artifact (export, load on the card and on the
    # CPU, served beside the Predictor), the int8_static export parity
    # check, and one frame's convs split over ranks with hand-written halos
    # (two gloo ranks on this card, a world of one on NCCL)
    s11 = run_slice11_phases(torch, infer, nms, dw, nproc)

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
    il = int8["path"]["launches"]
    s10l = {k: sum(s10[p]["launches"].get(k, 0) for p in ("synthetic_write",
                   "infer_out_jpeg", "dp_two_ranks", "eval_two_ranks"))
               + sum(r["launches"].get(k, 0) for r in s10["dp_world1"].values())
            for k in ("depthwise3x3_s1", "depthwise3x3_s1_fgrad", "encode_targets",
                      "greedy_suppress")}
    s11l = {k: sum(r["launches"].get(k, 0) for r in s11.values())
            for k in ("depthwise3x3_s1", "greedy_suppress")}

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
                       + fl["greedy_suppress"] + il["greedy_suppress"]
                       + s10l["greedy_suppress"] + s11l["greedy_suppress"]),
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
                       + fl["depthwise3x3_s1"] + il["depthwise3x3_s1"]
                       + s10l["depthwise3x3_s1"] + s11l["depthwise3x3_s1"]),
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
                       + fl["depthwise3x3_s1_fgrad"] + s10l["depthwise3x3_s1_fgrad"]),
             max_abs_err=max(bwd_t["max_abs_err"], ydw["dk_max_abs_err"]),
             ms=bwd_t["dk"]["ms"],
             plain_ms=bwd_t["dk"]["plain_ms"], bound_ms=bwd_t["dk"]["bound_ms"],
             bound_by="bytes", library_ms=bwd_t["dk"]["library_ms"],
             yolo=yolo_row(ydw["dk"], "9 layers at 384², B=64 bf16")),
        dict(name="encode_targets", route="cuda",
             source="bdd100k_tpu_torch/csrc/matcher.cu",
             replaces="bdd100k_tpu/ops/pallas_matcher.py:202",
             launches=(tl["encode_targets"] + ytl["encode_targets"]
                       + vtl["encode_targets"] + fl["encode_targets"]
                       + s10l["encode_targets"]),
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
         int8_eval={k: dict(f32=int8["eval_f32"][k]["map50"],
                            bf16=int8["eval_bf16"][k]["map50"])
                    for k in int8["eval_f32"]},
         int8_serving={k: {m: dict(p50_ms=v[m]["p50_ms"], imgs_per_s=v[m]["imgs_per_s"])
                           for m in ("bf16", "int8_static")}
                       for k, v in int8["path"].items() if k != "launches"},
         int8_conv_sums=int8["conv"],
         png_720p_decode_ms=int8["png"]["decode_ms"],
         jpeg_encode_720p_q90_ms=s10["encode_ms"],
         slice10_launches=s10l, slice11_launches=s11l,
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
              "batches; int8_static serving (SSD300 64 b1 + 32 b8 requests, "
              "VGG16-SSD512 8 b32 requests); slice 10 (every rank's path): "
              "SSD300 3 steps at B=8 from the written split, the CLI's 2 "
              "drawn JPEGs, 8 f32 steps at B=32 for each of the plain, the "
              "pjit and the shard_map trainer at a world of one, 3 steps on "
              "each of two gloo ranks, and 1 eval batch on each of two ranks; "
              "slice 11 (every rank's path): the exported SSD300 artifact's 8 "
              "f32 b8 calls and 2 x 266 bf16 requests (b1, b8), the int8_static "
              "parity check's calibration and both its runs, and 8 b1 frames on "
              "each of two gloo ranks and on a world of one")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
