"""Serialized serving artifacts through `torch.export` (counterpart of
bdd100k_tpu/export.py, whose artifact is a `jax.export` StableHLO file).

One self-contained file holds the whole inference program — normalize →
backbone → heads → decode, score and class-wise NMS — with the
checkpoint's parameters (and, for int8_static, the calibrated activation
scales) in the program's state. A server loads it with `load()` and calls
it on uint8 image batches; no model code, config or checkpoint code runs
at load time.

The hand-written kernels are the ops `bdd100k_tpu_torch::greedy_suppress`
and `bdd100k_tpu_torch::depthwise3x3_s1` (`ops/nms.py`,
`ops/depthwise.py`), which the exported graph calls by name: on a CUDA
device they launch the kernels, on the CPU they run the plain versions.
So one artifact runs on both (`--platforms cuda,cpu`), with one NMS route
where the reference needs its pure-XLA fixpoint NMS for a multi-platform
artifact; `--nms` keeps the reference's choices, and each runs that route.

    python -m bdd100k_tpu_torch.export --config ssd_mobilenet_300 \\
        --ckpt_dir artifacts/ssd_mobilenet_300_synth9k.npz \\
        --out model.pt2 --batch_size 8
    # on the CPU: add --device cpu

`--dtype float32` exports convs in f32; the artifact records it, and
`load()` runs such an artifact with TF32 off, as the in-process f32 model
runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import warnings
from pathlib import Path

import torch

META = "bdd100k_tpu_torch.json"  # the artifact's own record, beside the program
PLATFORMS = ("cuda", "cpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="ssd_mobilenet_300")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint to bake in: a run directory of the port's "
                        "trainer or a .npz artifact (fresh init if omitted)")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--score_threshold", type=float, default=None,
                   help="override the config's postprocess threshold")
    p.add_argument("--nms", choices=("auto", "xla", "pallas", "fixpoint"),
                   default="auto",
                   help="the reference's NMS backends, which make identical "
                        "keep decisions; every choice runs the port's one "
                        "route, the op greedy_suppress")
    p.add_argument("--quant", choices=("none", "int8", "int8_static"),
                   default="none",
                   help="int8_static bakes CALIBRATED activation scales "
                        "into the artifact (needs --calib_images)")
    p.add_argument("--calib_images", default=None,
                   help="int8_static: directory of images to calibrate the "
                        "frozen activation scales on (a handful of "
                        "representative frames)")
    p.add_argument("--platforms", default=None,
                   help="comma list of cuda and cpu, e.g. 'cuda,cpu' for an "
                        "artifact that runs on either; default: the export "
                        "device's only")
    p.add_argument("--device", default="cuda",
                   help="where to trace: cuda (the default; raises without "
                        "CUDA) or cpu")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="working type of the convs: bfloat16, the "
                        "reference's, or float32 (run with TF32 off)")
    return p.parse_args(argv)


def parse_platforms(spec: str | None, device: torch.device) -> list[str]:
    """--platforms → the device types the artifact is for; a name other
    than cuda or cpu (tpu included) is refused."""
    if not spec:
        return [device.type]
    names = [s.strip() for s in spec.split(",") if s.strip()]
    bad = [n for n in names if n not in PLATFORMS]
    if bad or not names:
        raise SystemExit(
            f"--platforms {spec!r}: this artifact runs on {' and '.join(PLATFORMS)} "
            f"only (got {', '.join(bad) or 'nothing'})")
    return names


class ServingModule(torch.nn.Module):
    """uint8 (B, S, S, 3) images → {boxes, scores, classes, valid}, the
    detector's parameters, its anchors and (YOLO) cell sizes held inside."""

    def __init__(self, bundle):
        super().__init__()
        self.config = bundle.config
        self.model = bundle.model
        self.register_buffer("anchors", bundle.anchors)
        self.register_buffer("cell_sizes", bundle.cell_sizes)

    def forward(self, images_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        from bdd100k_tpu_torch.data.augment import preprocess_eval_batch
        from bdd100k_tpu_torch.ops.postprocess import postprocess

        images = preprocess_eval_batch(images_u8, self.config.image_size)
        loc, cls = self.model(images)
        det = postprocess(loc, cls, self.anchors, self.config.postprocess,
                          self.cell_sizes)
        return {"boxes": det.boxes, "scores": det.scores,
                "classes": det.classes, "valid": det.valid}


def build_serving_fn(bundle, variables=None) -> ServingModule:
    """uint8 (B, S, S, 3) images → detections dict, with the parameters
    held inside. `variables`, where given, is a state_dict loaded into the
    bundle's model first (the reference passes its flax variables here)."""
    if variables is not None:
        bundle.model.load_state_dict(variables)
    for p in bundle.model.parameters():
        p.requires_grad_(False)
    return ServingModule(bundle).eval()


def export_model(args) -> Path:
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.utils.device import resolve_device, strict_f32
    from bdd100k_tpu_torch.utils.weights import restore_eval_weights

    device = resolve_device(args.device)
    platforms = parse_platforms(args.platforms, device)
    cfg = get_config(args.config)
    pp = cfg.postprocess
    if args.score_threshold is not None:
        pp = dataclasses.replace(pp, score_threshold=args.score_threshold)
    cfg = dataclasses.replace(cfg, quant=args.quant, postprocess=pp)
    if args.quant == "int8_static" and not args.calib_images:
        raise SystemExit(
            "--quant int8_static needs --calib_images (a directory of "
            "representative frames to freeze activation scales on)")

    bundle = build_detector(cfg, dtype=DTYPES[args.dtype], device=device)
    step = 0
    if args.ckpt_dir:
        # a run directory OR a single-file .npz artifact, as evaluate/infer
        step = restore_eval_weights(bundle.model, args.ckpt_dir,
                                    expect_config=cfg.name)
        if step == 0:
            # an empty/mistyped --ckpt_dir must not silently bake
            # fresh-init weights into a serving artifact
            raise SystemExit(f"no checkpoint found under {args.ckpt_dir}")
    with strict_f32(args.dtype == "float32"):
        if args.quant == "int8_static":
            from bdd100k_tpu_torch.models.quant import calibrate_for_driver

            # the drivers' one protocol: ≤64 frames in batches of 8
            _, n = calibrate_for_driver(bundle, calib_images=args.calib_images)
            print(f"int8_static: calibrated act scales on {n} frames")
        serve = build_serving_fn(bundle)
        s = cfg.image_size
        example = torch.zeros((args.batch_size, s, s, 3), dtype=torch.uint8,
                              device=device)
        with torch.no_grad():
            program = torch.export.export(serve, (example,), strict=False)
    meta = dict(config=cfg.name, step=step, batch_size=args.batch_size,
                image_size=s, nms=args.nms, quant=args.quant,
                dtype=args.dtype, platforms=platforms,
                traced_on=device.type)
    out = Path(args.out)
    with warnings.catch_warnings():
        # channels_last weights are "incomplete" to the archive's storage
        # dedup, which then writes each one whole, strides kept
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(program, out, extra_files={META: json.dumps(meta)})
    print(
        f"exported {cfg.name} step={step} batch={args.batch_size} "
        f"nms={args.nms} quant={args.quant} platforms={platforms} "
        f"-> {out} ({out.stat().st_size / 1e6:.1f} MB)"
    )
    return out


def load(path: str | Path, device: str | torch.device | None = None):
    """Load a serving artifact → `fn(images_u8) -> dict` of {boxes,
    scores, classes, valid} tensors (fixed slots, validity-masked).

    `device` moves the program (its state and the devices written into
    its graph) to that device; it must be one of the artifact's
    platforms. Without it the program runs where it was traced. An
    artifact exported in float32 runs with TF32 off."""
    # the exported graph calls these ops by name: register them
    import bdd100k_tpu_torch.ops.depthwise  # noqa: F401
    import bdd100k_tpu_torch.ops.nms  # noqa: F401
    from bdd100k_tpu_torch.utils.device import resolve_device, strict_f32

    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META])
    if device is not None:
        device = resolve_device(device)
        if device.type not in meta["platforms"]:
            raise ValueError(
                f"{path} was exported for {meta['platforms']}, not "
                f"{device.type}; export it with --platforms "
                f"{','.join(meta['platforms'] + [device.type])}")
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    module = program.module()
    f32 = meta["dtype"] == "float32"

    def fn(images_u8: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.no_grad(), strict_f32(f32):
            return module(images_u8)

    fn.meta = meta
    return fn


def main(argv=None):
    return export_model(parse_args(argv))


if __name__ == "__main__":
    main()
