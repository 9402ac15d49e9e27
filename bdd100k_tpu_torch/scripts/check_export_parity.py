"""Check that an exported serving artifact reproduces the in-process
model's detections (counterpart of scripts/check_export_parity.py).

Exports with the drivers' one calibration protocol
(`models/quant.calibrate_for_driver`), loads the artifact back, runs it
and the in-process model on the same frames, and holds boxes, scores,
classes and valid to each other (atol 1e-5, the reference's check);
prints `PARITY OK: …` or fails.

    python -m bdd100k_tpu_torch.scripts.check_export_parity \\
        [--config ssd_mobilenet_300] \\
        [--ckpt artifacts/ssd_mobilenet_300_synth9k.npz] \\
        [--calib_images /tmp/bdd_synth/images/train] \\
        [--quant int8_static] [--device cuda] [--dtype bfloat16]

The frames are the first `--batch_size` .jpg/.jpeg/.png files of
`--calib_images`, decoded as PIL decodes them and resized with PIL's
bicubic `resize((s, s))` (`models/quant.calibration_batches_from_images`);
the reference takes its .jpg files only.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="ssd_mobilenet_300")
    p.add_argument("--ckpt", default="artifacts/ssd_mobilenet_300_synth9k.npz")
    p.add_argument("--calib_images", default="/tmp/bdd_synth/images/train")
    p.add_argument("--quant", choices=("none", "int8", "int8_static"),
                   default="int8_static")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--out", default=None,
                   help="where to write the artifact (default: a temporary "
                        "directory)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from bdd100k_tpu_torch import export as export_mod
    from bdd100k_tpu_torch.configs import get_config
    from bdd100k_tpu_torch.models.detector import build_detector
    from bdd100k_tpu_torch.models.quant import (
        calibrate_for_driver,
        calibration_batches_from_images,
    )
    from bdd100k_tpu_torch.utils.device import resolve_device, strict_f32
    from bdd100k_tpu_torch.utils.weights import restore_eval_weights

    device = resolve_device(args.device)
    out = (Path(args.out) if args.out
           else Path(tempfile.mkdtemp()) / "artifact.pt2")
    export_argv = [
        "--config", args.config, "--ckpt_dir", args.ckpt,
        "--out", str(out), "--batch_size", str(args.batch_size),
        "--quant", args.quant, "--device", str(device), "--dtype", args.dtype,
    ]
    if args.quant == "int8_static":
        export_argv += ["--calib_images", args.calib_images]
    export_mod.main(export_argv)
    serve = export_mod.load(out, device=device)

    cfg = dataclasses.replace(get_config(args.config), quant=args.quant)
    dtype = export_mod.DTYPES[args.dtype]
    bundle = build_detector(cfg, dtype=dtype, device=device)
    restore_eval_weights(bundle.model, args.ckpt, expect_config=cfg.name)
    f32 = args.dtype == "float32"
    with strict_f32(f32):
        if args.quant == "int8_static":
            calibrate_for_driver(bundle, calib_images=args.calib_images)
    live = export_mod.build_serving_fn(bundle)

    s = cfg.image_size
    n_files = sum(1 for p in Path(args.calib_images).iterdir()
                  if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    if n_files < args.batch_size:
        raise SystemExit(f"need {args.batch_size} frames in "
                         f"{args.calib_images}, found {n_files}")
    imgs = calibration_batches_from_images(
        args.calib_images, s, batch_size=args.batch_size,
        limit=args.batch_size)[0]
    x = torch.from_numpy(imgs).to(device)

    d_art = serve(x)
    with torch.no_grad(), strict_f32(f32):
        d_live = live(x)
    diffs = {}
    for field in ("boxes", "scores", "classes", "valid"):
        a = d_art[field].cpu().numpy()
        b = d_live[field].cpu().numpy()
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=field)
        diffs[field] = float(np.abs(a.astype(np.float64) - b).max())
    n_det = int(d_art["valid"].sum())
    print(
        f"PARITY OK: exported {args.quant} artifact == in-process model "
        f"({n_det} detections across {args.batch_size} frames)"
    )
    return dict(max_abs_diff=diffs, detections=n_det, artifact=str(out))


if __name__ == "__main__":
    main()
