"""Export a training run of the port to a single-file .npz weights artifact
(counterpart of scripts/export_weights.py).

    python -m bdd100k_tpu_torch.scripts.export_weights --ckpt_dir runs/ssd300 \\
        --config ssd_mobilenet_300 --out artifacts/ssd300_mine.npz --ema

The artifact (`utils/weights.py`, the reference's format: fp16 params, f32
BatchNorm statistics, meta {config, step, source}) is what
`python -m bdd100k_tpu_torch.evaluate --ckpt_dir foo.npz` and
`python -m bdd100k_tpu_torch.infer --ckpt_dir foo.npz` load, and the
reference's `load_into_state` too. The latest `ckpt_<step>.pt` of the run
directory gives the params and BatchNorm statistics; with `--ema` its EMA
shadow replaces the params (the run must have used `--ema_decay`). The
detector is built on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from bdd100k_tpu_torch.configs import apply_yolo_priors, get_config
from bdd100k_tpu_torch.models.detector import build_detector
from bdd100k_tpu_torch.utils.device import resolve_device
from bdd100k_tpu_torch.utils.weights import restore_eval_weights, save_detector_npz


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_dir", required=True,
                   help="a run directory of python -m bdd100k_tpu_torch.train")
    p.add_argument("--config", default="ssd_mobilenet_300")
    p.add_argument("--yolo_priors", default=None,
                   help="the fitted priors JSON the run trained with, if any")
    p.add_argument("--out", required=True)
    p.add_argument("--ema", action="store_true",
                   help="export the EMA shadow (the run must have used "
                        "--ema_decay)")
    p.add_argument("--dtype", choices=("float16", "float32"), default="float16")
    p.add_argument("--device", default="cuda",
                   help="where the detector is built (cuda; cpu for tests)")
    args = p.parse_args(argv)

    det_cfg = get_config(args.config)
    if args.yolo_priors:
        det_cfg = apply_yolo_priors(det_cfg, args.yolo_priors)
    bundle = build_detector(det_cfg, dtype=torch.float32,
                            device=resolve_device(args.device))
    if not Path(args.ckpt_dir).is_dir():
        raise SystemExit(f"{args.ckpt_dir} is not a run directory")
    step = restore_eval_weights(bundle.model, args.ckpt_dir, ema=args.ema)
    if step == 0:
        raise SystemExit(f"no checkpoint found under {args.ckpt_dir}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    meta = save_detector_npz(
        out, bundle.model.state_dict(), config_name=det_cfg.name, step=step,
        source="ema" if args.ema else "params",
        param_dtype=np.dtype(args.dtype))
    print(f"wrote {out} ({out.stat().st_size / 1e6:.1f} MB): {meta}", flush=True)
    return meta


if __name__ == "__main__":
    main()
