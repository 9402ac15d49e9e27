"""Training driver (counterpart of bdd100k_tpu/train.py).

    python -m bdd100k_tpu_torch.train --config ssd_mobilenet_300 \\
        --synthetic 64 --total_steps 40 --ckpt_dir runs/ssd300
    python -m bdd100k_tpu_torch.train --config yolo_mobilenet_384 \\
        --batch_size 64 --synthetic 64 --ckpt_dir runs/yolo384
    python -m bdd100k_tpu_torch.train --config ssd_vgg16_512 \\
        --batch_size 32 --synthetic 64 --ckpt_dir runs/vgg512
    # on the CPU, at the tiny test config:
    python -m bdd100k_tpu_torch.train --config ssd_tiny_64 --synthetic 8 \\
        --batch_size 4 --total_steps 3 --warmup_steps 0 --device cpu

Each step takes a batch of 720p uint8 frames with padded GT, copied to the
card ahead of use by the prefetcher, and runs the whole step there
(`parallel/train_step.py`). The host reads the metrics back only on
logging steps. Checkpoints (`utils/checkpoint.py`, the port's own
`torch.save` format) resume the step, the weights, the optimizer, the EMA
and the loader's shuffle position; each step's augment draws come from a
generator seeded by (seed, step), so a resumed run draws what an
uninterrupted one would.

Training data is the in-memory rendered seed scenes of
`data/synthetic.py` (`--synthetic N`) until JPEG decode is ported.
"""

from __future__ import annotations

import argparse
import time

import torch

from bdd100k_tpu_torch.configs import TrainConfig, apply_yolo_priors, get_config
from bdd100k_tpu_torch.data.augment import AugmentConfig
from bdd100k_tpu_torch.data.pipeline import (
    InMemoryDataset,
    make_loader,
    prefetch_to_device,
)
from bdd100k_tpu_torch.data.synthetic import generate_synthetic_scenes
from bdd100k_tpu_torch.models.detector import build_detector
from bdd100k_tpu_torch.parallel.train_step import (
    create_train_state,
    make_train_step,
)
from bdd100k_tpu_torch.utils.checkpoint import CheckpointManager
from bdd100k_tpu_torch.utils.device import resolve_device
from bdd100k_tpu_torch.utils.metrics import MetricsLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BDD100K detector training (GPU)")
    p.add_argument("--config", default="ssd_mobilenet_300",
                   help="ssd_mobilenet_300, ssd_vgg16_512, yolo_mobilenet_384, "
                        "or a tiny test config (ssd_tiny_64, yolo_tiny_64)")
    p.add_argument("--yolo_priors", default=None,
                   help="JSON of fitted YOLO priors (python -m "
                        "bdd100k_tpu_torch.data.priors --out) in place of "
                        "the config's")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N rendered seed scenes held in memory "
                        "(the only data source until JPEG decode is ported)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--total_steps", type=int, default=120_000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_boundaries", default=None,
                   help="comma-separated fractions of total_steps at which "
                        "the LR decays (default: config's 0.66,0.86)")
    p.add_argument("--lr_decays", default=None,
                   help="comma-separated decay factors, one per boundary")
    p.add_argument("--optimizer", default="momentum")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="keep an EMA shadow of the params (TF1 semantics "
                        "incl. the (1+t)/(10+t) ramp); 0 = off")
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--max_boxes", type=int, default=100)
    p.add_argument("--ckpt_dir", default="runs/default")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--no_resume", dest="resume", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    return p.parse_args(argv)


def step_seed(seed: int, step: int) -> int:
    """The augment generator's seed for one step."""
    return (seed * 1_000_003 + step) % (1 << 63)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if not args.synthetic:
        raise SystemExit("need --synthetic N: JPEG datasets are not ported yet")
    det_cfg = get_config(args.config)
    if args.yolo_priors:
        det_cfg = apply_yolo_priors(det_cfg, args.yolo_priors)
    lr_kw = {}
    if args.lr_boundaries is not None:
        lr_kw["lr_boundaries"] = tuple(
            float(x) for x in args.lr_boundaries.split(","))
    if args.lr_decays is not None:
        lr_kw["lr_decays"] = tuple(float(x) for x in args.lr_decays.split(","))
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        max_boxes=args.max_boxes,
        optimizer=args.optimizer,
        learning_rate=args.lr,
        warmup_steps=args.warmup_steps,
        total_steps=args.total_steps,
        checkpoint_every=args.checkpoint_every,
        log_every=args.log_every,
        seed=args.seed,
        ema_decay=args.ema_decay,
        **lr_kw,
    )

    bundle = build_detector(det_cfg, device=device, seed=train_cfg.seed)
    state = create_train_state(bundle, train_cfg)
    ckpt = CheckpointManager(args.ckpt_dir, keep=train_cfg.keep_checkpoints)
    start_step = 0
    if args.resume:
        start_step = ckpt.restore_latest(state)
        if start_step:
            print(f"resumed from step {start_step}", flush=True)

    frames, boxes, labels = generate_synthetic_scenes(
        args.synthetic, seed=args.seed)
    dataset = InMemoryDataset(frames, boxes, labels, train_cfg.max_boxes)
    print(f"dataset: {len(dataset)} images (rendered in memory)", flush=True)
    loader = make_loader(dataset, train_cfg.batch_size, seed=train_cfg.seed,
                         skip_steps=start_step)
    batches = prefetch_to_device(loader, device)
    step_fn = make_train_step(
        bundle, AugmentConfig(out_size=det_cfg.image_size),
        ema_decay=args.ema_decay, device=device)
    logger = MetricsLogger(args.ckpt_dir, "train")
    gen = torch.Generator(device=device)

    step = start_step
    saved = start_step
    t_last = time.monotonic()
    imgs_since = 0
    try:
        for batch in batches:
            if step >= train_cfg.total_steps:
                break
            gen.manual_seed(step_seed(train_cfg.seed, step))
            metrics = step_fn(state, gen, *batch)
            step += 1
            imgs_since += train_cfg.batch_size
            if step % train_cfg.log_every == 0 or step == start_step + 1:
                metrics = {k: float(v) for k, v in metrics.items()}  # a sync
                now = time.monotonic()
                metrics["imgs_per_sec"] = imgs_since / max(now - t_last, 1e-9)
                t_last, imgs_since = now, 0
                logger.log(step, metrics)
            if step % train_cfg.checkpoint_every == 0:
                ckpt.save(step, state)
                saved = step
    finally:
        batches.close()
        logger.close()
    if saved != step:
        ckpt.save(step, state)
    print(f"done at step {step}", flush=True)
    return state


if __name__ == "__main__":
    main()
