"""Training driver (counterpart of bdd100k_tpu/train.py).

    python -m bdd100k_tpu_torch.train --config ssd_mobilenet_300 \\
        --labels /data/labels/train.json --image_dir /data/images/train \\
        --batch_size 32 --decode_size 512 --ckpt_dir runs/ssd300 \\
        --pretrained_backbone mobilenet_v1.bin --ema_decay 0.9998
    python -m bdd100k_tpu_torch.train --config yolo_mobilenet_384 \\
        --batch_size 64 --synthetic 64 --ckpt_dir runs/yolo384
    # on the CPU, at the tiny test config:
    python -m bdd100k_tpu_torch.train --config ssd_tiny_64 --synthetic 8 \\
        --batch_size 4 --total_steps 3 --warmup_steps 0 --device cpu

Each step takes a batch of uint8 frames with padded GT, copied to the card
ahead of use by the prefetcher, and runs the whole step there
(`parallel/train_step.py`). The frames come from JPEG files and BDD100K
labels (`--labels/--image_dir`), decoded on the host by the decode pool:
at `--decode_size` S straight to S×S squares, on the rgb wire or, with
`--wire auto` and an even S, as YUV 4:2:0 planes (half the bytes; the step
rebuilds RGB on the card); with `--decode_size 0`, at full resolution on
`--num_workers` threads. The host reads the metrics back only on logging
steps. Checkpoints (`utils/checkpoint.py`, the port's own `torch.save`
format) resume the step, the weights, the optimizer, the EMA and the
loader's shuffle position; each step's augment draws come from a generator
seeded by (seed, step), so a resumed run draws what an uninterrupted one
would. `python -m bdd100k_tpu_torch.scripts.export_weights` turns a run
into the `.npz` artifact that evaluate and infer load.

`--synthetic N --synthetic_dir D` trains on the first N scenes of the
complete `train` split the reference's generator wrote in D. Without
`--synthetic_dir`, `--synthetic N` trains on N scenes rendered in memory,
the pixels before the reference's JPEG encode (the port has no JPEG
encoder to write the files yet: ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from bdd100k_tpu_torch.configs import TrainConfig, apply_yolo_priors, get_config
from bdd100k_tpu_torch.data.augment import AugmentConfig
from bdd100k_tpu_torch.data.pipeline import (
    DetectionDataset,
    InMemoryDataset,
    make_loader,
    prefetch_to_device,
    resolve_wire,
)
from bdd100k_tpu_torch.data.synthetic import (
    ensure_synthetic_dataset,
    generate_synthetic_scenes,
)
from bdd100k_tpu_torch.models.detector import build_detector
from bdd100k_tpu_torch.parallel.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from bdd100k_tpu_torch.utils import pretrained
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
    p.add_argument("--labels", default=None, help="BDD100K labels JSON")
    p.add_argument("--image_dir", default=None)
    p.add_argument("--records_dir", default=None,
                   help="not ported yet (record shards, ROADMAP Queue 1 item 12)")
    p.add_argument("--grain_workers", type=int, default=0,
                   help="not ported yet (record shards, ROADMAP Queue 1 item 12)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic scenes: the first N of "
                        "--synthetic_dir's train split, or, without it, N "
                        "scenes rendered in memory (their pixels before the "
                        "reference's JPEG encode: writing the JPEGs waits "
                        "for ROADMAP Queue 1 item 14)")
    p.add_argument("--synthetic_dir", default=None,
                   help="a directory the reference's generator wrote a "
                        "complete train split into (read, never written)")
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
                        "incl. the (1+t)/(10+t) ramp); evaluate/infer with "
                        "--ema to use it. 0 = off")
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--max_boxes", type=int, default=100)
    p.add_argument("--decode_size", type=int, default=0,
                   help="host-decode frames straight to this square size "
                        "before the card's augment (0 = native resolution); "
                        "e.g. 512 for a 300-input model")
    p.add_argument("--ckpt_dir", default="runs/default")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8,
                   help="threads of the JPEG decode pool")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="not ported yet (multi-GPU, ROADMAP Queue 1 item 11)")
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--no_resume", dest="resume", action="store_false")
    p.add_argument("--profile_steps", default=None,
                   help="'start,stop': a torch.profiler trace of those steps "
                        "into <ckpt_dir>/profile/")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection: the backward "
                        "raises at the op that made a NaN (debug only, slow)")
    p.add_argument("--checkify", action="store_true",
                   help="sync every step and raise FloatingPointError at the "
                        "first non-finite loss, gradient or updated parameter "
                        "(debug only)")
    p.add_argument("--pretrained_backbone", default=None,
                   help="seed the backbone before training: a .npz (a "
                        "save_params_npz transplant or a detector artifact), "
                        "or a torch .pth/.bin state_dict (torchvision vgg16 "
                        "or HF MobileNetV1, picked by the config's backbone)")
    p.add_argument("--multihost", action="store_true",
                   help="not ported yet (ROADMAP Queue 1 item 11)")
    p.add_argument("--wire", choices=("auto", "rgb", "yuv420"), default="auto",
                   help="host->card wire for decoded frames; yuv420 halves "
                        "the bytes (the card rebuilds RGB before the augment). "
                        "auto = yuv420 when --decode_size is even")
    p.add_argument("--image_summary_every", type=int, default=0,
                   help="every N steps, drawn detections of two batch images "
                        "as TensorBoard image summaries (when tensorboard "
                        "imports; 0 = off)")
    p.add_argument("--step_impl", choices=("pjit", "shard_map"), default="pjit",
                   help="the reference's data-parallel step forms; the port "
                        "has one single-card step (shard_map: ROADMAP Queue 1 "
                        "item 11)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Flags whose slice is still to come raise SystemExit, naming the
    ROADMAP item, when set away from their defaults."""
    later = []
    if args.records_dir is not None or args.grain_workers:
        later.append(("--records_dir/--grain_workers", "item 12 (record shards)"))
    if args.multihost or args.mesh_data is not None or args.step_impl != "pjit":
        later.append(("--multihost/--mesh_data/--step_impl",
                      "item 11 (multi-GPU and multi-host)"))
    if later:
        raise SystemExit("not ported yet: " + "; ".join(
            f"{flag}, ROADMAP Queue 1 {item}" for flag, item in later))


def step_seed(seed: int, step: int) -> int:
    """The augment generator's seed for one step."""
    return (seed * 1_000_003 + step) % (1 << 63)


def make_dataset(args) -> DetectionDataset | InMemoryDataset:
    """The training set the flags name (reference: train.py::make_dataset)."""
    decode_size = args.decode_size or None
    if args.synthetic and args.synthetic_dir is None:
        frames, boxes, labels = generate_synthetic_scenes(args.synthetic,
                                                          seed=args.seed)
        print("rendered in memory: JPEG files need ROADMAP Queue 1 item 14's "
              "encoder", flush=True)
        return InMemoryDataset(frames, boxes, labels, args.max_boxes)
    if args.synthetic:
        labels = ensure_synthetic_dataset(args.synthetic_dir,
                                          num_images=args.synthetic,
                                          seed=args.seed)
        ds = DetectionDataset.from_bdd100k(
            labels, Path(args.synthetic_dir) / "images" / "train",
            max_boxes=args.max_boxes, decode_size=decode_size)
        ds.records = ds.records[:args.synthetic]
        return ds
    if not args.labels or not args.image_dir:
        raise SystemExit("need --labels + --image_dir (or --synthetic N)")
    return DetectionDataset.from_bdd100k(args.labels, args.image_dir,
                                         max_boxes=args.max_boxes,
                                         decode_size=decode_size)


def seed_backbone(state, det_cfg, path: str) -> int:
    """Transplant pretrained backbone weights into the state's model in
    place (reference: train.py::_seed_backbone) and re-anchor the EMA
    shadow, if any, at the seeded weights → the tensors written. An .npz
    is a transplant or a detector artifact; anything else a torch
    state_dict of the config's backbone."""
    model = state.model
    if path.endswith(".npz"):
        n = pretrained.load_backbone_any_npz(model, path)
    elif det_cfg.backbone == "vgg16":
        n = pretrained.import_torch_vgg16(model, path)
    else:
        n = pretrained.import_torch_mobilenet_v1(model, path)
    print(f"seeded {det_cfg.backbone} backbone from {path} ({n} tensors)",
          flush=True)
    if state.ema_params is not None:
        with torch.no_grad():
            for e, p in zip(state.ema_params, model.parameters(), strict=True):
                e.copy_(p)
    return n


def first_non_finite(metrics: dict, model: torch.nn.Module) -> str | None:
    """The name of the first non-finite tensor among the step's loss, the
    gradients and the updated parameters, or None: one sync."""
    named = [(k, v) for k, v in metrics.items() if k.endswith("loss")]
    params = list(model.named_parameters())
    named += [(f"gradient of {k}", p.grad) for k, p in params if p.grad is not None]
    named += [(f"updated parameter {k}", p.detach()) for k, p in params]
    ok = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    bad = (~ok).nonzero()
    return named[int(bad[0])][0] if len(bad) else None


class StepProfile:
    """A torch.profiler trace of steps [start, stop) into
    <ckpt_dir>/profile/trace_<start>_<stop>.json, its window fenced by
    syncs so the printed wall time is the steps' own."""

    def __init__(self, spec: str, ckpt_dir: str, device: torch.device):
        self.start, self.stop = (int(x) for x in spec.split(","))
        if not 0 <= self.start < self.stop:
            raise SystemExit(f"--profile_steps {spec!r}: need start < stop")
        self.path = Path(ckpt_dir) / "profile" / f"trace_{self.start}_{self.stop}.json"
        self.device = device
        self._prof = None
        self._t0 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def before(self, step: int) -> None:
        if step == self.start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            self._prof = profile(activities=acts)
            self._prof.start()
            self._t0 = time.perf_counter()

    def after(self, step: int) -> None:
        if self._prof is not None and step == self.stop:
            self._sync()
            wall_ms = (time.perf_counter() - self._t0) * 1e3
            self._prof.stop()
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.path))
            self._prof = None
            print(f"profile: steps {self.start}-{self.stop}, "
                  f"{self.stop - self.start} steps, wall {wall_ms:.3f} ms, "
                  f"trace {self.path}", flush=True)


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    # anomaly detection for this run only: restored on the way out
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        return train(args, device)


def train(args, device: torch.device):
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
    if args.pretrained_backbone and not start_step:
        seed_backbone(state, det_cfg, args.pretrained_backbone)

    dataset = make_dataset(args)
    print(f"dataset: {len(dataset)} images", flush=True)
    wire = resolve_wire(args.wire, dataset)
    print(f"wire format: {wire}", flush=True)
    # one batch a step: the loader's position is a function of the step,
    # so a resumed run continues the exact shuffle
    loader = make_loader(dataset, train_cfg.batch_size, shuffle=True,
                         seed=train_cfg.seed, skip_steps=start_step,
                         num_workers=args.num_workers, wire_format=wire)
    batches = prefetch_to_device(loader, device)
    step_fn = make_train_step(
        bundle, AugmentConfig(out_size=det_cfg.image_size),
        ema_decay=args.ema_decay, device=device)
    eval_fn = None
    if args.image_summary_every:
        if wire != "rgb":
            # the summary draws on the batch's frames; planar batches would
            # need an RGB rebuild on the host
            print("image summaries disabled with --wire yuv420", flush=True)
        else:
            eval_fn = make_eval_step(bundle)
    logger = MetricsLogger(args.ckpt_dir, "train")
    prof = (StepProfile(args.profile_steps, args.ckpt_dir, device)
            if args.profile_steps else None)
    gen = torch.Generator(device=device)

    step = start_step
    saved = start_step
    t_last = time.monotonic()
    imgs_since = 0
    try:
        for batch in batches:
            if step >= train_cfg.total_steps:
                break
            if prof is not None:
                prof.before(step)
            gen.manual_seed(step_seed(train_cfg.seed, step))
            metrics = step_fn(state, gen, *batch)
            step += 1
            imgs_since += train_cfg.batch_size
            if args.checkify:
                bad = first_non_finite(metrics, state.model)
                if bad is not None:
                    raise FloatingPointError(f"step {step}: non-finite {bad}")
            if prof is not None:
                prof.after(step)
            if step % train_cfg.log_every == 0 or step == start_step + 1:
                metrics = {k: float(v) for k, v in metrics.items()}  # a sync
                now = time.monotonic()
                metrics["imgs_per_sec"] = imgs_since / max(now - t_last, 1e-9)
                t_last, imgs_since = now, 0
                logger.log(step, metrics)
            if eval_fn is not None and step % args.image_summary_every == 0:
                summarize(logger, eval_fn, batch.images[:2], step)
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


def summarize(logger: MetricsLogger, eval_fn, images: torch.Tensor,
              step: int) -> None:
    """Drawn detections of the current params on `images` (uint8 frames)
    as image summaries (reference: train.py:415-426)."""
    from bdd100k_tpu_torch.utils.viz import draw_detections

    det = eval_fn(images)
    frames = images.cpu().numpy()
    boxes, scores = det.boxes.float().cpu().numpy(), det.scores.float().cpu().numpy()
    classes, valid = det.classes.cpu().numpy(), det.valid.cpu().numpy()
    for i in range(frames.shape[0]):
        drawn = draw_detections(frames[i], boxes[i], scores[i], classes[i],
                                valid[i], score_threshold=0.3)
        logger.image(step, f"detections/{i}", drawn)


if __name__ == "__main__":
    main()
