"""Evaluation: mAP@0.5 over a val split, on the card (counterpart of
bdd100k_tpu/evaluate.py).

    python -m bdd100k_tpu_torch.evaluate --synthetic 64 \\
        --synthetic_dir tests/fixtures/synth_val_seed1 \\
        --ckpt_dir artifacts/ssd_mobilenet_300_synth9k.npz
    python -m bdd100k_tpu_torch.evaluate --config yolo_mobilenet_384 \\
        --synthetic 64 --ckpt_dir artifacts/yolo_mobilenet_384_synth4kds.npz \\
        --yolo_priors artifacts/yolo_priors_synth4k.json
    python -m bdd100k_tpu_torch.evaluate --config ssd_vgg16_512 \\
        --synthetic 64 --ckpt_dir artifacts/ssd_vgg16_512_synth9k.npz
    python -m bdd100k_tpu_torch.evaluate --labels val.json \\
        --image_dir images/val --ckpt_dir runs/ssd300 --ema
    # on the CPU (the plain versions of the kernels): add --device cpu

JPEG files decode on the host straight to the model's input size, a batch
in one call into the decode pool, one batch ahead of the card
(`data/pipeline.py`). On the card: preprocess, the forward in bf16 and the
postprocess with the NMS kernel (`parallel/train_step.make_eval_step`);
only the fixed detection slots come back, and the host accumulates the
mAP. Batch k+1 is dispatched before batch k is fetched and accumulated, so
the host's bookkeeping overlaps the card's work.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from bdd100k_tpu_torch.configs import BDD100K_CLASSES, apply_yolo_priors, get_config
from bdd100k_tpu_torch.data.pipeline import (
    DetectionDataset,
    make_loader,
    prefetch_to_device,
)
from bdd100k_tpu_torch.data.synthetic import FIXTURE_DIR, ensure_synthetic_dataset
from bdd100k_tpu_torch.models.detector import build_detector
from bdd100k_tpu_torch.ops.map_metric import DetectionEvaluator
from bdd100k_tpu_torch.ops.nms import Detections
from bdd100k_tpu_torch.parallel.train_step import make_eval_step
from bdd100k_tpu_torch.utils.device import resolve_device, strict_f32
from bdd100k_tpu_torch.utils.weights import restore_eval_weights


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BDD100K detector eval (GPU)")
    p.add_argument("--config", default="ssd_mobilenet_300")
    p.add_argument("--yolo_priors", default=None,
                   help="JSON of fitted YOLO priors (python -m "
                        "bdd100k_tpu_torch.data.priors --out); the weights "
                        "must have been trained with them")
    p.add_argument("--labels", default=None)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="evaluate the first N scenes of --synthetic_dir")
    p.add_argument("--synthetic_dir", default=str(FIXTURE_DIR),
                   help="a split the reference's generate_synthetic_dataset "
                        "wrote (read, never written); default: the "
                        "committed 64 seed-1 val scenes")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_boxes", type=int, default=100)
    p.add_argument("--ckpt_dir", default=None,
                   help="a run directory of the port's trainer (restore the "
                        "latest checkpoint) or a single-file .npz weights "
                        "artifact")
    p.add_argument("--ema", action="store_true",
                   help="evaluate the checkpoint's EMA shadow weights "
                        "(runs trained with --ema_decay)")
    p.add_argument("--iou_threshold", type=float, default=0.5)
    p.add_argument("--coco_map", action="store_true",
                   help="also report COCO-style mAP@[.50:.05:.95], matched "
                        "again per threshold on the host's accumulated "
                        "arrays; the card's pass runs once")
    p.add_argument("--dump_detections", default=None,
                   help="write all detections as BDD100K-format JSON "
                        "(name/category/box2d in source pixels + score)")
    p.add_argument("--num_workers", type=int, default=8,
                   help="threads of the JPEG decode pool")
    p.add_argument("--out", default=None, help="write results JSON here")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="not ported yet (multi-GPU, ROADMAP Queue 1 item 11)")
    p.add_argument("--nms", choices=("auto", "xla", "pallas", "fixpoint"),
                   default="auto",
                   help="the reference's NMS backends, which make identical "
                        "keep decisions; every choice runs the port's one "
                        "route: the CUDA greedy-NMS kernel on the card, the "
                        "plain greedy on the CPU")
    p.add_argument("--quant", choices=("none", "int8", "int8_static"),
                   default="none",
                   help="int8 is not ported yet (ROADMAP Queue 1 item 10)")
    p.add_argument("--calib_images", default=None,
                   help="int8_static calibration; not ported yet (item 10)")
    p.add_argument("--calib_batches", type=int, default=8,
                   help="int8_static calibration; not ported yet (item 10)")
    p.add_argument("--preselect", choices=("exact", "approx"), default="exact",
                   help="per-class candidate preselect. The reference's "
                        "approx is lax.approx_max_k, which is exact on every "
                        "backend but the TPU, so its own CPU and GPU runs "
                        "are exact too; both choices run the port's exact "
                        "dense preselect")
    p.add_argument("--per_class_topk", type=int, default=None,
                   help="override PostprocessConfig.per_class_topk (NMS "
                        "candidates per class, at most 256 on the card)")
    p.add_argument("--wire", choices=("rgb", "yuv420"), default="rgb",
                   help="host->card wire format; yuv420 ships half the "
                        "bytes and rebuilds RGB on the card (its chroma "
                        "path differs from rgb's at the last bit)")
    p.add_argument("--multihost", action="store_true",
                   help="not ported yet (ROADMAP Queue 1 item 11)")
    p.add_argument("--sync_dir", default=None,
                   help="not ported yet (ROADMAP Queue 1 item 11)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="the convs' working type; float32 turns TF32 off, "
                        "for comparisons with the reference's f32 mAP")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Flags whose slice is still to come raise SystemExit, naming the
    ROADMAP item, when set away from their defaults."""
    later = []
    if args.quant != "none" or args.calib_images is not None \
            or args.calib_batches != 8:
        later.append(("--quant/--calib_*", "item 10 (int8 quant)"))
    if args.multihost or args.sync_dir is not None or args.mesh_data is not None:
        later.append(("--multihost/--sync_dir/--mesh_data",
                      "item 11 (multi-GPU and multi-host)"))
    if later:
        raise SystemExit("not ported yet: " + "; ".join(
            f"{flag}, ROADMAP Queue 1 {item}" for flag, item in later))


def _dump_image(dataset, idx: int, det: Detections, row: int) -> dict:
    """One image's detections in the BDD100K labels format: normalized
    corner boxes → source-resolution pixels."""
    w, h = dataset.image_width, dataset.image_height
    labels = []
    for box, score, cls, ok in zip(
        det.boxes[row], det.scores[row], det.classes[row], det.valid[row]
    ):
        if not ok:
            continue
        labels.append({
            "category": BDD100K_CLASSES[int(cls) - 1],
            "score": round(float(score), 4),
            "box2d": {
                "x1": round(float(box[0]) * w, 2),
                "y1": round(float(box[1]) * h, 2),
                "x2": round(float(box[2]) * w, 2),
                "y2": round(float(box[3]) * h, 2),
            },
        })
    return {"name": dataset.records[idx]["name"], "labels": labels}


def fetch_async(tensors: list[torch.Tensor]):
    """Start the copies of `tensors` to the host → (host tensors, an event
    that completes with the copies, or None on the CPU). On the card the
    copies are queued on the current stream behind the work that made
    them, so a later dispatch does not delay them."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def run_eval(bundle, dataset, args) -> dict:
    """Evaluate `dataset` on the bundle's device → the result dict: the
    evaluator's mAP and per-class AP, `coco` with --coco_map,
    `images_per_sec` (steady state: the first batch, which pays the kernel
    builds and first launches, is fenced out of the clock; None when the
    run is that one batch) and `num_images`."""
    device = bundle.anchors.device
    eval_step = make_eval_step(bundle)
    wire = getattr(args, "wire", "rgb")
    print(f"wire format: {wire}")
    loader = make_loader(
        dataset, args.batch_size, shuffle=False, num_epochs=1,
        drop_last=False, num_workers=args.num_workers, wire_format=wire)
    batches = prefetch_to_device(loader, device)
    evaluator = DetectionEvaluator(bundle.config.num_classes,
                                   list(BDD100K_CLASSES))
    n_images = len(dataset)
    seen = 0
    dump = [] if getattr(args, "dump_detections", None) else None

    def accumulate(pending) -> None:
        nonlocal seen
        host, done = pending
        if done is not None:
            done.synchronize()
        arrays = [t.numpy() for t in host]
        det = Detections(*arrays[:4])
        gt_boxes, gt_labels, gt_mask = arrays[4:]
        for i in range(det.boxes.shape[0]):
            if seen >= n_images:
                break  # the padded tail of the final partial batch
            evaluator.add_image(
                det.boxes[i], det.scores[i], det.classes[i],
                gt_boxes[i], gt_labels[i],
                det_valid=det.valid[i], gt_mask=gt_mask[i])
            if dump is not None:
                dump.append(_dump_image(dataset, seen, det, i))
            seen += 1

    # one batch in flight: dispatch batch k+1, then fetch and accumulate k
    pending = None
    t0 = None
    timed = 0  # images dispatched after the clock started
    try:
        for batch in batches:
            det = eval_step(batch.images)
            if t0 is None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.monotonic()
            else:
                timed += det.boxes.shape[0]
            fetched = fetch_async([*det, batch.boxes, batch.labels, batch.mask])
            if pending is not None:
                accumulate(pending)
            pending = fetched
        if pending is not None:
            accumulate(pending)
    finally:
        batches.close()
    dt = (time.monotonic() - t0) if t0 is not None else 0.0
    result = evaluator.compute(iou_threshold=args.iou_threshold)
    if getattr(args, "coco_map", False):
        result["coco"] = evaluator.compute_range()
    result["images_per_sec"] = (
        round(min(timed, seen) / dt, 2) if timed and dt > 0 else None)
    result["num_images"] = seen
    if dump is not None:
        Path(args.dump_detections).write_text(json.dumps(dump))
        print(f"wrote {seen} images of detections to {args.dump_detections}")
    return result


def load_dataset(args, decode_size: int) -> DetectionDataset:
    """The --synthetic split (its first N scenes) or --labels/--image_dir,
    decoding straight to `decode_size`."""
    if args.synthetic:
        labels = ensure_synthetic_dataset(
            args.synthetic_dir, num_images=args.synthetic, seed=1, split="val")
        dataset = DetectionDataset.from_bdd100k(
            labels, Path(args.synthetic_dir) / "images" / "val",
            max_boxes=args.max_boxes, decode_size=decode_size)
        dataset.records = dataset.records[:args.synthetic]
        return dataset
    if not args.labels or not args.image_dir:
        raise SystemExit("need --labels + --image_dir (or --synthetic N)")
    return DetectionDataset.from_bdd100k(
        args.labels, args.image_dir, max_boxes=args.max_boxes,
        decode_size=decode_size)


def main(argv=None) -> dict:
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    det_cfg = get_config(args.config)
    if args.yolo_priors:
        det_cfg = apply_yolo_priors(det_cfg, args.yolo_priors)
    if args.per_class_topk is not None:
        det_cfg = dataclasses.replace(det_cfg, postprocess=dataclasses.replace(
            det_cfg.postprocess, per_class_topk=args.per_class_topk))
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    with strict_f32(args.dtype == "float32"):
        bundle = build_detector(det_cfg, dtype=dtype, device=device)
        if args.ckpt_dir:
            step = restore_eval_weights(bundle.model, args.ckpt_dir, ema=args.ema,
                                        expect_config=det_cfg.name)
            print(f"restored step {step}" + (" (EMA weights)" if args.ema else ""))
        # no augment at eval: decode straight to the model's input size
        dataset = load_dataset(args, det_cfg.image_size)
        result = run_eval(bundle, dataset, args)
    ips = result.get("images_per_sec")
    print(f"\nmAP@{args.iou_threshold}: {result['mAP']:.4f}"
          + (f" ({ips:.1f} imgs/sec steady-state)" if ips else ""))
    if "coco" in result:
        print(f"mAP@[.50:.95]: {result['coco']['mAP']:.4f}")
    for name, ap in result["per_class"].items():
        print(f"  {name:>14}: {'—' if ap is None else f'{ap:.4f}'}")
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
