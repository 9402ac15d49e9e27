"""Serving: `Predictor`, `load_predictor` and the inference CLI (mirror of
bdd100k_tpu/infer.py).

One request: the frames are padded to the fixed batch on the host (after
the host resize and the yuv420 conversion, when asked for), copied to the
card, resized (unless already at the model's size) and normalized there
(`preprocess_eval_batch`), run through the detector in its working type,
decoded, scored and suppressed on the card; only the fixed detection
slots come back. `dispatch` launches a batch without waiting, `fetch`
brings it back; `__call__` does both.

    python -m bdd100k_tpu_torch.infer --config ssd_mobilenet_300 \\
        --ckpt_dir artifacts/ssd_mobilenet_300_synth9k.npz --image road.jpg
    python -m bdd100k_tpu_torch.infer --config ssd_vgg16_512 \\
        --ckpt_dir artifacts/ssd_vgg16_512_synth9k.npz --image_dir DIR \\
        --batch_size 32 --out_dir out/
    # on the CPU (the plain versions of the kernels): add --device cpu

Two modes: one image (`run_single`, decoded at full resolution) and a
pipelined directory sweep (`run_dir`). Departures from the reference:
drawn outputs are PNG files (`det_<stem>.png`, written with zlib: the
card's machine has no PIL or cv2); the video mode is not ported (it needs
cv2.VideoCapture, which the card's machine lacks); PNG input is refused
(ROADMAP Queue 1 item 13); int8 (`--quant`) waits for ROADMAP Queue 1
item 10. `--dtype float32` is the port's own: it runs the convs in f32
with TF32 off, where the printed detections can be held to an f32 run of
the reference.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from bdd100k_tpu_torch.configs.detector_configs import (
    BDD100K_CLASSES,
    DetectorConfig,
    apply_yolo_priors,
    get_config,
)
from bdd100k_tpu_torch.data.augment import preprocess_eval_batch
from bdd100k_tpu_torch.data.host_resize import resize_linear
from bdd100k_tpu_torch.data.native_decode import NativeDecoder, decode_full
from bdd100k_tpu_torch.data.pipeline import (
    DetectionDataset,
    make_loader,
    resolve_wire,
    rgb_to_yuv420_host,
)
from bdd100k_tpu_torch.evaluate import fetch_async
from bdd100k_tpu_torch.models.detector import DetectorBundle, build_detector
from bdd100k_tpu_torch.ops.nms import Detections
from bdd100k_tpu_torch.utils.device import resolve_device, strict_f32
from bdd100k_tpu_torch.utils.viz import draw_detections, write_png
from bdd100k_tpu_torch.utils.weights import restore_eval_weights

QUANT_LATER = "int8 quant is not ported yet (ROADMAP Queue 1 item 10)"
PNG_LATER = "PNG input is not ported yet (ROADMAP Queue 1 item 13)"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
VIDEO_NOT_PORTED = ("--video is not ported: it reads frames with "
                    "cv2.VideoCapture, which the GPU machine does not have")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BDD100K detector inference (GPU)")
    p.add_argument("--config", default="ssd_mobilenet_300")
    p.add_argument("--yolo_priors", default=None,
                   help="JSON of fitted YOLO priors (python -m "
                        "bdd100k_tpu_torch.data.priors --out); the weights "
                        "must have been trained with them")
    p.add_argument("--ckpt_dir", default=None,
                   help="a run directory of the port's trainer or a "
                        "single-file .npz weights artifact")
    p.add_argument("--ema", action="store_true",
                   help="use the checkpoint's EMA shadow weights "
                        "(runs trained with --ema_decay)")
    p.add_argument("--image", default=None)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--video", default=None, help="not ported: " + VIDEO_NOT_PORTED)
    p.add_argument("--out_dir", default=None,
                   help="write drawn outputs here, as det_<stem>.png")
    p.add_argument("--score_threshold", type=float, default=0.4,
                   help="display threshold of the printed and drawn boxes")
    p.add_argument("--batch_size", type=int, default=8,
                   help="batch size of the directory sweep")
    p.add_argument("--host_resize", choices=("auto", "on", "off"),
                   default="auto",
                   help="resize frames to the model's size on the host "
                        "before the copy to the card; auto = on for the "
                        "directory sweep, off for one image")
    p.add_argument("--drain_timeout", type=float, default=0.05,
                   help="video mode only, which is not ported")
    p.add_argument("--wire", choices=("auto", "rgb", "yuv420"),
                   default="auto",
                   help="host->card wire format; yuv420 (auto: on with "
                        "host_resize at an even size) ships planar Y and "
                        "subsampled CbCr, half the bytes of RGB")
    p.add_argument("--nms", choices=("auto", "xla", "pallas", "fixpoint"),
                   default="auto",
                   help="the reference's NMS backends, which make identical "
                        "keep decisions; every choice runs the port's one "
                        "route: the CUDA greedy-NMS kernel on the card, the "
                        "plain greedy on the CPU")
    p.add_argument("--quant", choices=("none", "int8", "int8_static"),
                   default="none", help=QUANT_LATER)
    p.add_argument("--calib_images", default=None, help=QUANT_LATER)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="working type of the detector's convs: bfloat16, "
                        "the reference's, or float32 (with TF32 off) to hold "
                        "the printed detections against an f32 reference")
    return p.parse_args(argv)


def _pin_to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """`a` padded to n rows by repeating its last row."""
    if len(a) > n:
        raise ValueError(f"{len(a)} frames > batch size {n}")
    if len(a) == n:
        return a
    return np.concatenate([a, np.repeat(a[-1:], n - len(a), axis=0)])


class Predictor:
    """Forward + postprocess at a fixed batch size, padding-safe.

    `host_resize=True` resizes frames to the model's size on the host
    before the copy (boxes come back normalized, so drawing on the
    original frame is unaffected): the bytes of cv2.resize(INTER_LINEAR)
    (`data/host_resize.py`), or, on the yuv420 wire, the decode pool's
    resize and conversion in one call, whose small planes are then padded
    instead of the frames. `wire="yuv420"` without host resize converts
    the padded frames on the host (`rgb_to_yuv420_host`), dropping an odd
    edge row or column."""

    def __init__(self, bundle: DetectorBundle, batch_size: int = 1,
                 host_resize: bool = False, wire: str = "rgb",
                 quant: str = "none"):
        if quant != "none":
            raise NotImplementedError(f"quant={quant!r}: {QUANT_LATER}")
        if wire not in ("rgb", "yuv420"):
            raise ValueError(f"unknown wire {wire!r}")
        self.bundle = bundle
        self.batch_size = batch_size
        self.host_resize = host_resize
        self.wire = wire
        self.device = bundle.anchors.device
        self._native = (NativeDecoder(4) if wire == "yuv420" and host_resize
                        else None)

    def host_frames(self, frames_u8: np.ndarray):
        """Frames (N ≤ batch_size, H, W, 3) uint8 → what goes on the wire:
        the padded batch, RGB or a (y, uv) pair."""
        s = self.bundle.config.image_size
        if self._native is not None:
            y, uv = self._native.resize_yuv420_batch(frames_u8, s)
            return _pad_rows(y, self.batch_size), _pad_rows(uv, self.batch_size)
        if self.host_resize and frames_u8.shape[1:3] != (s, s):
            frames_u8 = resize_linear(frames_u8, s, s)
        frames_u8 = _pad_rows(frames_u8, self.batch_size)
        if self.wire == "yuv420":
            h, w = frames_u8.shape[1:3]
            return rgb_to_yuv420_host(frames_u8[:, :h - h % 2, :w - w % 2])
        return frames_u8

    def _images(self, host) -> torch.Tensor:
        on_card = (tuple(_pin_to(a, self.device) for a in host)
                   if isinstance(host, tuple) else _pin_to(host, self.device))
        return preprocess_eval_batch(on_card, self.bundle.config.image_size)

    def logits(self, frames_u8: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Padded batch → (loc (B, A, 4), cls (B, A, C+1)) f32 on the device."""
        return self.bundle.apply(self._images(self.host_frames(frames_u8)))

    def forward_ready(self, host) -> Detections:
        """A full batch already on the wire's host form (a loader's batch:
        RGB, or a (y, uv) pair) → device Detections, without waiting."""
        with torch.inference_mode():
            loc, cls = self.bundle.apply(self._images(host))
            return self.bundle.postprocess(loc, cls)

    def dispatch(self, frames_u8: np.ndarray) -> tuple[Detections, int]:
        """Run one batch on the device → (device Detections, n) without
        the copy back."""
        return self.forward_ready(self.host_frames(frames_u8)), len(frames_u8)

    @staticmethod
    def fetch(det: Detections, n: int) -> Detections:
        """Device Detections → numpy Detections for the first n frames."""
        return Detections(*(t[:n].cpu().numpy() for t in det))

    def __call__(self, frames_u8: np.ndarray) -> Detections:
        """frames (N ≤ batch_size, H, W, 3) uint8 → host Detections for N."""
        det, n = self.dispatch(frames_u8)
        return self.fetch(det, n)


def resolve_predictor_wire(wire: str, host_resize: bool, image_size: int) -> str:
    """The reference's choice: yuv420 when asked for, or on "auto" when
    the host resizes to an even size; rgb otherwise."""
    if wire == "yuv420" or (wire == "auto" and host_resize
                            and image_size % 2 == 0):
        return "yuv420"
    return "rgb"


def load_predictor(
    config: str | DetectorConfig,
    ckpt: str | Path,
    batch_size: int = 1,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    yolo_priors: str | Path | None = None,
    host_resize: bool = False,
    wire: str = "auto",
    ema: bool = False,
    quant: str = "none",
) -> Predictor:
    """A `Predictor` for `config` with the weights of `ckpt`: a .npz
    artifact (strict: every key, every shape; another recorded config name
    warns) or a run directory of the port's trainer, its latest
    checkpoint (`ema`: its EMA shadow). `yolo_priors` replaces a YOLO
    config's anchor priors with a fitted set (`apply_yolo_priors`), which
    the weights must have been trained with. `wire` resolves as the
    reference's does (`resolve_predictor_wire`). `device` defaults to CUDA
    and raises without it; the CPU runs only when asked for."""
    if quant != "none":
        raise NotImplementedError(f"quant={quant!r}: {QUANT_LATER}")
    cfg = get_config(config) if isinstance(config, str) else config
    if yolo_priors:
        cfg = apply_yolo_priors(cfg, yolo_priors)
    if not Path(ckpt).exists():
        raise FileNotFoundError(f"no weights at {ckpt}")
    bundle = build_detector(cfg, dtype=dtype, device=device)
    restore_eval_weights(bundle.model, ckpt, ema=ema, expect_config=cfg.name)
    return Predictor(
        bundle, batch_size, host_resize=host_resize,
        wire=resolve_predictor_wire(wire, host_resize, cfg.image_size))


# ------------------------------------------------------------------- CLI


def _want_host_resize(args, default: bool) -> bool:
    return {"auto": default, "on": True, "off": False}[args.host_resize]


def _refuse_png(path: Path) -> None:
    if path.suffix.lower() == ".png":
        raise SystemExit(f"{path}: {PNG_LATER}")


def _read_image(path) -> np.ndarray:
    """A JPEG file → (H, W, 3) uint8 RGB at full resolution."""
    _refuse_png(Path(path))
    return decode_full(Path(path).read_bytes())


def _cli_predictor(args, batch_size: int, host_resize: bool) -> Predictor:
    if not args.ckpt_dir:
        raise SystemExit("need --ckpt_dir (a .npz artifact or a run directory)")
    return load_predictor(
        args.config, args.ckpt_dir, batch_size=batch_size,
        device=resolve_device(args.device), dtype=DTYPES[args.dtype],
        yolo_priors=args.yolo_priors,
        host_resize=host_resize, wire=args.wire, ema=args.ema)


def _emit(args, name, frame, det_i, out_dir):
    keep = det_i["valid"] & (det_i["scores"] >= args.score_threshold)
    for box, score, cls in zip(
        det_i["boxes"][keep], det_i["scores"][keep], det_i["classes"][keep]
    ):
        print(
            f"{name}: {BDD100K_CLASSES[int(cls) - 1]} {score:.3f} "
            f"[{box[0]:.3f} {box[1]:.3f} {box[2]:.3f} {box[3]:.3f}]"
        )
    if out_dir:
        drawn = draw_detections(
            frame, det_i["boxes"], det_i["scores"], det_i["classes"],
            det_i["valid"], score_threshold=args.score_threshold,
        )
        write_png(Path(out_dir) / f"det_{Path(name).stem}.png", drawn)


def parse_detection_lines(text: str) -> dict[str, list[tuple]]:
    """The detection lines `_emit` prints, `name: class score [x1 y1 x2
    y2]`, → {file name: [(class, score, (x1, y1, x2, y2))]}; other lines
    are skipped."""
    out: dict[str, list[tuple]] = {}
    for line in text.splitlines():
        if "]" not in line or ": " not in line:
            continue
        name, rest = line.rsplit(": ", 1)
        head, box = rest.rstrip("]").split(" [")
        cls, score = head.rsplit(" ", 1)
        out.setdefault(Path(name).name, []).append(
            (cls, float(score), tuple(float(v) for v in box.split())))
    return out


def _det_slice(det: Detections, i: int) -> dict:
    return {"boxes": det.boxes[i], "scores": det.scores[i],
            "classes": det.classes[i], "valid": det.valid[i]}


def _sync(predictor: Predictor) -> None:
    if predictor.device.type == "cuda":
        torch.cuda.synchronize(predictor.device)


def run_single(args):
    predictor = _cli_predictor(
        args, batch_size=1, host_resize=_want_host_resize(args, default=False))
    frame = _read_image(args.image)
    t0 = time.monotonic()
    det = predictor(frame[None])
    latency = time.monotonic() - t0
    _emit(args, args.image, frame, _det_slice(det, 0), args.out_dir)
    print(f"latency (incl. kernel builds and first launches): "
          f"{latency * 1e3:.1f} ms")
    t0 = time.monotonic()
    predictor(frame[None])
    print(f"warm latency: {(time.monotonic() - t0) * 1e3:.1f} ms")


def run_dir(args):
    """Directory sweep, pipelined as the reference's.

    The loader decodes the next batch on a producer thread (through the
    decode pool straight to the model's size with host resize on, at full
    resolution without it) while the card runs this one, and dispatch runs
    one batch ahead of fetch and emit: the copy back of batch k is queued
    right behind its work, then batch k+1 is dispatched, then batch k is
    printed. With --out_dir, boxes are drawn on the decoded frames (boxes
    are normalized, so any size draws correctly) and the wire is rgb; a
    pure sweep with host resize takes the yuv420 wire on "auto". A decode
    or IO error on the producer thread is raised here, never taken for the
    end of the directory."""
    paths = sorted(
        p for p in Path(args.image_dir).iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    if not paths:
        raise SystemExit(f"no images in {args.image_dir}")
    for p in paths:
        _refuse_png(p)
    host_resize = _want_host_resize(args, default=True)
    # the loader does the host resize; the predictor sees ready frames
    predictor = _cli_predictor(args, batch_size=args.batch_size,
                               host_resize=False)
    s = predictor.bundle.config.image_size
    records = [{"name": p.name, "boxes": np.zeros((0, 4), np.float32),
                "labels": np.zeros((0,), np.int32)} for p in paths]
    dataset = DetectionDataset(records, args.image_dir, max_boxes=1,
                               decode_size=s if host_resize else None)
    wire = ("rgb" if (args.out_dir or not host_resize)
            else resolve_wire(args.wire, dataset))
    loader = make_loader(dataset, args.batch_size, shuffle=False, num_epochs=1,
                         drop_last=False, num_workers=8, wire_format=wire)

    hq: queue.Queue = queue.Queue(maxsize=4)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                hq.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():  # decode-ahead: the loader runs while the card computes
        try:
            for b in loader:
                if not put(b):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            put(e)
        finally:
            loader.close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    n, t0 = 0, time.monotonic()
    first = None  # (images, time) when the first batch had been printed
    pending = None  # (names, host frames or None, host detections, event, k)

    def emit_pending(p):
        nonlocal n, first
        names, frames, (host, done), k = p
        if done is not None:
            done.synchronize()
        det = Detections(*(t[:k].numpy() for t in host))
        for i in range(k):
            frame = frames[i] if frames is not None else None
            _emit(args, names[i], frame, _det_slice(det, i), args.out_dir)
        n += k
        if first is None:
            first = (n, time.monotonic())

    start = 0
    try:
        while True:
            item = hq.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise RuntimeError("image_dir pipeline failed; see cause") from item
            k = min(args.batch_size, len(paths) - start)
            names = [str(p) for p in paths[start:start + k]]
            start += args.batch_size
            fetched = fetch_async(list(predictor.forward_ready(item.images)))
            if pending is not None:  # print batch k-1 while k computes
                emit_pending(pending)
            frames = np.asarray(item.images) if args.out_dir else None
            pending = (names, frames, fetched, k)
        if pending is not None:
            emit_pending(pending)
    finally:
        stop.set()
        thread.join(timeout=10)
    t1 = time.monotonic()
    dt = t1 - t0
    steady = ""
    if first is not None and n > first[0]:
        steady = (f"; {(n - first[0]) / (t1 - first[1]):.1f} imgs/sec after "
                  "the first batch")
    print(f"{n} images in {dt:.2f}s = {n / dt:.1f} imgs/sec "
          f"(incl. kernel builds and first launches){steady}")


def main(argv=None):
    args = parse_args(argv)
    if args.quant != "none" or args.calib_images is not None:
        raise SystemExit(f"--quant/--calib_images: {QUANT_LATER}")
    if args.video:
        raise SystemExit(VIDEO_NOT_PORTED)
    if args.out_dir:
        Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    if not (args.image or args.image_dir):
        raise SystemExit("need one of --image / --image_dir")
    with strict_f32(args.dtype == "float32"):
        if args.image:
            run_single(args)
        else:
            run_dir(args)


if __name__ == "__main__":
    main()
