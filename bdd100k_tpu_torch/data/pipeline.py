"""Host input pipeline: datasets → fixed batches → copies to the card
(counterpart of bdd100k_tpu/data/pipeline.py).

Two datasets:
* `DetectionDataset`: JPEG files and BDD100K labels. With a `decode_size`,
  a batch is one call into the decode pool (`data/native_decode.py`, the
  reference's `native/decode_pool.cc`), which decodes the JPEGs straight
  to a (decode_size, decode_size) square, RGB or planar YUV 4:2:0; without
  one, each JPEG decodes at full resolution on a thread pool of single
  decodes, as the reference's non-native route does;
* `InMemoryDataset`: frames already in host memory as uint8, such as the
  rendered scenes of `data/synthetic.generate_synthetic_scenes`.

`make_loader` keeps the reference's batching exactly: fixed batches, a
per-epoch permutation that is a pure function of (seed, epoch), the final
partial batch dropped or padded with its last index repeated, and
`skip_steps` for resume. `prefetch_to_device` runs the loader ahead in a
background thread (so the next batch decodes while the card works on
this one), gathers each batch into pinned host memory and copies it to
the card on a side stream, with an event the consuming stream waits on.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from bdd100k_tpu_torch.data.bdd100k import (
    IMAGE_HEIGHT,
    IMAGE_WIDTH,
    load_bdd100k_labels,
    pad_ground_truth,
)
from bdd100k_tpu_torch.data.host_resize import resize_bicubic, resize_linear
from bdd100k_tpu_torch.data.native_decode import (
    NativeDecoder,
    decode_full,
    decode_scaled,
    image_size,
)
from bdd100k_tpu_torch.data.png import decode_png, is_png


class Batch(NamedTuple):
    # (B, H, W, 3) uint8 RGB, or (y (B, S, S), uv (B, S/2, S/2, 2)) uint8
    # planes on the yuv420 wire (augment.yuv420_to_rgb_batch rebuilds RGB)
    images: np.ndarray | torch.Tensor | tuple
    boxes: np.ndarray | torch.Tensor    # (B, M, 4) f32 corner, normalized
    labels: np.ndarray | torch.Tensor   # (B, M) int32
    mask: np.ndarray | torch.Tensor     # (B, M) bool


def _leaves(batch: Batch) -> list:
    images = batch.images
    return [*(images if isinstance(images, tuple) else (images,)),
            batch.boxes, batch.labels, batch.mask]


def _map(fn, batch: Batch) -> Batch:
    images = batch.images
    images = (tuple(fn(a) for a in images) if isinstance(images, tuple)
              else fn(images))
    return Batch(images, fn(batch.boxes), fn(batch.labels), fn(batch.mask))


def rgb_to_yuv420_host(images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, H, W, 3) uint8 RGB → (y (N, H, W), uv (N, H/2, W/2, 2)) uint8:
    the BT.601 full-range forward matrix and the 2×2 chroma mean, in numpy
    (the reference's oracle for the pool's planar output). H and W must be
    even."""
    f = images.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    n, h, w = images.shape[:3]
    uv = np.stack([cb, cr], axis=-1)
    uv = uv.reshape(n, h // 2, 2, w // 2, 2, 2).mean(axis=(2, 4))
    return (np.clip(y + 0.5, 0, 255).astype(np.uint8),
            np.clip(uv + 0.5, 0, 255).astype(np.uint8))


def decode_image(data: bytes, name: str | None = None) -> np.ndarray:
    """A JPEG or PNG file's bytes → (H, W, 3) uint8 RGB at full resolution,
    the pixels of PIL's `Image.open(path).convert("RGB")`; a truncated file
    raises OSError naming `name`, as PIL does."""
    if is_png(data):
        return decode_png(data, name=name)
    return decode_full(data, name=name)


def decode_jpeg_bytes_resized(data: bytes, size: int,
                              name: str | None = None) -> np.ndarray:
    """JPEG bytes → (size, size, 3) uint8 RGB by the reference's route on a
    host with cv2 (bdd100k_tpu/data/pipeline.py decode_jpeg_bytes_resized):
    libjpeg's 1/4 or 1/2 scaled decode (cv2's IMREAD_REDUCED_COLOR_4 / _2)
    when the shorter side is at least 4× or 2× `size`, else a full decode,
    then cv2's INTER_LINEAR resize. The reference's `DetectionDataset`
    decodes an item so at a decode_size; its loader, and the port's, take
    the decode pool instead, whose pixels differ by a level here and
    there."""
    h, w = image_size(data)
    denom = 4 if min(h, w) >= 4 * size else 2 if min(h, w) >= 2 * size else 1
    return resize_linear(decode_scaled(data, denom, name)[None], size, size)[0]


class InMemoryDataset:
    """Frames and padded GT held in host memory."""

    def __init__(self, frames: np.ndarray, boxes: list[np.ndarray],
                 labels: list[np.ndarray], max_boxes: int = 100):
        if len(frames) != len(boxes) or len(boxes) != len(labels):
            raise ValueError("frames, boxes and labels differ in length")
        self.frames = frames
        padded = [pad_ground_truth(b, l, max_boxes) for b, l in zip(boxes, labels)]
        self.boxes = np.stack([p[0] for p in padded])
        self.labels = np.stack([p[1] for p in padded])
        self.mask = np.stack([p[2] for p in padded])

    def __len__(self) -> int:
        return len(self.frames)

    def batch(self, idx: np.ndarray) -> Batch:
        return Batch(self.frames[idx], self.boxes[idx], self.labels[idx],
                     self.mask[idx])


class FullResolutionPool:
    """A thread pool of single full-resolution decodes (`decode_full`
    releases the GIL), the decoder of a `DetectionDataset` without a
    decode_size."""

    def __init__(self, num_workers: int = 8):
        self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def map(self, fn, *items) -> list:
        return list(self._pool.map(fn, *items))

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class DetectionDataset:
    """Random-access dataset of (JPEG file, padded GT).

    `decode_size` S: each JPEG decodes straight to an (S, S) square on the
    host, through libjpeg's DCT-domain downscale and the pool's bilinear
    resize (boxes are normalized, so the GT is unaffected); the eval path
    decodes at the model's input size. `decode_size=None`: each JPEG
    decodes at full resolution (`decode_full`, PIL's pixels), and an image
    that is not image_height × image_width is resized to it with PIL's
    default filter, bicubic (`data/host_resize.resize_bicubic`), as the
    reference's PIL route resizes it. A PNG decodes there too
    (`decode_image`), and a JPEG cut before its EOI marker raises, as PIL
    does; the pool at a decode_size takes JPEGs only, and decodes a
    truncated one as far as it goes, as the reference's pool does."""

    def __init__(
        self,
        records: Sequence[dict],
        image_dir: str | Path,
        max_boxes: int = 100,
        image_height: int = IMAGE_HEIGHT,
        image_width: int = IMAGE_WIDTH,
        decode_size: int | None = None,
    ):
        self.records = list(records)
        self.image_dir = Path(image_dir)
        self.max_boxes = max_boxes
        self.image_height = image_height
        self.image_width = image_width
        self.decode_size = decode_size
        self._gt_arrays = None
        self._gt_key = None

    @classmethod
    def from_bdd100k(cls, labels_path: str | Path, image_dir: str | Path,
                     max_boxes: int = 100, **kw) -> "DetectionDataset":
        return cls(load_bdd100k_labels(labels_path), image_dir, max_boxes, **kw)

    def __len__(self) -> int:
        return len(self.records)

    def read_jpegs(self, idx: Sequence[int]) -> list[bytes]:
        return [(self.image_dir / self.records[i]["name"]).read_bytes()
                for i in idx]

    def decode_full(self, jpeg: bytes, name: str | None = None) -> np.ndarray:
        """One JPEG or PNG at full resolution, resized to image_height ×
        image_width if it is another size; `name` names the file in an
        error."""
        image = decode_image(jpeg, name)
        if image.shape[:2] != (self.image_height, self.image_width):
            image = resize_bicubic(image[None], self.image_height,
                                   self.image_width)[0]
        return image

    def __getitem__(self, i: int) -> dict:
        """One image, decoded in this thread at full resolution, or by a
        one-thread pool of its own at `decode_size` (the loader decodes
        whole batches instead)."""
        rec = self.records[i]
        boxes, labels, mask = pad_ground_truth(
            rec["boxes"], rec["labels"], self.max_boxes)
        if self.decode_size is None:
            image = self.decode_full(self.read_jpegs([i])[0], rec["name"])
        else:
            decoder = NativeDecoder(1)
            try:
                image = decoder.decode_batch(self.read_jpegs([i]),
                                             self.decode_size)[0]
            finally:
                decoder.close()
        return {"image": image, "boxes": boxes, "labels": labels,
                "mask": mask, "name": rec["name"]}

    def padded_gt_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All GT padded into (N, M, 4) / (N, M) / (N, M) arrays, built once
        (again if the records or max_boxes change), so a batch's GT is one
        gather."""
        key = (len(self.records), self.max_boxes)
        if self._gt_key != key:
            n, m = key
            boxes = np.zeros((n, m, 4), np.float32)
            labels = np.zeros((n, m), np.int32)
            mask = np.zeros((n, m), bool)
            for i, rec in enumerate(self.records):
                boxes[i], labels[i], mask[i] = pad_ground_truth(
                    rec["boxes"], rec["labels"], m)
            self._gt_arrays = (boxes, labels, mask)
            self._gt_key = key
        return self._gt_arrays

    def batch(self, idx: np.ndarray,
              decoder: NativeDecoder | FullResolutionPool,
              wire_format: str = "rgb") -> Batch:
        """The images of `idx`, decoded in one call into `decoder`'s pool
        (a `FullResolutionPool` without a decode_size), and their GT."""
        jpegs = self.read_jpegs(idx)
        if self.decode_size is None:
            names = [self.records[i]["name"] for i in idx]
            images = np.stack(decoder.map(self.decode_full, jpegs, names))
        elif wire_format == "yuv420":
            images = decoder.decode_batch_yuv420(jpegs, self.decode_size)
        else:
            images = decoder.decode_batch(jpegs, self.decode_size)
        boxes, labels, mask = self.padded_gt_arrays()
        return Batch(images, boxes[idx], labels[idx], mask[idx])


def resolve_wire(choice: str = "auto", dataset=None) -> str:
    """A --wire choice → "rgb" or "yuv420". "auto" takes yuv420 unless the
    dataset's decode_size is missing or odd (4:2:0 needs even frames; no
    dataset means the caller promises even frames). The reference also
    falls back to rgb when its pool did not build; here the pool always
    builds or raises, so that case does not arise."""
    if choice != "auto":
        return choice
    if dataset is not None:
        size = getattr(dataset, "decode_size", None)
        if size is None or size % 2:
            return "rgb"
    return "yuv420"


def make_loader(
    dataset: InMemoryDataset | DetectionDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    num_epochs: int | None = None,
    drop_last: bool = True,
    skip_steps: int = 0,
    num_workers: int = 8,
    wire_format: str = "rgb",
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Batch]:
    """Fixed batches over the dataset, for `num_epochs` epochs (None:
    forever), each epoch in the next permutation of `seed`'s RandomState
    (or in order, without `shuffle`). The final partial batch of an epoch
    is dropped, or with `drop_last=False` padded to the batch size by
    repeating its last index, as the reference pads it. `skip_steps`
    fast-forwards past the first N batches without building them: whole
    epochs only advance the RNG, the rest moves the cursor inside the
    epoch. A `DetectionDataset` decodes through a pool of `num_workers`
    threads (full-resolution decodes on a `FullResolutionPool` of as many
    threads without a decode_size), on the `wire_format` "rgb" or "yuv420"
    (even decode_size).

    `process_index` / `process_count`: this rank's shard of the indices,
    the strided `[index::count]`, cut to len // count rows so that every
    rank yields as many batches an epoch (reference: pipeline.py:264-271);
    each epoch permutes the shard, and `skip_steps` counts the shard's
    batches."""
    if wire_format not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire_format {wire_format!r}")
    files = isinstance(dataset, DetectionDataset)
    size = dataset.decode_size if files else None
    if wire_format == "yuv420" and not (size and size % 2 == 0):
        raise ValueError("wire_format='yuv420' needs an even decode_size")
    local = np.arange(len(dataset))[process_index::process_count]
    if process_count > 1:
        local = local[:len(dataset) // process_count]
    n = len(local)
    per_epoch = n // batch_size if drop_last else -(-n // batch_size)
    if per_epoch == 0:
        raise ValueError(f"{n} images cannot fill one batch of {batch_size}")
    rng = np.random.RandomState(seed)
    full_epochs, skip_batches = divmod(skip_steps, per_epoch)
    for _ in range(full_epochs):
        if shuffle:
            rng.permutation(local)  # advance the RNG identically
    epoch = full_epochs
    decoder = None
    if files:
        decoder = (NativeDecoder(num_workers) if size is not None
                   else FullResolutionPool(num_workers))
    try:
        while num_epochs is None or epoch < num_epochs:
            order = rng.permutation(local) if shuffle else local
            for bi in range(skip_batches, per_epoch):  # mid-epoch resume cursor
                idx = order[bi * batch_size:(bi + 1) * batch_size]
                if len(idx) < batch_size:  # pad the final partial batch
                    idx = np.concatenate(
                        [idx, np.repeat(idx[-1:], batch_size - len(idx))])
                yield (dataset.batch(idx, decoder, wire_format) if files
                       else dataset.batch(idx))
            skip_batches = 0
            epoch += 1
    finally:
        if decoder is not None:
            decoder.close()


class _Failure:
    """Carries a pipeline-thread exception to the consumer, so a failure
    is raised and never looks like the end of the data."""

    def __init__(self, exc: BaseException):
        self.exc = exc


PREFETCH = 2  # batches in flight: one in the step, one being copied


def prefetch_to_device(iterator: Iterator[Batch],
                       device: torch.device) -> Iterator[Batch]:
    """Run `iterator` ahead in a background thread and yield its batches as
    tensors on `device`. For a CUDA device each batch is copied into pinned
    host memory and sent with a non-blocking copy on a side stream; the
    consumer's stream waits on the copy's event, and the tensors are
    recorded on that stream so their memory is not reused too early. At
    most `PREFETCH` batches are in flight."""
    device = torch.device(device)
    out: queue.Queue = queue.Queue(maxsize=PREFETCH)
    end = object()
    stop = threading.Event()
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def to_device(batch: Batch):
        host = _map(lambda a: torch.from_numpy(np.ascontiguousarray(a)), batch)
        if not cuda:
            return host, None
        pinned = _map(lambda t: t.pin_memory(), host)
        with torch.cuda.stream(side):
            dev = _map(lambda t: t.to(device, non_blocking=True), pinned)
            ready = torch.cuda.Event()
            ready.record(side)
        # the pinned buffers must outlive the copy: keep them with the batch
        return dev, (ready, pinned)

    def producer():
        try:
            for batch in iterator:
                item = to_device(batch)
                while not stop.is_set():
                    try:
                        out.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            out.put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            out.put(_Failure(e))
        finally:
            # a loader stopped early releases what it holds (its decode pool)
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = out.get()
            if item is end:
                return
            if isinstance(item, _Failure):
                raise RuntimeError("input pipeline thread failed") from item.exc
            batch, sync = item
            if sync is not None:
                ready, _pinned = sync
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for t in _leaves(batch):
                    t.record_stream(stream)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
