"""Static int8 activation-scale calibration for "int8_static" (mirror of
bdd100k_tpu/models/quant.py).

Calibration runs a few representative batches through the model with
every static `QuantConv` calibrating: each keeps a running max of its
input's amax (`act_amax`) and, where it emits int8 codes, of its
post-ReLU output (`out_amax`), all in one float pass. The maxima are
buffers of the `QuantConv`s; `quant_state` lists them by module path, the
port's form of the reference's `quant` collection
(`utils/weights.quant_state_from_flax` converts it).

The one calibration protocol of evaluate and infer (`calibrate_for_driver`):
up to CALIB_MAX_IMAGES frames, batched at CALIB_BATCH with a partial tail
padded by its last image, from `--calib_images` or the eval set's head.
The frames decode as the reference decodes them: the dataset's images
through cv2's route (libjpeg's 1/2 or 1/4 scaled decode, then
INTER_LINEAR; `data/pipeline.decode_jpeg_bytes_resized`), a directory's
through PIL's (`convert("RGB")` at full resolution, then the bicubic
`resize((s, s))`), since the running maxima see every pixel.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from bdd100k_tpu_torch.models.layers import QuantConv

CALIB_BATCH = 8
CALIB_MAX_IMAGES = 64
CALIB_SUFFIXES = (".jpg", ".jpeg", ".png")


def static_convs(model: torch.nn.Module) -> dict[str, QuantConv]:
    """The model's static `QuantConv`s by module path."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, QuantConv) and m.static_act}


def quant_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """{"<module path>.act_amax" / ".out_amax": f32 scalar} of every static
    `QuantConv`, copies on the host."""
    out = {}
    for name, m in static_convs(model).items():
        out[f"{name}.act_amax"] = m.act_amax.detach().cpu().clone()
        if m.emit_int8:
            out[f"{name}.out_amax"] = m.out_amax.detach().cpu().clone()
    return out


def load_quant_state(model: torch.nn.Module,
                     state: dict[str, torch.Tensor]) -> None:
    """Set the buffers `quant_state` names; strict: every static buffer
    of the model, and nothing else."""
    want = set(quant_state(model))
    if set(state) != want:
        missing, extra = sorted(want - set(state)), sorted(set(state) - want)
        raise ValueError(f"quant state mismatch: missing {missing[:4]}, "
                         f"unexpected {extra[:4]}")
    convs = static_convs(model)
    with torch.no_grad():
        for key, v in state.items():
            name, leaf = key.rsplit(".", 1)
            getattr(convs[name], leaf).copy_(torch.as_tensor(v))


def init_quant_vars(bundle) -> dict[str, torch.Tensor] | None:
    """Zero every static buffer of the bundle's model → the zero state, or
    None when the model has no static-quant layers."""
    convs = static_convs(bundle.model)
    if not convs:
        return None
    for m in convs.values():
        m.act_amax.zero_()
        if m.emit_int8:
            m.out_amax.zero_()
    return quant_state(bundle.model)


@contextlib.contextmanager
def _calibrating(model: torch.nn.Module):
    convs = static_convs(model).values()
    for m in convs:
        m.calibrating = True
    try:
        yield
    finally:
        for m in convs:
            m.calibrating = False


def calibrate(bundle, batches: Iterable) -> dict[str, torch.Tensor] | None:
    """Run `batches` through the model with its static convs calibrating,
    from zero, → the frozen maxima (`quant_state`), which stay in the
    model. A batch is what the eval step takes: preprocessed float
    images, uint8 RGB or a (y, uv) yuv420 pair, numpy or torch. None when
    the model has no static-quant layers; zero batches raise, as the
    reference does (every scale would be 0)."""
    from bdd100k_tpu_torch.data.augment import preprocess_eval_batch

    if init_quant_vars(bundle) is None:
        return None
    device = bundle.anchors.device
    n = 0
    with _calibrating(bundle.model), torch.inference_mode():
        for images in batches:
            if isinstance(images, (tuple, list)):
                images = tuple(torch.as_tensor(a).to(device) for a in images)
            else:
                images = torch.as_tensor(images).to(device)
            if isinstance(images, tuple) or images.dtype == torch.uint8:
                images = preprocess_eval_batch(images, bundle.config.image_size)
            bundle.model(images)
            n += 1
    if n == 0:
        raise ValueError("int8_static calibration got zero batches — the "
                         "frozen activation scales would all be 0")
    return quant_state(bundle.model)


def _batches(images: list[np.ndarray], batch_size: int) -> list[np.ndarray]:
    """Stack `images` in batches of `batch_size`, the partial tail padded
    by repeating its last image (a running max cannot change)."""
    out = []
    for lo in range(0, len(images), batch_size):
        chunk = list(images[lo:lo + batch_size])
        chunk += [chunk[-1]] * (batch_size - len(chunk))
        out.append(np.stack(chunk))
    return out


def _reference_image(dataset, i: int) -> np.ndarray:
    """`dataset[i]["image"]` as the reference's `DetectionDataset` decodes
    it: cv2's route at a decode_size (the port's own __getitem__ takes the
    decode pool there, whose pixels differ), PIL's without one."""
    from bdd100k_tpu_torch.data.pipeline import decode_jpeg_bytes_resized

    size = getattr(dataset, "decode_size", None)
    if size is None:
        return dataset[i]["image"]
    name = dataset.records[i]["name"]
    return decode_jpeg_bytes_resized(dataset.read_jpegs([i])[0], size, name)


def calibration_batches_from_dataset(
    dataset, batch_size: int = CALIB_BATCH,
    num_batches: int = CALIB_MAX_IMAGES // CALIB_BATCH,
) -> list[np.ndarray]:
    """The first `num_batches` batches of `dataset`'s decoded uint8 RGB
    images, on the caller's thread, the tail padded."""
    n = min(len(dataset), num_batches * batch_size)
    return _batches([_reference_image(dataset, i) for i in range(n)],
                    batch_size)


def calibration_batches_from_images(
    image_dir, image_size: int, batch_size: int = CALIB_BATCH,
    limit: int = CALIB_MAX_IMAGES,
) -> list[np.ndarray]:
    """Batches of the first `limit` .jpg/.jpeg/.png files of `image_dir`
    (sorted by path), each decoded as PIL decodes it and resized to the
    model's input with PIL's default `resize`, bicubic; the tail padded."""
    from bdd100k_tpu_torch.data.host_resize import resize_bicubic
    from bdd100k_tpu_torch.data.pipeline import decode_image

    paths = sorted(p for p in Path(image_dir).iterdir()
                   if p.suffix.lower() in CALIB_SUFFIXES)[:limit]
    if not paths:
        raise SystemExit(f"no images under {image_dir}")
    images = [resize_bicubic(decode_image(p.read_bytes(), str(p))[None],
                             image_size, image_size)[0] for p in paths]
    return _batches(images, batch_size)


def calibrate_for_driver(bundle, *, calib_images=None, dataset=None,
                         num_batches: int = CALIB_MAX_IMAGES // CALIB_BATCH):
    """The one calibration protocol of evaluate and infer: `calib_images` (a directory
    of representative frames) when given, else the head of `dataset`, at
    CALIB_BATCH → (quant state, images used, padding included, as the
    reference counts them)."""
    if calib_images is not None:
        batches = calibration_batches_from_images(
            calib_images, bundle.config.image_size)
    elif dataset is not None:
        batches = calibration_batches_from_dataset(dataset,
                                                   num_batches=num_batches)
    else:
        raise SystemExit(
            "--quant int8_static needs --calib_images (a directory of "
            "representative frames to freeze activation scales on)")
    state = calibrate(bundle, batches)
    return state, sum(b.shape[0] for b in batches)
