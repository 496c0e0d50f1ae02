"""Host-side data pipelines (Laval Indoor layout) and synthetic batches.

The port's own copy of emlight_tpu/train/data.py:

- ``RegressionDataset`` (crop .exr + GT pickle) and ``ProjectorDataset``
  (GT pickle + warped panorama + crop), with the same file pairing, alpha
  plumbing, light-map threshold and names; the anchor-GT guide is
  rasterized on the device inside the steps, not here;
- ``batched``: stacked NumPy batches in a seeded shuffled order;
- ``prefetch``: a host thread that runs the loader ahead of the steps. The
  EXR decoder (core/hdr.py -> native/) is a foreign call that releases the
  GIL, so the thread decodes while the main thread drives the card;
- ``device_prefetch``: batch i+1 copied through pinned memory onto the card
  while step i runs;
- ``synthetic_regression_batch`` / ``synthetic_projector_batch``: the same
  draws in the same order as the JAX package's, so one seed gives both
  packages the same batch.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from collections.abc import Iterator

import numpy as np
import torch

from ..core.hdr import TONEMAP_INPUT, Tonemap, read_hdr, resize_panorama
from ..dist.mesh import shard_rows

__all__ = ["RegressionDataset", "ProjectorDataset", "batched", "prefetch", "device_prefetch",
           "synthetic_regression_batch", "synthetic_projector_batch"]


class RegressionDataset:
    """Pairs of (crop exr, GT pickle), as the reference's ParameterDataset."""

    def __init__(self, root: str, tone: Tonemap = TONEMAP_INPUT,
                 crop_hw: tuple[int, int] | None = (192, 256)):
        gt_dir = os.path.join(root, "pkl")
        crop_dir = os.path.join(root, "crop")
        self.pairs = []
        for nm in sorted(os.listdir(gt_dir)):
            if nm.endswith("pickle"):
                crop_path = os.path.join(crop_dir, nm.replace("pickle", "exr"))
                if os.path.exists(crop_path):
                    self.pairs.append((crop_path, os.path.join(gt_dir, nm)))
        self.tone = tone
        self.crop_hw = crop_hw

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int) -> dict:
        crop_path, gt_path = self.pairs[i]
        img, alpha = self.tone(read_hdr(crop_path))
        if self.crop_hw is not None and img.shape[:2] != self.crop_hw:
            img = resize_panorama(img, (self.crop_hw[1], self.crop_hw[0]))
        with open(gt_path, "rb") as f:
            gt = pickle.load(f)
        return {
            "crop": img.astype(np.float32),
            "distribution": np.asarray(gt["distribution"], np.float32),
            # alpha plumbing (RegressionNetwork/data.py:71-73)
            "intensity": np.float32(gt["intensity"] * alpha / 500.0),
            "rgb_ratio": np.asarray(gt["rgb_ratio"], np.float32),
            "ambient": np.asarray(gt["ambient"], np.float32) * alpha / (128 * 256),
            "name": os.path.basename(gt_path).split(".pickle")[0],
        }


class ProjectorDataset:
    """GT pickle + warped panorama + crop; the env-map guide is rasterized
    on the device."""

    def __init__(self, root: str, tone: Tonemap = TONEMAP_INPUT, crop_size: int = 128,
                 env_hw: tuple[int, int] | None = None):
        pkl_dir = os.path.join(root, "pkl")
        self.samples = []
        for nm in sorted(os.listdir(pkl_dir)):
            if nm.endswith(".pickle"):
                warped = os.path.join(root, "warped", nm.replace("pickle", "exr"))
                crop = os.path.join(root, "crop", nm.replace("pickle", "exr"))
                if os.path.exists(warped) and os.path.exists(crop):
                    self.samples.append((os.path.join(pkl_dir, nm), warped, crop))
        self.tone = tone
        self.crop_size = crop_size
        # the generator's output is (crop_size, 2 * crop_size); the warped
        # target and light mask must match
        self.env_hw = env_hw or (crop_size, crop_size * 2)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        pkl_path, warped_path, crop_path = self.samples[i]
        with open(pkl_path, "rb") as f:
            gt = pickle.load(f)
        crop, alpha = self.tone(read_hdr(crop_path))
        crop = resize_panorama(crop, (self.crop_size, self.crop_size))
        hdr = read_hdr(warped_path)
        if hdr.shape[:2] != self.env_hw:
            hdr = resize_panorama(hdr, (self.env_hw[1], self.env_hw[0]))
        intensity = 0.3 * hdr[..., 0] + 0.59 * hdr[..., 1] + 0.11 * hdr[..., 2]
        light_map = (intensity > intensity.max() * 0.05).astype(np.float32)
        return {
            "crop": crop.astype(np.float32),
            "warped": (hdr * alpha).astype(np.float32),
            "map": light_map,
            "distribution": np.asarray(gt["distribution"], np.float32),
            "intensity": np.float32(gt["intensity"] * 0.01),  # GenProjector/data.py:87
            "rgb_ratio": np.asarray(gt["rgb_ratio"], np.float32),
            "ambient": np.asarray(gt["ambient"], np.float32) / (128 * 256),
            "alpha": np.float32(alpha),
            "name": os.path.basename(pkl_path).split(".")[0],
        }


def batched(dataset, batch_size: int, *, shuffle: bool = True, seed: int = 0,
            drop_last: bool = True, epochs: int | None = None,
            group=None) -> Iterator[dict]:
    """Collate dict samples into stacked NumPy batches (strings as lists).
    With the ranks' ``group`` (a dist/mesh.py RankGroup) each batch is the
    rank's rows [r·B/R, (r+1)·B/R) of the global batch, and only those
    samples are read; B % R must be 0.

    The order depends on `seed` and the epoch only, so a run resumed with
    --resume starts again at epoch 0's first batch and the training CLIs
    stop it at their total step count: the resumed steps replay the first
    batches, not the ones after the bookmark. The JAX package does the same
    (emlight_tpu/train/data.py:122), and the port keeps it.
    """
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[s : s + batch_size]
            if drop_last and len(idx) < batch_size:
                continue
            idx = idx[shard_rows(len(idx), group)]
            samples = [dataset[int(i)] for i in idx]
            batch = {}
            for k in samples[0]:
                vals = [smp[k] for smp in samples]
                batch[k] = vals if isinstance(vals[0], str) else np.stack(vals)
            yield batch
        epoch += 1


def device_prefetch(it: Iterator[dict], device) -> Iterator[tuple[dict, dict]]:
    """Overlap the host-to-device copy with compute: batch i+1 is copied
    while the consumer steps on batch i. Yields (tensors on `device`, the
    batch's strings and lists as they were).

    On CUDA each array goes into a fresh pinned tensor and onto the card
    with ``non_blocking=True``: the copy is enqueued on the current stream
    behind the steps before it and the host goes on at once. No pinned
    buffer is reused (the caching host allocator keeps each one until its
    copy has run), so none is overwritten before the card has read it. On
    the CPU the arrays become tensors without a copy.
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def put(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.pin_memory().to(dev, non_blocking=True) if cuda else t

    pending = None
    for batch in it:
        arrays = {k: put(v) for k, v in batch.items() if not isinstance(v, (str, list))}
        rest = {k: v for k, v in batch.items() if isinstance(v, (str, list))}
        if pending is not None:
            yield pending
        pending = (arrays, rest)
    if pending is not None:
        yield pending


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue. An
    exception in the thread is raised again on the consumer's; when the
    consumer stops early (the generator is closed), the thread stops too."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - raised again on the consumer's thread
            err.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def synthetic_regression_batch(batch_size: int, n_anchors: int = 96,
                               crop_hw: tuple[int, int] = (192, 256), seed: int = 0) -> dict:
    """A regressor batch: crop and the four anchor-parameter targets."""
    rng = np.random.default_rng(seed)
    dist = rng.gamma(0.3, 1.0, (batch_size, n_anchors)).astype(np.float32)
    dist /= dist.sum(1, keepdims=True)
    rgb = rng.uniform(0.4, 0.7, (batch_size, 3)).astype(np.float32)
    rgb /= np.linalg.norm(rgb, axis=1, keepdims=True)
    return {
        "crop": rng.random((batch_size, *crop_hw, 3), dtype=np.float32),
        "distribution": dist,
        "intensity": rng.uniform(0.2, 2.0, batch_size).astype(np.float32),
        "rgb_ratio": rgb,
        "ambient": rng.uniform(0, 0.05, (batch_size, 3)).astype(np.float32),
    }


def synthetic_projector_batch(batch_size: int, n_anchors: int = 128,
                              crop_size: int = 128, env_hw: tuple[int, int] = (128, 256),
                              seed: int = 0) -> dict:
    """A GenProjector batch: crop, warped HDR target, light map and the
    anchor parameters the guide is rasterized from."""
    rng = np.random.default_rng(seed)
    dist = rng.gamma(0.3, 1.0, (batch_size, n_anchors)).astype(np.float32)
    dist /= dist.sum(1, keepdims=True)
    rgb = rng.uniform(0.4, 0.7, (batch_size, 3)).astype(np.float32)
    rgb /= np.linalg.norm(rgb, axis=1, keepdims=True)
    return {
        "crop": rng.random((batch_size, crop_size, crop_size, 3), dtype=np.float32),
        "warped": rng.random((batch_size, *env_hw, 3), dtype=np.float32),
        "map": (rng.random((batch_size, *env_hw)) > 0.9).astype(np.float32),
        "distribution": dist,
        "intensity": rng.uniform(0.2, 2.0, batch_size).astype(np.float32),
        "rgb_ratio": rgb,
        "ambient": rng.uniform(0, 0.05, (batch_size, 3)).astype(np.float32),
        "alpha": rng.uniform(0.5, 2.0, batch_size).astype(np.float32),
    }
