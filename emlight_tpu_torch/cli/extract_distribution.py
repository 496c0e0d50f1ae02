"""Anchor-GT extraction on the card: warped HDR panoramas -> anchor pickles.

Port of emlight_tpu/cli/extract_distribution.py (the reference's
distribution_representation.py:123-147): the same flags and pickles
({distribution, intensity, rgb_ratio, ambient} per panorama, the GT layout
of the training datasets). Pipelined: a loader thread decodes and
area-resizes batch i+1 in the native library's threads
(native.load_batch, outside the interpreter lock), batch i is copied onto
the card and its extraction (representation/extract.py) dispatched BEFORE
the results of batch i-1 are fetched, and a writer thread pickles them.

The JAX CLI falls back to its Python codec when the native one refuses a
batch; the port's reader is the native codec alone (core/hdr.py), so a
file it refuses raises, naming the file.

Usage:
  python -m emlight_tpu_torch.cli.extract_distribution --hdr_dir .../warpedHDROutputs \
      --out_dir .../pkl [--anchors 128] [--batch 16] [--preview_dir tmp/] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle
import queue
import threading
import time

import numpy as np
import torch

from .. import native
from ..core.hdr import TONEMAP_VIZ
from ..core.png import write_png
from ..representation.extract import extract_anchors_batch
from ..representation.splat import render_anchor_params
from ..train.data import prefetch
from ._common import add_device_flag, checked_device

GT_KEYS = ("distribution", "intensity", "rgb_ratio", "ambient")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hdr_dir", required=True, help="directory of .exr panoramas")
    ap.add_argument("--out_dir", required=True, help="output directory for .pickle GT")
    ap.add_argument("--anchors", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--limit", type=int, default=0, help="process at most N files")
    ap.add_argument("--preview_dir", default=None, help="optional splat-render previews")
    add_device_flag(ap)
    return ap


def _write(args, chunk: list[str], out: dict, dev) -> None:
    """One batch's pickles (and previews)."""
    for i, nm in enumerate(chunk):
        para = {"distribution": out["distribution"][i],
                "intensity": np.asarray(out["intensity"][i]),
                "rgb_ratio": out["rgb_ratio"][i],
                "ambient": out["ambient"][i]}
        with open(os.path.join(args.out_dir, nm.replace(".exr", ".pickle")), "wb") as f:
            pickle.dump(para, f, protocol=pickle.HIGHEST_PROTOCOL)
        if args.preview_dir:
            as_t = lambda a: torch.as_tensor(np.asarray(a)[None], device=dev)  # noqa: E731
            env = render_anchor_params(as_t(para["distribution"]), as_t(para["intensity"]),
                                       as_t(para["rgb_ratio"]), n=args.anchors)
            tone, _ = TONEMAP_VIZ(env[0].cpu().numpy())
            os.makedirs(args.preview_dir, exist_ok=True)
            write_png(os.path.join(args.preview_dir, nm.replace(".exr", "_rec.png")),
                      (tone * 255).astype(np.uint8))


def main(argv=None) -> dict:
    """Run the CLI; returns the panoramas written, the loop's seconds, the
    host's load_batch ms per batch and, on the card, each batch's extraction
    ms (CUDA events)."""
    ap = _parser()
    dev = checked_device(ap, argv)
    args = ap.parse_args(argv)

    names = sorted(n for n in os.listdir(args.hdr_dir) if n.endswith(".exr"))
    if args.limit:
        names = names[:args.limit]
    os.makedirs(args.out_dir, exist_ok=True)
    h, w = args.height, args.height * 2
    cuda = dev.type == "cuda"
    load_ms: list[float] = []

    def loader():
        for s in range(0, len(names), args.batch):
            chunk = names[s:s + args.batch]
            t0 = time.perf_counter()
            imgs, _ = native.load_batch([os.path.join(args.hdr_dir, nm) for nm in chunk], (h, w))
            load_ms.append((time.perf_counter() - t0) * 1e3)
            yield chunk, imgs

    # pickles are written off the dispatching thread; a failure is raised
    # again on it once the queue is drained
    wq: queue.Queue = queue.Queue(maxsize=8)
    werr: list[BaseException] = []
    done = 0

    def writer():
        nonlocal done
        while (item := wq.get()) is not None:
            if werr:
                continue
            try:
                _write(args, *item, dev)
                done += len(item[0])
            except Exception as e:  # noqa: BLE001 - raised again on the main thread
                werr.append(e)

    wthread = threading.Thread(target=writer, daemon=True)
    wthread.start()
    device_ms: list[float] = []

    def fetch(pending):
        chunk, out, events = pending
        out = {k: v.cpu().numpy() for k, v in out.items() if k in GT_KEYS}
        if events:
            device_ms.append(events[0].elapsed_time(events[1]))
        wq.put((chunk, out))

    t0 = time.perf_counter()
    pending = None  # (chunk, device outputs, events): fetched one batch behind
    try:
        for chunk, imgs in prefetch(loader(), depth=4):
            x = torch.from_numpy(imgs)
            x = x.pin_memory().to(dev, non_blocking=True) if cuda else x
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) if cuda else None
            if events:
                events[0].record()
            out = extract_anchors_batch(x, n=args.anchors)
            if events:
                events[1].record()
            if pending is not None:
                fetch(pending)
            pending = (chunk, out, events)
        if pending is not None:
            fetch(pending)
    finally:
        wq.put(None)
        wthread.join()
    if werr:
        raise werr[0]
    dt = time.perf_counter() - t0
    print(f"extracted {done} panoramas in {dt:.2f}s ({done / max(dt, 1e-9):.1f} panoramas/sec)")
    return {"panoramas": done, "seconds": dt, "load_ms": load_ms, "device_ms": device_ms}


if __name__ == "__main__":
    main()
