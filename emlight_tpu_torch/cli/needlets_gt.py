"""Needlet GT generation + roundtrip check CLI (replaces Needlets/gt_gen_j2.py,
gt_gen_j3.py and mat_gen2.py).

Port of emlight_tpu/cli/needlets_gt.py: the same flags and .npy files,
plus --device. Builds the SN basis analytically (addition theorem), projects
batches of panoramas on the device, applies the per-band sparsification (j2
only; j3 saves dense coefficients like gt_gen_j3.py), and optionally
verifies a reconstruction (mat_gen2.py:55-64 energy check). Panoramas are
read by the native EXR reader; the per-sample alpha of --crop_dir is
``tonemap_alpha(crop, TONEMAP_INPUT, gamma=False)``.

Usage:
  python -m emlight_tpu_torch.cli.needlets_gt --hdr_dir .../warpedHDROutputs \
      --out_dir .../needlets_j2 [--jmax 2] [--crop_dir .../crop] [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..config import NeedletsConfig
from ..core.hdr import TONEMAP_INPUT, read_hdr, resize_panorama, tonemap_alpha
from ..needlets import NeedletPipeline
from ._common import add_device_flag, checked_device


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hdr_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--jmax", type=int, default=2, choices=(2, 3))
    ap.add_argument("--crop_dir", default=None,
                    help="crops for the per-sample tonemap alpha (gt_gen_j2.py:36-39)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--no_sparsify", action="store_true")
    ap.add_argument("--check", action="store_true", help="print roundtrip energies")
    add_device_flag(ap)
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns the panoramas written, the basis build's and the
    loop's seconds and, on the card, each batch's project (+ sparsify) ms
    (CUDA events)."""
    ap = _parser()
    dev = checked_device(ap, argv)
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(NeedletsConfig(), jmax=args.jmax)
    t0 = time.perf_counter()
    pipe = NeedletPipeline(cfg, device=dev)
    basis_s = time.perf_counter() - t0
    print(f"SN basis: {pipe.n_coeffs} coefficients (jmax={args.jmax})")

    names = sorted(n for n in os.listdir(args.hdr_dir) if n.endswith(".exr"))
    if args.limit:
        names = names[: args.limit]
    os.makedirs(args.out_dir, exist_ok=True)
    sparsify = args.jmax == 2 and not args.no_sparsify
    cuda = dev.type == "cuda"
    device_ms = []

    t0 = time.perf_counter()
    for s in range(0, len(names), args.batch):
        chunk = names[s : s + args.batch]
        imgs = []
        for nm in chunk:
            img = read_hdr(os.path.join(args.hdr_dir, nm))
            if img.shape[:2] != (cfg.env_h, cfg.env_w):
                img = resize_panorama(img, (cfg.env_w, cfg.env_h))
            alpha = np.float64(1.0)
            if args.crop_dir:
                crop = read_hdr(os.path.join(args.crop_dir, nm))
                alpha = np.float64(tonemap_alpha(crop, TONEMAP_INPUT, gamma=False))
            imgs.append(img * alpha)
        im = np.stack(imgs)
        x = torch.as_tensor(im, dtype=torch.float32).to(dev)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        coeffs = pipe.project(x)
        if sparsify:
            coeffs = pipe.sparsify(coeffs)
        if cuda:
            ev[1].record()
        out = coeffs.cpu().numpy()
        if cuda:
            device_ms.append(ev[0].elapsed_time(ev[1]))
        for i, nm in enumerate(chunk):
            np.save(os.path.join(args.out_dir, nm.replace(".exr", ".npy")), out[i])
        if args.check:
            rec = pipe.reconstruct(coeffs).cpu().numpy()
            lum = lambda a: a[..., 0] * 0.3 + a[..., 1] * 0.59 + a[..., 2] * 0.11  # noqa: E731
            print(f"energy in {lum(im).sum():.4g} rec {lum(rec).sum():.4g}")
        print(f"{min(s + args.batch, len(names))}/{len(names)}")
    dt = time.perf_counter() - t0
    print(f"{len(names)} panoramas in {dt:.2f}s ({len(names) / max(dt, 1e-9):.1f}/sec)")
    return {"panoramas": len(names), "basis_s": basis_s, "seconds": dt, "device_ms": device_ms}


if __name__ == "__main__":
    main()
