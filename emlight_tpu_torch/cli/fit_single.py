"""Single-panorama spherical-Gaussian fit (replaces the RegressionNetwork/
panorama.py overfit demo): fit K lights + ambient to one .exr panorama and
save the reconstruction next to it.

Port of emlight_tpu/cli/fit_single.py: the same flags, plus --device; the
strip of the panorama beside its fit is a .png where the JAX CLI writes a
.jpg.

Usage:
  python -m emlight_tpu_torch.cli.fit_single --pano scene.exr [--lights 3] [--steps 500] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.hdr import TONEMAP_VIZ, read_hdr, resize_panorama, write_hdr
from ..core.png import write_png
from ..representation.fit import fit_spherical_gaussians
from ._common import add_device_flag, checked_device


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pano", required=True)
    ap.add_argument("--lights", type=int, default=3)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--out", default=None, help="output prefix (default: <pano>_fit)")
    add_device_flag(ap)
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns the fitted parameters and the per-step losses
    as NumPy arrays."""
    ap = _parser()
    dev = checked_device(ap, argv)
    args = ap.parse_args(argv)

    img = read_hdr(args.pano)
    h, w = args.height, args.height * 2
    if img.shape[:2] != (h, w):
        img = resize_panorama(img, (w, h))

    fitted, env, metrics = fit_spherical_gaussians(
        img, n_lights=args.lights, steps=args.steps, lr=args.lr, device=dev)
    losses = metrics["loss"].cpu().numpy()
    print(f"loss {losses[0]:.5g} -> {losses[-1]:.5g} over {args.steps} steps")
    fitted = {k: v.cpu().numpy() for k, v in fitted.items()}
    for k in ("dirs", "sizes", "colors", "ambient"):
        print(k, fitted[k].round(4).tolist())

    prefix = args.out or os.path.splitext(args.pano)[0] + "_fit"
    env = env.cpu().numpy()
    write_hdr(prefix + ".exr", env)
    tone, _ = TONEMAP_VIZ(np.maximum(env, 0))
    ref_tone, _ = TONEMAP_VIZ(np.maximum(img, 0))
    write_png(prefix + ".png", (np.hstack([ref_tone, tone]) * 255).astype(np.uint8))
    print(f"wrote {prefix}.exr / .png")
    return {**fitted, "loss": losses}


if __name__ == "__main__":
    main()
