"""Bulk tonemapped previews (replaces RegressionNetwork/representation/
exr_reader.py): panorama .exr -> .png with the viz tonemap.

Port of emlight_tpu/cli/preview.py: the same flags, plus --device as every
CLI of the port takes it (checked; the tonemap is host work); the previews
are .png (the port's stdlib writer) where the JAX CLI writes .jpg.

Usage:
  python -m emlight_tpu_torch.cli.preview --hdr_dir .../warpedHDROutputs --out_dir previews/ \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.hdr import TONEMAP_VIZ, read_hdr
from ..core.png import write_png
from ._common import add_device_flag, checked_device


def main(argv=None) -> int:
    """Run the CLI; returns the number of previews written."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hdr_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--limit", type=int, default=0)
    add_device_flag(ap)
    checked_device(ap, argv)
    args = ap.parse_args(argv)

    names = sorted(n for n in os.listdir(args.hdr_dir) if n.endswith(".exr"))
    if args.limit:
        names = names[: args.limit]
    os.makedirs(args.out_dir, exist_ok=True)
    for nm in names:
        tone, _ = TONEMAP_VIZ(read_hdr(os.path.join(args.hdr_dir, nm)))
        write_png(os.path.join(args.out_dir, nm.replace(".exr", ".png")),
                  (tone * 255).astype(np.uint8))
    print(f"wrote {len(names)} previews")
    return len(names)


if __name__ == "__main__":
    main()
