"""Anchor-GT pickle migration tool (replaces RegressionNetwork/representation/
intensity_modify.py:145-176, minus the hardcoded /home paths).

Port of emlight_tpu/cli/modify_pickles.py: the same flags and pickles, plus
--device for --legacy_42's extraction (representation/extract.py::
extract_light_info_legacy; CUDA unless cpu is asked).

Rewrites a directory of GT pickles with optional transforms: rescale the
intensity/ambient terms (the reference's loop rewrote `intensity` in place),
or re-extract parameters from the source panoramas with the legacy 42-vertex
icosahedron anchor set (`--legacy_42`, intensity_modify.py:70-143).

Usage:
  python -m emlight_tpu_torch.cli.modify_pickles --pkl_dir pkl/ --out_dir pkl_mod/ \
      [--scale_intensity 2.0] [--scale_ambient 0.5]
  python -m emlight_tpu_torch.cli.modify_pickles --hdr_dir warped/ --out_dir pkl42/ --legacy_42
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..core.hdr import read_hdr, resize_panorama
from ..representation.extract import extract_light_info_legacy
from ._common import add_device_flag, checked_device


def main(argv=None) -> int:
    """Run the CLI; returns the number of pickles written."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pkl_dir", default=None, help="existing pickles to transform")
    ap.add_argument("--hdr_dir", default=None, help="panoramas (required for --legacy_42)")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scale_intensity", type=float, default=1.0)
    ap.add_argument("--scale_ambient", type=float, default=1.0)
    ap.add_argument("--legacy_42", action="store_true",
                    help="re-extract with the 42-vertex icosahedron anchors")
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--limit", type=int, default=0)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.legacy_42:
        if not args.hdr_dir:
            ap.error("--legacy_42 re-extracts from panoramas: pass --hdr_dir")
        dev = checked_device(ap, argv)
    elif not args.pkl_dir:
        ap.error("pass --pkl_dir (or --legacy_42 with --hdr_dir)")

    os.makedirs(args.out_dir, exist_ok=True)
    n = 0

    if args.legacy_42:
        h, w = args.height, args.height * 2
        names = sorted(nm for nm in os.listdir(args.hdr_dir) if nm.endswith(".exr"))
        if args.limit:
            names = names[: args.limit]
        for nm in names:
            img = read_hdr(os.path.join(args.hdr_dir, nm))
            if img.shape[:2] != (h, w):
                img = resize_panorama(img, (w, h))
            out = extract_light_info_legacy(np.asarray(img, np.float32), device=dev)
            para = {k: v.cpu().numpy() for k, v in out.items()}
            para["intensity"] = para["intensity"] * args.scale_intensity
            with open(os.path.join(args.out_dir, nm.replace(".exr", ".pickle")), "wb") as f:
                pickle.dump(para, f, protocol=pickle.HIGHEST_PROTOCOL)
            n += 1
    else:
        names = sorted(nm for nm in os.listdir(args.pkl_dir) if nm.endswith(".pickle"))
        if args.limit:
            names = names[: args.limit]
        for nm in names:
            with open(os.path.join(args.pkl_dir, nm), "rb") as f:
                para = pickle.load(f)
            para["intensity"] = np.asarray(para["intensity"]) * args.scale_intensity
            if "ambient" in para:
                para["ambient"] = np.asarray(para["ambient"]) * args.scale_ambient
            with open(os.path.join(args.out_dir, nm), "wb") as f:
                pickle.dump(para, f, protocol=pickle.HIGHEST_PROTOCOL)
            n += 1
    print(f"wrote {n} pickles to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
