"""Regression inference on the card: crop .exr -> anchor-parameter pickles.

Port of emlight_tpu/cli/test_regression.py: the same flags and outputs.
Loads a checkpoint (the JAX package's .msgpack RegressionState or a
reference torch .pth), predicts anchor parameters for every crop in
--data_root/crop (or the --crops dir) and dumps {distribution, intensity,
rgb_ratio, ambient} pickles to --out_dir, the format GenProjector's dataset
consumes for end-to-end inference; --render adds an {name}_env.png preview.
--eval_apply fast (the default, as in the JAX CLI) predicts through the
concat-free buffer forward as a closure over the checkpoint; --load_config
also supplies the training run's compute dtype. --parallel splits each
batch over one rank per card (cli/_common.py::launch), a ragged batch
padded by repeating its last crop; each rank reads its crops and writes
their files (dist/parallel.py::serving_rows).

Usage:
  python -m emlight_tpu_torch.cli.test_regression \
      --ckpt runs/regression/checkpoints/latest.msgpack \
      --data_root /data/LavalIndoor --out_dir results/ [--render] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..core.hdr import TONEMAP_TEST, read_hdr
from ..core.png import write_png
from ..dist.parallel import serving_rows
from ..representation.splat import render_anchor_params
from ..train.config_io import apply_saved_defaults
from ._common import (PARALLEL_HELP, add_device_flag, checked_device, crop_names, launch,
                      load_regressor, regression_config, regressor_apply, saved_dtype,
                      tonemapped_crop)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help=".msgpack state or torch .pth")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--crops", default=None, help="directory of crop .exr files")
    ap.add_argument("--out_dir", default="results")
    ap.add_argument("--anchors", type=int, default=96)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--render", action="store_true", help="also dump env-map previews")
    ap.add_argument("--parallel", action="store_true",
                    help="each batch's crops split over the ranks (a ragged one padded); "
                         + PARALLEL_HELP)
    ap.add_argument("--eval_apply", choices=("fast", "standard"), default="fast",
                    help="eval forward: 'fast' (default) is the concat-free channels-last "
                         "buffer forward (nn/densenet_fast.buffer_apply) as a closure over "
                         "the checkpoint (train/regression.make_baked_infer); 'standard' is "
                         "the reference-shaped DenseNet module. Same checkpoint, same math "
                         "up to float reassociation")
    ap.add_argument("--block_config", default="16,16,16")
    ap.add_argument("--crop", default="192,256")
    ap.add_argument("--clip_grad_norm", type=float, default=0.0,
                    help="accepted, changes nothing: the optimizer state, whose "
                         "structure clipping changes, is not read")
    ap.add_argument("--load_config", default=None,
                    help="a train run's opt.json (or run dir): model-shape "
                         "flags become defaults so the checkpoint fits")
    add_device_flag(ap)
    return ap


def main(argv=None) -> None:
    ap = _parser()
    dev = checked_device(ap, argv)
    saved = apply_saved_defaults(ap, argv, exclude=("out_dir",))
    args = ap.parse_args(argv)
    launch(main, argv, args.parallel, dev, lambda d, group: _serve(args, saved, d, group))


def _serve(args, saved: dict | None, dev, group) -> None:
    """The run on `dev`, as one rank of `group` under --parallel."""
    cfg = regression_config(args.anchors, args.crop, args.block_config, args.clip_grad_norm,
                            dtype=saved_dtype(saved))
    regressor = load_regressor(args.ckpt, cfg, dev)
    apply = regressor_apply(args.eval_apply, cfg, regressor)

    crop_dir, names = crop_names(args.crops, args.data_root, args.limit)
    os.makedirs(args.out_dir, exist_ok=True)
    for s in range(0, len(names), args.batch):
        rows, n_real = serving_rows(len(names[s : s + args.batch]), group)
        chunk = [names[s + i] for i in rows]
        crops = [tonemapped_crop(read_hdr(os.path.join(crop_dir, nm)), cfg.crop_h, cfg.crop_w)[1]
                 for nm in chunk]
        pred = apply(torch.as_tensor(np.stack(crops), device=dev))
        pred = {k: v.cpu().numpy() for k, v in pred.items()}
        for i, nm in enumerate(chunk[:n_real]):
            para = {
                "distribution": pred["distribution"][i],
                "intensity": pred["intensity"][i, 0],
                "rgb_ratio": pred["rgb_ratio"][i],
                "ambient": pred["ambient"][i],
            }
            with open(os.path.join(args.out_dir, nm.replace(".exr", ".pickle")), "wb") as f:
                pickle.dump(para, f, protocol=pickle.HIGHEST_PROTOCOL)
            if args.render:
                # the reference's quirk, kept: the predicted distribution is
                # softmaxed once more before rendering (ROADMAP.md §3)
                as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
                env = render_anchor_params(
                    torch.softmax(as_t(pred["distribution"][i]), -1)[None],
                    as_t([pred["intensity"][i, 0]]),
                    as_t(pred["rgb_ratio"][i][None]),
                    n=args.anchors, intensity_scale=cfg.anchors.intensity_scale,
                )
                tone, _ = TONEMAP_TEST(np.maximum(env.cpu().numpy()[0], 0.0))
                write_png(os.path.join(args.out_dir, nm.replace(".exr", "_env.png")),
                          (tone * 255).astype(np.uint8))
        if group is None or group.rank == 0:
            print(f"{min(s + args.batch, len(names))}/{len(names)}")


if __name__ == "__main__":
    main()
