"""GenProjector inference on the card (replaces GenProjector/test.py + test.sh).

Port of emlight_tpu/cli/test_projector.py: the same flags and outputs.
Generates full HDR environment maps from anchor-GT pickles (or the pickles
predicted by cli.test_regression, for end-to-end inference) plus crops,
through train/data.py::ProjectorDataset and train/projector.py::inference,
writing per sample {name}.exr (the HDR map, float32) and a tonemapped
{name}.png (the JAX CLI writes {name}.jpg; the pixels are the same uint8
array of TONEMAP_VIZ).

The checkpoint is a .msgpack ProjectorState (the JAX package's or the
port's); only the generator is read, so --ndf and --clip_grad_norm, which
must match training for the JAX CLI's restore, change nothing here and are
accepted for command-line compatibility. --parallel splits each batch
over one rank per card (cli/_common.py::launch), a ragged batch padded by
repeating its last sample; each rank reads its samples and writes their
files (dist/parallel.py::serving_rows).

Usage:
  python -m emlight_tpu_torch.cli.test_projector \
      --ckpt runs/projector/checkpoints/latest.msgpack \
      --data_root /data/LavalIndoor --out_dir results_projector [--limit 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.exr import write_exr
from ..core.hdr import TONEMAP_VIZ
from ..core.png import write_png
from ..dist.parallel import serving_rows
from ..train import projector as P
from ..train.checkpoint import restore_generator
from ..train.config_io import apply_saved_defaults
from ..train.data import ProjectorDataset
from ._common import (PARALLEL_HELP, add_device_flag, checked_device, launch,
                      projector_config, stacked)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out_dir", default="results_projector")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--ndf", type=int, default=64,
                    help="accepted, changes nothing (only the generator is read)")
    ap.add_argument("--anchors", type=int, default=128)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="bfloat16: conv compute in bf16 (f32 accumulation)")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--parallel", action="store_true",
                    help="each batch split over the ranks (a ragged one padded); "
                         + PARALLEL_HELP)
    ap.add_argument("--clip_grad_norm", type=float, default=0.0,
                    help="accepted, changes nothing: the optimizer state, whose "
                         "structure clipping changes, is not read")
    ap.add_argument("--load_config", default=None,
                    help="the train run's opt.json (or run dir): model-shape "
                         "flags become defaults so the checkpoint fits")
    add_device_flag(ap)
    return ap


def main(argv=None) -> None:
    ap = _parser()
    dev = checked_device(ap, argv)
    apply_saved_defaults(ap, argv, exclude=("out_dir",))
    args = ap.parse_args(argv)
    launch(main, argv, args.parallel, dev, lambda d, group: _serve(args, d, group))


def _serve(args, dev, group) -> None:
    """The run on `dev`, as one rank of `group` under --parallel."""
    cfg = projector_config(args)
    generator = restore_generator(args.ckpt, P.make_models(cfg, device=dev))

    ds = ProjectorDataset(args.data_root, crop_size=args.crop_size // 2)
    n = min(len(ds), args.limit) if args.limit else len(ds)
    os.makedirs(args.out_dir, exist_ok=True)
    for s in range(0, n, args.batch):
        rows, n_real = serving_rows(min(s + args.batch, n) - s, group)
        samples = [ds[s + i] for i in rows]
        fake = P.inference(generator, stacked(samples, dev), cfg).float().cpu().numpy()
        for i, smp in enumerate(samples[:n_real]):
            nm = smp["name"]
            write_exr(os.path.join(args.out_dir, f"{nm}.exr"), fake[i])
            tone, _ = TONEMAP_VIZ(fake[i])
            write_png(os.path.join(args.out_dir, f"{nm}.png"), (tone * 255).astype(np.uint8))
        if group is None or group.rank == 0:
            print(f"{min(s + args.batch, n)}/{n}")


if __name__ == "__main__":
    main()
