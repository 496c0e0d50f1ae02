"""End-to-end lighting estimation on the card: crop .exr -> full HDR environment map.

Port of emlight_tpu/cli/infer.py: the same flags, defaults and outputs. Per
batch of crops, DenseNet anchor regression, the Gaussian-splat guide and the
SPADE generator run as one call (train/pipeline.py::pipeline_inference; see
the JAX module for the alpha-cancellation derivation). Per crop it writes
{stem}.exr (the HDR map, float32), a {stem}.png preview (the JAX CLI writes
{stem}.jpg; the pixels are the same uint8 array of TONEMAP_VIZ) and, with
--save_pickles, {stem}.pickle (the predicted anchor parameters as NumPy
values, which GenProjector-format readers load without torch).

Usage:
  python -m emlight_tpu_torch.cli.infer \
      --reg_ckpt runs/regression/checkpoints/latest.msgpack \
      --proj_ckpt runs/projector/checkpoints/latest.msgpack \
      --reg_config runs/regression --proj_config runs/projector \
      --data_root /data/LavalIndoor --out_dir results_e2e [--device cpu]

Model-shape flags default from the two training runs' opt.json snapshots
(--reg_config / --proj_config) so the checkpoints always fit their models.
The checkpoints are the JAX package's .msgpack train states (or, for the
regressor, a reference .pth); their optimizer state is not read, so
--reg_clip_grad_norm and --proj_clip_grad_norm change nothing and are
accepted for command-line compatibility.

--parallel serves over one rank per card (cli/_common.py::launch): each
batch of --batch crops is padded to a multiple of the rank count by
repeating its last crop, each rank reads and runs its rows of it
(dist/parallel.py::serving_rows) and writes the files of its real crops.
No collective runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from ..config import AnchorConfig, ProjectorConfig
from ..core.exr import write_exr
from ..core.hdr import TONEMAP_VIZ, read_hdr, resize_panorama
from ..core.png import write_png
from ..dist.parallel import serving_rows
from ..train import projector as P
from ..train.checkpoint import restore_generator
from ..train.pipeline import pipeline_inference
from ._common import (PARALLEL_HELP, add_device_flag, checked_device, crop_names, launch,
                      load_regressor, regression_config, tonemapped_crop)


def _apply_snapshot_defaults(ap: argparse.ArgumentParser, argv):
    """Install each train run's saved config as defaults for its stage's flags."""
    from ..train.config_io import load_run_config

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--reg_config", default=None)
    pre.add_argument("--proj_config", default=None)
    known, _ = pre.parse_known_args(argv)
    if known.reg_config:
        saved = load_run_config(known.reg_config)
        ap.set_defaults(**{
            k: saved[k]
            for k in ("anchors", "block_config", "crop")
            if k in saved
        })
        if "clip_grad_norm" in saved:
            ap.set_defaults(reg_clip_grad_norm=saved["clip_grad_norm"])
        print(f"regression config loaded from {known.reg_config}")
    if known.proj_config:
        saved = load_run_config(known.proj_config)
        ap.set_defaults(**{
            k: saved[k] for k in ("crop_size", "ngf", "ndf", "dtype") if k in saved
        })
        if "clip_grad_norm" in saved:
            ap.set_defaults(proj_clip_grad_norm=saved["clip_grad_norm"])
        print(f"projector config loaded from {known.proj_config}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reg_ckpt", required=True, help=".msgpack state or torch .pth")
    ap.add_argument("--proj_ckpt", required=True, help=".msgpack projector state")
    ap.add_argument("--reg_config", default=None,
                    help="regression run's opt.json (or run dir): shape flags")
    ap.add_argument("--proj_config", default=None,
                    help="projector run's opt.json (or run dir): shape flags")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--crops", default=None, help="directory of crop .exr files")
    ap.add_argument("--out_dir", default="results_e2e")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--save_pickles", action="store_true",
                    help="also dump the intermediate predicted anchor pickles")
    ap.add_argument("--parallel", action="store_true",
                    help="each batch's crops split over the ranks (a ragged one padded); "
                         + PARALLEL_HELP)
    add_device_flag(ap)
    # regression stage shape (defaults overridden by --reg_config)
    ap.add_argument("--anchors", type=int, default=96)
    ap.add_argument("--block_config", default="16,16,16")
    ap.add_argument("--crop", default="192,256", help="regressor input H,W")
    ap.add_argument("--reg_clip_grad_norm", type=float, default=0.0,
                    help="accepted, changes nothing (the optimizer state is not read)")
    # projector stage shape (defaults overridden by --proj_config)
    ap.add_argument("--crop_size", type=int, default=256, help="2x env height")
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--ndf", type=int, default=64)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--proj_clip_grad_norm", type=float, default=0.0,
                    help="accepted, changes nothing (the optimizer state is not read)")
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns where the time went: crops, batches, host
    seconds of read, tonemap + resize (prep), pipeline and write, the wall
    seconds, and on the card each batch's device ms (CUDA events around
    pipeline_inference): rank 0's crops under --parallel."""
    ap = _parser()
    dev = checked_device(ap, argv)
    _apply_snapshot_defaults(ap, argv)
    args = ap.parse_args(argv)
    return launch(main, argv, args.parallel, dev, lambda d, group: _serve(args, d, group))


def _serve(args, dev, group) -> dict:
    """The run on `dev`, as one rank of `group` under --parallel."""
    t_start = time.perf_counter()

    reg_cfg = regression_config(args.anchors, args.crop, args.block_config,
                                args.reg_clip_grad_norm)
    env_h, env_w = args.crop_size // 2, args.crop_size
    proj_cfg = dataclasses.replace(
        ProjectorConfig(),
        crop_size=args.crop_size, ngf=args.ngf, ndf=args.ndf, dtype=args.dtype,
        clip_grad_norm=args.proj_clip_grad_norm,
        anchors=AnchorConfig(n_anchors=args.anchors, env_h=env_h, env_w=env_w),
    )
    regressor = load_regressor(args.reg_ckpt, reg_cfg, dev)
    generator = restore_generator(args.proj_ckpt, P.make_models(proj_cfg, device=dev))

    crop_dir, names = crop_names(args.crops, args.data_root, args.limit)
    os.makedirs(args.out_dir, exist_ok=True)
    proj_in = args.crop_size // 2
    n_mine = sum(serving_rows(len(names[s : s + args.batch]), group)[1]
                 for s in range(0, len(names), args.batch))
    stats = {"crops": n_mine, "batches": 0, "read_s": 0.0, "prep_s": 0.0,
             "pipeline_s": 0.0, "write_s": 0.0, "device_ms": []}
    t_loop = time.perf_counter()
    for s in range(0, len(names), args.batch):
        rows, n_real = serving_rows(len(names[s : s + args.batch]), group)
        chunk = [names[s + i] for i in rows]
        regs, projs = [], []
        for nm in chunk:
            t0 = time.perf_counter()
            img = read_hdr(os.path.join(crop_dir, nm))
            t1 = time.perf_counter()
            img, reg_in = tonemapped_crop(img, reg_cfg.crop_h, reg_cfg.crop_w)
            regs.append(reg_in)
            projs.append(resize_panorama(img, (proj_in, proj_in)))
            stats["read_s"] += t1 - t0
            stats["prep_s"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        env, pred = pipeline_inference(regressor, generator, np.stack(regs), np.stack(projs),
                                       reg_cfg, proj_cfg, device=dev)
        if dev.type == "cuda":
            end.record()
        env = env.cpu().numpy()
        pred = {k: v.cpu().numpy() for k, v in pred.items()}
        if dev.type == "cuda":
            stats["device_ms"].append(start.elapsed_time(end))
        t1 = time.perf_counter()
        stats["pipeline_s"] += t1 - t0
        for i, nm in enumerate(chunk[:n_real]):
            stem = nm[: -len(".exr")]
            write_exr(os.path.join(args.out_dir, f"{stem}.exr"), env[i])
            tone, _ = TONEMAP_VIZ(env[i])
            write_png(os.path.join(args.out_dir, f"{stem}.png"), (tone * 255).astype(np.uint8))
            if args.save_pickles:
                para = {
                    "distribution": pred["distribution"][i],
                    "intensity": pred["intensity"][i, 0],
                    "rgb_ratio": pred["rgb_ratio"][i],
                    "ambient": pred["ambient"][i],
                }
                with open(os.path.join(args.out_dir, f"{stem}.pickle"), "wb") as f:
                    pickle.dump(para, f, protocol=pickle.HIGHEST_PROTOCOL)
        stats["write_s"] += time.perf_counter() - t1
        stats["batches"] += 1
        if group is None or group.rank == 0:
            print(f"{min(s + args.batch, len(names))}/{len(names)}")
    stats["loop_s"] = time.perf_counter() - t_loop
    stats["wall_s"] = time.perf_counter() - t_start
    n = max(stats["crops"], 1)
    print(f"{stats['crops']} crops in {stats['loop_s']:.3f} s after {stats['wall_s'] - stats['loop_s']:.3f} s "
          f"of set-up: read {1e3 * stats['read_s'] / n:.3f}, tonemap + resize "
          f"{1e3 * stats['prep_s'] / n:.3f}, write {1e3 * stats['write_s'] / n:.3f} ms per "
          f"crop (host); pipeline {1e3 * stats['pipeline_s'] / max(stats['batches'], 1):.3f} ms "
          f"per batch (host, {dev.type})")
    return stats


if __name__ == "__main__":
    main()
