"""Quantitative quality evaluation of a GenProjector checkpoint, on the card.

Port of emlight_tpu/cli/eval_projector.py: the same flags, the same table
and the same JSON line (keys and statistics). Given a projector checkpoint
and a data dir (pkl/ + warped/ + crop/, the training layout), it
synthesizes the environment map of every sample and reports, against the
GT warped panorama:

  - env RMSE and si-RMSE (scale-invariant: the generated env rescaled by
    the per-sample least-squares scalar first), in the alpha-scaled HDR
    domain the GAN trains in (train/data.py::ProjectorDataset);
  - the luminance-weighted mean-direction angular error (degrees) between
    the generated and GT envs (solid-angle weighted);
  - the dominant-light angular error: the brightest GT anchor's direction
    against the generated env's peak-luminance direction.

One check the JAX CLI does not make: every GT pickle's distribution must
have --anchors entries. The JAX CLI gathers the anchor directions of
--anchors points with indices of the pickle's length, and so reports a
wrong direction when the two differ; the port exits instead. Valid inputs
give the same output.

Only the generator is read from the checkpoint (--ndf and --clip_grad_norm
are accepted and change nothing). Prints a table plus ONE JSON line; --out
writes the JSON to a file.

Usage:
  python -m emlight_tpu_torch.cli.eval_projector \
      --ckpt runs/proj/checkpoints/latest.msgpack \
      --data_root /data/LavalIndoor --load_config runs/proj [--limit 100] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.geometry import equirect_xyz_splat, sphere_points, steradian_map
from ..train import projector as P
from ..train.checkpoint import restore_generator
from ..train.config_io import apply_saved_defaults
from ..train.data import ProjectorDataset
from ._common import (add_device_flag, checked_device, projector_config, stacked,
                      summary_line)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help=".msgpack projector state")
    ap.add_argument("--data_root", required=True, help="dir with pkl/ + warped/ + crop/")
    ap.add_argument("--out", default=None, help="write the JSON line here too")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--ndf", type=int, default=64,
                    help="accepted, changes nothing (only the generator is read)")
    ap.add_argument("--anchors", type=int, default=128)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--clip_grad_norm", type=float, default=0.0,
                    help="accepted, changes nothing (the optimizer state is not read)")
    ap.add_argument("--load_config", default=None,
                    help="the train run's opt.json (or run dir): model-shape "
                         "flags become defaults so the checkpoint fits")
    add_device_flag(ap)
    return ap


def angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angle between unit vectors along the last axis, in degrees."""
    return torch.rad2deg(torch.arccos(torch.clip(torch.sum(a * b, dim=-1), -1.0, 1.0)))


def env_errors(fake: torch.Tensor, gt: torch.Tensor) -> dict:
    """Per-sample env RMSE and si-RMSE of (B, H, W, 3) maps."""
    env_rmse = torch.sqrt(torch.mean((fake - gt) ** 2, dim=(1, 2, 3)))
    num = torch.sum(fake * gt, dim=(1, 2, 3))
    den = torch.clamp(torch.sum(fake * fake, dim=(1, 2, 3)), min=1e-12)
    si = fake * (num / den)[:, None, None, None] - gt
    return {"env_rmse": env_rmse, "env_sirmse": torch.sqrt(torch.mean(si * si, dim=(1, 2, 3)))}


@torch.inference_mode()
def batch_metrics(generator, batch: dict, cfg, pix_dirs, pix_sr, anchor_dirs) -> dict:
    fake = P.inference(generator, batch, cfg).float()
    gt = batch["warped"].float()

    def lum(env):  # solid-angle-weighted luminance (B, H, W)
        return (0.3 * env[..., 0] + 0.59 * env[..., 1] + 0.11 * env[..., 2]) * pix_sr

    def mean_dir(env):
        v = torch.einsum("bhw,hwc->bc", torch.clamp(lum(env), min=0.0) + 1e-12, pix_dirs)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    # generated peak-luminance direction vs the GT dominant anchor
    peak_dir = pix_dirs.reshape(-1, 3)[torch.argmax(lum(fake).reshape(fake.shape[0], -1), 1)]
    gt_anchor = anchor_dirs[torch.argmax(batch["distribution"], dim=1)]
    return {
        **env_errors(fake, gt),
        "angular_err_mean_dir_deg": angle_deg(mean_dir(fake), mean_dir(gt)),
        "angular_err_peak_vs_gt_anchor_deg": angle_deg(peak_dir, gt_anchor),
    }


def main(argv=None) -> dict:
    """Run the CLI; returns the summary it prints as its JSON line."""
    ap = _parser()
    dev = checked_device(ap, argv)
    apply_saved_defaults(ap, argv, exclude=("out",))
    args = ap.parse_args(argv)

    cfg = projector_config(args)
    generator = restore_generator(args.ckpt, P.make_models(cfg, device=dev))
    env_h, env_w = args.crop_size // 2, args.crop_size
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    pix_dirs = f32(equirect_xyz_splat(env_h, env_w))          # (H, W, 3)
    pix_sr = f32(steradian_map(env_h, env_w, multiply=False))  # (H, W)
    anchor_dirs = f32(sphere_points(args.anchors))             # (N, 3)

    ds = ProjectorDataset(args.data_root, crop_size=args.crop_size // 2)
    count = len(ds) if not args.limit else min(args.limit, len(ds))
    if count == 0:
        raise SystemExit(f"no (pkl, warped, crop) triples under {args.data_root}")
    acc: dict[str, list] = {}
    for s in range(0, count, args.batch):
        samples = [ds[i] for i in range(s, min(s + args.batch, count))]
        for smp in samples:
            if smp["distribution"].shape != (args.anchors,):
                raise SystemExit(
                    f"{smp['name']}: the GT distribution has {smp['distribution'].shape[0]} "
                    f"anchors, --anchors is {args.anchors}; the dominant-light error needs "
                    f"the anchors the pickles were made with")
        out = batch_metrics(generator, stacked(samples, dev), cfg, pix_dirs, pix_sr,
                            anchor_dirs)
        for k, v in out.items():
            acc.setdefault(k, []).append(v.cpu().numpy())
        print(f"{min(s + args.batch, count)}/{count}", flush=True)
    return summary_line(acc, count, args.out, width=36)


if __name__ == "__main__":
    main()
