"""Quantitative quality evaluation of a regression checkpoint, on the card.

Port of emlight_tpu/cli/eval_metrics.py: the same flags, the same table and
the same JSON line (keys and statistics). Given a checkpoint (the JAX
package's .msgpack RegressionState, the port's, or a reference .pth) and a
data dir (crop/ + pkl/ GT, the training layout), it reports

  - parameter errors: distribution RMSE, intensity relative error,
    rgb_ratio RMSE, ambient RMSE (against the alpha-scaled training
    targets, RegressionNetwork/data.py:71-73);
  - env-map RMSE and si-RMSE (scale-invariant: pred rescaled by the optimal
    per-sample scalar first), on the HDR render of pred against GT
    parameters (intensity x500);
  - dominant-light angular error (degrees): argmax-anchor direction, and
    the energy-weighted mean-direction variant.

--eval_apply fast (the default, as in the JAX CLI) predicts through the
concat-free buffer forward, 'standard' through the DenseNet module;
--load_config also supplies the training run's compute dtype. Prints a
table plus ONE JSON line; --out writes the JSON to a file.

Usage:
  python -m emlight_tpu_torch.cli.eval_metrics \
      --ckpt runs/reg/checkpoints/latest.msgpack \
      --data_root /data/LavalIndoor [--load_config runs/reg] [--limit 100] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..core.geometry import sphere_points
from ..representation.splat import render_anchor_params
from ..train.config_io import apply_saved_defaults
from ..train.data import RegressionDataset
from ._common import (add_device_flag, checked_device, load_regressor, regression_config,
                      regressor_apply, saved_dtype, stacked, summary_line)
from .eval_projector import angle_deg, env_errors


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help=".msgpack state or torch .pth")
    ap.add_argument("--data_root", required=True, help="dir with crop/ + pkl/")
    ap.add_argument("--out", default=None, help="write the JSON line here too")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--env_hw", default="128,256", help="render resolution H,W")
    ap.add_argument("--anchors", type=int, default=96)
    ap.add_argument("--block_config", default="16,16,16")
    ap.add_argument("--crop", default="192,256")
    ap.add_argument("--clip_grad_norm", type=float, default=0.0,
                    help="accepted, changes nothing (the optimizer state is not read)")
    ap.add_argument("--eval_apply", choices=("fast", "standard"), default="fast",
                    help="eval forward: 'fast' (default) is the concat-free channels-last "
                         "buffer forward (nn/densenet_fast.buffer_apply) as a closure over "
                         "the checkpoint (train/regression.make_baked_infer); 'standard' is "
                         "the reference-shaped DenseNet module. Same checkpoint, same math "
                         "up to float reassociation")
    ap.add_argument("--load_config", default=None,
                    help="a train run's opt.json (or run dir): model-shape "
                         "flags become defaults so the checkpoint fits")
    add_device_flag(ap)
    return ap


@torch.inference_mode()
def batch_metrics(apply, crop: torch.Tensor, gt: dict, n: int, env_h: int, env_w: int,
                  dirs: torch.Tensor) -> dict:
    pred = apply(crop)
    p_dist, g_dist = pred["distribution"], gt["distribution"]
    p_int, g_int = pred["intensity"][:, 0], gt["intensity"]
    p_rgb, g_rgb = pred["rgb_ratio"], gt["rgb_ratio"]
    p_amb, g_amb = pred["ambient"], gt["ambient"]
    rmse = lambda a, b: torch.sqrt(torch.mean((a - b) ** 2, dim=1))  # noqa: E731

    def render(d, i, r, a):  # the train.py summary composition, intensity x500
        return render_anchor_params(d, i, r, a, n=n, h=env_h, w=env_w, intensity_scale=500.0)

    def wmean(d):  # energy-weighted mean direction, unit-normalized
        v = (torch.clamp(d, min=0.0) + 1e-12) @ dirs
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    top = lambda d: dirs[torch.argmax(d, dim=1)]  # noqa: E731
    return {
        "dist_rmse": rmse(p_dist, g_dist),
        "intensity_rel_err": torch.abs(p_int - g_int) / torch.clamp(torch.abs(g_int), min=1e-8),
        "rgb_rmse": rmse(p_rgb, g_rgb),
        "ambient_rmse": rmse(p_amb, g_amb),
        **env_errors(render(p_dist, p_int, p_rgb, p_amb), render(g_dist, g_int, g_rgb, g_amb)),
        "angular_err_deg": angle_deg(top(p_dist), top(g_dist)),
        "angular_err_mean_dir_deg": angle_deg(wmean(p_dist), wmean(g_dist)),
    }


def main(argv=None) -> dict:
    """Run the CLI; returns the summary it prints as its JSON line."""
    ap = _parser()
    dev = checked_device(ap, argv)
    saved = apply_saved_defaults(ap, argv, exclude=("out",))
    args = ap.parse_args(argv)

    cfg = regression_config(args.anchors, args.crop, args.block_config, args.clip_grad_norm,
                            dtype=saved_dtype(saved))
    apply = regressor_apply(args.eval_apply, cfg, load_regressor(args.ckpt, cfg, dev))
    env_h, env_w = (int(x) for x in str(args.env_hw).split(","))
    dirs = torch.as_tensor(sphere_points(args.anchors), dtype=torch.float32, device=dev)

    ds = RegressionDataset(args.data_root, crop_hw=(cfg.crop_h, cfg.crop_w))
    count = len(ds) if not args.limit else min(args.limit, len(ds))
    if count == 0:
        raise SystemExit(f"no (crop, pkl) pairs under {args.data_root}")
    acc: dict[str, list] = {}
    for s in range(0, count, args.batch):
        batch = stacked([ds[i] for i in range(s, min(s + args.batch, count))], dev)
        gt = {k: batch[k] for k in ("distribution", "intensity", "rgb_ratio", "ambient")}
        out = batch_metrics(apply, batch["crop"], gt, args.anchors, env_h, env_w, dirs)
        for k, v in out.items():
            acc.setdefault(k, []).append(v.cpu().numpy())
        print(f"{min(s + args.batch, count)}/{count}", flush=True)
    return summary_line(acc, count, args.out, width=28)


if __name__ == "__main__":
    main()
