"""What the port's CLIs share: the refusal of the flags whose features are
not ported (each message names its ROADMAP.md §1 item by title), the device
check, the regressor's and projector's configs, the regressor's restore
(.msgpack or reference .pth, in the dtype of the run it came from), the
crop list and the crop preprocessing, dataset items as a batch on the
device, the eval CLIs' report and a training loop's data wait."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..config import AnchorConfig, ProjectorConfig, RegressionConfig
from ..core.device import resolve_device
from ..core.hdr import TONEMAP_INPUT, resize_panorama
from ..train import regression as R
from ..train.checkpoint import load_checked, restore_regressor
from ..train.jax_weights import densenet_state_from_jax
from ..train.torch_import import import_densenet_state_dict

__all__ = ["PARALLEL_NOT_PORTED", "GAN_STEP_NOT_PORTED", "VGG_NOT_PORTED", "add_device_flag",
           "checked_device", "refuse", "regression_config", "saved_dtype", "projector_config",
           "pooled_hw", "load_regressor", "regressor_apply", "crop_names", "tonemapped_crop",
           "stacked", "summary_line", "next_timed"]

PARALLEL_NOT_PORTED = ("--parallel (the batch sharded over several cards) is not ported yet "
                       "(ROADMAP.md §1, \"Multi-GPU\"); run without it on one card")
GAN_STEP_NOT_PORTED = ("--fused and --scan_steps (the fused G+D step) are not ported yet "
                       "(ROADMAP.md §1, \"The rest of GAN training\"); run the alternating "
                       "G/D steps without them")
VGG_NOT_PORTED = ("the VGG19 perceptual term (--vgg_npz with a file, $EMLIGHT_VGG19_NPZ, "
                  "--vgg_random) is not ported yet (ROADMAP.md §1, \"The rest of GAN "
                  "training\"); run without it, as the JAX CLI does when no VGG19 weights "
                  "are present")


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the kernels' "
                         "plain PyTorch versions)")


def checked_device(ap: argparse.ArgumentParser, argv):
    """First parse of the command line, before any file is read or written:
    --parallel (where the CLI has it) exits with its message, and a CUDA
    device that is not there raises."""
    args = ap.parse_args(argv)
    if getattr(args, "parallel", False):
        ap.error(PARALLEL_NOT_PORTED)
    return resolve_device(args.device)


def refuse(ap: argparse.ArgumentParser, *checks: tuple[bool, str]) -> None:
    """Exit (argparse's usage error, code 2) with the message of the first
    check that is set: a flag whose feature is not ported is never
    ignored."""
    for bad, message in checks:
        if bad:
            ap.error(message)


def regression_config(anchors: int, crop, block_config, clip_grad_norm: float,
                      **fields) -> RegressionConfig:
    crop_h, crop_w = (int(x) for x in str(crop).split(","))
    return dataclasses.replace(
        RegressionConfig(),
        anchors=AnchorConfig(regression_anchors=anchors),
        crop_h=crop_h,
        crop_w=crop_w,
        block_config=tuple(int(x) for x in str(block_config).split(",")),
        clip_grad_norm=clip_grad_norm,
        **fields,
    )


def saved_dtype(saved: dict | None) -> str:
    """The regressor's compute dtype of the training run whose opt.json
    --load_config named (float32 without one)."""
    return (saved or {}).get("dtype", "float32")


def projector_config(args: argparse.Namespace, **fields) -> ProjectorConfig:
    """The ProjectorConfig of a projector CLI's shape flags (crop_size, ngf,
    ndf, anchors, dtype, clip_grad_norm); env maps are crop_size/2 x
    crop_size."""
    return dataclasses.replace(
        ProjectorConfig(),
        crop_size=args.crop_size, ngf=args.ngf, ndf=args.ndf, dtype=args.dtype,
        clip_grad_norm=args.clip_grad_norm,
        anchors=AnchorConfig(n_anchors=args.anchors, env_h=args.crop_size // 2,
                             env_w=args.crop_size),
        **fields,
    )


def pooled_hw(cfg: RegressionConfig) -> tuple[int, int]:
    """The map the regressor's fc reads: every block's transition halves the
    crop, then the 4x4 average pool."""
    n = 2 ** len(cfg.block_config) * 4
    return cfg.crop_h // n, cfg.crop_w // n


def load_regressor(path: str, cfg: RegressionConfig, device):
    """The regressor from a JAX .msgpack checkpoint or a reference .pth
    (imported at this config's depth and crop), computing in cfg.dtype."""
    model = R.make_model(cfg, device=device)
    if path.endswith(".pth"):
        params, stats = import_densenet_state_dict(path, block_config=cfg.block_config,
                                                   pooled_hw=pooled_hw(cfg))
        return load_checked(model, densenet_state_from_jax(params, stats), path)
    return restore_regressor(path, model)


def regressor_apply(eval_apply: str, cfg: RegressionConfig, regressor):
    """The eval CLIs' forward, ``--eval_apply``: "fast" (the default) the
    concat-free buffer forward, as a closure over this checkpoint
    (regression.make_baked_infer); "standard" the DenseNet module's own.
    Returns apply(crop) -> heads."""
    if eval_apply == "fast":
        return R.make_baked_infer(cfg, regressor)
    return lambda crop: R.predict(regressor, crop)


def crop_names(crops: str | None, data_root: str | None, limit: int) -> tuple[str, list[str]]:
    crop_dir = crops or os.path.join(data_root, "crop")
    names = sorted(n for n in os.listdir(crop_dir) if n.endswith(".exr"))
    return crop_dir, names[:limit] if limit else names


def tonemapped_crop(img: np.ndarray, crop_h: int, crop_w: int) -> tuple[np.ndarray, np.ndarray]:
    """TONEMAP_INPUT of a crop (its alpha cancels end to end), and that
    image at the regressor's crop size (resized where it differs)."""
    img, _ = TONEMAP_INPUT(img)
    reg_in = img
    if reg_in.shape[:2] != (crop_h, crop_w):
        reg_in = resize_panorama(img, (crop_w, crop_h))
    return img, reg_in


def stacked(samples: list[dict], device) -> dict:
    """A list of dataset items as one batch of tensors on `device` (the
    names left out)."""
    return {k: torch.as_tensor(np.stack([smp[k] for smp in samples]), device=device)
            for k in samples[0] if k != "name"}


def summary_line(acc: dict[str, list], count: int, out: str | None, width: int) -> dict:
    """The eval CLIs' report: a table of each metric's mean, median and p90
    over the samples, then ONE JSON line of the same (keys sorted, as the
    JAX CLIs' jitted metric dicts come back), also written to `out` if
    given. Returns the JSON line's dict."""
    summary: dict = {"n_samples": count}
    print(f"\n{'metric':<{width}} {'mean':>10} {'median':>10} {'p90':>10}")
    for k in sorted(acc):
        v = np.concatenate(acc[k])
        summary[k] = {"mean": float(v.mean()), "median": float(np.median(v)),
                      "p90": float(np.percentile(v, 90))}
        print(f"{k:<{width}} {v.mean():>10.4f} {np.median(v):>10.4f} "
              f"{np.percentile(v, 90):>10.4f}")
    line = json.dumps(summary)
    print(line)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return summary


def next_timed(it, waits: list[float]):
    """next(it, None), its wait on the host clock appended to `waits` (a
    training loop's wait on its data queue)."""
    t0 = time.perf_counter()
    item = next(it, None)
    waits.append(time.perf_counter() - t0)
    return item
