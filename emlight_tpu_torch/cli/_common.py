"""What the port's inference CLIs share: the refusal of --parallel, the
device check, the regressor's config and restore (.msgpack or reference
.pth), the crop list and the crop preprocessing."""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from ..config import AnchorConfig, RegressionConfig
from ..core.device import resolve_device
from ..core.hdr import TONEMAP_INPUT, resize_panorama
from ..train import regression as R
from ..train.checkpoint import load_checked, restore_regressor
from ..train.jax_weights import densenet_state_from_jax
from ..train.torch_import import import_densenet_state_dict

__all__ = ["PARALLEL_NOT_PORTED", "add_device_flag", "checked_device", "regression_config",
           "pooled_hw", "load_regressor", "crop_names", "tonemapped_crop"]

PARALLEL_NOT_PORTED = ("--parallel (the batch sharded over several cards) is not ported yet: "
                       "multi-GPU is ROADMAP.md §1 item 6; run without it on one card")


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the kernels' "
                         "plain PyTorch versions)")


def checked_device(ap: argparse.ArgumentParser, argv):
    """First parse of the command line, before any file is read: --parallel
    exits with its message, and a CUDA device that is not there raises."""
    args = ap.parse_args(argv)
    if args.parallel:
        ap.error(PARALLEL_NOT_PORTED)
    return resolve_device(args.device)


def regression_config(anchors: int, crop, block_config, clip_grad_norm: float) -> RegressionConfig:
    crop_h, crop_w = (int(x) for x in str(crop).split(","))
    return dataclasses.replace(
        RegressionConfig(),
        anchors=AnchorConfig(regression_anchors=anchors),
        crop_h=crop_h,
        crop_w=crop_w,
        block_config=tuple(int(x) for x in str(block_config).split(",")),
        clip_grad_norm=clip_grad_norm,
    )


def pooled_hw(cfg: RegressionConfig) -> tuple[int, int]:
    """The map the regressor's fc reads: every block's transition halves the
    crop, then the 4x4 average pool."""
    n = 2 ** len(cfg.block_config) * 4
    return cfg.crop_h // n, cfg.crop_w // n


def load_regressor(path: str, cfg: RegressionConfig, device):
    """The regressor from a JAX .msgpack checkpoint or a reference .pth
    (imported at this config's depth and crop)."""
    model = R.make_model(cfg, device=device)
    if path.endswith(".pth"):
        params, stats = import_densenet_state_dict(path, block_config=cfg.block_config,
                                                   pooled_hw=pooled_hw(cfg))
        return load_checked(model, densenet_state_from_jax(params, stats), path)
    return restore_regressor(path, model)


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
