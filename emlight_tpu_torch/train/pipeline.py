"""Fused two-stage inference: crop -> regression -> guide -> generator -> HDR env map.

Port of emlight_tpu/train/pipeline.py. With the scales of the two training
recipes resolved analytically, the end-to-end guide is

    guide = splat(dist_hat * int_hat * rgb_hat, scale=5) + amb_hat

with no per-sample tonemap alpha (it cancels); see the JAX module's
docstring for the derivation. The regressor runs through
``regression.make_eval_apply``, the concat-free buffer eval forward, as
the JAX package's pipeline does.
"""

from __future__ import annotations

import torch

from ..config import ProjectorConfig, RegressionConfig
from ..core.device import resolve_device
from ..representation.splat import render_anchor_params
from .regression import make_eval_apply

__all__ = ["pipeline_inference", "predicted_guide", "END_TO_END_INTENSITY_SCALE"]

# dist_hat * int_hat * 5 * rgb_hat — the alpha-cancelled composition of the
# regression targets (x alpha/500) with the projector's guide (x0.01, x alpha)
END_TO_END_INTENSITY_SCALE = 5.0


def predicted_guide(pred: dict, env_h: int, env_w: int, splat_size: float) -> torch.Tensor:
    """Rasterize regression predictions into the generator's conditioning map."""
    return render_anchor_params(
        pred["distribution"],
        pred["intensity"][:, 0],
        pred["rgb_ratio"],
        pred["ambient"],
        n=pred["distribution"].shape[-1],
        h=env_h,
        w=env_w,
        size=splat_size,
        intensity_scale=END_TO_END_INTENSITY_SCALE,
    )


def _on(model: torch.nn.Module, dev: torch.device, what: str) -> None:
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise ValueError(f"{what} lives on {p.device}, the pipeline runs on {dev}")


@torch.inference_mode()
def pipeline_inference(regressor, generator, crop_reg, crop_proj,
                       reg_cfg: RegressionConfig, proj_cfg: ProjectorConfig, device=None):
    """Crops -> (HDR env maps (B, H, W, 3), pred dict).

    crop_reg:  (B, reg_cfg.crop_h, reg_cfg.crop_w, 3) tonemapped crops.
    crop_proj: (B, proj_cfg.crop_size//2, proj_cfg.crop_size//2, 3) the SAME
               crops at the generator encoder's resolution.
    Both may be numpy arrays or tensors; they are moved to `device` (CUDA
    unless "cpu" is asked), where both models must already live.
    """
    dev = resolve_device(device)
    _on(regressor, dev, "regressor")
    _on(generator, dev, "generator")
    crop_reg = torch.as_tensor(crop_reg, dtype=torch.float32, device=dev)
    crop_proj = torch.as_tensor(crop_proj, dtype=torch.float32, device=dev)
    if tuple(crop_reg.shape[1:]) != (reg_cfg.crop_h, reg_cfg.crop_w, 3):
        raise ValueError(f"crop_reg {tuple(crop_reg.shape)} does not match the "
                         f"regressor's {reg_cfg.crop_h}x{reg_cfg.crop_w} crop")
    pred = make_eval_apply(reg_cfg)(regressor, crop_reg)
    env_h, env_w = proj_cfg.crop_size // 2, proj_cfg.crop_size
    guide = predicted_guide(pred, env_h, env_w, proj_cfg.anchors.splat_size)
    env = generator(guide, crop_proj)
    return env, pred
