"""DenseNet anchor regressor (EMLight stage 1): model construction and eval.

Port of emlight_tpu/train/regression.py:75 ``make_model`` and :188
``predict``. Training (Sinkhorn loss, Adam, the buffer forward) waits for the
regression-training port.
"""

from __future__ import annotations

import torch

from ..config import RegressionConfig
from ..core.device import resolve_device
from ..nn.densenet import DenseNet

__all__ = ["make_model", "predict"]


def make_model(cfg: RegressionConfig, device=None, seed: int = 0) -> DenseNet:
    """The regressor in eval mode on `device` (CUDA unless "cpu" is asked).

    Weights are drawn on the CPU from a torch.Generator seeded with `seed`,
    so one seed gives the same model on every device.
    """
    dev = resolve_device(device)
    if cfg.dtype != "float32":
        raise NotImplementedError(f"regressor dtype {cfg.dtype!r}: only float32 is ported")
    gen = torch.Generator().manual_seed(seed)
    model = DenseNet(
        growth_rate=cfg.growth_rate,
        block_config=cfg.block_config,
        num_init_features=cfg.num_init_features,
        n_anchors=cfg.anchors.regression_anchors,
        input_hw=(cfg.crop_h, cfg.crop_w),
        generator=gen,
    )
    return model.eval().to(dev)


@torch.inference_mode()
def predict(model: DenseNet, crop: torch.Tensor) -> dict[str, torch.Tensor]:
    """Inference: crop (B, H, W, 3) -> anchor parameter dict
    {distribution (B, N), intensity (B, 1), rgb_ratio (B, 3), ambient (B, 3)}."""
    return model(crop)
