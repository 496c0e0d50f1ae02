"""SPADE GenProjector (EMLight stage 2): generator construction and eval.

Port of emlight_tpu/train/projector.py:56 ``make_models`` (generator half),
:156 ``make_guide`` and :415 ``inference``. The discriminator, VGG, losses
and GAN steps wait for the GAN-training port.
"""

from __future__ import annotations

import torch

from ..config import ProjectorConfig
from ..core.device import resolve_device
from ..nn.spade import SPADEGenerator
from ..representation.splat import render_anchor_params

__all__ = ["make_models", "make_guide", "inference", "compute_dtype"]


def compute_dtype(cfg: ProjectorConfig) -> torch.dtype:
    """cfg.dtype -> the conv compute dtype ("bfloat16": bf16 sphere convs and
    SNConvs with f32 accumulation; everything else stays f32)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def make_models(cfg: ProjectorConfig, device=None, seed: int = 0) -> SPADEGenerator:
    """The generator in eval mode on `device` (CUDA unless "cpu" is asked).

    Weights are drawn on the CPU from a torch.Generator seeded with `seed`,
    so one seed gives the same model on every device.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    g = SPADEGenerator(
        ngf=cfg.ngf,
        norm_type="syncbatch" if "syncbatch" in cfg.norm_g else "instance",
        num_upsampling_layers=cfg.num_upsampling_layers,
        crop_size=cfg.crop_size,
        aspect_ratio=2.0,
        use_vae=cfg.use_vae,
        label_nc=cfg.semantic_nc,
        compute_dtype=compute_dtype(cfg),
        generator=gen,
    )
    return g.eval().to(dev)


def _env_hw(cfg: ProjectorConfig) -> tuple[int, int]:
    return cfg.crop_size // 2, cfg.crop_size


def make_guide(batch: dict, cfg: ProjectorConfig) -> torch.Tensor:
    """Rasterize the anchor-GT environment map:
    env = (splat(dist * intensity * rgb) + ambient) * alpha."""
    env_h, env_w = _env_hw(cfg)
    env = render_anchor_params(
        batch["distribution"], batch["intensity"], batch["rgb_ratio"], batch["ambient"],
        n=batch["distribution"].shape[-1], h=env_h, w=env_w, size=cfg.anchors.splat_size,
    )
    return env * batch["alpha"][:, None, None, None]


@torch.inference_mode()
def inference(generator: SPADEGenerator, batch: dict, cfg: ProjectorConfig) -> torch.Tensor:
    """Eval-mode generation from an anchor-GT batch (with "crop")."""
    return generator(make_guide(batch, cfg), batch["crop"])
