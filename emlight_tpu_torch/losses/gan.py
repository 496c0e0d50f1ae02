"""GAN objectives for the GenProjector stage.

Port of emlight_tpu/losses/gan.py:24-106:
- hinge / ls / original / w GAN losses over multiscale outputs;
- light-mask-weighted multiscale feature matching (non-light pixels x50),
  the mask re-interpolated sequentially from the previous scale;
- the per-pixel cosine-similarity loss, with a gradient that stays finite
  at an exactly-zero pixel;
- the VAE KL divergence.
Maps are NHWC.
"""

from __future__ import annotations

import torch

from ..nn.layers import resize_nearest

__all__ = ["gan_loss", "feature_matching_loss", "cosine_loss", "kld_loss"]


def _single_gan_loss(x: torch.Tensor, target_is_real: bool, for_discriminator: bool,
                     mode: str) -> torch.Tensor:
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.clamp(x - 1, max=0.0).mean()
            return -torch.clamp(-x - 1, max=0.0).mean()
        assert target_is_real, "generator hinge loss aims for real"
        return -x.mean()
    if mode == "ls":
        t = 1.0 if target_is_real else 0.0
        return ((x - t) ** 2).mean()
    if mode == "original":
        t = 1.0 if target_is_real else 0.0
        # BCE with logits
        return (torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()
    if mode == "w":
        return -x.mean() if target_is_real else x.mean()
    raise ValueError(f"unknown gan mode {mode}")


def gan_loss(pred, target_is_real: bool, for_discriminator: bool,
             mode: str = "hinge") -> torch.Tensor:
    """pred: list (per discriminator) of lists of activations; the last entry
    of each inner list is the logit map."""
    total = 0.0
    for per_d in pred:
        logits = per_d[-1] if isinstance(per_d, (list, tuple)) else per_d
        total = total + _single_gan_loss(logits, target_is_real, for_discriminator, mode)
    return total / len(pred)


def feature_matching_loss(pred_fake, pred_real, light_map: torch.Tensor,
                          ambient_weight: float = 50.0) -> torch.Tensor:
    """L1 between mask-weighted intermediate D features.

    light_map: (B, H, W, 1) binary light mask; non-light pixels weighted
    ambient_weight x. The mask is resized sequentially scale to scale, and
    the real features carry no gradient.
    """
    num_d = len(pred_fake)
    total = 0.0
    m = light_map
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):  # exclude the logit map
            f, r = pred_fake[i][j], pred_real[i][j].detach()
            m = resize_nearest(m, tuple(f.shape[1:3]))
            wf = f * m + f * (1 - m) * ambient_weight
            wr = r * m + r * (1 - m) * ambient_weight
            total = total + (wf - wr).abs().mean() / num_d
    return total


def cosine_loss(fake: torch.Tensor, real: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """(1 - cosine similarity over channels).mean().

    Double where: sqrt never sees 0, and a pixel with a zero norm contributes
    cos = 0 with a zero gradient (norm's own gradient there is 0/0).
    """
    num = (fake * real).sum(-1)
    prod = (fake * fake).sum(-1) * (real * real).sum(-1)
    safe = prod > 0
    den = torch.sqrt(torch.where(safe, prod, torch.ones_like(prod)))
    cos = torch.where(safe, num / torch.clamp(den, min=eps), torch.zeros_like(num))
    return (1.0 - cos).mean()


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """VAE KL divergence -0.5 * sum(1 + logvar - mu^2 - exp(logvar))."""
    return -0.5 * torch.sum(1.0 + logvar - mu.square() - logvar.exp())
