"""Shared NN building blocks on NHWC tensors: spectral norm (eval form),
instance norm and torch-parity resizing.

Port of emlight_tpu/nn/layers.py:25-108. ``avg_pool_3x3s2`` is
discriminator-only and waits for the GAN-training port.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

__all__ = ["spectral_sigma", "spectral_normalize", "instance_norm", "resize_nearest",
           "resize_bilinear", "full_f32_matmul", "dense"]


def dense(in_features: int, out_features: int,
          generator: torch.Generator | None) -> nn.Linear:
    """nn.Linear with the JAX package's init: lecun normal kernel, zero bias."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(out_features, in_features, generator=generator)
                         / math.sqrt(in_features))
        lin.bias.zero_()
    return lin


def spectral_sigma(kernel: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sigma = u^T W v for a kernel whose LAST axis is the output channel.

    W is (out, rest) with the rest flattened in the kernel's own leading-axis
    order — (kh, kw, in) for an HWIO kernel, the order the stored v indexes.
    Eval form (torch.nn.utils.spectral_norm in eval): the STORED u and v are
    used verbatim, with no power iteration.
    """
    wmat = kernel.reshape(-1, kernel.shape[-1]).t()  # (out, rest)
    return (u @ wmat) @ v


def spectral_normalize(kernel: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """kernel / sigma, kernel with its output channel on the LAST axis."""
    return kernel / spectral_sigma(kernel, u, v)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W of an NHWC tensor
    (nn.InstanceNorm2d(affine=False): biased variance, no running stats)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode='nearest') on NHWC: src = floor(dst * in/out)."""
    _, h, w, _ = x.shape
    ho, wo = size
    if (h, w) == (ho, wo):
        return x
    ri = torch.floor(torch.arange(ho, dtype=torch.float32) * (h / ho)).long().to(x.device)
    ci = torch.floor(torch.arange(wo, dtype=torch.float32) * (w / wo)).long().to(x.device)
    return x[:, ri][:, :, ci]


def _axis_weights(n_in: int, n_out: int, device):
    pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * (n_in / n_out) - 0.5
    pos = pos.clamp(0.0, n_in - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=n_in - 1)
    frac = pos - lo
    return lo.to(device), hi.to(device), frac.to(device)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) on NHWC:
    half-pixel centers, clamped edges."""
    _, h, w, _ = x.shape
    ho, wo = size
    if (h, w) == (ho, wo):
        return x
    r0, r1, fr = _axis_weights(h, ho, x.device)
    c0, c1, fc = _axis_weights(w, wo, x.device)
    rows = x[:, r0] * (1 - fr)[None, :, None, None] + x[:, r1] * fr[None, :, None, None]
    return (rows[:, :, c0] * (1 - fc)[None, None, :, None]
            + rows[:, :, c1] * fc[None, None, :, None])


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matmuls on the card in full f32 (no TF32) inside the block,
    whatever the process-wide setting; the previous setting is restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
