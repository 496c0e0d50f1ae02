"""Shared NN building blocks: spectral norm (eval and train forms), flax's
BatchNorm, instance norm, torch-parity resizing and the discriminator's
count-exclude average pool. NHWC unless a function says otherwise.

Port of emlight_tpu/nn/layers.py, plus the train-mode BatchNorm of
emlight_tpu/nn/densenet_fast.py:171-211 (flax.linen.BatchNorm's semantics).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["spectral_sigma", "spectral_normalize", "spectral_power_iteration", "l2_normalize",
           "BatchNorm", "instance_norm", "resize_nearest", "resize_bilinear", "avg_pool_3x3s2",
           "full_f32_matmul", "dense"]


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


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.norm(x) + eps)


@torch.no_grad()
def spectral_power_iteration(kernel: torch.Tensor, u: torch.Tensor,
                             eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """One power iteration on the DETACHED kernel (output channel on the last
    axis), torch.nn.utils.spectral_norm's train form: v = normalize(Wᵀu), then
    u = normalize(W v). Returns the fresh (u, v); the caller stores them and
    takes sigma = uᵀ W v with them, so the gradient flows through W only."""
    wmat = kernel.detach().reshape(-1, kernel.shape[-1]).t()  # (out, rest)
    v = l2_normalize(wmat.t() @ u, eps)
    return l2_normalize(wmat @ v, eps), v


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) over every axis but
    ``channel_dim``.

    Train: the batch's moments mean and mean of squares, the biased variance
    var = max(0, mu2 - mean^2) (flax's fast variance), the output
    (x - mean) * (rsqrt(var + eps) * scale) + bias, and the running statistics
    updated as r = momentum * r + (1 - momentum) * batch, the BIASED variance
    included (nn.BatchNorm2d would store the unbiased one). Eval: the running
    statistics; on NCHW through F.batch_norm.

    ``dtype`` is flax's compute dtype: the moments, the normalization and the
    running statistics stay in float32 (or float64 for a float64 input), and
    the output is rounded to ``dtype`` (None: left in that type, as flax
    promotes the input with the float32 scale).

    ``affine`` adds the parameters ``weight`` (flax's scale) and ``bias``.
    ``torch_names`` names the running statistics as nn.BatchNorm2d does
    (running_mean, running_var, num_batches_tracked), else ``mean`` and
    ``var`` as flax does; the weight bridge (train/jax_weights.py) fills
    either. num_batches_tracked is carried for that layout only and is not
    counted.
    """

    def __init__(self, channels: int, *, channel_dim: int = -1, affine: bool = False,
                 torch_names: bool = False, eps: float = 1e-5, momentum: float = 0.9,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.channel_dim = channel_dim
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self._names = ("running_mean", "running_var") if torch_names else ("mean", "var")
        self.register_buffer(self._names[0], torch.zeros(channels))
        self.register_buffer(self._names[1], torch.ones(channels))
        if torch_names:
            self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.weight = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def running_stats(self) -> tuple[torch.Tensor, torch.Tensor]:
        return getattr(self, self._names[0]), getattr(self, self._names[1])

    def _shape(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        shape = [1] * ndim
        shape[self.channel_dim] = -1
        return v.reshape(shape)

    def moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, biased var) of the batch in float32 (float64 for a float64
        x), differentiable; the running statistics are not touched."""
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
        mean = xs.mean(dims)
        var = torch.clamp((xs * xs).mean(dims) - mean * mean, min=0.0)
        return mean, var

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """r = momentum * r + (1 - momentum) * batch, for the mean and the
        (biased) variance."""
        rm, rv = self.running_stats()
        rm.mul_(self.momentum).add_(mean.to(rm.dtype), alpha=1.0 - self.momentum)
        rv.mul_(self.momentum).add_(var.to(rv.dtype), alpha=1.0 - self.momentum)

    def batch_moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, biased var) of the batch, differentiable; updates the running
        statistics (train mode only)."""
        mean, var = self.moments(x)
        self.update_running(mean.detach(), var.detach())
        return mean, var

    def affine(self, mean: torch.Tensor, var: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The normalization as a per-channel affine y = x * a + b, with
        a = scale * rsqrt(var + eps) and b = bias - mean * a
        (differentiable)."""
        a = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            a = a * self.weight
        b = -mean * a
        if self.bias is not None:
            b = b + self.bias
        return a, b

    def normalize(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        """(x - mean) * (rsqrt(var + eps) * scale) + bias in the moments'
        type, rounded to ``dtype`` if set."""
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x.to(mean.dtype) - self._shape(mean, x.dim())) * self._shape(mul, x.dim())
        if self.bias is not None:
            y = y + self._shape(self.bias, x.dim())
        return y if self.dtype is None else y.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self.normalize(x, *self.batch_moments(x))
        rm, rv = self.running_stats()
        if self.channel_dim == 1:
            ct = torch.promote_types(x.dtype, rm.dtype)
            y = F.batch_norm(x.to(ct), rm.to(ct), rv.to(ct), self.weight, self.bias, False, 0.0,
                             self.eps)
            return y if self.dtype is None else y.to(self.dtype)
        return self.normalize(x, rm, rv)


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
    dev = str(x.device)
    return x[:, _nearest_index(h, ho, dev)][:, :, _nearest_index(w, wo, dev)]


# The index and weight tables below go onto the device once per size: a copy
# from pageable host memory in every call would make the host wait for the
# card. They are made outside inference mode, so that a table first made in
# serving can be saved for a training step's backward.
@functools.lru_cache(maxsize=None)
def _nearest_index(n_in: int, n_out: int, device: str) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.floor(torch.arange(n_out, dtype=torch.float32) * (n_in / n_out)).long().to(
            device)


@functools.lru_cache(maxsize=None)
def _axis_weights(n_in: int, n_out: int, device: str):
    with torch.inference_mode(False):
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
    r0, r1, fr = _axis_weights(h, ho, str(x.device))
    c0, c1, fc = _axis_weights(w, wo, str(x.device))
    rows = x[:, r0] * (1 - fr)[None, :, None, None] + x[:, r1] * fr[None, :, None, None]
    return (rows[:, :, c0] * (1 - fc)[None, None, :, None]
            + rows[:, :, c1] * fc[None, None, :, None])


@functools.lru_cache(maxsize=None)
def _pool_counts(h: int, w: int, device: str) -> torch.Tensor:
    """(Ho, Wo, 1) count of the in-image taps of each 3x3/s2 window."""
    def per_axis(n):
        i = np.arange((n - 1) // 2 + 1)
        return 3 - (i == 0) - (2 * i + 1 >= n)

    cnt = np.outer(per_axis(h), per_axis(w)).astype(np.float32)[..., None]
    return torch.from_numpy(cnt).to(device)


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(kernel 3, stride 2, padding 1, count_include_pad=False) on
    NHWC — the multiscale discriminator's downsampler — computed as the JAX
    package computes it: the sum of the 9 strided taps over the zero-padded
    map, divided by the count of taps inside the image."""
    _, h, w, _ = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    s = sum(xp[:, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2]
            for dy in range(3) for dx in range(3))
    return s / _pool_counts(h, w, str(x.device))


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
