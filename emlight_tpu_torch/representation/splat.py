"""Gaussian-splat environment-map rasterizer.

Port of emlight_tpu/representation/splat.py:36-112: one batched matmul pair,

    logits[b, n, p] = dirs[b, n, :] . grid[:, p]                      (matmul 1)
    env[b, p, c]    = sum_n colors[b, n, c] * exp((logits - 1) / size)  (matmul 2)

Both matmuls run in full f32 (no TF32): the dot product feeds an exp scaled
by 1/size (~400x), where a 10-bit mantissa would blow up the exponent.
Layout is NHWC.
"""

from __future__ import annotations

import functools

import torch

from ..core.geometry import equirect_xyz_splat, sphere_points
from ..nn.layers import full_f32_matmul

__all__ = ["render_sg", "render_anchor_params", "DEFAULT_SPLAT_SIZE"]

DEFAULT_SPLAT_SIZE = 0.0025


@functools.lru_cache(maxsize=None)
def _grid(h: int, w: int, device: str, dtype: torch.dtype) -> torch.Tensor:
    grid = equirect_xyz_splat(h, w).reshape(-1, 3).T  # (3, P)
    return torch.tensor(grid, dtype=dtype, device=device)


def render_sg(dirs: torch.Tensor, sizes: torch.Tensor, colors: torch.Tensor,
              h: int = 128, w: int = 256) -> torch.Tensor:
    """Render B environment maps from N spherical Gaussians each.

    dirs (B, N, 3) or (B, N*3); sizes (B, N); colors (B, N, 3) or (B, N*3).
    Returns (B, h, w, 3).
    """
    b = dirs.shape[0]
    dirs = dirs.reshape(b, -1, 3)
    colors = colors.reshape(b, -1, 3)
    grid = _grid(h, w, str(dirs.device), dirs.dtype)
    with full_f32_matmul():
        logits = torch.matmul(dirs, grid)  # (B, N, P)
        weights = torch.exp((logits - 1.0) / sizes[..., None])
        env = torch.matmul(weights.transpose(1, 2), colors)  # (B, P, 3)
    return env.reshape(b, h, w, 3)


def render_anchor_params(distribution: torch.Tensor, intensity: torch.Tensor,
                         rgb_ratio: torch.Tensor, ambient: torch.Tensor | None = None, *,
                         n: int = 128, h: int = 128, w: int = 256,
                         size: float = DEFAULT_SPLAT_SIZE,
                         intensity_scale: float = 1.0) -> torch.Tensor:
    """Anchor parameters -> environment map (B, h, w, 3).

    colors_i = distribution_i * intensity * intensity_scale * rgb_ratio;
    env = splat(colors) (+ ambient per pixel if given).
    distribution (B, N); intensity (B,) or (B, 1); rgb_ratio (B, 3);
    ambient (B, 3) or None.
    """
    b = distribution.shape[0]
    dt, dev = distribution.dtype, distribution.device
    anchors = torch.tensor(sphere_points(n), dtype=dt, device=dev)
    dirs = anchors[None].expand(b, n, 3)
    sizes = torch.full((b, n), size, dtype=dt, device=dev)
    colors = (distribution[:, :, None] * intensity.reshape(b, 1, 1) * intensity_scale
              * rgb_ratio.reshape(b, 1, 3))
    env = render_sg(dirs, sizes, colors, h=h, w=w)
    if ambient is not None:
        env = env + ambient.reshape(b, 1, 1, 3)
    return env
