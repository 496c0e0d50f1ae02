"""Sphere / equirectangular geometry — own copy of what the port needs.

Same functions and caches as emlight_tpu/core/geometry.py:38-51, 53-121 and
139-146 (that module is JAX-free, but the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["sphere_points", "geometric_points", "equirect_xyz_splat", "steradian_map",
           "rgb_to_intensity", "INTENSITY_WEIGHTS_GT"]

# Luma weights used by GT extraction / light-mask construction
# (distribution_representation.py:16-17,93; GenProjector/data.py:75).
INTENSITY_WEIGHTS_GT = (0.3, 0.59, 0.11)


def rgb_to_intensity(rgb, weights=INTENSITY_WEIGHTS_GT):
    """Luma of an (..., 3) RGB array (NumPy or torch)."""
    wr, wg, wb = weights
    return wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]


@functools.lru_cache(maxsize=None)
def _sphere_points_cached(n: int) -> np.ndarray:
    golden_angle = np.pi * (3.0 - np.sqrt(5.0))
    theta = golden_angle * np.arange(n)
    z = np.linspace(1 - 1.0 / n, 1.0 / n - 1, n)
    radius = np.sqrt(1 - z * z)
    points = np.zeros((n, 3))
    points[:, 0] = radius * np.cos(theta)
    points[:, 1] = radius * np.sin(theta)
    points[:, 2] = z
    return points


def sphere_points(n: int = 128) -> np.ndarray:
    """N golden-spiral (Fibonacci) points on the unit sphere, (n, 3) float64.

    Cached per n; returns a copy.
    """
    return _sphere_points_cached(int(n)).copy()


def geometric_points(n: int, anchor_depth) -> np.ndarray:
    """GMLight variant: golden-spiral directions pushed to per-anchor depths,
    (n, 3) float64. Only x and y scale with the depth; z stays on the unit
    profile, as the reference has it (RegressionNetwork/gmloss/utils.py:63-73).
    """
    golden_angle = np.pi * (3.0 - np.sqrt(5.0))
    theta = golden_angle * np.arange(n)
    z = np.linspace(1 - 1.0 / n, 1.0 / n - 1, n)
    radius = np.asarray(anchor_depth)
    points = np.zeros((n, 3))
    points[:, 0] = radius * np.cos(theta)
    points[:, 1] = radius * np.sin(theta)
    points[:, 2] = z
    return points


@functools.lru_cache(maxsize=None)
def _equirect_xyz_splat_cached(h: int, w: int) -> np.ndarray:
    # pixel-center grid: lat = (i+0.5) * pi/h, lon = (j+0.5) * 2*pi/w
    lat = (np.arange(h, dtype=np.float64) + 0.5) * (np.pi / h)
    lon = (np.arange(w, dtype=np.float64) + 0.5) * (2.0 * np.pi / w)
    lat, lon = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(lat) * np.cos(lon)
    y = np.sin(lat) * np.sin(lon)
    z = np.cos(lat)
    return np.stack((x, y, z), axis=-1)  # (h, w, 3)


def equirect_xyz_splat(h: int = 128, w: int = 256) -> np.ndarray:
    """Unit-vector grid used by the Gaussian-splat rasterizer, (h, w, 3)."""
    return _equirect_xyz_splat_cached(int(h), int(w))


def steradian_map(height: int, width: int, multiply: bool = True) -> np.ndarray:
    """sin(theta) row weights, optionally scaled by per-pixel area, (h, w)
    float32."""
    s = np.linspace(0, height, num=height, endpoint=False) + 0.5
    s = np.sin(s / height * np.pi)
    s = np.repeat(s[:, None], width, axis=1)
    if multiply:
        s = s * (((2 * np.pi) / width) * (np.pi / height))
    return s.astype(np.float32)
