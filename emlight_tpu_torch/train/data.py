"""Synthetic training batches, in NumPy from a seed.

The port's own copies of emlight_tpu/train/data.py:192-229
``synthetic_regression_batch`` and ``synthetic_projector_batch``: the same
draws in the same order, so one seed gives the JAX package and the port the
same batch.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_regression_batch", "synthetic_projector_batch"]


def synthetic_regression_batch(batch_size: int, n_anchors: int = 96,
                               crop_hw: tuple[int, int] = (192, 256), seed: int = 0) -> dict:
    """A regressor batch: crop and the four anchor-parameter targets."""
    rng = np.random.default_rng(seed)
    dist = rng.gamma(0.3, 1.0, (batch_size, n_anchors)).astype(np.float32)
    dist /= dist.sum(1, keepdims=True)
    rgb = rng.uniform(0.4, 0.7, (batch_size, 3)).astype(np.float32)
    rgb /= np.linalg.norm(rgb, axis=1, keepdims=True)
    return {
        "crop": rng.random((batch_size, *crop_hw, 3), dtype=np.float32),
        "distribution": dist,
        "intensity": rng.uniform(0.2, 2.0, batch_size).astype(np.float32),
        "rgb_ratio": rgb,
        "ambient": rng.uniform(0, 0.05, (batch_size, 3)).astype(np.float32),
    }


def synthetic_projector_batch(batch_size: int, n_anchors: int = 128,
                              crop_size: int = 128, env_hw: tuple[int, int] = (128, 256),
                              seed: int = 0) -> dict:
    """A GenProjector batch: crop, warped HDR target, light map and the
    anchor parameters the guide is rasterized from."""
    rng = np.random.default_rng(seed)
    dist = rng.gamma(0.3, 1.0, (batch_size, n_anchors)).astype(np.float32)
    dist /= dist.sum(1, keepdims=True)
    rgb = rng.uniform(0.4, 0.7, (batch_size, 3)).astype(np.float32)
    rgb /= np.linalg.norm(rgb, axis=1, keepdims=True)
    return {
        "crop": rng.random((batch_size, crop_size, crop_size, 3), dtype=np.float32),
        "warped": rng.random((batch_size, *env_hw, 3), dtype=np.float32),
        "map": (rng.random((batch_size, *env_hw)) > 0.9).astype(np.float32),
        "distribution": dist,
        "intensity": rng.uniform(0.2, 2.0, batch_size).astype(np.float32),
        "rgb_ratio": rgb,
        "ambient": rng.uniform(0, 0.05, (batch_size, 3)).astype(np.float32),
        "alpha": rng.uniform(0.5, 2.0, batch_size).astype(np.float32),
    }
