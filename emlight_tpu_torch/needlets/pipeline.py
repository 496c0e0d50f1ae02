"""Needlet GT-generation / reconstruction pipeline on the card.

Port of emlight_tpu/needlets/pipeline.py (Needlets/gt_gen_j2.py:29-77,
gt_gen_j3.py and mat_gen2.py:35-64 as single matmuls):

    analysis:   coeffs = (img ⊙ solidAngle)ᵀ @ SN        (P x C)
    synthesis:  rec    = SN @ coeffs

plus the per-band top-energy sparsification of gt_gen_j2.py:47-66.

The basis (built once per config in NumPy float64, stored float32, as the
JAX package stores it) and the solid-angle column live as tensors on the
pipeline's device. The JAX package runs both products outside any Pallas
kernel at ``Precision.HIGHEST``; here each is one ``torch.einsum`` inside
``full_f32_matmul``, so TF32 does not round the 32768-pixel reductions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import NeedletsConfig
from ..core.device import resolve_device
from ..core.geometry import solid_angle_map
from ..nn.layers import full_f32_matmul
from .needlets import band_slices, needlet_basis_matrix

__all__ = ["NeedletPipeline", "gt_grid_angles"]


def gt_grid_angles(h: int, w: int):
    """The reference's endpoint-inclusive equirect grid (mat_gen2.py:22-25)."""
    theta = np.linspace(0, 1, h) * np.pi
    phi = np.linspace(0, 2, w) * np.pi
    P, T = np.meshgrid(phi, theta)
    return T.reshape(-1), P.reshape(-1)


@functools.lru_cache(maxsize=None)
def _basis(h: int, w: int, jmax: int, b: float) -> np.ndarray:
    theta, phi = gt_grid_angles(h, w)
    return needlet_basis_matrix(theta, phi, jmax, b).astype(np.float32)


class NeedletPipeline:
    """project / sparsify / reconstruct over (B, H, W, 3) panorama batches
    on `device` (CUDA unless "cpu" is asked)."""

    def __init__(self, cfg: NeedletsConfig = NeedletsConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sn = torch.from_numpy(_basis(cfg.env_h, cfg.env_w, cfg.jmax, cfg.b)).to(self.device)
        self.solid = torch.from_numpy(
            solid_angle_map(cfg.env_w).reshape(-1, 1).astype(np.float32)).to(self.device)
        self.slices = band_slices(cfg.jmax, cfg.b)
        self.n_coeffs = self.sn.shape[1]

    def project(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, C, 3) needlet coefficients."""
        b = imgs.shape[0]
        flat = imgs.reshape(b, -1, 3) * self.solid[None]
        with full_f32_matmul():
            return torch.einsum("bpc,pk->bkc", flat, self.sn)

    def sparsify(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Per-band top-energy masking (gt_gen_j2.py:47-66): keep coefficients
        whose |rgb|-sum energy exceeds the band's percentile threshold
        (linear interpolation, jnp.percentile's default method)."""
        out = coeffs.clone()
        for sl, pct in zip(self.slices, self.cfg.sparsity_percentiles):
            band = out[:, sl, :]
            energy = band.abs().sum(-1)  # (B, K)
            thre = torch.quantile(energy, pct / 100.0, dim=1, keepdim=True,
                                  interpolation="linear")
            out[:, sl, :] = band * (energy > thre)[..., None].to(band.dtype)
        return out

    def reconstruct(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(B, C, 3) -> (B, H, W, 3) tight-frame synthesis (mat_gen2.py:55)."""
        b = coeffs.shape[0]
        with full_f32_matmul():
            rec = torch.einsum("pk,bkc->bpc", self.sn, coeffs)
        return rec.reshape(b, self.cfg.env_h, self.cfg.env_w, 3)
