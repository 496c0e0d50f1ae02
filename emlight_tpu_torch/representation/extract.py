"""Anchor GT extraction: HDR panorama -> spherical light-distribution
parameters, on the card.

Port of emlight_tpu/representation/extract.py (the reference's extract_mesh,
RegressionNetwork/representation/distribution_representation.py:65-120).
The per-pixel nearest-anchor assignment is an index map, computed once per
(H, W, N) on the host and kept on the device, and the per-anchor energy sums
of a batch are ONE ``index_add_`` of its (B·H·W, 3) pixels into B·N bins, in
float32. The JAX package forms them as a one-hot (H·W, N) matmul at
Precision.HIGHEST, work it does without a Pallas kernel; on the H100 that
matmul in full float32 is several times slower than the index_add_
(chip_smoke.py phase 16 times both; PERF.md), so the port keeps the
index_add_. Its float32 sums are taken in another order (atomically on the
card), within the tests' rtol 1e-5 of the JAX package's.

Functions take a tensor and run on its device; a NumPy array is moved to
``device`` (CUDA unless "cpu" is asked).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.geometry import (
    INTENSITY_WEIGHTS_GT,
    icosphere,
    nearest_anchor_index,
    polar_to_cartesian,
    rgb_to_intensity,
    steradian_map,
)

__all__ = ["extract_anchors", "extract_anchors_batch", "extract_light_info_legacy",
           "AnchorExtractor"]


@functools.lru_cache(maxsize=None)
def _legacy_index(h: int, w: int) -> np.ndarray:
    """Pixel -> nearest of the 42 icosphere(1) vertices, on the legacy tool's
    UNSHIFTED lattice (phi = j/w·2π, theta = i/h·π: no half-pixel offset;
    intensity_modify.py:84-100), (H, W) int."""
    verts, _ = icosphere(1)
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xyz = polar_to_cartesian((j / w * 2 * np.pi).reshape(-1), (i / h * np.pi).reshape(-1))
    return ((xyz[:, None, :] - verts[None]) ** 2).sum(-1).argmin(-1).reshape(h, w)


@functools.lru_cache(maxsize=None)
def _constants(h: int, w: int, n: int | None, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(pixel -> anchor index (H·W,), steradian row weights (H, W)) on the
    device; n None: the legacy 42-anchor set."""
    idx = nearest_anchor_index(h, w, n) if n is not None else _legacy_index(h, w)
    ster = steradian_map(h, w, multiply=False)
    return (torch.from_numpy(np.asarray(idx, np.int64).reshape(-1)).to(device),
            torch.from_numpy(ster).to(device))


def _as_tensor(hdr, device) -> torch.Tensor:
    if isinstance(hdr, torch.Tensor):
        return hdr.to(torch.float32)
    return torch.as_tensor(np.asarray(hdr, np.float32), device=resolve_device(device))


def _anchor_sums(x: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Per-anchor RGB sums of a (B, H, W, 3) map: (B, N, 3), one index_add_
    of every pixel into its image's bin of its anchor."""
    b = x.shape[0]
    bins = (index[None] + n * torch.arange(b, device=x.device)[:, None]).reshape(-1)
    out = torch.zeros(b * n, 3, dtype=x.dtype, device=x.device)
    return out.index_add_(0, bins, x.reshape(-1, 3)).view(b, n, 3)


def _extract(hdr: torch.Tensor, n: int, light_threshold: float) -> dict[str, torch.Tensor]:
    """Batched extract_mesh.compute: steradian weight -> light mask at
    light_threshold of the brightest pixel's luma -> ambient from the rest
    -> per-anchor energy sums -> distribution / intensity / rgb_ratio."""
    _, h, w, _ = hdr.shape
    index, ster = _constants(h, w, n, str(hdr.device))
    hdr = hdr * ster[..., None]
    intensity = rgb_to_intensity(hdr, INTENSITY_WEIGHTS_GT)
    peak = intensity.amax(dim=(1, 2), keepdim=True)
    mask = (intensity > peak * light_threshold).to(hdr.dtype)[..., None]
    light = hdr * mask
    ambient = (hdr * (1.0 - mask)).sum(dim=(1, 2))
    anchors = _anchor_sums(light, index, n)
    energy = rgb_to_intensity(anchors, INTENSITY_WEIGHTS_GT)
    anchors_rgb = anchors.sum(dim=1)
    total = torch.linalg.vector_norm(anchors_rgb, dim=-1)
    return {
        "distribution": energy / energy.sum(dim=-1, keepdim=True),
        "intensity": total,
        "rgb_ratio": anchors_rgb / total[:, None],
        "ambient": ambient,
        "map": mask[..., 0],
    }


@torch.no_grad()
def extract_anchors(hdr, n: int = 128, light_threshold: float = 0.05, device=None
                    ) -> dict[str, torch.Tensor]:
    """Anchor parameters of one (H, W, 3) HDR panorama: distribution (N,),
    intensity (), rgb_ratio (3,), ambient (3,) and the light mask (H, W)."""
    out = _extract(_as_tensor(hdr, device)[None], n, light_threshold)
    return {k: v[0] for k, v in out.items()}


@torch.no_grad()
def extract_anchors_batch(hdrs, n: int = 128, light_threshold: float = 0.05, device=None
                          ) -> dict[str, torch.Tensor]:
    """``extract_anchors`` over a (B, H, W, 3) batch, every output with a
    leading batch axis."""
    return _extract(_as_tensor(hdrs, device), n, light_threshold)


@torch.no_grad()
def extract_light_info_legacy(hdr, device=None) -> dict[str, torch.Tensor]:
    """The legacy 42-anchor icosahedron extraction (intensity_modify.py:
    70-120): no light / ambient split (every pixel contributes), each
    anchor's RGB sum + 1e-9, rgb_ratio summing to 1 (not unit norm), and
    intensity = total luma / luma(rgb_ratio)."""
    x = _as_tensor(hdr, device)
    h, w, _ = x.shape
    index, ster = _constants(h, w, None, str(x.device))
    rgbs = _anchor_sums((x * ster[..., None])[None], index, 42)[0] + 1e-9
    tmp = rgbs.sum(dim=0)
    rgb_ratio = tmp / tmp.sum()
    total_energy = rgb_to_intensity(tmp, INTENSITY_WEIGHTS_GT)
    return {
        "distribution": rgb_to_intensity(rgbs, INTENSITY_WEIGHTS_GT) / total_energy,
        "rgb_ratio": rgb_ratio,
        "intensity": total_energy / rgb_to_intensity(rgb_ratio, INTENSITY_WEIGHTS_GT),
    }


class AnchorExtractor:
    """The reference's extract_mesh as an object:
    ``AnchorExtractor(ln=128).compute(hdr)`` -> (params as NumPy arrays
    shaped like the reference pickles, the light mask)."""

    def __init__(self, h: int = 128, w: int = 256, ln: int = 128,
                 light_threshold: float = 0.05, device=None):
        self.h, self.w, self.ln = h, w, ln
        self.light_threshold = light_threshold
        self.device = resolve_device(device)

    def compute(self, hdr: np.ndarray):
        out = extract_anchors(np.asarray(hdr, np.float32), n=self.ln,
                              light_threshold=self.light_threshold, device=self.device)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        params = {k: out[k] for k in ("distribution", "intensity", "rgb_ratio", "ambient")}
        return params, out["map"]

    def compute_batch(self, hdrs: np.ndarray) -> dict[str, np.ndarray]:
        out = extract_anchors_batch(np.asarray(hdrs, np.float32), n=self.ln,
                                    light_threshold=self.light_threshold, device=self.device)
        return {k: v.cpu().numpy() for k, v in out.items()}
