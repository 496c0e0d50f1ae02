"""Planar-image -> sphere projection (the vendored OmniMNIST demo capability).

Port of emlight_tpu/nn/sphere_demo.py. The reference vendors an OmniMNIST
dataset (GenProjector/models/networks/spherenet/dataset.py:73-155) that
gnomonically projects MNIST digits onto an equirectangular sphere to
exercise the distortion-aware convolutions. This module provides the same
capability: project any planar image onto the sphere at a given
rotation/FOV, batched on the device (one rotation per sample), for
SphereConv demos and distortion-robustness tests without torchvision.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.geometry import equirect_xyz_splat

__all__ = ["project_to_sphere", "OmniDigits", "load_mnist_idx", "synthetic_digits"]


@functools.lru_cache(maxsize=None)
def _grid(out_h: int, out_w: int, device: str) -> torch.Tensor:
    return torch.tensor(equirect_xyz_splat(out_h, out_w), dtype=torch.float32,
                        device=device).reshape(-1, 3)


def project_to_sphere(img: torch.Tensor, v_rot: torch.Tensor, h_rot: torch.Tensor,
                      out_h: int = 60, out_w: int = 60, fov_deg: float = 120.0) -> torch.Tensor:
    """Project (B, H, W, C) planar images onto (B, out_h, out_w, C) equirect maps.

    The image is placed on the tangent plane at the (v_rot, h_rot)-rotated
    +x equator point and sampled gnomonically: equirect pixels whose rays
    hit the tangent-plane square within the FOV read the image bilinearly;
    the rest are zero (the OmniMNIST construction). float32 throughout, in
    the JAX package's order of operations.

    v_rot/h_rot: (B,) rotation angles in radians.
    """
    b, h, w, c = img.shape
    grid = _grid(out_h, out_w, str(img.device))  # (P, 3)
    # tangent plane at the equator point (1, 0, 0), rotated by v_rot (about
    # y: vertical) then h_rot (about z: horizontal) — both rotations move
    # the projected image, like the OmniMNIST dataset
    cv, sv = torch.cos(v_rot), torch.sin(v_rot)
    ch, sh = torch.cos(h_rot), torch.sin(h_rot)
    zero, one = torch.zeros_like(cv), torch.ones_like(cv)
    rot_v = torch.stack([torch.stack([cv, zero, sv], -1), torch.stack([zero, one, zero], -1),
                         torch.stack([-sv, zero, cv], -1)], -2)
    rot_h = torch.stack([torch.stack([ch, -sh, zero], -1), torch.stack([sh, ch, zero], -1),
                         torch.stack([zero, zero, one], -1)], -2)
    rays = grid[None] @ (rot_h @ rot_v)  # inverse-rotate rays: (B, P, 3)
    z = rays[..., 0]  # component toward the tangent point
    valid = z > 1e-6
    scale = torch.tan(torch.deg2rad(torch.tensor(fov_deg / 2.0, device=img.device)))
    zc = torch.clamp(z, min=1e-6)
    u = torch.where(valid, rays[..., 1] / zc, 2.0) / scale
    v = torch.where(valid, rays[..., 2] / zc, 2.0) / scale
    inside = valid & (u.abs() <= 1) & (v.abs() <= 1)
    px = (u + 1) / 2 * (w - 1)
    py = (v + 1) / 2 * (h - 1)
    x0 = torch.clamp(torch.floor(px).to(torch.int32), 0, w - 1)
    y0 = torch.clamp(torch.floor(py).to(torch.int32), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    flat = img.reshape(b, h * w, c)
    rows = torch.arange(b, device=img.device)[:, None]

    def at(yy, xx):
        return flat[rows, (yy * w + xx).long()]

    sample = (
        at(y0, x0) * (1 - fy) * (1 - fx)
        + at(y0, x1) * (1 - fy) * fx
        + at(y1, x0) * fy * (1 - fx)
        + at(y1, x1) * fy * fx
    )
    return torch.where(inside[..., None], sample, 0.0).reshape(b, out_h, out_w, c)


def load_mnist_idx(root: str, train: bool = True):
    """Read MNIST idx(.gz) files from `root` (no torchvision in this image).

    Expects the standard filenames (train-images-idx3-ubyte[.gz], ...).
    Returns (images (N, 28, 28) float32 in [0, 255], labels (N,) int32).
    """
    import gzip
    import os
    import struct

    prefix = "train" if train else "t10k"

    def read(name):
        for suffix in (".gz", ""):
            path = os.path.join(root, name + suffix)
            if os.path.exists(path):
                opener = gzip.open if suffix else open
                with opener(path, "rb") as f:
                    return f.read()
        raise FileNotFoundError(f"{name}[.gz] not under {root}")

    raw = read(f"{prefix}-images-idx3-ubyte")
    _, n, h, w = struct.unpack(">IIII", raw[:16])
    images = np.frombuffer(raw, np.uint8, offset=16).reshape(n, h, w).astype(np.float32)
    raw = read(f"{prefix}-labels-idx1-ubyte")
    (_, n2) = struct.unpack(">II", raw[:8])
    labels = np.frombuffer(raw, np.uint8, offset=8).astype(np.int32)
    assert n == n2
    return images, labels


def synthetic_digits(n: int, seed: int = 0, size: int = 28):
    """Procedural 10-class digit-like glyphs (stroke patterns + jitter) so the
    demo runs in images without MNIST files. Classes are visually distinct
    strokes, so a working SphereCNN separates them in a few hundred steps."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    templates = np.stack([
        ((0.2 < xx) & (xx < 0.8) & (0.2 < yy) & (yy < 0.35)),       # top bar
        ((0.2 < xx) & (xx < 0.8) & (0.65 < yy) & (yy < 0.8)),       # bottom bar
        ((0.2 < xx) & (xx < 0.35) & (0.2 < yy) & (yy < 0.8)),       # left bar
        ((0.65 < xx) & (xx < 0.8) & (0.2 < yy) & (yy < 0.8)),       # right bar
        (np.abs(xx - yy) < 0.12),                                   # diagonal
        (np.abs(xx + yy - 1) < 0.12),                               # anti-diagonal
        (np.abs(np.hypot(xx - 0.5, yy - 0.5) - 0.3) < 0.08),        # ring
        (np.hypot(xx - 0.5, yy - 0.5) < 0.22),                      # disk
        ((np.abs(xx - 0.5) < 0.08) | (np.abs(yy - 0.5) < 0.08)),    # cross
        ((np.abs(xx - 0.3) < 0.07) | (np.abs(xx - 0.7) < 0.07)),    # double bar
    ]).astype(np.float32) * 255.0
    labels = rng.integers(0, 10, n).astype(np.int32)
    images = templates[labels]
    # jitter: random shift up to +-3px and pixel noise
    out = np.zeros_like(images)
    for i in range(n):
        dy, dx = rng.integers(-3, 4, 2)
        out[i] = np.roll(np.roll(images[i], dy, 0), dx, 1)
    out += rng.normal(0, 12.0, out.shape).astype(np.float32)
    return np.clip(out, 0, 255), labels


class OmniDigits:
    """Omnidirectional classification dataset (OmniMNIST rebuilt for the
    card).

    Mirrors the reference's OmniDataset surface (GenProjector/models/networks/
    spherenet/dataset.py:73-155): each planar digit is gnomonically projected
    onto an equirectangular sphere with optional flip / horizontal roll /
    vertical rotation augmentation, `fix_aug` freezing the per-index draw.
    The projection runs batched on `device` (project_to_sphere; CUDA unless
    "cpu" is asked) instead of per-item scipy map_coordinates; the NumPy
    draws are the JAX package's, call for call.
    """

    def __init__(self, images, labels, fov: float = 120.0,
                 outshape: tuple[int, int] = (60, 60), flip: bool = False,
                 h_rotate: bool = False, v_rotate: bool = False,
                 fix_aug: bool = False, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.images = np.asarray(images, np.float32)
        self.labels = np.asarray(labels, np.int32)
        self.fov = float(fov)
        self.outshape = tuple(outshape)
        self.flip, self.h_rotate, self.v_rotate = flip, h_rotate, v_rotate
        self._rng = np.random.default_rng(seed)
        self.aug = None
        if fix_aug:
            self.aug = {
                "flip": self._rng.integers(0, 2, len(self.labels)) == 0,
                "h": self._rng.integers(0, self.outshape[1], len(self.labels)),
                "v": self._rng.uniform(-np.pi / 2, np.pi / 2, len(self.labels)),
            }

    def __len__(self):
        return len(self.labels)

    def batch(self, idx) -> tuple[np.ndarray, np.ndarray]:
        """Project digits idx -> ((B, oh, ow, 1) maps, (B,) labels)."""
        idx = np.asarray(idx)
        imgs = self.images[idx][..., None]
        n = len(idx)
        if self.v_rotate:
            v = self.aug["v"][idx] if self.aug is not None else (
                self._rng.uniform(-np.pi / 2, np.pi / 2, n))
        else:
            v = np.zeros(n)
        dev = self.device
        x = project_to_sphere(
            torch.from_numpy(np.ascontiguousarray(imgs)).to(dev),
            torch.as_tensor(v, dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev), out_h=self.outshape[0],
            out_w=self.outshape[1], fov_deg=self.fov,
        ).cpu().numpy()
        if self.flip:
            do = (self.aug["flip"][idx] if self.aug is not None
                  else self._rng.integers(0, 2, n) == 0)
            x[do] = x[do, :, ::-1]
        if self.h_rotate:
            dx = (self.aug["h"][idx] if self.aug is not None
                  else self._rng.integers(0, self.outshape[1], n))
            for i in range(n):
                x[i] = np.roll(x[i], int(dx[i]), axis=1)
        return x, self.labels[idx]

    def __getitem__(self, i: int):
        x, y = self.batch([int(i)])
        return x[0], int(y[0])
