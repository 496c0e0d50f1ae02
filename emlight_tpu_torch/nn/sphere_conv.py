"""Distortion-aware spherical convolution on equirectangular feature maps.

Port of emlight_tpu/nn/sphere_conv.py. The sample locations of the 3x3
gnomonic kernel depend only on (h, w, stride), so the bilinear taps are
precomputed in NumPy into flat gather indices + weights (one table per shape,
cached); the conv is 9 accumulated [weighted 4-neighbour gather -> (P, Cin) x
(Cin, Cout) matmul] steps.

Two implementations of one function:
- ``sphere_conv_plain``: the gather formulation in plain PyTorch. It serves
  CPU tensors and is the oracle the CUDA kernel is checked against.
- ``nn/sphere_conv_kernel.py``: the hand-written stride-1 CUDA kernel.

``sphere_conv`` dispatches on the tensor's device: a CUDA tensor takes the
kernel (every stride-1 conv, at every resolution) or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

__all__ = ["SphereConv2D", "sphere_taps", "sphere_conv_plain", "sphere_conv"]


@functools.lru_cache(maxsize=None)
def _kernel_offsets(delta_phi: float, delta_theta: float) -> np.ndarray:
    """Tangent-plane offsets (x, y) of the 3x3 kernel (sphere_cnn.py:10-28)."""
    tp, tt = np.tan(delta_phi), np.tan(delta_theta)
    ct = np.cos(delta_theta)
    ys = np.array([tp, 0.0, -tp])
    xs = np.array([-tt, 0.0, tt])
    off = np.zeros((3, 3, 2))
    for r in range(3):
        for c in range(3):
            y = ys[r] / (ct if c != 1 else 1.0)
            off[r, c] = (xs[c], y)
    # middle-center is the identity tap; the reference stores (1,1) there but
    # overwrites the result with the source pixel anyway (sphere_cnn.py:57)
    off[1, 1] = (1.0, 1.0)
    return off


@functools.lru_cache(maxsize=None)
def sphere_taps(h: int, w: int, stride: int = 1):
    """Precompute gather indices/weights for all output pixels.

    Returns (idx, wgt, (ho, wo)): int32/float32 arrays of shape (Ho*Wo, 9, 4)
    — four bilinear neighbours per gnomonic tap, as flat indices into (h*w).
    Weights are zeroed for out-of-image rows/columns (grid_sample zero
    padding).
    """
    rows = np.arange(0, h, stride)
    cols = np.arange(0, w, stride)
    i, j = np.meshgrid(rows, cols, indexing="ij")  # (Ho, Wo)
    phi = -((i + 0.5) / h * np.pi - np.pi / 2)  # latitude
    theta = (j + 0.5) / w * 2 * np.pi - np.pi  # longitude

    off = _kernel_offsets(np.pi / h, 2 * np.pi / w)  # (3, 3, 2)
    x = off[..., 0].reshape(9, 1, 1)
    y = off[..., 1].reshape(9, 1, 1)
    rho = np.sqrt(x * x + y * y)
    v = np.arctan(rho)
    with np.errstate(invalid="ignore", divide="ignore"):
        arg = np.cos(v) * np.sin(phi) + y * np.sin(v) * np.cos(phi) / rho
        new_phi = np.arcsin(np.clip(arg, -1.0, 1.0))
        new_theta = theta + np.arctan(
            x * np.sin(v) / (rho * np.cos(phi) * np.cos(v) - y * np.sin(phi) * np.sin(v))
        )
    new_r = (-new_phi + np.pi / 2) * h / np.pi - 0.5
    new_c = (new_theta + np.pi) * w / (2 * np.pi) - 0.5
    new_c = (new_c + w) % w  # equirect wraparound (sphere_cnn.py:54-55)
    # center tap = source pixel exactly (sphere_cnn.py:57)
    new_r[4] = i
    new_c[4] = j

    # grid_sample align_corners=False: pixel position = coordinate - 0.5
    pr = new_r - 0.5
    pc = new_c - 0.5
    r0 = np.floor(pr)
    c0 = np.floor(pc)
    fr = pr - r0
    fc = pc - c0

    idx = np.zeros((9,) + i.shape + (4,), dtype=np.int64)
    wgt = np.zeros((9,) + i.shape + (4,), dtype=np.float32)
    for k, (dr, dc) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        rr = r0 + dr
        cc = c0 + dc
        wq = (fr if dr else 1 - fr) * (fc if dc else 1 - fc)
        valid = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
        idx[..., k] = np.clip(rr, 0, h - 1) * w + np.clip(cc, 0, w - 1)
        wgt[..., k] = wq * valid

    ho, wo = i.shape
    idx = idx.transpose(1, 2, 0, 3).reshape(ho * wo, 9, 4).astype(np.int32)
    wgt = wgt.transpose(1, 2, 0, 3).reshape(ho * wo, 9, 4)
    return idx, wgt, (ho, wo)


@functools.lru_cache(maxsize=None)
def _taps_on(h: int, w: int, stride: int, device: str):
    """sphere_taps as (9, P, 4) tensors on `device`, copied once per shape."""
    idx, wgt, _ = sphere_taps(h, w, stride)
    idx_t = torch.from_numpy(idx.transpose(1, 0, 2).astype(np.int64)).to(device)
    wgt_t = torch.from_numpy(np.ascontiguousarray(wgt.transpose(1, 0, 2))).to(device)
    return idx_t, wgt_t


def sphere_conv_plain(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor | None = None, stride: int = 1) -> torch.Tensor:
    """The gather formulation in plain PyTorch (no dispatch).

    x: (B, H, W, Cin) float32 or bfloat16; kernel (3, 3, Cin, Cout) HWIO;
    bias (Cout,) or None. Returns (B, Ho, Wo, Cout) float32.

    Numerics, shared with the CUDA kernel: inputs are read in their own dtype
    and converted to f32; the 4-neighbour bilinear sum is taken in f32 and
    rounded once to the input dtype (the staged operand of the matmul); the
    9 per-tap matmuls accumulate in f32. For f32 inputs this is exactly the
    arithmetic of emlight_tpu's sphere_conv_gather.
    """
    b, h, w, cin = x.shape
    _, _, (ho, wo) = sphere_taps(h, w, stride)
    idx_t, wgt_t = _taps_on(h, w, stride, str(x.device))
    dt = x.dtype
    xf = x.reshape(b, h * w, cin).float()
    kflat = kernel.reshape(9, cin, -1).to(dt).float()
    out = torch.zeros(b, ho * wo, kflat.shape[-1], dtype=torch.float32, device=x.device)
    for t in range(9):
        s = 0.0
        for k in range(4):
            s = s + xf[:, idx_t[t, :, k]] * wgt_t[t, :, k][None, :, None]
        out = out + torch.matmul(s.to(dt).float(), kflat[t])
    if bias is not None:
        out = out + bias.float()
    return out.reshape(b, ho, wo, -1)


def sphere_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None,
                stride: int = 1) -> torch.Tensor:
    """Sphere conv dispatched on the tensor's device.

    Stride 1 goes through the kernel wrapper, which takes the CUDA kernel for
    a CUDA tensor (at every resolution: no pixel gate) and the plain version
    for a CPU tensor. Stride 2 has no kernel yet: plain on the CPU, an error
    on CUDA.
    """
    if stride == 1:
        from .sphere_conv_kernel import sphere_conv_s1

        return sphere_conv_s1(x, kernel, bias)
    if x.is_cuda:
        raise NotImplementedError("stride-2 sphere conv kernel (B2) not ported yet")
    return sphere_conv_plain(x, kernel, bias, stride)


class SphereConv2D(nn.Module):
    """3x3 distortion-aware conv on NHWC maps; kernel kept in HWIO layout
    (3, 3, Cin, Cout), which the kernel consumes as (9, Cin, Cout)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 use_bias: bool = True, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        self.compute_dtype = compute_dtype
        # kaiming_uniform(a=sqrt(5)) bound over fan_in = 9*cin (sphere_cnn.py:107-109)
        bound = float(np.sqrt(6.0 / ((1 + 5) * 9 * in_channels)))
        kernel = torch.empty(3, 3, in_channels, features)
        kernel.uniform_(-bound, bound, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        # x may be a channel slice of a fused conv's output: the kernel reads
        # a dense NHWC block
        return sphere_conv(x.to(cdt).contiguous(), self.kernel.to(cdt), self.bias, self.stride)
