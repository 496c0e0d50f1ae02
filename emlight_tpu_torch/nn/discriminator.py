"""Multiscale PatchGAN discriminator built from sphere convs.

Port of emlight_tpu/nn/discriminator.py:22-60, with the same module names
(``discriminator_{i}.model{n}_conv``), on NHWC maps:
- NLayerDiscriminator: SphereConv (stride 2) + lrelu, then n_layers - 1
  spectral-normed, instance-normed SphereConvs (strides 2, 2, 1 at
  n_layers 4), and a final SphereConv to 3 channels; returns every
  intermediate activation for the feature-matching loss.
- MultiscaleDiscriminator: num_d copies; the input is downsampled by the
  3x3/s2 count-exclude average pool between scales.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import avg_pool_3x3s2, instance_norm
from .spade import SNSphereConv, _lrelu
from .sphere_conv import SphereConv2D

__all__ = ["NLayerDiscriminator", "MultiscaleDiscriminator"]


class NLayerDiscriminator(nn.Module):
    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 4,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.n_layers = n_layers
        self.model0_conv = SphereConv2D(in_channels, ndf, stride=2, **kw)
        nf = cin = ndf
        for n in range(1, n_layers):
            nf = min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            self.add_module(f"model{n}_conv",
                            SNSphereConv(cin, nf, stride=stride, use_bias=False, **kw))
            cin = nf
        self.add_module(f"model{n_layers}_conv", SphereConv2D(cin, 3, **kw))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = _lrelu(self.model0_conv(x))
        results = [h]
        for n in range(1, self.n_layers):
            h = _lrelu(instance_norm(getattr(self, f"model{n}_conv")(h)))
            results.append(h)
        results.append(getattr(self, f"model{self.n_layers}_conv")(h))
        return results


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, in_channels: int, ndf: int = 64, num_d: int = 2, n_layers: int = 4,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            self.add_module(f"discriminator_{i}",
                            NLayerDiscriminator(in_channels, ndf, n_layers, compute_dtype,
                                                generator))

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        out = []
        for i in range(self.num_d):
            out.append(getattr(self, f"discriminator_{i}")(x))
            if i != self.num_d - 1:
                x = avg_pool_3x3s2(x)
        return out
