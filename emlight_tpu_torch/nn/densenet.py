"""DenseNet-BC regression backbone (EMLight stage 1), eval forward.

Port of emlight_tpu/nn/densenet.py:32-179 in the standard formulation:
growth 12, blocks (16, 16, 16), compression 0.5, 24 init features, bn_size 4,
a transition + trailing BatchNorm after EVERY block, global 4x4 avg-pool,
fc -> 1024 and four linear heads. Kept quirk of the reference: no ReLU
between a dense layer's norm2 and conv2.

Module names follow the JAX tree (``denseblock{i}_denselayer{j}``,
``transition{i}``, ``last_norm{i}``), so train/jax_weights.py maps parameters
one to one. Internally NCHW; the input is an NHWC crop and the pooled
features are flattened in H, W, C order, as the JAX package flattens them, so
the fc weight needs no permutation.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dense

__all__ = ["DenseNet"]


def _conv(cin: int, cout: int, k: int, generator: torch.Generator | None) -> nn.Conv2d:
    """Bias-free conv with the JAX package's init (lecun normal)."""
    conv = nn.Conv2d(cin, cout, k, padding=(k - 1) // 2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(cout, cin, k, k, generator=generator)
                          / math.sqrt(cin * k * k))
    return conv


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int,
                 generator: torch.Generator | None):
        super().__init__()
        self.norm1 = _bn(cin)
        self.conv1 = _conv(cin, bn_size * growth_rate, 1, generator)
        self.norm2 = _bn(bn_size * growth_rate)
        self.conv2 = _conv(bn_size * growth_rate, growth_rate, 3, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(self.norm2(h))  # no ReLU here (reference layer order)
        return torch.cat([x, h], dim=1)


class _Transition(nn.Module):
    def __init__(self, cin: int, cout: int, generator: torch.Generator | None):
        super().__init__()
        self.norm = _bn(cin)
        self.conv = _conv(cin, cout, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2)


class DenseNet(nn.Module):
    """crop (B, H, W, 3) -> {distribution, intensity, rgb_ratio, ambient}.

    ``input_hw`` fixes the fc width: the default 192x256 crop gives the
    reference's 8208-dim pooled feature vector (6 x 8 x 171).
    """

    def __init__(self, growth_rate: int = 12, block_config: Sequence[int] = (16, 16, 16),
                 compression: float = 0.5, num_init_features: int = 24, bn_size: int = 4,
                 avgpool_size: int = 4, n_anchors: int = 96,
                 input_hw: tuple[int, int] = (192, 256),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.block_config = tuple(block_config)
        self.avgpool_size = avgpool_size
        self.conv0 = _conv(3, num_init_features, 3, generator)
        self.norm0 = _bn(num_init_features)
        num_features = num_init_features
        h, w = input_hw
        for i, num_layers in enumerate(self.block_config, start=1):
            for j in range(1, num_layers + 1):
                cin = num_features + (j - 1) * growth_rate
                self.add_module(f"denseblock{i}_denselayer{j}",
                                _DenseLayer(cin, growth_rate, bn_size, generator))
            cin = num_features + num_layers * growth_rate
            num_features = int(math.floor(cin * compression))
            self.add_module(f"transition{i}", _Transition(cin, num_features, generator))
            self.add_module(f"last_norm{i}", _bn(num_features))
            h, w = h // 2, w // 2
        h, w = h // avgpool_size, w // avgpool_size
        self.fc = dense(h * w * num_features, 1024, generator)
        self.fc_dist = dense(1024, n_anchors, generator)
        self.fc_intensity = dense(1024, 1, generator)
        self.fc_rgb_ratio = dense(1024, 3, generator)
        self.fc_ambient = dense(1024, 3, generator)

    def forward(self, crop: torch.Tensor) -> dict[str, torch.Tensor]:
        x = crop.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.norm0(self.conv0(x)))
        for i, num_layers in enumerate(self.block_config, start=1):
            for j in range(1, num_layers + 1):
                x = getattr(self, f"denseblock{i}_denselayer{j}")(x)
            x = getattr(self, f"last_norm{i}")(getattr(self, f"transition{i}")(x))
        x = F.avg_pool2d(F.relu(x), self.avgpool_size)
        x = self.fc(x.permute(0, 2, 3, 1).flatten(1))  # H, W, C flatten
        return {
            "distribution": self.fc_dist(x),
            "intensity": self.fc_intensity(x),
            "rgb_ratio": self.fc_rgb_ratio(x),
            "ambient": self.fc_ambient(x),
        }
