"""DenseNet-BC regression backbone (EMLight stage 1), eval and train forward.

Port of emlight_tpu/nn/densenet.py in the standard formulation: growth 12,
blocks (16, 16, 16), compression 0.5, 24 init features, bn_size 4, a
transition + trailing BatchNorm after EVERY block, global 4x4 avg-pool,
fc -> 1024 and four linear heads. Kept quirk of the reference: no ReLU
between a dense layer's norm2 and conv2.

BatchNorm is flax's (nn/layers.py::BatchNorm): in train mode it normalizes
with the batch's moments and keeps the BIASED variance in its running
statistics. The train forward (``.train()``) is the standard graph under
autograd with one fused step: each dense layer's norm2 -> conv2 runs as
``fused_affine_conv3x3(h1, A, B, conv2)`` (kernels B7, B7', B8 on the card)
with A = scale * rsqrt(var + eps) and B = bias - mean * A from h1's batch
moments, through which autograd carries da and db back to h1. It runs in the
channels_last memory format, so the fused conv reads h1 as NHWC without a
copy. The eval forward (``.eval()``) uses the running statistics and cuDNN
convs throughout. The concat-free forwards the JAX package runs by default
are nn/densenet_fast.py; they read this module's parameters.

- ``dtype``: the compute dtype (flax's), parameters stay float32: convs and
  the fc take their operands in ``dtype``, BatchNorm computes its moments in
  float32 and rounds its output to ``dtype``, and the four heads run in
  float32 after the fc.
- ``remat``: in the train forward each dense layer runs under
  ``torch.utils.checkpoint`` (the JAX package's ``nn.remat(_DenseLayer)``):
  its activations are recomputed in the backward. The running statistics
  are updated once, outside the recomputed region.
- ``fold_bn``: the eval-only layer of ``fold_eval_variables``: norm2 folded
  into conv2's kernel and a bias; conv2 pads its input with ``conv2_pad``
  (norm2's preimage of zero, per channel) and runs VALID.

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
from torch.utils.checkpoint import checkpoint

from .dense_conv import fused_affine_conv3x3
from .layers import BatchNorm, dense

__all__ = ["DenseNet", "fold_eval_variables"]

# output name -> head module
_HEADS = (("distribution", "fc_dist"), ("intensity", "fc_intensity"),
          ("rgb_ratio", "fc_rgb_ratio"), ("ambient", "fc_ambient"))


def _conv(cin: int, cout: int, k: int, generator: torch.Generator | None) -> nn.Conv2d:
    """Bias-free conv with the JAX package's init (lecun normal)."""
    conv = nn.Conv2d(cin, cout, k, padding=(k - 1) // 2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(cout, cin, k, k, generator=generator)
                          / math.sqrt(cin * k * k))
    return conv


def _bn(c: int, dtype: torch.dtype, group=None) -> BatchNorm:
    """flax BatchNorm with scale and bias on NCHW, under nn.BatchNorm2d's
    state-dict names (the weight bridge fills them); synced over `group`."""
    return BatchNorm(c, channel_dim=1, affine=True, torch_names=True, dtype=dtype, group=group)


def _conv_in(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """conv(x) with the weight (and bias) cast to x's dtype, as flax's Conv
    computes in its dtype with float32 parameters."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, padding=conv.padding)


def heads_f32(model: "DenseNet", x: torch.Tensor) -> dict[str, torch.Tensor]:
    """The four heads on the fc's output, in float32 (in float64 for a
    float64 model: the features are rounded to float32 first either way, as
    the JAX package computes them). Each head reads its own cast of the
    rounded features, as each of JAX's promotes them apart, so each head's
    cotangent is rounded to float32 before the four are summed, in JAX's
    order."""
    x = x.to(torch.float32)
    dt = model.fc_dist.weight.dtype
    return {name: getattr(model, mod)(x.to(dt)) for name, mod in _HEADS}


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int,
                 generator: torch.Generator | None, dtype: torch.dtype,
                 fold_bn: bool = False, group=None):
        super().__init__()
        self.remat = False
        self.norm1 = _bn(cin, dtype, group)
        self.conv1 = _conv(cin, bn_size * growth_rate, 1, generator)
        if fold_bn:
            self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=0, bias=True)
            self.conv2_pad = nn.Parameter(torch.zeros(bn_size * growth_rate))
        else:
            self.norm2 = _bn(bn_size * growth_rate, dtype, group)
            self.conv2 = _conv(bn_size * growth_rate, growth_rate, 3, generator)

    def _train_body(self, x: torch.Tensor):
        """The train forward and the batch moments it normalized with:
        (out, mean1, var1, mean2, var2); the running statistics are left to
        the caller."""
        m1, v1 = self.norm1.moments(x)
        h = _conv_in(F.relu(self.norm1.normalize(x, m1, v1)), self.conv1)
        m2, v2 = self.norm2.moments(h)
        a, b = self.norm2.affine(m2, v2)
        # no ReLU between norm2 and conv2 (reference layer order)
        h = fused_affine_conv3x3(h.permute(0, 2, 3, 1), a, b,
                                 self.conv2.weight.permute(2, 3, 1, 0)).permute(0, 3, 1, 2)
        return torch.cat([x, h.to(x.dtype)], dim=1), m1, v1, m2, v2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if self.remat:
                out, m1, v1, m2, v2 = checkpoint(self._train_body, x, use_reentrant=False)
            else:
                out, m1, v1, m2, v2 = self._train_body(x)
            self.norm1.update_running(m1.detach(), v1.detach())
            self.norm2.update_running(m2.detach(), v2.detach())
            return out
        h = _conv_in(F.relu(self.norm1(x)), self.conv1)
        if hasattr(self, "conv2_pad"):
            # conv2 zero-padded its input after norm2: the folded conv pads
            # with norm2's preimage of zero and runs VALID
            bsz, c, hh, ww = h.shape
            pad = self.conv2_pad.to(h.dtype)[None, :, None, None]
            row = pad.expand(bsz, c, 1, ww)
            hv = torch.cat([row, h, row], dim=2)
            col = pad.expand(bsz, c, hh + 2, 1)
            h = _conv_in(torch.cat([col, hv, col], dim=3), self.conv2)
        else:
            h = _conv_in(self.norm2(h), self.conv2)
        return torch.cat([x, h.to(x.dtype)], dim=1)


class _Transition(nn.Module):
    def __init__(self, cin: int, cout: int, generator: torch.Generator | None,
                 dtype: torch.dtype, group=None):
        super().__init__()
        self.norm = _bn(cin, dtype, group)
        self.conv = _conv(cin, cout, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(_conv_in(F.relu(self.norm(x)), self.conv), 2)


class DenseNet(nn.Module):
    """crop (B, H, W, 3) -> {distribution, intensity, rgb_ratio, ambient}.

    ``input_hw`` fixes the fc width: the default 192x256 crop gives the
    reference's 8208-dim pooled feature vector (6 x 8 x 171). ``group``
    (a dist/mesh.py RankGroup) syncs every BatchNorm over the ranks in
    training (the JAX DenseNet's ``axis_name``); nn/densenet_fast.py's
    train forward reads it too.
    """

    def __init__(self, growth_rate: int = 12, block_config: Sequence[int] = (16, 16, 16),
                 compression: float = 0.5, num_init_features: int = 24, bn_size: int = 4,
                 avgpool_size: int = 4, n_anchors: int = 96,
                 input_hw: tuple[int, int] = (192, 256),
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 fold_bn: bool = False, group=None):
        super().__init__()
        self.group = group
        self.block_config = tuple(block_config)
        self.growth_rate = growth_rate
        self.num_init_features = num_init_features
        self.compression = compression
        self.avgpool_size = avgpool_size
        self.dtype = dtype
        self.fold_bn = fold_bn
        self.conv0 = _conv(3, num_init_features, 3, generator)
        self.norm0 = _bn(num_init_features, dtype, group)
        num_features = num_init_features
        h, w = input_hw
        for i, num_layers in enumerate(self.block_config, start=1):
            for j in range(1, num_layers + 1):
                cin = num_features + (j - 1) * growth_rate
                self.add_module(f"denseblock{i}_denselayer{j}",
                                _DenseLayer(cin, growth_rate, bn_size, generator, dtype, fold_bn,
                                            group))
            cin = num_features + num_layers * growth_rate
            num_features = int(math.floor(cin * compression))
            self.add_module(f"transition{i}", _Transition(cin, num_features, generator, dtype,
                                                          group))
            self.add_module(f"last_norm{i}", _bn(num_features, dtype, group))
            h, w = h // 2, w // 2
        h, w = h // avgpool_size, w // avgpool_size
        self.fc = dense(h * w * num_features, 1024, generator)
        self.fc_dist = dense(1024, n_anchors, generator)
        self.fc_intensity = dense(1024, 1, generator)
        self.fc_rgb_ratio = dense(1024, 3, generator)
        self.fc_ambient = dense(1024, 3, generator)
        for m in self.modules():
            if isinstance(m, _DenseLayer):
                m.remat = remat

    def dense_layer(self, i: int, j: int) -> _DenseLayer:
        return getattr(self, f"denseblock{i}_denselayer{j}")

    def forward(self, crop: torch.Tensor) -> dict[str, torch.Tensor]:
        if self.fold_bn and self.training:
            raise RuntimeError("fold_bn is an eval-only transform")
        layout = torch.channels_last if self.training else torch.contiguous_format
        x = crop.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=layout)
        x = F.relu(self.norm0(_conv_in(x, self.conv0)))
        for i, num_layers in enumerate(self.block_config, start=1):
            for j in range(1, num_layers + 1):
                x = self.dense_layer(i, j)(x)
            x = getattr(self, f"last_norm{i}")(getattr(self, f"transition{i}")(x))
        x = F.avg_pool2d(F.relu(x), self.avgpool_size)
        x = x.permute(0, 2, 3, 1).flatten(1)  # H, W, C flatten
        x = F.linear(x, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))
        return heads_f32(self, x)


@torch.no_grad()
def fold_eval_variables(state: dict[str, torch.Tensor],
                        eps: float = 1e-5) -> dict[str, torch.Tensor]:
    """Fold every dense layer's norm2 into its conv2, for
    ``DenseNet(fold_bn=True)``: a state_dict of the standard model -> the
    folded model's (emlight_tpu/nn/densenet.py::fold_eval_variables).

    norm2 -> conv2 has no nonlinearity between them, so in eval mode
    conv2(norm2(h)) == conv2'(h) with the BN affine a*h + b absorbed into the
    kernel (K * a per input channel) plus a bias (sum of K * b), exact up to
    float reassociation. conv2 zero-pads AFTER norm2, so the folded conv pads
    h with ``conv2_pad`` = -b/a per channel and runs VALID. A channel with
    |a| < 1e-12 * max|a| (a decayed BN scale) would make -b/a explode and
    the border taps cancel catastrophically: its kernel column and its pad
    are zeroed, which folds it to the exact constant b through the bias.
    """
    out = dict(state)
    layers = sorted({k.rsplit(".norm2.", 1)[0] for k in state
                     if "_denselayer" in k and ".norm2." in k})
    for name in layers:
        n2 = f"{name}.norm2."
        a = state[n2 + "weight"] / torch.sqrt(state[n2 + "running_var"] + eps)
        b = state[n2 + "bias"] - state[n2 + "running_mean"] * a
        tiny = a.abs() < 1e-12 * a.abs().max()
        a_safe = torch.where(tiny, torch.zeros_like(a), a)
        k = state[f"{name}.conv2.weight"]  # (cout, cin, 3, 3)
        out[f"{name}.conv2.weight"] = k * a_safe[None, :, None, None]
        out[f"{name}.conv2.bias"] = torch.einsum("oihw,i->o", k, b)
        out[f"{name}.conv2_pad"] = torch.where(
            tiny, torch.zeros_like(a), -b / torch.where(tiny, torch.ones_like(a), a_safe))
        for key in [k_ for k_ in out if k_.startswith(n2)]:
            del out[key]
    return out
