"""VGG19 feature extractor for the perceptual loss.

Port of emlight_tpu/nn/vgg.py: the slicing of GenProjector/models/networks/
architecture.py:92-122 (relu1_1, relu2_1, relu3_1, relu4_1, relu5_1 at
torchvision feature indices 2/7/12/21/30) with loss weights 1/32..1
(loss.py:107).

Weights come as the JAX package's ``{"params": {"conv{i}": {"kernel",
"bias"}}}`` tree of NumPy arrays, kernels HWIO: ``load_vgg19_params`` reads
the npz that ``export_torchvision_weights`` writes (path via argument or
$EMLIGHT_VGG19_NPZ; None when absent), ``random_vgg19_params`` draws the
same He-normal bits as the JAX function for a seed. ``VGG19Features`` holds
them frozen (no dW is ever computed) as OIHW ``nn.Conv2d`` weights; its
convs run through cuDNN in float32 under PyTorch's process-wide TF32
setting, like the port's other cuDNN convs, whatever the run's --dtype
(the JAX package casts only the sphere convs).

Not ported: ``export_torchvision_weights``, which needs torchvision and a
download of the pretrained weights.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device

__all__ = ["VGG19Features", "load_vgg19_params", "random_vgg19_params", "vgg_perceptual_loss",
           "VGG_SLICE_WEIGHTS"]

# torchvision vgg19.features conv widths, in layer order
_WIDTHS = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512, 512, 512, 512]
# conv-count boundaries of the 5 slices (relu1_1/2_1/3_1/4_1/5_1 at
# torchvision feature idx 2/7/12/21/30)
_SLICE_CONVS = [1, 3, 5, 9, 13]  # number of convs consumed at each slice end
_POOL_AFTER_CONV = {2, 4, 8, 12}  # maxpool after these many convs consumed
VGG_SLICE_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


class VGG19Features(nn.Module):
    """The 13 convs up to relu5_1, frozen, on `device` (CUDA unless "cpu"
    is asked). Input NHWC in [0, +inf), the HDR range, with no
    normalisation (the reference feeds HDR env maps straight in,
    pix2pix_model.py:120); returns the 5 sliced feature maps, NHWC."""

    def __init__(self, variables: Mapping, device=None):
        super().__init__()
        params = variables["params"]
        cin = 3
        for i in range(_SLICE_CONVS[-1]):
            conv = torch.nn.utils.skip_init(nn.Conv2d, cin, _WIDTHS[i], 3, padding=1)
            with torch.no_grad():
                kernel = np.asarray(params[f"conv{i}"]["kernel"], np.float32)
                conv.weight.copy_(torch.tensor(kernel.transpose(3, 2, 0, 1)))
                conv.bias.copy_(torch.tensor(np.asarray(params[f"conv{i}"]["bias"], np.float32)))
            self.add_module(f"conv{i}", conv)
            cin = _WIDTHS[i]
        self.requires_grad_(False)
        # NHWC activations are channels_last NCHW: the weights too
        self.to(device=resolve_device(device), memory_format=torch.channels_last).eval()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)  # NHWC in memory: channels_last, no copy
        feats = []
        conv_i = 0
        for slice_end in _SLICE_CONVS:
            while conv_i < slice_end:
                x = F.relu(getattr(self, f"conv{conv_i}")(x))
                conv_i += 1
                if conv_i in _POOL_AFTER_CONV and conv_i < slice_end:
                    x = F.max_pool2d(x, 2, 2)
            feats.append(x.permute(0, 2, 3, 1))
        return feats


def vgg_perceptual_loss(vgg: VGG19Features, fake: torch.Tensor,
                        real: torch.Tensor) -> torch.Tensor:
    """Slice-weighted L1 between VGG19 features of fake and real.

    Real features are detached (computed without a graph), weights 1/32..1:
    the reference's VGGLoss (GenProjector/models/networks/loss.py:96-110).
    Multiply by lambda_vgg at the call site (pix2pix_model.py:120).
    """
    ff = vgg(fake)
    with torch.no_grad():
        fr = vgg(real)
    return sum(w * (a - b).abs().mean() for w, a, b in zip(VGG_SLICE_WEIGHTS, ff, fr))


def load_vgg19_params(path: str | None = None) -> dict | None:
    """{params} for VGG19Features from an npz (``conv{i}_kernel`` HWIO,
    ``conv{i}_bias``); None if unavailable."""
    path = path or os.environ.get("EMLIGHT_VGG19_NPZ")
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {"params": {f"conv{i}": {"kernel": data[f"conv{i}_kernel"],
                                        "bias": data[f"conv{i}_bias"]}
                           for i in range(_SLICE_CONVS[-1])}}  # only the convs the slices use


def random_vgg19_params(seed: int = 0) -> dict:
    """Random-init {params} with the pretrained layout and shapes: the JAX
    package's draws bit for bit (numpy ``default_rng(seed)``, He-normal over
    the fan-in, in layer order; zero biases).

    Perf-identical to pretrained weights (same graph, same FLOPs), so the
    GAN can be trained and timed WITH the reference's VGG x5 term where the
    torchvision weights do not exist; a random-feature L1 is a weaker
    perceptual proxy, and the reference's loss values will not match.
    """
    rng = np.random.default_rng(seed)
    params = {}
    cin = 3
    for i in range(_SLICE_CONVS[-1]):
        cout = _WIDTHS[i]
        std = float(np.sqrt(2.0 / (9 * cin)))
        params[f"conv{i}"] = {
            "kernel": rng.normal(0.0, std, (3, 3, cin, cout)).astype(np.float32),
            "bias": np.zeros((cout,), np.float32),
        }
        cin = cout
    return {"params": params}
