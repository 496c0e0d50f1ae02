"""Torch oracles of the reference models, with the reference's exact
state_dict naming — fresh implementations of the architectures described in
RegressionNetwork/DenseNet.py:68-157 and GenProjector/models/networks/
(generator.py:17-126, discriminator.py:16-125, spherenet/sphere_cnn.py:31-124).

The port's own copy of emlight_tpu/train/torch_ref.py, independent of the
port's modules (it shares no code with nn/), so it can judge them. Used by
the checkpoint-parity harness (cli/verify_parity.py): a reference `.pth`
loads into these modules via `load_state_dict`, runs the reference math in
torch, and the outputs are compared against the imported port model. Three
changes from the JAX package's file, none of arithmetic: the classes are
defined at import (the port needs torch anyway); ``TSphereConv`` moves its
sampling grid to the input's device, so the oracle runs on the card; and
``reference_grid``'s per-pixel Python loop runs once per (h, w, stride) in
a process (``_reference_grid_np``), not once per conv.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import spectral_norm

__all__ = [
    "reference_grid",
    "build_torch_densenet",
    "randomize_densenet",
    "TSphereConv",
    "TSPADE",
    "TSPADEResnetBlock",
    "TEncoder",
    "TGenerator",
    "TNLayerD",
    "TMultiscaleD",
    "randomize",
]


def reference_grid(h, w, stride):
    """Reproduce the reference coordinate pipeline (sphere_cnn.py:31-84) in
    torch-ready normalized-grid form (fresh implementation of the formulas)."""
    return torch.from_numpy(_reference_grid_np(int(h), int(w), int(stride))).float()


@functools.lru_cache(maxsize=None)
def _reference_grid_np(h, w, stride):
    from numpy import sin, cos, tan, pi, arcsin, arctan

    def taps_for(img_r, img_c):
        phi = -((img_r + 0.5) / h * pi - pi / 2)
        theta = (img_c + 0.5) / w * 2 * pi - pi
        dp, dt = pi / h, 2 * pi / w
        out = np.zeros((3, 3, 2))
        for r, sy in enumerate((1, 0, -1)):
            for c, sx in enumerate((-1, 0, 1)):
                if r == 1 and c == 1:
                    out[r, c] = (img_r, img_c)
                    continue
                x = sx * tan(dt)
                y = sy * tan(dp) * (1 / cos(dt) if c != 1 else 1.0)
                if r == 1:
                    y = 0.0
                rho = np.sqrt(x * x + y * y)
                v = arctan(rho)
                nphi = arcsin(cos(v) * sin(phi) + y * sin(v) * cos(phi) / rho)
                ntheta = theta + arctan(
                    x * sin(v) / (rho * cos(phi) * cos(v) - y * sin(phi) * sin(v))
                )
                nr = (-nphi + pi / 2) * h / pi - 0.5
                nc = (ntheta + pi) * w / 2 / pi - 0.5
                nc = (nc + w) % w
                out[r, c] = (nr, nc)
        return out

    co = np.array([[taps_for(i, j) for j in range(0, w, stride)] for i in range(0, h, stride)])
    # (Ho, Wo, 3, 3, 2) -> normalized grid (1, Ho*3, Wo*3, 2[x,y])
    rr = co[..., 0] * 2 / h - 1
    cc = co[..., 1] * 2 / w - 1
    grid = np.stack([cc, rr], axis=-1)  # x first
    ho, wo = co.shape[:2]
    return grid.transpose(0, 2, 1, 3, 4).reshape(1, ho * 3, wo * 3, 2)


# --------------------------------------------------------------------------- #
# DenseNet regressor oracle (RegressionNetwork/DenseNet.py:68-157)
# --------------------------------------------------------------------------- #

def build_torch_densenet(block_config=(16, 16, 16), growth=12, init=24,
                         n_anchors=96, pooled_hw=(6, 8)):
    """Torch DenseNet with the reference's exact child names/order
    (norm1,relu,conv1,norm2,conv2 — no second relu). Returns a module whose
    `.fwd(x_nchw)` runs the reference forward and returns the 4-head dict."""
    class _TLayer(nn.Module):
        def __init__(self, cin):
            super().__init__()
            self.norm1 = nn.BatchNorm2d(cin)
            self.conv1 = nn.Conv2d(cin, 4 * growth, 1, bias=False)
            self.norm2 = nn.BatchNorm2d(4 * growth)
            self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

        def forward(self, x):
            h = self.conv1(torch.relu(self.norm1(x)))
            h = self.conv2(self.norm2(h))
            return torch.cat([x, h], 1)

    class _TTransition(nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.norm = nn.BatchNorm2d(cin)
            self.conv = nn.Conv2d(cin, cout, 1, bias=False)

        def forward(self, x):
            return nn.functional.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2)

    feats = nn.Module()
    feats.conv0 = nn.Conv2d(3, init, 3, padding=1, bias=False)
    feats.norm0 = nn.BatchNorm2d(init)
    c = init
    for i, n_layers in enumerate(block_config, start=1):
        block = nn.Module()
        for j in range(1, n_layers + 1):
            setattr(block, f"denselayer{j}", _TLayer(c))
            c += growth
        setattr(feats, f"denseblock{i}", block)
        cout = c // 2
        setattr(feats, f"transition{i}", _TTransition(c, cout))
        c = cout
        setattr(feats, f"last_norm{i}", nn.BatchNorm2d(c))

    model = nn.Module()
    model.features = feats
    ph, pw = pooled_hw
    model.fc = nn.Linear(c * ph * pw, 1024)
    model.fc_dist = nn.Linear(1024, n_anchors)
    model.fc_intensity = nn.Linear(1024, 1)
    model.fc_rgb_ratio = nn.Linear(1024, 3)
    model.fc_ambient = nn.Linear(1024, 3)

    def fwd(x):
        h = torch.relu(feats.norm0(feats.conv0(x)))
        for i in range(1, len(block_config) + 1):
            block = getattr(feats, f"denseblock{i}")
            for j in range(1, len(list(block.children())) + 1):
                h = getattr(block, f"denselayer{j}")(h)
            h = getattr(feats, f"transition{i}")(h)
            h = getattr(feats, f"last_norm{i}")(h)
        h = torch.relu(h)
        h = nn.functional.avg_pool2d(h, 4).reshape(h.shape[0], -1)
        h = model.fc(h)
        return {
            "distribution": model.fc_dist(h),
            "intensity": model.fc_intensity(h),
            "rgb_ratio": model.fc_rgb_ratio(h),
            "ambient": model.fc_ambient(h),
        }

    model.fwd = fwd
    return model


def randomize_densenet(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)


# --------------------------------------------------------------------------- #
# SPADE generator / multiscale discriminator oracle (GenProjector)
# --------------------------------------------------------------------------- #

class TSphereConv(nn.Module):
    """grid_sample-based sphere conv (sphere_cnn.py:87-124 semantics)."""

    def __init__(self, cin, cout, stride=1, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, 3, 3) * 0.1)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride
        self._grids = {}

    def forward(self, x):
        key = tuple(x.shape[2:4])
        if key not in self._grids:
            self._grids[key] = reference_grid(x.shape[2], x.shape[3], self.stride)
        grid = self._grids[key].to(x.device, x.dtype).repeat(x.shape[0], 1, 1, 1)
        r = F.grid_sample(x, grid, mode="bilinear", align_corners=False)
        return F.conv2d(r, self.weight, self.bias, stride=3)

class TSPADE(nn.Module):
    def __init__(self, norm_nc, label_nc, nhidden=128):
        super().__init__()
        self.param_free_norm = nn.BatchNorm2d(norm_nc, affine=False)
        self.mlp_shared = nn.Sequential(TSphereConv(label_nc, nhidden), nn.ReLU())
        self.mlp_gamma = TSphereConv(nhidden, norm_nc)
        self.mlp_beta = TSphereConv(nhidden, norm_nc)

    def forward(self, x, segmap):
        normalized = self.param_free_norm(x)
        seg = F.interpolate(segmap, size=x.shape[2:], mode="nearest")
        a = self.mlp_shared(seg)
        return normalized * (1 + self.mlp_gamma(a)) + self.mlp_beta(a)

class TSPADEResnetBlock(nn.Module):
    def __init__(self, fin, fout, label_nc=3):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = spectral_norm(TSphereConv(fin, fmiddle))
        self.conv_1 = spectral_norm(TSphereConv(fmiddle, fout))
        self.norm_0 = TSPADE(fin, label_nc)
        self.norm_1 = TSPADE(fmiddle, label_nc)
        if self.learned_shortcut:
            self.conv_s = spectral_norm(TSphereConv(fin, fout))
            self.norm_s = TSPADE(fin, label_nc)

    def forward(self, x, seg):
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return xs + dx

class TEncoder(nn.Module):
    def __init__(self, ndf):
        super().__init__()
        widths = [(3, ndf), (ndf, ndf * 2), (ndf * 2, ndf * 4),
                  (ndf * 4, ndf * 8), (ndf * 8, ndf * 8)]
        for i, (ci, co) in enumerate(widths, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                spectral_norm(nn.Conv2d(ci, co, 3, stride=2, padding=1, bias=False)),
                nn.InstanceNorm2d(co, affine=False),
            ))
        self.fc = nn.Linear(ndf * 8 * 4 * 4, 16 * ndf * 2 * 1)

    def forward(self, x):
        x = F.interpolate(x, size=(128, 128), mode="bilinear")
        x = self.layer1(x)
        for i in range(2, 6):
            x = getattr(self, f"layer{i}")(F.leaky_relu(x, 0.2))
        x = F.leaky_relu(x, 0.2)
        return self.fc(x.reshape(x.shape[0], -1))

class TGenerator(nn.Module):
    def __init__(self, ngf=64, crop_size=256):
        super().__init__()
        nf = ngf
        self.nf = nf
        self.sw = crop_size // 32
        self.sh = round(self.sw / 2.0)
        self.head_0 = TSPADEResnetBlock(16 * nf, 16 * nf)
        self.G_middle_0 = TSPADEResnetBlock(16 * nf, 16 * nf)
        self.G_middle_1 = TSPADEResnetBlock(16 * nf, 16 * nf)
        self.up_0 = TSPADEResnetBlock(16 * nf, 8 * nf)
        self.up_1 = TSPADEResnetBlock(8 * nf, 4 * nf)
        self.up_2 = TSPADEResnetBlock(4 * nf, 2 * nf)
        self.up_3 = TSPADEResnetBlock(2 * nf, 1 * nf)
        self.sphere_conv1 = TSphereConv(nf, 3)
        self.netE = TEncoder(nf)

    def forward(self, guide, crop):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        x = self.netE(crop).view(-1, 16 * self.nf, 1, 2)
        x = F.interpolate(x, size=(self.sh, self.sw), mode="nearest")
        x = self.head_0(x, guide)
        x = up(x)
        x = self.G_middle_0(x, guide)
        x = self.G_middle_1(x, guide)
        x = up(x)
        x = self.up_0(x, guide)
        x = up(x)
        x = self.up_1(x, guide)
        x = up(x)
        x = self.up_2(x, guide)
        x = up(x)
        x = self.up_3(x, guide)
        x = self.sphere_conv1(F.leaky_relu(x, 0.2))
        return (torch.tanh(x) + 1) * 25

class TNLayerD(nn.Module):
    def __init__(self, ndf=64, n_layers=4, input_nc=6):
        super().__init__()
        self.n_layers = n_layers
        self.model0 = nn.Sequential(TSphereConv(input_nc, ndf, stride=2),
                                    nn.LeakyReLU(0.2, False))
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            setattr(self, f"model{n}", nn.Sequential(
                nn.Sequential(
                    spectral_norm(TSphereConv(prev, nf, stride=stride, bias=False)),
                    nn.InstanceNorm2d(nf, affine=False),
                ),
                nn.LeakyReLU(0.2, False),
            ))
        setattr(self, f"model{n_layers}", nn.Sequential(TSphereConv(nf, 3)))

    def forward(self, x):
        results = []
        h = x
        for n in range(self.n_layers + 1):
            h = getattr(self, f"model{n}")(h)
            results.append(h)
        return results

class TMultiscaleD(nn.Module):
    def __init__(self, ndf=64, num_d=2, n_layers=4, input_nc=6):
        super().__init__()
        for i in range(num_d):
            setattr(self, f"discriminator_{i}", TNLayerD(ndf, n_layers, input_nc))
        self.num_d = num_d

    def forward(self, x):
        out = []
        for i in range(self.num_d):
            out.append(getattr(self, f"discriminator_{i}")(x))
            if i != self.num_d - 1:
                x = F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)
        return out


def randomize(model, seed=0, scale=0.1):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.5 + 0.75)
    # settle spectral u/v with a few power iterations (training-mode
    # forwards would do this; converged u makes eval sigma deterministic)
    for m in model.modules():
        for hook in m._forward_pre_hooks.values():
            if hook.__class__.__name__ == "SpectralNorm":
                for _ in range(20):
                    hook.compute_weight(m, do_power_iteration=True)
