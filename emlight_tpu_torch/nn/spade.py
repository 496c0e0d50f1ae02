"""SPADE generator stack (EMLight stage 2 / GenProjector).

Port of emlight_tpu/nn/spade.py. Module and parameter names follow the JAX
tree (train/jax_weights.py maps one onto the other); activations are NHWC,
the layout the sphere-conv kernel takes. Sphere-conv kernels stay HWIO
(3, 3, Cin, Cout); SNConv keeps an OIHW ``weight`` for F.conv2d.

As in the JAX package, each SPADEResnetBlock runs ONE fused ``mlp_shared``
sphere conv for all of its norms (same resized guide, independent output
channels) and each SPADE one fused ``mlp_gammabeta`` conv with 2C outputs.

Train mode (``.train()``) follows torch's and the JAX package's state
dynamics: every forward updates the BatchNorm running statistics and the
spectral-norm vectors u, v in place (emlight_tpu/train/projector.py:15-17).
Eval mode uses the running statistics and the stored u, v verbatim.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (
    BatchNorm,
    dense,
    instance_norm,
    l2_normalize,
    resize_bilinear,
    resize_nearest,
    spectral_normalize,
    spectral_power_iteration,
)
from .sphere_conv import SphereConv2D, sphere_conv

__all__ = ["SNConv", "SNSphereConv", "SPADE", "SPADEResnetBlock", "ConvEncoder",
           "SPADEGenerator"]


def _register_uv(module: nn.Module, kernel_hwio: torch.Tensor,
                 generator: torch.Generator | None) -> None:
    """Spectral-norm vectors u (out,) and v (rest,) as buffers, initialised
    like the JAX package: u random, v = normalize(W^T u)."""
    out = kernel_hwio.shape[-1]
    u = l2_normalize(torch.randn(out, generator=generator))
    v = l2_normalize(kernel_hwio.detach().reshape(-1, out) @ u)
    module.register_buffer("u", u)
    module.register_buffer("v", v)


def _sn_kernel(module: nn.Module, kernel_hwio: torch.Tensor) -> torch.Tensor:
    """kernel / sigma for a kernel with its output channel on the last axis.

    Train mode: one power iteration on the detached kernel, u and v updated
    in place, sigma = uᵀ W v with the fresh vectors (gradient through W
    only). Eval mode: the stored u and v verbatim.
    """
    if not module.training:
        return spectral_normalize(kernel_hwio, module.u, module.v)
    u, v = spectral_power_iteration(kernel_hwio, module.u)
    with torch.no_grad():
        module.u.copy_(u)
        module.v.copy_(v)
    return spectral_normalize(kernel_hwio, u, v)


class SNConv(nn.Module):
    """Standard conv with torch-style spectral norm on NHWC maps.

    ``weight`` is OIHW; sigma is taken over its (kh, kw, in) flattening, the
    order the stored v indexes (HWIO in the JAX package).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = (k - 1) // 2
        self.compute_dtype = compute_dtype
        # xavier normal over the (k, k, cin, cout) kernel
        std = math.sqrt(2.0 / (k * k * in_channels + k * k * features))
        kernel = torch.randn(k, k, in_channels, features, generator=generator) * std
        self.weight = nn.Parameter(kernel.permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        _register_uv(self, kernel, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # sigma over the HWIO view of the OIHW weight: v's (kh, kw, in) order
        w = _sn_kernel(self, self.weight.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)
        cdt = self.compute_dtype
        # NHWC viewed as channels_last NCHW: no copy in or out
        y = F.conv2d(x.permute(0, 3, 1, 2).to(cdt), w.to(cdt), stride=self.stride,
                     padding=self.padding).float()
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias
        return y


class SNSphereConv(SphereConv2D):
    """SphereConv2D with spectral norm; kernel HWIO."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 use_bias: bool = True, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, features, stride, use_bias, compute_dtype, generator)
        _register_uv(self, self.kernel, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        kernel = _sn_kernel(self, self.kernel)
        return sphere_conv(x.to(cdt).contiguous(), kernel.to(cdt), self.bias, self.stride)


class SPADE(nn.Module):
    """Spatially-adaptive denormalization conditioned on the env-map guide.

    Takes its slice ``shared_a`` of the block-level fused mlp_shared conv
    (SPADEResnetBlock computes it once for all of its norms).
    """

    def __init__(self, norm_nc: int, norm_type: str = "syncbatch", nhidden: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if norm_type not in ("syncbatch", "batch", "instance"):
            raise ValueError(f"unknown SPADE norm {norm_type!r}")
        self.param_free_norm = None if norm_type == "instance" else BatchNorm(norm_nc)
        # gamma and beta convs share the input: ONE conv with 2C outputs
        self.mlp_gammabeta = SphereConv2D(nhidden, 2 * norm_nc, compute_dtype=compute_dtype,
                                          generator=generator)

    def forward(self, x: torch.Tensor, shared_a: torch.Tensor) -> torch.Tensor:
        if self.param_free_norm is None:
            normalized = instance_norm(x)
        else:
            normalized = self.param_free_norm(x)
        gamma, beta = self.mlp_gammabeta(shared_a).chunk(2, dim=-1)
        return normalized * (1 + gamma) + beta


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin: int, fout: int, norm_type: str = "syncbatch",
                 nhidden: int = 128, label_nc: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.nhidden = nhidden
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        n_norms = 3 if self.learned_shortcut else 2
        # one fused cin=3 conv for every norm of the block, split in
        # (norm_0, norm_1[, norm_s]) order
        self.mlp_shared = SphereConv2D(label_nc, n_norms * nhidden, **kw)
        self.norm_0 = SPADE(fin, norm_type, nhidden, **kw)
        self.norm_1 = SPADE(fmiddle, norm_type, nhidden, **kw)
        self.conv_0 = SNSphereConv(fin, fmiddle, **kw)
        self.conv_1 = SNSphereConv(fmiddle, fout, **kw)
        if self.learned_shortcut:
            self.norm_s = SPADE(fin, norm_type, nhidden, **kw)
            self.conv_s = SNSphereConv(fin, fout, **kw)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        seg_r = resize_nearest(seg, tuple(x.shape[1:3]))
        a = F.relu(self.mlp_shared(seg_r)).split(self.nhidden, dim=-1)
        if self.learned_shortcut:
            x_s = self.conv_s(self.norm_s(x, a[2]))
        else:
            x_s = x
        dx = self.conv_0(_lrelu(self.norm_0(x, a[0])))
        dx = self.conv_1(_lrelu(self.norm_1(dx, a[1])))
        return x_s + dx


class ConvEncoder(nn.Module):
    """Crop image (B, H, W, 3) -> latent z; norm_E='spectralinstance'.

    The encoder's input is resized to 128x128, so its pooled map is always
    (4, 4, 8*ndf), flattened in H, W, C order as in the JAX package.
    vae=True returns (mu, logvar) from the ``fc_mu``/``fc_var`` heads.
    """

    def __init__(self, ndf: int = 64, vae: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.vae = vae
        widths = (ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 8)
        cin = 3
        for i, wdt in enumerate(widths, start=1):
            self.add_module(f"layer{i}", SNConv(cin, wdt, 3, 2, compute_dtype=compute_dtype,
                                                generator=generator))
            cin = wdt
        flat = 4 * 4 * ndf * 8
        zdim = 16 * ndf * 2 * 1
        if vae:
            self.fc_mu = dense(flat, zdim, generator)
            self.fc_var = dense(flat, zdim, generator)
        else:
            self.fc = dense(flat, zdim, generator)

    def forward(self, x: torch.Tensor):
        x = resize_bilinear(x, (128, 128))
        for i in range(1, 6):
            if i > 1:
                x = _lrelu(x)
            x = instance_norm(getattr(self, f"layer{i}")(x))
        x = _lrelu(x).reshape(x.shape[0], -1)
        if self.vae:
            return self.fc_mu(x), self.fc_var(x)
        return self.fc(x)


class SPADEGenerator(nn.Module):
    """guide (B, H, W, 3) + crop (B, h, w, 3) -> HDR env map (B, H, W, 3).

    Encoder latent reshaped to (16nf, 1, 2) in NCHW order, nearest-resized to
    (sh, sw), 7 SPADE blocks with 5 nearest 2x upsamples, a SphereConv head,
    (tanh+1)*25 HDR range. With use_vae (upstream SPADE's --use_vae) the
    encoder gives (mu, logvar); train mode takes the reparameterized latent
    z = mu + eps * exp(logvar / 2), eval mode z = mu.
    """

    def __init__(self, ngf: int = 64, norm_type: str = "syncbatch",
                 num_upsampling_layers: str = "normal", crop_size: int = 256,
                 aspect_ratio: float = 2.0, use_vae: bool = False, label_nc: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        nf = ngf
        self.ngf = ngf
        self.use_vae = use_vae
        self.num_upsampling_layers = num_upsampling_layers
        num_up = {"normal": 5, "more": 6, "most": 7}[num_upsampling_layers]
        self.sw = crop_size // (2 ** num_up)
        self.sh = round(self.sw / aspect_ratio)
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.netE = ConvEncoder(ndf=nf, vae=use_vae, **kw)
        block = lambda fin, fout: SPADEResnetBlock(fin, fout, norm_type, label_nc=label_nc, **kw)
        self.head_0 = block(16 * nf, 16 * nf)
        self.G_middle_0 = block(16 * nf, 16 * nf)
        self.G_middle_1 = block(16 * nf, 16 * nf)
        self.up_0 = block(16 * nf, 8 * nf)
        self.up_1 = block(8 * nf, 4 * nf)
        self.up_2 = block(4 * nf, 2 * nf)
        self.up_3 = block(2 * nf, 1 * nf)
        final_nc = nf
        if num_upsampling_layers == "most":
            self.up_4 = block(nf, nf // 2)
            final_nc = nf // 2
        self.sphere_conv1 = SphereConv2D(final_nc, 3, **kw)

    def forward(self, guide: torch.Tensor, crop: torch.Tensor, eps: torch.Tensor | None = None,
                want_vae: bool = False):
        """The env map; with want_vae (a use_vae model) also the encoder's
        (mu, logvar), for the KLD term. eps: the train-mode latent noise,
        (B, 32 * ngf) N(0, 1), drawn from torch's global generator when None
        (the training steps pass a seeded draw)."""
        nf = self.ngf
        if self.use_vae:
            mu, logvar = self.netE(crop)
            if self.training:
                std = torch.exp(0.5 * logvar)
                z = mu + (torch.randn_like(std) if eps is None else eps) * std
            else:
                z = mu
        elif want_vae:
            raise ValueError("want_vae needs a use_vae generator")
        else:
            z = self.netE(crop)
        # torch's z.view(-1, 16nf, 1, 2) element order, then NHWC
        x = z.reshape(-1, 16 * nf, 1, 2).permute(0, 2, 3, 1)
        x = resize_nearest(x, (self.sh, self.sw)).contiguous()

        up = lambda t: resize_nearest(t, (t.shape[1] * 2, t.shape[2] * 2))
        x = self.head_0(x, guide)
        x = up(x)
        x = self.G_middle_0(x, guide)
        if self.num_upsampling_layers in ("more", "most"):
            x = up(x)
        x = self.G_middle_1(x, guide)
        x = up(x)
        x = self.up_0(x, guide)
        x = up(x)
        x = self.up_1(x, guide)
        x = up(x)
        x = self.up_2(x, guide)
        x = up(x)
        x = self.up_3(x, guide)
        if self.num_upsampling_layers == "most":
            x = up(x)
            x = self.up_4(x, guide)
        x = self.sphere_conv1(_lrelu(x))
        out = (torch.tanh(x) + 1.0) * 25.0
        return (out, (mu, logvar)) if want_vae else out
