"""Reference PyTorch checkpoints (.pth) -> JAX-layout NumPy trees.

The port's own copy of emlight_tpu/train/torch_import.py. The regressor's
importer (``load_torch_state_dict``, ``import_densenet_state_dict``, :30-122)
maps a reference ``state_dict`` (RegressionNetwork/DenseNet.py:68-157,
saved by train.py:147-167) onto the JAX module tree:

- conv weights OIHW -> HWIO;
- BatchNorm weight/bias/running_mean/running_var -> scale/bias + batch_stats;
- Linear weight (out, in) -> kernel (in, out);
- the fc layer's input axis permuted from torch's C, H, W flatten
  (DenseNet.py:138) to H, W, C, the order in which the port's DenseNet, like
  the JAX one, flattens its pooled features.

The projector's importers (``import_generator_state_dict``,
``import_discriminator_state_dict``, :180-254) map GenProjector's netG and
netD state_dicts (util.py:173-179) the same way, fusing each SPADE block's
per-norm ``mlp_shared`` convs and each SPADE's gamma/beta convs into the
JAX package's fused convs, and carrying the spectral-norm u and v (v
permuted from torch's (in, kh, kw) flattening to (kh, kw, in)).

The trees feed ``jax_weights.densenet_state_from_jax``,
``generator_state_from_jax`` and ``discriminator_state_from_jax``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["import_densenet_state_dict", "import_generator_state_dict",
           "import_discriminator_state_dict", "load_torch_state_dict"]


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _conv(sd, prefix):
    return {"kernel": np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))}


def _bn(sd, prefix):
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return params, stats


def _linear(sd, prefix):
    return {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
            "bias": sd[f"{prefix}.bias"]}


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def import_densenet_state_dict(
    sd: dict[str, np.ndarray] | str,
    block_config=(16, 16, 16),
    pooled_hw: tuple[int, int] = (6, 8),
):
    """Returns (params, batch_stats) NumPy trees in the JAX DenseNet layout.

    pooled_hw: spatial dims of the pooled feature map feeding fc (6x8 for the
    reference's 192x256 crops; the channel count is inferred).
    """
    if isinstance(sd, str):
        sd = load_torch_state_dict(sd)
    params: dict = {}
    stats: dict = {}

    params["conv0"] = _conv(sd, "features.conv0")
    params["norm0"], stats["norm0"] = _bn(sd, "features.norm0")
    for i, num_layers in enumerate(block_config, start=1):
        for j in range(1, num_layers + 1):
            tp = f"features.denseblock{i}.denselayer{j}"
            fl = f"denseblock{i}_denselayer{j}"
            p1, s1 = _bn(sd, f"{tp}.norm1")
            p2, s2 = _bn(sd, f"{tp}.norm2")
            params[fl] = {
                "norm1": p1,
                "conv1": _conv(sd, f"{tp}.conv1"),
                "norm2": p2,
                "conv2": _conv(sd, f"{tp}.conv2"),
            }
            stats[fl] = {"norm1": s1, "norm2": s2}
        pt, st = _bn(sd, f"features.transition{i}.norm")
        params[f"transition{i}"] = {"norm": pt, "conv": _conv(sd, f"features.transition{i}.conv")}
        stats[f"transition{i}"] = {"norm": st}
        params[f"last_norm{i}"], stats[f"last_norm{i}"] = _bn(sd, f"features.last_norm{i}")

    # fc: permute the flattened input axis from torch's C,H,W to H,W,C
    fc = _linear(sd, "fc")
    in_dim = fc["kernel"].shape[0]
    ph, pw = pooled_hw
    c = in_dim // (ph * pw)
    if c * ph * pw != in_dim:
        raise ValueError(f"fc in_dim {in_dim} not divisible by the pooled map {ph}x{pw}")
    # torch flat index: c*ph*pw + h*pw + w ; H,W,C flat index: h*pw*c + w*c + c_idx
    torch_idx = np.arange(in_dim).reshape(c, ph, pw)
    hwc_order = np.transpose(torch_idx, (1, 2, 0)).reshape(-1)  # H,W,C position -> torch index
    fc["kernel"] = np.ascontiguousarray(fc["kernel"][hwc_order])
    params["fc"] = fc

    for head in ("fc_dist", "fc_intensity", "fc_rgb_ratio", "fc_ambient"):
        params[head] = _linear(sd, head)
    return _f32(params), _f32(stats)


# --------------------------------------------------------------------------- #
# GenProjector (SPADE generator + multiscale discriminator) import.
#
# Torch naming derives from GenProjector/models/networks/{generator.py:27-47,
# architecture.py:22-47, normalization.py:68-99, discriminator.py:76-105};
# torch.nn.utils.spectral_norm stores weight_orig / weight_u / weight_v.
# The port's eval sigma is u^T W v with the stored u and v, as torch's
# spectral_norm computes it in eval mode, so weight_orig, weight_u and
# weight_v are all carried (v permuted to the (kh, kw, in) flattening).
# --------------------------------------------------------------------------- #

def _sn_conv(sd, prefix):
    w = sd[f"{prefix}.weight_orig"]  # (out, in, kh, kw)
    params = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    if f"{prefix}.bias" in sd:
        params["bias"] = sd[f"{prefix}.bias"]
    # torch's v indexes W_mat columns in (in, kh, kw) flatten order; the JAX
    # kernel reshape flattens (kh, kw, in) -> permute
    _, cin, kh, kw = w.shape
    v = sd[f"{prefix}.weight_v"].reshape(cin, kh, kw).transpose(1, 2, 0).reshape(-1)
    return params, {"u": sd[f"{prefix}.weight_u"], "v": np.ascontiguousarray(v)}


def _spade(sd, prefix):
    """SPADE norm: gamma/beta SphereConvs + param-free BN running stats.

    The per-norm mlp_shared conv lives at the BLOCK level in the JAX graph
    (one fused conv per SPADEResnetBlock) — see _block_mlp_shared.
    """
    gamma = _conv(sd, f"{prefix}.mlp_gamma")
    beta = _conv(sd, f"{prefix}.mlp_beta")
    params = {
        # the JAX SPADE fuses the gamma/beta convs (same input) into one
        # 2C-output conv — concatenate the reference's kernels/biases
        "mlp_gammabeta": {
            "kernel": np.concatenate([gamma["kernel"], beta["kernel"]], axis=-1),
            "bias": np.concatenate(
                [sd[f"{prefix}.mlp_gamma.bias"], sd[f"{prefix}.mlp_beta.bias"]]
            ),
        },
    }
    stats = {
        "param_free_norm": {
            "mean": sd[f"{prefix}.param_free_norm.running_mean"],
            "var": sd[f"{prefix}.param_free_norm.running_var"],
        }
    }
    return params, stats


def _block_mlp_shared(sd, block, norms):
    """Fuse the reference's per-norm mlp_shared convs (same resized-guide
    input within a block) into the JAX block-level conv: concatenate
    kernels/biases on the output-channel axis in (norm_0, norm_1[, norm_s])
    order — the SPADEResnetBlock split order."""
    kernels, biases = [], []
    for nrm in norms:
        c = _conv(sd, f"{block}.{nrm}.mlp_shared.0")
        kernels.append(c["kernel"])
        biases.append(sd[f"{block}.{nrm}.mlp_shared.0.bias"])
    return {
        "kernel": np.concatenate(kernels, axis=-1),
        "bias": np.concatenate(biases),
    }


def import_generator_state_dict(sd: dict[str, np.ndarray] | str, ngf: int = 64):
    """netG state_dict -> (params, {'batch_stats': ..., 'spectral': ...})."""
    if isinstance(sd, str):
        sd = load_torch_state_dict(sd)
    params: dict = {}
    batch_stats: dict = {}
    spectral: dict = {}

    blocks = ["head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2", "up_3"]
    for b in blocks:
        bp: dict = {}
        bs: dict = {}
        bu: dict = {}
        convs = ["conv_0", "conv_1"] + (["conv_s"] if f"{b}.conv_s.weight_orig" in sd else [])
        for c in convs:
            bp[c], bu[c] = _sn_conv(sd, f"{b}.{c}")
        norms = ["norm_0", "norm_1"] + (["norm_s"] if f"{b}.norm_s.mlp_gamma.weight" in sd else [])
        for nrm in norms:
            bp[nrm], bs[nrm] = _spade(sd, f"{b}.{nrm}")
        bp["mlp_shared"] = _block_mlp_shared(sd, b, norms)
        params[b] = bp
        batch_stats[b] = bs
        spectral[b] = bu

    enc_p: dict = {}
    enc_u: dict = {}
    for i in range(1, 6):
        enc_p[f"layer{i}"], enc_u[f"layer{i}"] = _sn_conv(sd, f"netE.layer{i}.0")
    fc = _linear(sd, "netE.fc")
    # torch flattens the pooled (C, 4, 4) NCHW feature map as C*H*W
    # (generator.py:124); JAX flattens NHWC -> permute the fc input axis
    c = ngf * 8
    torch_idx = np.arange(c * 16).reshape(c, 4, 4)
    hwc_order = np.transpose(torch_idx, (1, 2, 0)).reshape(-1)
    fc["kernel"] = np.ascontiguousarray(fc["kernel"][hwc_order])
    enc_p["fc"] = fc
    params["netE"] = enc_p
    spectral["netE"] = enc_u

    params["sphere_conv1"] = _conv(sd, "sphere_conv1")
    params["sphere_conv1"]["bias"] = sd["sphere_conv1.bias"]

    return _f32(params), {"batch_stats": _f32(batch_stats), "spectral": _f32(spectral)}


def import_discriminator_state_dict(sd: dict[str, np.ndarray] | str,
                                    num_d: int = 2, n_layers: int = 4):
    """netD state_dict -> (params, {'spectral': ...})."""
    if isinstance(sd, str):
        sd = load_torch_state_dict(sd)
    params: dict = {}
    spectral: dict = {}
    for i in range(num_d):
        dp: dict = {}
        du: dict = {}
        p0 = f"discriminator_{i}.model0.0"
        dp["model0_conv"] = _conv(sd, p0)
        dp["model0_conv"]["bias"] = sd[f"{p0}.bias"]
        for n in range(1, n_layers):
            dp[f"model{n}_conv"], du[f"model{n}_conv"] = _sn_conv(
                sd, f"discriminator_{i}.model{n}.0.0"
            )
        plast = f"discriminator_{i}.model{n_layers}.0"
        dp[f"model{n_layers}_conv"] = _conv(sd, plast)
        dp[f"model{n_layers}_conv"]["bias"] = sd[f"{plast}.bias"]
        params[f"discriminator_{i}"] = dp
        spectral[f"discriminator_{i}"] = du

    return _f32(params), {"spectral": _f32(spectral)}
