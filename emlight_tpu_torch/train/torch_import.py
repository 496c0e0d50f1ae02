"""Reference PyTorch checkpoints (.pth) of the DenseNet regressor -> JAX-layout
NumPy trees.

The port's own copy of ``load_torch_state_dict`` and
``import_densenet_state_dict`` (emlight_tpu/train/torch_import.py:30-122),
which map a reference ``state_dict`` (RegressionNetwork/DenseNet.py:68-157,
saved by train.py:147-167) onto the JAX module tree:

- conv weights OIHW -> HWIO;
- BatchNorm weight/bias/running_mean/running_var -> scale/bias + batch_stats;
- Linear weight (out, in) -> kernel (in, out);
- the fc layer's input axis permuted from torch's C, H, W flatten
  (DenseNet.py:138) to H, W, C, the order in which the port's DenseNet, like
  the JAX one, flattens its pooled features.

The trees feed ``jax_weights.densenet_state_from_jax``. The generator and
discriminator importers are not copied: no CLI of the port reads a
projector .pth yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["import_densenet_state_dict", "load_torch_state_dict"]


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
