"""Weight bridge: JAX parameter trees -> state_dicts of the port's modules.

The inverse direction of emlight_tpu/train/torch_import.py. Inputs are the
JAX trees as nested mappings of NumPy arrays (for example
``jax.tree.map(np.asarray, params)``); nothing here imports JAX. The port's
module names equal the JAX names, so each leaf maps by its path:

- dense conv kernels HWIO -> OIHW ``weight`` (F.conv2d layout);
- sphere-conv kernels stay HWIO ``kernel`` (the kernel reads (9, Cin, Cout));
- Dense kernels (in, out) -> Linear ``weight`` (out, in). Both packages
  flatten pooled features in H, W, C order, so no fc permutation is needed;
- BatchNorm scale/bias -> weight/bias, batch stats mean/var -> running_*;
- spectral-norm u and v are copied verbatim: v already indexes the
  (kh, kw, in) flattening the port's sigma uses.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["densenet_state_from_jax", "generator_state_from_jax"]


def _walk(tree: Mapping, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _f32(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32)


def densenet_state_from_jax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """DenseNet (nn/densenet.py) params + batch_stats -> port state_dict."""
    sd = {}
    for path, a in _walk(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            sd[f"{mod}.weight"] = _f32(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
        elif leaf == "scale":
            sd[f"{mod}.weight"] = _f32(a)
        elif leaf == "bias":
            sd[f"{mod}.bias"] = _f32(a)
        else:
            raise KeyError(f"unexpected DenseNet parameter {'/'.join(path)}")
    for path, a in _walk(batch_stats):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise KeyError(f"unexpected DenseNet batch stat {'/'.join(path)}")
        sd[f"{mod}.running_{leaf}"] = _f32(a)
        sd[f"{mod}.num_batches_tracked"] = np.zeros((), np.int64)
    return _tensors(sd)


def generator_state_from_jax(params: Mapping, stats: Mapping) -> dict[str, torch.Tensor]:
    """SPADEGenerator params + {"batch_stats", "spectral"} -> port state_dict.

    The generator's only dense convs are the encoder's SNConvs (``netE``);
    every other 4-d kernel is a sphere conv and stays HWIO.
    """
    sd = {}
    for path, a in _walk(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and a.ndim == 4:
            if path[0] == "netE":
                sd[f"{mod}.weight"] = _f32(a.transpose(3, 2, 0, 1))
            else:
                sd[f"{mod}.kernel"] = _f32(a)
        elif leaf == "kernel" and a.ndim == 2:
            sd[f"{mod}.weight"] = _f32(a.T)
        elif leaf == "bias":
            sd[f"{mod}.bias"] = _f32(a)
        else:
            raise KeyError(f"unexpected generator parameter {'/'.join(path)}")
    # "vae_stats" holds the (mu, logvar) a use_vae model sows at init: outputs,
    # not weights
    unknown = set(stats) - {"batch_stats", "spectral", "vae_stats"}
    if unknown:
        raise KeyError(f"unexpected generator collections {sorted(unknown)}")
    for coll in ("batch_stats", "spectral"):
        for path, a in _walk(stats.get(coll, {})):
            sd[".".join(path)] = _f32(a)
    return _tensors(sd)
