"""Weight bridge: JAX parameter trees <-> state_dicts of the port's modules.

The inverse direction of emlight_tpu/train/torch_import.py, and
(``densenet_tree_from_state``, ``generator_tree_from_state``) back again, so
a port model can be written as a JAX-layout checkpoint. Inputs are the
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

__all__ = ["densenet_state_from_jax", "densenet_grads_from_jax", "generator_state_from_jax",
           "discriminator_state_from_jax", "densenet_tree_from_state",
           "generator_tree_from_state"]


def _walk(tree: Mapping, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    # (not np.ascontiguousarray: it makes the 0-d num_batches_tracked 1-d)
    return {k: torch.from_numpy(v if v.flags.c_contiguous else v.copy(order="C"))
            for k, v in sd.items()}


def _f32(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32)


def _densenet_params(params: Mapping) -> dict[str, np.ndarray]:
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
    return sd


def densenet_state_from_jax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """DenseNet (nn/densenet.py) params + batch_stats -> port state_dict."""
    sd = _densenet_params(params)
    for path, a in _walk(batch_stats):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise KeyError(f"unexpected DenseNet batch stat {'/'.join(path)}")
        sd[f"{mod}.running_{leaf}"] = _f32(a)
        sd[f"{mod}.num_batches_tracked"] = np.zeros((), np.int64)
    return _tensors(sd)


def densenet_grads_from_jax(grads: Mapping) -> dict[str, torch.Tensor]:
    """A DenseNet gradient tree (shaped as its params) -> {port parameter
    name: gradient in the parameter's layout}, to compare leaf by leaf with
    the port's ``.grad``."""
    return _tensors(_densenet_params(grads))


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


def discriminator_state_from_jax(params: Mapping, stats: Mapping) -> dict[str, torch.Tensor]:
    """MultiscaleDiscriminator params + {"spectral"} -> port state_dict.

    Every kernel is a sphere conv and stays HWIO; the spectral-norm u and v
    of the SN convs are copied verbatim.
    """
    sd = {}
    for path, a in _walk(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in ("kernel", "bias") or (leaf == "kernel" and a.ndim != 4):
            raise KeyError(f"unexpected discriminator parameter {'/'.join(path)}")
        sd[f"{mod}.{leaf}"] = _f32(a)
    unknown = set(stats) - {"spectral"}
    if unknown:
        raise KeyError(f"unexpected discriminator collections {sorted(unknown)}")
    for path, a in _walk(stats.get("spectral", {})):
        sd[".".join(path)] = _f32(a)
    return _tensors(sd)


# -- the inverse direction: port state_dicts -> JAX parameter trees ------------


def _nest(tree: dict, key: str, value: np.ndarray) -> None:
    *mods, leaf = key.split(".")
    for m in mods:
        tree = tree.setdefault(m, {})
    tree[leaf] = value


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def densenet_tree_from_state(sd: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """Port DenseNet state_dict -> (params, batch_stats) NumPy trees in the
    JAX layout; the inverse of ``densenet_state_from_jax``."""
    params: dict = {}
    stats: dict = {}
    for key, t in sd.items():
        mod, leaf = key.rsplit(".", 1)
        a = _numpy(t)
        if leaf == "weight":
            if a.ndim == 4:
                _nest(params, f"{mod}.kernel", a.transpose(2, 3, 1, 0))
            elif a.ndim == 2:
                _nest(params, f"{mod}.kernel", a.T)
            else:
                _nest(params, f"{mod}.scale", a)
        elif leaf == "bias":
            _nest(params, f"{mod}.bias", a)
        elif leaf in ("running_mean", "running_var"):
            _nest(stats, f"{mod}.{leaf[len('running_'):]}", a)
        elif leaf != "num_batches_tracked":
            raise KeyError(f"unexpected DenseNet state entry {key}")
    return params, stats


def generator_tree_from_state(sd: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """Port SPADEGenerator state_dict -> (params, {"batch_stats", "spectral"})
    NumPy trees in the JAX layout; the inverse of
    ``generator_state_from_jax``."""
    params: dict = {}
    stats: dict = {"batch_stats": {}, "spectral": {}}
    for key, t in sd.items():
        mod, leaf = key.rsplit(".", 1)
        a = _numpy(t)
        if leaf == "weight":  # the encoder's SNConvs (OIHW) and its Dense layers
            _nest(params, f"{mod}.kernel", a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)
        elif leaf in ("kernel", "bias"):
            _nest(params, key, a)
        elif leaf in ("mean", "var"):
            _nest(stats["batch_stats"], key, a)
        elif leaf in ("u", "v"):
            _nest(stats["spectral"], key, a)
        else:
            raise KeyError(f"unexpected generator state entry {key}")
    return params, stats
