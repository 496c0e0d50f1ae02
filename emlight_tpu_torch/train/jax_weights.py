"""Weight bridge: JAX parameter trees <-> state_dicts of the port's modules.

The inverse direction of emlight_tpu/train/torch_import.py, and
(``densenet_tree_from_state``, ``generator_tree_from_state``,
``discriminator_tree_from_state``) back again, so a port model can be
written as a JAX-layout checkpoint. ``adam_tree_from_state`` and
``adam_state_from_tree`` carry a ``torch.optim.Adam``'s moments and count
to and from optax.adam's ``{count, mu, nu}`` through the same maps. Inputs are the
JAX trees as nested mappings of NumPy arrays (for example
``jax.tree.map(np.asarray, params)``); nothing here imports JAX. The port's
module names equal the JAX names, so each leaf maps by its path:

- dense conv kernels HWIO -> OIHW ``weight`` (F.conv2d layout);
- sphere-conv kernels stay HWIO ``kernel`` (the kernel reads (9, Cin, Cout));
- Dense kernels (in, out) -> Linear ``weight`` (out, in). Both packages
  flatten pooled features in H, W, C order, so no fc permutation is needed;
- BatchNorm scale/bias -> weight/bias, batch stats mean/var -> running_*;
- a folded dense layer (``fold_eval_variables``: conv2 with a bias, its
  ``conv2_pad``, no norm2) maps the same way, ``conv2_pad`` verbatim;
- spectral-norm u and v are copied verbatim: v already indexes the
  (kh, kw, in) flattening the port's sigma uses.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["densenet_state_from_jax", "densenet_grads_from_jax", "generator_state_from_jax",
           "discriminator_state_from_jax", "densenet_tree_from_state",
           "generator_tree_from_state", "discriminator_tree_from_state",
           "spherenet_state_from_jax", "adam_tree_from_state", "adam_state_from_tree"]


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
        elif leaf == "conv2_pad":  # a folded dense layer's (fold_eval_variables)
            sd[f"{mod}.conv2_pad"] = _f32(a)
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


def spherenet_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The sphere demo's SphereNet (cli/sphere_demo.py) params -> port
    state_dict: the sphere-conv kernels HWIO as they are, the Dense head's
    kernel (in, out) -> Linear weight (out, in)."""
    sd = {}
    for path, a in _walk(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and a.ndim == 2:
            sd[f"{mod}.weight"] = _f32(a.T)
        elif leaf in ("kernel", "bias"):
            sd[f"{mod}.{leaf}"] = _f32(a)
        else:
            raise KeyError(f"unexpected SphereNet parameter {'/'.join(path)}")
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
        elif leaf in ("bias", "conv2_pad"):
            _nest(params, key, a)
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


def discriminator_tree_from_state(sd: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """Port MultiscaleDiscriminator state_dict -> (params, {"spectral"})
    NumPy trees in the JAX layout; the inverse of
    ``discriminator_state_from_jax``."""
    params: dict = {}
    stats: dict = {"spectral": {}}
    for key, t in sd.items():
        leaf = key.rsplit(".", 1)[1]
        if leaf in ("kernel", "bias"):
            _nest(params, key, _numpy(t))
        elif leaf in ("u", "v"):
            _nest(stats["spectral"], key, _numpy(t))
        else:
            raise KeyError(f"unexpected discriminator state entry {key}")
    return params, stats


# -- optimizer state: torch.optim.Adam <-> optax.adam's ScaleByAdamState -------


def adam_tree_from_state(opt: torch.optim.Adam, named_params, count: int,
                         params_tree_of) -> dict:
    """optax.adam's ``{count, mu, nu}`` of a torch Adam.

    ``named_params``: the model's (name, parameter) pairs; ``params_tree_of``
    maps {name: tensor} to the JAX params tree (the model's
    ``*_tree_from_state``, first element). Torch keeps the moments per
    parameter as ``exp_avg`` / ``exp_avg_sq`` (optax's mu / nu, the same
    arithmetic) and its step as a float per parameter; optax keeps one int32
    count, written here as `count`. A parameter without Adam state (a fresh
    optimizer) has zero moments, as optax's init.
    """
    mu, nu = {}, {}
    for name, p in named_params:
        st = opt.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    return {"count": np.asarray(count, np.int32), "mu": params_tree_of(mu),
            "nu": params_tree_of(nu)}


def adam_state_from_tree(opt: torch.optim.Adam, named_params, tree: Mapping,
                         state_of, source: str) -> int:
    """Load optax.adam's ``{count, mu, nu}`` into a torch Adam; returns the
    count.

    ``state_of`` maps a JAX params-shaped tree to {name: tensor} in the
    port's layout (the model's ``*_state_from_jax``). A count of 0 with zero
    moments leaves the optimizer fresh. A moment whose name or shape differs
    from the parameter's raises ValueError naming both.
    """
    count = int(np.asarray(tree["count"]))
    mu, nu = state_of(tree["mu"]), state_of(tree["nu"])
    named = dict(named_params)
    for what, moments in (("mu", mu), ("nu", nu)):
        for name in [*named, *(k for k in moments if k not in named)]:
            a = tuple(named[name].shape) if name in named else None
            b = tuple(moments[name].shape) if name in moments else None
            if a != b:
                raise ValueError(
                    f"checkpoint {source} does not match the optimizer at {what}/{name}: "
                    f"parameter {'missing' if a is None else a} vs checkpoint "
                    f"{'missing' if b is None else b}")
    opt.state.clear()
    if count == 0 and not any(bool(m.any()) for m in (*mu.values(), *nu.values())):
        return 0
    for name, p in named.items():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype).clone(),
        }
    return count
