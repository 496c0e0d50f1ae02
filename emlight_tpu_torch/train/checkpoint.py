"""Checkpoints in the JAX package's wire format: read, restore into the
port's models and train states, write.

Counterpart of emlight_tpu/train/checkpoint.py. The JAX package writes its
whole train state with ``flax.serialization.to_bytes``; this module reads
that file with the port's own msgpack codec (core/msgpack.py) into nested
dicts of NumPy arrays and hands the trees to the weight bridge
(train/jax_weights.py):

- a ``RegressionState`` file holds ``step``, ``params``, ``batch_stats``,
  ``opt_state``: ``restore_regressor`` takes ``params`` and ``batch_stats``;
- a ``ProjectorState`` file holds ``step``, ``g_params``, ``g_stats``
  (``spectral``, ``batch_stats``), ``d_params``, ``d_stats``, ``g_opt``,
  ``d_opt``: ``restore_generator`` takes ``g_params`` and ``g_stats``.

Those two read the model's trees only, so a checkpoint trained with
``--clip_grad_norm`` loads the same as one trained without it.
``save_train_state`` and ``restore_train_state`` carry the whole train
state, the optimizer's too, in optax's layout:

- ``RegressionState.opt_state``: ``{"0": adam, "1": {}}`` (optax.adam at a
  constant rate: scale_by_adam, then an empty scale state);
- ``ProjectorState.g_opt`` / ``d_opt``: ``{"0": adam, "1": {"count"}}``
  (the learning-rate schedule's count; present at a constant rate too);
- ``--clip_grad_norm > 0`` wraps either in ``{"0": {}, "1": <that>}``
  (optax.chain(clip_by_global_norm, adam));

where adam is ``{count, mu, nu}`` (train/jax_weights.py::adam_*). The JAX
package's ``restore_checkpoint(path, create_state(...))`` restores every
leaf of the port's file bit for bit, and the port reads the JAX package's.
``save_checkpoint`` writes any tree of NumPy arrays, atomically.
"""

from __future__ import annotations

import os
import tempfile
from collections.abc import Mapping

import torch

import numpy as np

from ..core.msgpack import msgpack_restore, packb
from .jax_weights import (
    adam_state_from_tree,
    adam_tree_from_state,
    densenet_grads_from_jax,
    densenet_state_from_jax,
    densenet_tree_from_state,
    discriminator_state_from_jax,
    discriminator_tree_from_state,
    generator_state_from_jax,
    generator_tree_from_state,
)
from .projector import ProjectorState
from .regression import RegressionState

__all__ = ["read_checkpoint", "save_checkpoint", "restore_regressor", "restore_generator",
           "load_checked", "save_train_state", "restore_train_state", "latest_checkpoint"]


def read_checkpoint(path: str) -> dict:
    """The checkpoint at `path` as a nested dict of NumPy arrays (read-only
    views of the file's bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    return msgpack_restore(data)


def save_checkpoint(ckpt_dir: str, tree: Mapping, name: str = "latest") -> str:
    """Write a tree of NumPy arrays to {ckpt_dir}/{name}.msgpack atomically
    (a temporary file in the same directory, then os.replace)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    data = packb(dict(tree))
    path = os.path.join(ckpt_dir, f"{name}.msgpack")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_checked(model: torch.nn.Module, sd: Mapping[str, torch.Tensor], source: str):
    """model.load_state_dict(sd) after checking every entry's presence and
    shape; a mismatch raises ValueError naming the entry and both shapes
    (the usual cause: the model was built with other size flags than the
    checkpointed run)."""
    own = model.state_dict()
    for key in [*own, *(k for k in sd if k not in own)]:
        a = tuple(own[key].shape) if key in own else None
        b = tuple(sd[key].shape) if key in sd else None
        if a != b:
            raise ValueError(
                f"checkpoint {source} does not match the model at {key}: model "
                f"{'missing' if a is None else a} vs checkpoint {'missing' if b is None else b}"
                f" — check the model size flags (--anchors/--block_config/--crop/--ngf/...) "
                f"used for training")
    model.load_state_dict(sd)
    return model


def restore_regressor(path: str, model: torch.nn.Module):
    """Load a RegressionState checkpoint's params and batch_stats into the
    port's DenseNet; returns the model."""
    tree = read_checkpoint(path)
    return load_checked(model, densenet_state_from_jax(tree["params"], tree["batch_stats"]), path)


def restore_generator(path: str, model: torch.nn.Module):
    """Load a ProjectorState checkpoint's g_params and g_stats into the
    port's SPADEGenerator; returns the model."""
    tree = read_checkpoint(path)
    return load_checked(model, generator_state_from_jax(tree["g_params"], tree["g_stats"]), path)



def latest_checkpoint(ckpt_dir: str) -> str | None:
    p = os.path.join(ckpt_dir, "latest.msgpack")
    return p if os.path.exists(p) else None


def _params_only(sd_of):
    return lambda tree: sd_of(tree, {})


_REG_MAPS = (lambda named: densenet_tree_from_state(named)[0], densenet_grads_from_jax)
_G_MAPS = (lambda named: generator_tree_from_state(named)[0],
           _params_only(generator_state_from_jax))
_D_MAPS = (lambda named: discriminator_tree_from_state(named)[0],
           _params_only(discriminator_state_from_jax))


def _opt_tree(opt, model, count: int, maps, clip: float, schedule: bool) -> dict:
    tree = {"0": adam_tree_from_state(opt, model.named_parameters(), count, maps[0]),
            "1": {"count": np.asarray(count, np.int32)} if schedule else {}}
    return {"0": {}, "1": tree} if clip and clip > 0 else tree


def _load_opt(opt, model, tree, maps, clip: float, what: str, source: str) -> int:
    clipped = set(tree) == {"0", "1"} and tree["0"] == {} and "0" in tree["1"]
    if clipped != bool(clip and clip > 0):
        raise ValueError(
            f"checkpoint {source}: {what} was saved {'with' if clipped else 'without'} "
            f"gradient clipping, but --clip_grad_norm is {clip}; resume with the "
            f"--clip_grad_norm of the run that wrote it")
    adam = tree["1"]["0"] if clipped else tree["0"]
    return adam_state_from_tree(opt, model.named_parameters(), adam, maps[1], source)


def _step(state) -> np.ndarray:
    return np.asarray(state.step, np.int32)


def train_state_tree(state) -> dict:
    """The JAX package's state dict of a port RegressionState or
    ProjectorState, as a tree of NumPy arrays (the keys in flax's order)."""
    clip = state.cfg.clip_grad_norm
    if isinstance(state, RegressionState):
        params, stats = densenet_tree_from_state(state.model.state_dict())
        return {"step": _step(state), "params": params, "batch_stats": stats,
                "opt_state": _opt_tree(state.opt, state.model, state.step, _REG_MAPS, clip,
                                       schedule=False)}
    if isinstance(state, ProjectorState):
        g_params, g_stats = generator_tree_from_state(state.g.state_dict())
        d_params, d_stats = discriminator_tree_from_state(state.d.state_dict())
        return {"step": _step(state), "g_params": g_params, "g_stats": g_stats,
                "d_params": d_params, "d_stats": d_stats,
                "g_opt": _opt_tree(state.opt_g, state.g, state.step, _G_MAPS, clip, True),
                "d_opt": _opt_tree(state.opt_d, state.d, state.d_step, _D_MAPS, clip, True)}
    raise TypeError(f"not a train state of the port: {type(state).__name__}")


def save_train_state(ckpt_dir: str, state, name: str = "latest") -> str:
    """Write a port RegressionState or ProjectorState as the JAX package's
    checkpoint of the same state: {ckpt_dir}/{name}.msgpack, atomically."""
    return save_checkpoint(ckpt_dir, train_state_tree(state), name)


def restore_train_state(path: str, state):
    """Load a RegressionState or ProjectorState checkpoint (the JAX
    package's or the port's) into a port train state, in place; returns it.

    Models: parameters, BatchNorm statistics and spectral u, v. Optimizers:
    Adam's moments and count. ``state.step`` is the file's step (for a
    ProjectorState, its generator updates); a ProjectorState's ``d_step``
    is d_opt's Adam count. A shape mismatch raises ValueError naming the
    entry and both shapes; an optimizer structure that does not match
    ``cfg.clip_grad_norm`` raises ValueError naming --clip_grad_norm.
    """
    tree = read_checkpoint(path)
    clip = state.cfg.clip_grad_norm
    if isinstance(state, RegressionState):
        load_checked(state.model, densenet_state_from_jax(tree["params"], tree["batch_stats"]),
                     path)
        _load_opt(state.opt, state.model, tree["opt_state"], _REG_MAPS, clip, "opt_state", path)
    elif isinstance(state, ProjectorState):
        load_checked(state.g, generator_state_from_jax(tree["g_params"], tree["g_stats"]), path)
        load_checked(state.d, discriminator_state_from_jax(tree["d_params"], tree["d_stats"]),
                     path)
        _load_opt(state.opt_g, state.g, tree["g_opt"], _G_MAPS, clip, "g_opt", path)
        state.d_step = _load_opt(state.opt_d, state.d, tree["d_opt"], _D_MAPS, clip, "d_opt",
                                 path)
    else:
        raise TypeError(f"not a train state of the port: {type(state).__name__}")
    state.step = int(np.asarray(tree["step"]))
    return state
