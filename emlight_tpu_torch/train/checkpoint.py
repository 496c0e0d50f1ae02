"""Checkpoints in the JAX package's wire format: read, restore into the
port's models, write.

Counterpart of emlight_tpu/train/checkpoint.py:1-67. The JAX package writes
its whole train state with ``flax.serialization.to_bytes``; this module
reads that file with the port's own msgpack codec (core/msgpack.py) into
nested dicts of NumPy arrays and hands the model's trees to the weight
bridge (train/jax_weights.py):

- a ``RegressionState`` file holds ``step``, ``params``, ``batch_stats``,
  ``opt_state``: ``restore_regressor`` takes ``params`` and ``batch_stats``;
- a ``ProjectorState`` file holds ``step``, ``g_params``, ``g_stats``
  (``spectral``, ``batch_stats``), ``d_params``, ``d_stats``, ``g_opt``,
  ``d_opt``: ``restore_generator`` takes ``g_params`` and ``g_stats``.

Both ignore the optimizer state, so a checkpoint trained with
``--clip_grad_norm`` (another optimizer-state structure) loads the same as
one trained without it. ``save_checkpoint`` writes a tree of NumPy arrays in
the same format, atomically.
"""

from __future__ import annotations

import os
import tempfile
from collections.abc import Mapping

import torch

from ..core.msgpack import msgpack_restore, packb
from .jax_weights import densenet_state_from_jax, generator_state_from_jax

__all__ = ["read_checkpoint", "save_checkpoint", "restore_regressor", "restore_generator",
           "load_checked"]


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

