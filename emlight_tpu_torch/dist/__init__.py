"""Training and serving over several ranks (one process per card): ``mesh``
(the group, the (data, model) grid, the rank's rows, the collectives),
``parallel`` (data-parallel train steps and serving), ``auto`` (data x
tensor parallel train steps and serving over the grid) and
``fullsize_check`` (a full-size fused G+D step over the grid, ``python -m
emlight_tpu_torch.dist.fullsize_check``).

Port of emlight_tpu/dist/. The package exports the JAX package's names,
each imported from its submodule at first use: nn/ and losses/ import
``mesh``, and ``parallel`` and ``auto`` import train/ and nn/, so importing
them here would make a cycle.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh", "shard_batch": "mesh", "replicate": "mesh", "pad_leading": "mesh",
    "make_parallel_regression_step": "parallel", "make_parallel_projector_steps": "parallel",
    "make_parallel_fused_step": "parallel", "make_parallel_inference": "parallel",
    "make_parallel_pipeline": "parallel", "make_parallel_predict": "parallel",
    "auto_shard_state": "auto", "auto_shard_batch": "auto",
    "make_auto_regression_step": "auto", "make_auto_projector_steps": "auto",
    "make_auto_inference": "auto", "make_auto_pipeline": "auto",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
