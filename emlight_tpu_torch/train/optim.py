"""Gradient helpers shared by the training steps: optax's global norm and
global-norm clipping on the ``.grad`` of a set of parameters."""

from __future__ import annotations

import torch

from ..dist.mesh import RankGroup, all_reduce_sum_, is_model_split

__all__ = ["global_norm", "grads_global_norm", "clip_by_global_norm"]


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all gradients together."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def grads_global_norm(params, model: RankGroup | None = None) -> torch.Tensor:
    """The global norm of the parameters' gradients. Under a ``model`` group
    (dist/auto.py's tensor parallelism) a parameter split over it
    (``is_model_split``) holds the rank's slice: the squares of those are
    summed over the model ranks, and the whole parameters, equal on every
    model rank, count once, so the norm is one device's on the whole
    gradients."""
    params = [p for p in params if p.grad is not None]
    if model is None or model.size == 1:
        return global_norm([p.grad for p in params])
    sq = []
    for split in (True, False):
        grads = [p.grad for p in params if is_model_split(p) == split]
        sq.append(global_norm(grads) ** 2 if grads else torch.zeros((), device=params[0].device))
    return torch.sqrt(all_reduce_sum_(sq[0], model) + sq[1])


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float, model: RankGroup | None = None) -> None:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm (``grads_global_norm`` over ``model``) exceeds
    max_norm."""
    params = [p for p in params if p.grad is not None]
    norm = grads_global_norm(params, model)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        p.grad.mul_(scale)
