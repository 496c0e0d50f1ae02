"""Gradient helpers shared by the training steps: optax's global norm and
global-norm clipping on the ``.grad`` of a set of parameters."""

from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all gradients together."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm exceeds max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
