"""Data-parallel train steps and serving over the ranks of a group.

Port of emlight_tpu/dist/parallel.py. Each rank holds the whole model and
runs the single-device step on its rows of the global batch; what JAX's
shard_map does with collectives, the port's steps do under the state's
group (dist/mesh.py RankGroup):

- the gradients are averaged over the ranks after each backward, as ONE
  flat buffer per dtype (dist/mesh.py::all_reduce_mean_), before the
  gradient norms, clipping and Adam: JAX's ``pmean`` of the gradients
  (explicit all-reduces, not DistributedDataParallel, whose buffer
  broadcast would overwrite the spectral u, v and the running statistics,
  and whose hooks would fire on the D pass inside the G loss);
- BatchNorm takes the global batch's moments (``BatchNorm(group=...)``,
  the buffer route's ``_DenseBlock``), so its running statistics, and the
  spectral u, v (a power iteration on equal weights), come out equal on
  every rank without a collective;
- the Sinkhorn diameter is the global batch's and the EMD sum is scaled
  by the rank count (train/regression.py::loss_fn);
- the metrics are averaged over the ranks (``mean_metrics``), so every
  rank logs, and NaN-checks, the global batch's.

All of that happens inside the single-device steps, keyed on
``state.group``; the make_parallel_* functions keep the JAX package's
names and check that the state was built with the group.

R ranks so compute what one device computes on the global batch, up to
float reassociation. The states come from ``create_state(..., group)``.

Serving needs no collective: each rank runs its rows of a batch padded to
a multiple of R (``serving_rows``, mesh.pad_leading's edge repeat) and
keeps the outputs of the real ones.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..train import pipeline as PL
from ..train import projector as P
from ..train import regression as R
from .mesh import RankGroup, pad_leading, shard_rows

__all__ = ["make_parallel_regression_step", "make_parallel_projector_steps",
           "make_parallel_fused_step", "serving_rows", "make_parallel_predict",
           "make_parallel_inference", "make_parallel_pipeline"]


def _check(state, group: RankGroup) -> None:
    if state.group is not group:
        raise ValueError("the state was not built with this group: create_state(..., group)")


def make_parallel_regression_step(group: RankGroup) -> Callable:
    """step(state, batch) -> metrics averaged over the ranks: regression's
    train_step, checked to run under `group`; batch is the rank's rows,
    state from regression.create_state(cfg, dev, seed, group)."""

    def step(state: R.RegressionState, batch: dict) -> dict:
        _check(state, group)
        return R.train_step(state, batch)

    return step


def make_parallel_projector_steps(group: RankGroup, vgg=None) -> tuple[Callable, Callable]:
    """(g_step, d_step): projector's generator_step (with `vgg`'s
    perceptual term) and discriminator_step, checked to run under `group`;
    batch is the rank's rows, state from projector.create_state(...,
    group=group)."""

    def g_step(state: P.ProjectorState, batch: dict):
        _check(state, group)
        return P.generator_step(state, batch, vgg)

    def d_step(state: P.ProjectorState, batch: dict) -> dict:
        _check(state, group)
        return P.discriminator_step(state, batch)

    return g_step, d_step


def make_parallel_fused_step(group: RankGroup, vgg=None) -> Callable:
    """step(state, batch) -> (metrics averaged over the ranks, the rank's
    fake): projector.fused_gan_step, checked to run under `group`, both
    nets' gradients averaged in one all-reduce after both backwards."""

    def step(state: P.ProjectorState, batch: dict):
        _check(state, group)
        return P.fused_gan_step(state, batch, vgg)

    return step


def serving_rows(n: int, group: RankGroup | None) -> tuple[np.ndarray, int]:
    """The rows of a batch of n that this rank serves: the indices into the
    batch of its part of the batch padded to a multiple of R by repeating
    the last row, and how many of them, from the front, are real (the
    others are padding, whose outputs are dropped)."""
    if group is None:
        return np.arange(n), n
    padded, _ = pad_leading(np.arange(n), group.size)
    rows = shard_rows(len(padded), group)
    return padded[rows], max(0, min(n, rows.stop) - rows.start)


def _rows_of(batch, rows: np.ndarray):
    take = lambda v: v[torch.as_tensor(rows, device=v.device)] if isinstance(  # noqa: E731
        v, torch.Tensor) else np.asarray(v)[rows]
    return {k: take(v) for k, v in batch.items()} if isinstance(batch, dict) else take(batch)


def _real(out, n_real: int):
    return ({k: v[:n_real] for k, v in out.items()} if isinstance(out, dict) else out[:n_real])


def make_parallel_predict(cfg, group: RankGroup | None, apply_fn: Callable | None = None
                          ) -> Callable:
    """predict(model, crop) on the global batch -> (the batch rows this rank
    served, their heads): regression.predict over the rank's rows through
    the concat-free eval forward (make_eval_apply; `apply_fn` to
    override)."""
    eval_apply = apply_fn or R.make_eval_apply(cfg)

    def predict(model, crop):
        rows, n_real = serving_rows(len(crop), group)
        mine = torch.as_tensor(_rows_of(crop, rows), device=next(model.parameters()).device)
        return rows[:n_real], _real(R.predict(model, mine, eval_apply), n_real)

    return predict


def make_parallel_inference(cfg, group: RankGroup | None) -> Callable:
    """inference(generator, batch) on the global batch -> (the rows this
    rank served, their env maps): projector.inference over its rows."""

    def inference(generator, batch: dict):
        rows, n_real = serving_rows(len(batch["crop"]), group)
        return rows[:n_real], P.inference(generator, _rows_of(batch, rows), cfg)[:n_real]

    return inference


def make_parallel_pipeline(reg_cfg, proj_cfg, group: RankGroup | None) -> Callable:
    """pipeline(regressor, generator, crop_reg, crop_proj, device) on the
    global batch -> (the rows this rank served, their env maps, their
    predicted anchor parameters): pipeline_inference over its rows."""

    def pipeline(regressor, generator, crop_reg, crop_proj, device=None):
        rows, n_real = serving_rows(len(crop_reg), group)
        env, pred = PL.pipeline_inference(regressor, generator, _rows_of(crop_reg, rows),
                                          _rows_of(crop_proj, rows), reg_cfg, proj_cfg,
                                          device=device)
        return rows[:n_real], env[:n_real], _real(pred, n_real)

    return pipeline
