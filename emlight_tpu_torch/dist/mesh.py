"""Ranks, their devices, the rank's rows of a batch and the collectives of
data-parallel training and serving.

Port of emlight_tpu/dist/mesh.py to torch.distributed. JAX's 1-D data mesh
becomes one process ("rank") per card in one process group: NCCL between
cards, gloo on the CPU (and for CUDA tensors where NCCL cannot go, as two
ranks on one card). Parameters are replicated (``replicate``: a broadcast
from rank 0), batches are split over the ranks by rows (``shard_batch``),
and what JAX's ``pmean``/``psum``/``pmin``/``pmax`` over the data axis do
is done here by all-reduces over the group: gradients as one coalesced flat
buffer (``all_reduce_mean_``), BatchNorm moments with their cotangents
(``global_moments``), the Sinkhorn diameter (``global_extremum``), metrics
(``mean_metrics``). ``pad_leading`` pads a ragged serving batch to a
multiple of the rank count, as the JAX package's does.

A ``RankGroup`` names the group with its rank and size. It is what models,
losses and train states hold (``group=None``: one device, no collective).

``make_mesh`` lays the ranks out as JAX's 2-D mesh, a (data, model) grid
with rank = d·tp + m, and gives each rank its ``data`` group (the ranks of
its model index), its ``model`` group (the tp contiguous ranks of its data
index) and the whole grid (``world``). dist/auto.py's tensor parallelism
moves activations between the model ranks with two differentiable
collectives: ``all_gather_channels`` joins their channel slices (its
backward sums the readers' partial cotangents over ``model`` and keeps the
rank's slice: a reduce-scatter), ``split_channels`` takes the rank's slice
(its backward all-gathers the cotangent). ``mean_grads_`` averages a train
step's gradients on such a grid: the parameters split over ``model``
(``model_split``) over ``data``, the whole ones over the grid.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DIST_TIMEOUT_S", "RankGroup", "Mesh", "make_mesh", "all_gather_channels",
           "split_channels", "mark_model_split", "is_model_split", "mean_grads_", "join",
           "barrier", "leave", "rank_device", "shard_rows", "shard_batch", "replicate",
           "pad_leading", "all_reduce_mean_", "all_reduce_sum_", "mean_metrics",
           "global_moments", "global_extremum"]

# every collective of a group fails after this long instead of hanging (a
# rank that died, or one that stopped calling collectives)
DIST_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True, eq=False)
class RankGroup:
    """A process group with this process's rank in it and its size."""

    pg: object
    rank: int
    size: int


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) grid of ranks, as JAX's ``Mesh((data, model))``:
    this rank's ``data`` group (one rank per data index, all of its model
    index), its ``model`` group (the tp ranks of its data index) and the
    whole grid. None groups: one device."""

    data: RankGroup | None
    model: RankGroup | None
    world: RankGroup | None = None


def make_mesh(group: RankGroup | None, model_parallel: int = 1) -> Mesh:
    """The default group's ranks as a (size / tp, tp) grid, rank = d·tp + m
    (emlight_tpu/dist/mesh.py::make_mesh's reshape). Every rank must call
    it, in the same order as its other group creations: each rank creates
    every subgroup (torch.distributed.new_group), and a rank that created
    only its own would hang the others. ``group=None`` with tp 1: one
    device."""
    tp = model_parallel
    if group is None:
        if tp != 1:
            raise ValueError(f"model_parallel={tp} needs a group of ranks")
        return Mesh(None, None)
    if tp < 1 or group.size % tp:
        raise ValueError(f"{group.size} ranks not divisible by model_parallel={tp}")
    if group.size != dist.get_world_size():
        raise ValueError("make_mesh lays out the default group's ranks")
    dp = group.size // tp
    d, m = divmod(group.rank, tp)
    data = [dist.new_group([j * tp + i for j in range(dp)]) for i in range(tp)]
    model = [dist.new_group([j * tp + i for i in range(tp)]) for j in range(dp)]
    return Mesh(RankGroup(data[m], d, dp), RankGroup(model[d], m, tp), group)


def _gather(x: torch.Tensor, model: RankGroup, parts: int) -> torch.Tensor:
    """The model ranks' slices of x's last axis joined part by part."""
    x = x.contiguous()
    if dist.get_backend(model.pg) == "nccl":
        out = torch.empty((model.size, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=model.pg)
    else:
        outs = [torch.empty_like(x) for _ in range(model.size)]
        dist.all_gather(outs, x, group=model.pg)
        out = torch.stack(outs)
    lead, c = x.shape[:-1], x.shape[-1]
    return out.reshape(model.size, *lead, parts, c // parts).movedim(0, -2).reshape(
        *lead, model.size * c)


def _reduce_scatter(t: torch.Tensor, model: RankGroup) -> torch.Tensor:
    """t (tp, ...) summed over the model ranks; the rank's entry of it:
    NCCL's reduce-scatter, or an all-reduce of a copy on gloo."""
    if dist.get_backend(model.pg) == "nccl":
        t = t.contiguous()
        out = torch.empty(t.shape[1:], dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t, group=model.pg)
        return out
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=model.pg)
    return t[model.rank]


class _GatherChannels(torch.autograd.Function):
    """all_gather_channels with its backward: part by part, a cotangent its
    readers left partial is summed over ``model`` before the rank keeps its
    slice (a reduce-scatter); one they left whole is sliced alone."""

    @staticmethod
    def forward(ctx, x, model, parts, summed):
        ctx.model, ctx.parts, ctx.summed = model, parts, summed
        return _gather(x, model, parts)

    @staticmethod
    def backward(ctx, g):
        model, parts, summed = ctx.model, ctx.parts, ctx.summed
        lead = g.shape[:-1]
        g = g.reshape(*lead, parts, model.size, -1)
        mine = g.select(-2, model.rank)  # (..., parts, c / parts)
        sel = [p for p in range(parts) if summed[p]]
        if sel:
            part = g if len(sel) == parts else g[..., sel, :, :]
            red = _reduce_scatter(part.movedim(-2, 0), model)
            all_gather_channels.grad_calls += 1
            if len(sel) == parts:
                mine = red
            else:
                mine = mine.clone()
                mine[..., sel, :] = red
        return mine.reshape(*lead, -1), None, None, None


def all_gather_channels(x: torch.Tensor, model: RankGroup | None, parts: int = 1,
                        partial_grad: bool | tuple[bool, ...] = True) -> torch.Tensor:
    """The model ranks' slices of x's last axis joined, in model-rank order:
    (..., c) on each of tp ranks -> (..., tp·c). With ``parts`` the slices
    are cut into that many parts each, and each part is joined on its own
    (part p of the result is part p of every rank's slice, in rank order):
    the layout of a fused conv split by part. No collective for one model
    rank. Counted in ``all_gather_channels.calls``.

    Differentiable. ``partial_grad`` (one flag, or one per part) says how
    the result is read. True: by convs split over ``model`` (Cout/tp each),
    whose dx on each rank is a partial sum of the whole dx, so the backward
    sums the cotangent over ``model`` and keeps the rank's slice (a
    reduce-scatter, counted in ``all_gather_channels.grad_calls``). False:
    by an op that runs whole on every rank (the head's conv), whose
    cotangent is already the whole one on every rank: the backward keeps
    the rank's slice, with no collective (summing it would make the
    gradient tp times too large)."""
    if model is None or model.size == 1:
        return x
    all_gather_channels.calls += 1
    summed = (partial_grad,) * parts if isinstance(partial_grad, bool) else tuple(partial_grad)
    if len(summed) != parts:
        raise ValueError(f"{len(summed)} partial_grad flags for {parts} parts")
    return _GatherChannels.apply(x, model, parts, summed)


all_gather_channels.calls = 0
all_gather_channels.grad_calls = 0


class _SplitChannels(torch.autograd.Function):
    """split_channels with its backward: the all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        per = x.shape[-1] // model.size
        return x[..., model.rank * per:(model.rank + 1) * per].contiguous()

    @staticmethod
    def backward(ctx, g):
        split_channels.grad_calls += 1
        return _gather(g, ctx.model, 1), None


def split_channels(x: torch.Tensor, model: RankGroup | None) -> torch.Tensor:
    """The rank's contiguous slice r of tp of x's last axis, where x is
    whole on every model rank. Differentiable: each rank's cotangent is
    that of its slice, so the backward all-gathers them into the whole
    cotangent on every rank (counted in ``split_channels.grad_calls``)."""
    if model is None or model.size == 1:
        return x
    if x.shape[-1] % model.size:
        raise ValueError(f"{x.shape[-1]} channels do not split over {model.size} model ranks")
    return _SplitChannels.apply(x, model)


split_channels.grad_calls = 0


def mark_model_split(p: torch.Tensor) -> None:
    """Mark a parameter as this rank's slice of one split over ``model``
    (its gradient is averaged over ``data`` and its squares summed over
    ``model`` in the global norm)."""
    p.model_split = True


def is_model_split(p: torch.Tensor) -> bool:
    return getattr(p, "model_split", False)


@torch.no_grad()
def mean_grads_(params, group: RankGroup | None, mesh: Mesh | None = None) -> None:
    """Average the parameters' gradients over the ranks in place: over
    `group` (data parallelism); on a (data, model) ``mesh`` (dist/auto.py),
    the slices split over ``model`` (``is_model_split``) over ``mesh.data``
    and the parameters that are whole on every model rank over the whole
    grid. That is the same mean as over ``data`` (their gradients agree on
    the model ranks up to the order of float sums), and it leaves them
    equal bit for bit on every rank."""
    if mesh is None:
        all_reduce_mean_((p.grad for p in params), group)
        return
    params = list(params)
    all_reduce_mean_((p.grad for p in params if is_model_split(p)), mesh.data)
    all_reduce_mean_((p.grad for p in params if not is_model_split(p)), mesh.world)


def join(device: torch.device, init_method: str | None = None,
         timeout_s: float = DIST_TIMEOUT_S, backend: str | None = None) -> tuple[RankGroup, bool]:
    """The default process group as a RankGroup, initialised here if no
    one did: from torchrun's environment (``env://``, WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT) or from ``init_method`` with RANK and
    WORLD_SIZE from the environment. NCCL for a CUDA device, gloo else
    (``backend`` to choose: gloo carries CUDA tensors too, through the
    host, where NCCL cannot go, as for two ranks on one card). Returns
    (group, whether this call created it: the caller then ``leave``s
    it)."""
    created = not dist.is_initialized()
    if created:
        backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
        kw = {}
        if init_method is not None:
            kw = dict(init_method=init_method, rank=int(os.environ.get("RANK", 0)),
                      world_size=int(os.environ.get("WORLD_SIZE", 1)))
        dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s), **kw)
    return RankGroup(dist.group.WORLD, dist.get_rank(), dist.get_world_size()), created


def barrier(group: RankGroup | None) -> None:
    """Wait until every rank of the group is here."""
    if group is None:
        return
    if dist.get_backend(group.pg) == "nccl":
        dist.barrier(group=group.pg, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group.pg)


def leave(created: bool) -> None:
    """Destroy the default group if ``join`` created it."""
    if created and dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device: torch.device, group: RankGroup) -> torch.device:
    """The rank's device: for CUDA the card LOCAL_RANK names (the rank
    modulo the visible cards without it), made current; the CPU as is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    index = int(os.environ.get("LOCAL_RANK", group.rank % torch.cuda.device_count()))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def shard_rows(n: int, group: RankGroup | None) -> slice:
    """Rank r's rows [r·n/R, (r+1)·n/R) of a batch of n; n % R must be 0."""
    if group is None:
        return slice(0, n)
    if n % group.size:
        raise ValueError(f"a batch of {n} does not split over {group.size} ranks")
    per = n // group.size
    return slice(group.rank * per, (group.rank + 1) * per)


def shard_batch(batch: dict, group: RankGroup | None) -> dict:
    """The rank's rows of every leaf (arrays, tensors and lists)."""
    if group is None:
        return batch
    rows = shard_rows(len(next(iter(batch.values()))), group)
    return {k: v[rows] for k, v in batch.items()}


@torch.no_grad()
def replicate(modules, group: RankGroup | None) -> None:
    """Broadcast every parameter and buffer of the modules from rank 0, in
    place: ranks that built their models from seeds, or restored them, hold
    rank 0's afterwards."""
    if group is None or group.size == 1:
        return
    for m in modules:
        for t in [*m.parameters(), *m.buffers()]:
            dist.broadcast(t.data, src=0, group=group.pg)


def pad_leading(tree, multiple: int):
    """Pad every leaf's leading axis up to a multiple of `multiple` with
    copies of its last element (edge-repeat), as
    emlight_tpu/dist/mesh.py::pad_leading. A dict of leaves or one leaf
    (array, tensor or list). Returns (padded, n_original)."""
    leaves = list(tree.values()) if isinstance(tree, dict) else [tree]
    n = len(leaves[0])
    pad = (-n) % multiple
    if pad == 0:
        return tree, n
    reps = np.concatenate([np.arange(n), np.full(pad, n - 1)])

    def _pad(x):
        if isinstance(x, list):
            return [x[i] for i in reps]
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(reps, device=x.device)]
        return np.asarray(x)[reps]

    if isinstance(tree, dict):
        return {k: _pad(v) for k, v in tree.items()}, n
    return _pad(tree), n


@torch.no_grad()
def all_reduce_mean_(tensors, group: RankGroup | None) -> None:
    """Average the tensors over the ranks in place, as one flat buffer per
    dtype (one all-reduce each), summed and divided by R. None entries
    are skipped (a parameter without a gradient). `tensors` may be a
    generator: without a group it is not read, so one device pays no walk
    over the parameters."""
    if group is None:
        return
    tensors = [t for t in tensors if t is not None]
    for dt in dict.fromkeys(t.dtype for t in tensors):
        part = [t for t in tensors if t.dtype == dt]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, group=group.pg)
        flat /= group.size
        for t, v in zip(part, flat.split([t.numel() for t in part])):
            t.copy_(v.view_as(t))


@torch.no_grad()
def all_reduce_sum_(t: torch.Tensor, group: RankGroup | None) -> torch.Tensor:
    """Sum a tensor over the ranks in place (no gradient); returns it."""
    if group is not None:
        dist.all_reduce(t, group=group.pg)
    return t


def mean_metrics(metrics: dict, group: RankGroup | None) -> dict:
    """A dict of 0-d metric tensors averaged over the ranks (one
    all-reduce): each rank's metrics of its rows -> the global batch's, as
    JAX's pmean of the step's metrics."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float64) for k in keys])
    dist.all_reduce(flat, group=group.pg)
    flat /= group.size
    return {k: v.to(metrics[k].dtype) for k, v in zip(keys, flat.unbind())}


def global_moments(mu: torch.Tensor, mu2: torch.Tensor, group: RankGroup | None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global batch's per-channel (mean, mean of squares) from each
    rank's over its rows: one all-reduce of the stacked pair / R. The
    all-reduce is differentiable and its backward all-reduces the
    cotangents (JAX's pmean and its transpose), so each rank's rows get
    the whole batch's gradient through the moments. Equal shards
    assumed."""
    if group is None:
        return mu, mu2
    both = _SumOverRanks.apply(torch.stack([mu, mu2]), group) / group.size
    return both[0], both[1]


class _SumOverRanks(torch.autograd.Function):
    """A tensor summed over the ranks; its backward sums the cotangents over
    the ranks (the transpose of JAX's psum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group.pg)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group.pg)
        return g, None


@torch.no_grad()
def global_extremum(t: torch.Tensor, group: RankGroup | None, is_min: bool) -> torch.Tensor:
    """The min (or max) of a tensor over the ranks, without a gradient
    (JAX's pmin / pmax with a zero tangent)."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MIN if is_min else dist.ReduceOp.MAX, group=group.pg)
    return t
