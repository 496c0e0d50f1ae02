"""Data x tensor parallel training and serving over a (data, model) grid of
ranks.

Port of emlight_tpu/dist/auto.py: ``auto_shard_state``,
``auto_shard_batch``, ``make_auto_regression_step``,
``make_auto_projector_steps``, ``make_auto_inference`` and
``make_auto_pipeline`` over a ``dist/mesh.py::make_mesh`` grid. The JAX
package commits its trees to a ``Mesh((data, model))`` with shape-based
PartitionSpecs and lets GSPMD place the collectives; the port has no GSPMD,
so the placement is written out here:

- batches are split by rows over ``data`` (``auto_shard_batch``);
- every sphere conv of the SPADE blocks, and the head, becomes a
  ``ColumnSphereConv``: the rank's contiguous slice of the output channels
  of ``kernel``, ``bias`` and the spectral ``u`` (``v`` indexes (kh, kw, in)
  and stays whole), as ``_leaf_spec`` shards a leaf's trailing axis over
  ``model`` where it divides. Its input is all-gathered over ``model``
  where it arrives split, and B1 (``sphere_conv`` on a CUDA tensor) runs on
  the whole input and the Cout/tp slice. A conv whose Cout does not divide
  by tp runs whole on every rank, as ``_leaf_spec`` replicates it: the
  head (Cout 3) is one;
- the port fuses convs that GSPMD never splits by part: a SPADE's γ‖β conv
  (``mlp_gammabeta``, 2C outputs) and a block's ``mlp_shared`` (one
  nhidden part per norm). Each is split by part (rank r holds part p's
  slice r of every part p), so the rank's γ and β slices line up with its
  slice of x; ``mlp_shared``'s output is all-gathered part by part before
  the norms' γ‖β convs read it;
- activations stay split through the per-channel ops between two convs:
  BatchNorm on the rank's channels (train: the moments over ``data``;
  eval: the rank's slice of the running statistics), ``instance_norm``,
  SPADE's x·(1+γ)+β, LeakyReLU, the nearest upsample and the residual add;
  the first block takes the rank's slice of the encoder's map
  (``split_channels`` in a forward pre-hook on ``head_0``);
- the spectral σ = uᵀWv of a split kernel is each rank's u_rᵀW_r v summed
  over ``model``. Train mode runs the power iteration on the split kernel
  first: v = normalize(Σ_r W_rᵀu_r) (one all-reduce of a 9·Cin vector),
  u_r = W_r v / (‖W v‖ + eps) with ‖W v‖² = Σ_r ‖W_r v‖² (one scalar
  all-reduce); the gradient flows through W only, as on one device.

The ConvEncoder (cuDNN SNConvs and a dense layer), the discriminator and
the DenseNet regressor (B7 and, in training, B7′ and B8) run whole on every
``model`` rank over their ``data`` rows: GSPMD's conv output hook only
hints a split there, and equality with one device is the contract. The
outputs are the rank's ``data`` rows, whole channels, equal on every
``model`` rank.

Training. A rank's state is built with ``create_state(cfg, device, seed,
group=mesh.data)`` (BatchNorm moments, the Sinkhorn diameter, the EMD scale
and the metrics over ``data``) and placed with ``auto_shard_state``, which
rebuilds G's Adam over its slices. The loss is computed whole on every
model rank (the head gathers), so the backward needs:

- the gathers' backward: a split conv's dx (B3, B6 or B5 on the rank's
  Cout/tp slice of the cotangent) is a partial sum of the whole dx, so the
  gather in front of it sums its cotangent over ``model`` and keeps the
  rank's slice (a reduce-scatter; by part after ``mlp_shared``); a conv
  that runs whole (the head) leaves the whole cotangent on every rank,
  which is sliced alone (``all_gather_channels``' ``partial_grad``). This
  holds because the channel counts only shrink towards the head: a split
  conv never reads an input that a whole op made;
- ``head_0``'s input slice: its backward all-gathers the cotangent, so
  the encoder gets the whole gradient on every rank;
- the gradient averages (dist/mesh.py::mean_grads_): G's slices over
  ``data``, the whole parameters (encoder, head, discriminator, regressor)
  over the whole grid, which is the same mean and keeps them equal bit for
  bit on the model ranks; clipping by one device's global norm
  (train/optim.py::grads_global_norm over ``model``).

B4's dK on the slice stays local.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from ..nn.densenet import DenseNet
from ..nn.layers import BatchNorm, l2_normalize, spectral_power_iteration, spectral_sigma
from ..nn.spade import SPADEGenerator, SPADEResnetBlock
from ..nn.sphere_conv import SphereConv2D, sphere_conv
from ..train import pipeline as PL
from ..train import projector as P
from ..train import regression as R
from .mesh import (Mesh, RankGroup, _SumOverRanks, all_gather_channels, all_reduce_sum_,
                   mark_model_split, shard_batch, shard_rows, split_channels)

__all__ = ["ColumnSphereConv", "rank_channels", "auto_shard_state", "auto_shard_batch",
           "make_auto_regression_step", "make_auto_projector_steps", "make_auto_inference",
           "make_auto_pipeline"]


def rank_channels(n: int, model: RankGroup | None, parts: int = 1) -> torch.Tensor | None:
    """The output channels of n that this model rank holds, split by part:
    n in ``parts`` equal parts, of each part the rank's contiguous slice r of
    tp, in part order. None where a part does not divide by tp (the conv
    runs whole)."""
    tp = 1 if model is None else model.size
    part = n // parts
    if n % parts or part % tp:
        return None
    per = part // tp
    r = 0 if model is None else model.rank
    return torch.cat([torch.arange(p * part + r * per, p * part + (r + 1) * per)
                      for p in range(parts)])


class ColumnSphereConv(nn.Module):
    """A SphereConv2D's, or an SNSphereConv's, output-channel slice on one
    model rank (column parallelism), built from the whole conv.

    Holds the rank's channels (``rank_channels``, kept in ``channels``) of
    ``kernel`` and ``bias`` as contiguous copies (B1 refuses a strided
    kernel), and of an SNSphereConv's ``u`` with the whole ``v``. The
    forward all-gathers an input that arrives split over ``model``, runs
    ``sphere_conv`` on the whole input and the slice, and returns the slice
    (``gather_output``: the whole output, joined part by part, its readers
    split convs or not as ``readers_split`` says, one flag per part).
    ``split`` is False where Cout does not divide by tp: the conv then
    runs whole on every rank. In train mode an SNSphereConv's power
    iteration runs on the split kernel and updates u, v in place.
    """

    def __init__(self, conv: SphereConv2D, model: RankGroup | None, parts: int = 1,
                 gather_output: bool = False, readers_split: bool | tuple[bool, ...] = True):
        super().__init__()
        cin, cout = conv.kernel.shape[2], conv.kernel.shape[3]
        idx = rank_channels(cout, model, parts)
        self.split = idx is not None
        if idx is None:
            idx = torch.arange(cout)
        self.channels = idx.to(conv.kernel.device)
        self.model, self.parts = model, parts
        self.gather_output, self.readers_split = gather_output, readers_split
        self.in_channels, self.out_channels = cin, cout
        self.stride, self.compute_dtype = conv.stride, conv.compute_dtype
        with torch.no_grad():
            self.kernel = nn.Parameter(conv.kernel[..., self.channels].contiguous())
            self.bias = (None if conv.bias is None
                         else nn.Parameter(conv.bias[self.channels].contiguous()))
            if hasattr(conv, "u"):  # SNSphereConv
                self.register_buffer("u", conv.u[self.channels].contiguous())
                self.register_buffer("v", conv.v.clone())
            else:
                self.u = self.v = None
        if self._sums_over_model():
            for p in self.parameters():
                mark_model_split(p)
        self.train(conv.training)

    def _sums_over_model(self) -> bool:
        return self.split and self.model is not None and self.model.size > 1

    def sigma(self, u: torch.Tensor | None = None, v: torch.Tensor | None = None
              ) -> torch.Tensor:
        """The spectral σ = uᵀWv of the whole kernel (the stored u, v unless
        given): this rank's u_rᵀW_r v, summed over ``model`` where the
        kernel is split (its backward sums the cotangent over ``model``:
        every rank divides its slice by σ)."""
        s = spectral_sigma(self.kernel, self.u if u is None else u,
                           self.v if v is None else v).reshape(1)
        if self._sums_over_model():
            s = _SumOverRanks.apply(s, self.model)
        return s[0]

    @torch.no_grad()
    def _power_iteration(self, eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
        """One power iteration on the split kernel (spectral_power_iteration
        where it is whole); stores and returns the fresh (u_r, v)."""
        if not self._sums_over_model():
            u, v = spectral_power_iteration(self.kernel, self.u, eps)
        else:
            wmat = self.kernel.detach().reshape(-1, self.kernel.shape[-1]).t()  # (out/tp, rest)
            v = l2_normalize(all_reduce_sum_(wmat.t() @ self.u, self.model), eps)
            wv = wmat @ v
            u = wv / (torch.sqrt(all_reduce_sum_((wv * wv).sum(), self.model)) + eps)
        self.u.copy_(u)
        self.v.copy_(v)
        return u, v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_channels:
            x = all_gather_channels(x, self.model, partial_grad=self.split)
        kernel = self.kernel
        if self.u is not None:
            uv = self._power_iteration() if self.training else (None, None)
            kernel = kernel / self.sigma(*uv)
        cdt = self.compute_dtype
        y = sphere_conv(x.to(cdt).contiguous(), kernel.to(cdt), self.bias, self.stride)
        if self.gather_output and self.split:
            y = all_gather_channels(y, self.model, self.parts, self.readers_split)
        return y


def _sliced_batchnorm(bn: BatchNorm | None, model: RankGroup | None) -> BatchNorm | None:
    """SPADE's parameter-free BatchNorm on the rank's channels, where they
    split over ``model`` (where they do not, x arrives whole and the norm
    stays whole): the rank's slice of the running statistics, and in train
    mode the moments over the norm's group (a state's ``mesh.data``)."""
    if bn is None:
        return None
    mean, var = bn.running_stats()
    idx = rank_channels(mean.numel(), model)
    if idx is None:
        return bn
    out = BatchNorm(idx.numel(), eps=bn.eps, momentum=bn.momentum, dtype=bn.dtype,
                    group=bn.group)
    out.train(bn.training)
    idx = idx.to(mean.device)
    with torch.no_grad():
        out.mean, out.var = mean[idx].clone(), var[idx].clone()
    return out


def _shard_block(block: SPADEResnetBlock, model: RankGroup | None) -> None:
    n_norms = 3 if block.learned_shortcut else 2
    norms = [getattr(block, name) for name in ("norm_0", "norm_1", "norm_s")[:n_norms]]
    for spade in norms:
        spade.mlp_gammabeta = ColumnSphereConv(spade.mlp_gammabeta, model, parts=2)
        spade.param_free_norm = _sliced_batchnorm(spade.param_free_norm, model)
    # part p of mlp_shared's gathered output is read by norm p's γ‖β conv
    block.mlp_shared = ColumnSphereConv(
        block.mlp_shared, model, parts=n_norms, gather_output=True,
        readers_split=tuple(spade.mlp_gammabeta.split for spade in norms))
    for name in ("conv_0", "conv_1", "conv_s")[:n_norms]:
        setattr(block, name, ColumnSphereConv(getattr(block, name), model))


def _place_generator(model: SPADEGenerator, mesh: Mesh) -> SPADEGenerator:
    if getattr(model, "auto_mesh", None) is not None:
        raise ValueError("the generator is already placed on a mesh")
    for block in model.modules():
        if isinstance(block, SPADEResnetBlock):
            _shard_block(block, mesh.model)
    model.sphere_conv1 = ColumnSphereConv(model.sphere_conv1, mesh.model)
    if rank_channels(16 * model.ngf, mesh.model) is not None:
        model.head_0.register_forward_pre_hook(
            lambda _, args: (split_channels(args[0], mesh.model), *args[1:]))
    model.auto_mesh = mesh
    return model


@torch.no_grad()
def _sliced_adam(opt: torch.optim.Adam, before: dict, generator: SPADEGenerator
                 ) -> torch.optim.Adam:
    """Adam over the placed generator's parameters, with opt's settings and
    each parameter's moments taken from opt's state of the whole parameter
    it came from (``before``: name -> parameter), at the slice's channels
    (``_leaf_spec`` shards the moments like their leaves)."""
    new = torch.optim.Adam(generator.parameters(), **opt.defaults)
    new.param_groups[0]["lr"] = opt.param_groups[0]["lr"]
    channels = {f"{name}.{pn}": m.channels for name, m in generator.named_modules()
                if isinstance(m, ColumnSphereConv) for pn, _ in m.named_parameters(recurse=False)}
    for name, p in generator.named_parameters():
        whole = before[name]
        idx = channels.get(name)
        new.state[p] = {
            k: (v[..., idx.to(v.device)].clone() if idx is not None and v.shape == whole.shape
                else v.clone()) if torch.is_tensor(v) else v
            for k, v in opt.state.get(whole, {}).items()}
    return new


def auto_shard_state(state, mesh: Mesh):
    """Place a model, or a train state, on the mesh, in place; returns it.

    A SPADEGenerator's blocks and head take their column-parallel convs and
    sliced norms over ``mesh.model``, and its first block the rank's
    channels of the encoder's map; a DenseNet regressor runs whole on every
    rank and is returned as it is. A train state must have been built with
    ``group=mesh.data``: a ProjectorState's G is placed so, and its Adam
    rebuilt over the slices with their moments (``_sliced_adam``); D runs
    whole. A RegressionState's regressor runs whole. Both record the mesh
    in ``state.mesh``, which their steps read."""
    if isinstance(state, (R.RegressionState, P.ProjectorState)):
        if state.group is not mesh.data:
            raise ValueError("the state was not built over this mesh's data group: "
                             "create_state(cfg, device, seed, group=mesh.data)")
        if state.mesh is not None:
            raise ValueError("the state is already placed on a mesh")
        if isinstance(state, P.ProjectorState):
            before = dict(state.g.named_parameters())
            _place_generator(state.g, mesh)
            state.opt_g = _sliced_adam(state.opt_g, before, state.g)
        state.mesh = mesh
        return state
    if isinstance(state, DenseNet):
        return state
    if not isinstance(state, SPADEGenerator):
        raise TypeError(f"auto_shard_state places a SPADEGenerator or a DenseNet, or their "
                        f"train states, got {type(state).__name__}")
    return _place_generator(state, mesh)


def auto_shard_batch(batch, mesh: Mesh):
    """The rank's ``data`` rows of a batch: of every leaf of a dict, or of
    one array or tensor."""
    if isinstance(batch, dict):
        return shard_batch(batch, mesh.data)
    return batch[shard_rows(len(batch), mesh.data)]


def _check_state(state, cfg, mesh: Mesh) -> None:
    if state.mesh is not mesh:
        raise ValueError("the state was not placed on this mesh: auto_shard_state(state, mesh)")
    if state.group is not mesh.data:
        raise ValueError("the state was not built over this mesh's data group")
    if state.cfg != cfg:
        raise ValueError("the state was built with another config than the step's")


def make_auto_regression_step(cfg, mesh: Mesh) -> Callable:
    """step(state, batch) -> metrics averaged over ``data``, equal on every
    model rank: regression's train_step on the rank's data rows
    (``auto_shard_batch``), the state from ``create_state(cfg, device,
    seed, group=mesh.data)`` placed with ``auto_shard_state``. The
    regressor runs whole on every model rank; its BatchNorm moments, the
    Sinkhorn diameter and the EMD scale are over ``data``, its gradients
    averaged over the whole grid."""

    def step(state: R.RegressionState, batch: dict) -> dict:
        _check_state(state, cfg, mesh)
        return R.train_step(state, batch)

    return step


def make_auto_projector_steps(cfg, mesh: Mesh) -> tuple[Callable, Callable, Callable]:
    """(g_step, d_step, fused): projector's generator_step ->
    (losses, fake), discriminator_step -> losses and fused_gan_step ->
    (metrics, fake), without the VGG term (the JAX package's
    ``vgg_apply=None``), on the rank's data rows, the state from
    ``create_state(cfg, device, seed, group=mesh.data)`` placed with
    ``auto_shard_state``. The metrics are averaged over ``data`` and the
    fakes are the rank's rows, whole channels: both equal on every model
    rank."""

    def g_step(state: P.ProjectorState, batch: dict):
        _check_state(state, cfg, mesh)
        return P.generator_step(state, batch)

    def d_step(state: P.ProjectorState, batch: dict) -> dict:
        _check_state(state, cfg, mesh)
        return P.discriminator_step(state, batch)

    def fused(state: P.ProjectorState, batch: dict):
        _check_state(state, cfg, mesh)
        return P.fused_gan_step(state, batch)

    return g_step, d_step, fused


def _check(generator: SPADEGenerator, mesh: Mesh) -> None:
    if getattr(generator, "auto_mesh", None) is not mesh:
        raise ValueError("the generator was not placed on this mesh: auto_shard_state(g, mesh)")
    if generator.training:
        raise RuntimeError("tensor-parallel serving runs the generator in eval mode")


def make_auto_inference(cfg, mesh: Mesh) -> Callable:
    """inference(generator, batch) -> the env maps of the rank's data rows:
    projector.inference (eval-mode synthesis from an anchor-GT batch) with
    the generator from ``auto_shard_state(g, mesh)`` and the batch from
    ``auto_shard_batch``. The models live on the rank's device
    (``rank_device``)."""

    def inference(generator: SPADEGenerator, batch: dict) -> torch.Tensor:
        _check(generator, mesh)
        return P.inference(generator, batch, cfg)

    return inference


def make_auto_pipeline(reg_cfg, proj_cfg, mesh: Mesh) -> Callable:
    """pipeline(regressor, generator, crop_reg, crop_proj, device=None) ->
    (env maps, pred) of the rank's data rows: pipeline_inference (regressor
    -> guide -> generator) with the generator from ``auto_shard_state(g,
    mesh)`` and the crops from ``auto_shard_batch``; `device` as
    pipeline_inference's (CUDA unless "cpu" is asked; a CUDA request
    without CUDA raises), where both models live."""

    def pipeline(regressor, generator, crop_reg, crop_proj, device=None):
        _check(generator, mesh)
        return PL.pipeline_inference(regressor, generator, crop_reg, crop_proj, reg_cfg,
                                     proj_cfg, device=device)

    return pipeline
