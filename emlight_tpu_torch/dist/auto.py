"""Data x tensor parallel serving over a (data, model) grid of ranks.

Port of the serving half of emlight_tpu/dist/auto.py: ``auto_shard_state``,
``auto_shard_batch``, ``make_auto_inference`` and ``make_auto_pipeline``
over a ``dist/mesh.py::make_mesh`` grid. The JAX package commits its trees
to a ``Mesh((data, model))`` with shape-based PartitionSpecs and lets GSPMD
place the collectives; the port has no GSPMD, so the placement is written
out here:

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
  eval BatchNorm on the rank's slice of the running statistics,
  ``instance_norm``, SPADE's x·(1+γ)+β, LeakyReLU, the nearest upsample and
  the residual add; the first block takes the rank's slice of the
  encoder's map (a forward pre-hook on ``head_0``);
- the spectral σ = uᵀWv of a split kernel is each rank's u_rᵀW_r v summed
  over ``model`` (eval: the stored u and v, no power iteration).

The ConvEncoder (cuDNN SNConvs and a dense layer) and the DenseNet
regressor (B7's buffer eval forward) run whole on every ``model`` rank over
their ``data`` rows: GSPMD's conv output hook only hints a split there, and
equality with one device is the contract. The outputs are the rank's
``data`` rows, whole channels, equal on every ``model`` rank.

Eval only. The training half (the steps' partial dx summed over ``model``,
the power iteration on a split kernel, BatchNorm moments over ``data``)
and ``fullsize_check`` are the next slice; the split modules raise in
train mode.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from ..nn.densenet import DenseNet
from ..nn.layers import BatchNorm, spectral_sigma
from ..nn.spade import SPADEGenerator, SPADEResnetBlock
from ..nn.sphere_conv import SphereConv2D, sphere_conv
from ..train import pipeline as PL
from ..train import projector as P
from .mesh import Mesh, RankGroup, _SumOverRanks, all_gather_channels, shard_batch, shard_rows

__all__ = ["ColumnSphereConv", "rank_channels", "auto_shard_state", "auto_shard_batch",
           "make_auto_inference", "make_auto_pipeline"]


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

    Holds the rank's channels (``rank_channels``) of ``kernel`` and
    ``bias`` as contiguous copies (B1 refuses a strided kernel), and of an
    SNSphereConv's ``u`` with the whole ``v``. The forward all-gathers an
    input that arrives split over ``model``, runs ``sphere_conv`` on the
    whole input and the slice, and returns the slice (``gather_output``:
    the whole output, joined part by part). ``split`` is False where Cout
    does not divide by tp: the conv then runs whole on every rank.
    """

    def __init__(self, conv: SphereConv2D, model: RankGroup | None, parts: int = 1,
                 gather_output: bool = False):
        super().__init__()
        cin, cout = conv.kernel.shape[2], conv.kernel.shape[3]
        idx = rank_channels(cout, model, parts)
        self.split = idx is not None
        if idx is None:
            idx = torch.arange(cout)
        idx = idx.to(conv.kernel.device)
        self.model, self.parts, self.gather_output = model, parts, gather_output
        self.in_channels, self.out_channels = cin, cout
        self.stride, self.compute_dtype = conv.stride, conv.compute_dtype
        with torch.no_grad():
            self.kernel = nn.Parameter(conv.kernel[..., idx].contiguous())
            self.bias = None if conv.bias is None else nn.Parameter(conv.bias[idx].contiguous())
            if hasattr(conv, "u"):  # SNSphereConv
                self.register_buffer("u", conv.u[idx].contiguous())
                self.register_buffer("v", conv.v.clone())
            else:
                self.u = self.v = None
        self.train(conv.training)

    def sigma(self) -> torch.Tensor:
        """The spectral σ = uᵀWv of the whole kernel with the stored u, v:
        this rank's u_rᵀW_r v, summed over ``model`` where the kernel is
        split."""
        s = spectral_sigma(self.kernel, self.u, self.v).reshape(1)
        if self.split and self.model is not None and self.model.size > 1:
            s = _SumOverRanks.apply(s, self.model)
        return s[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("tensor-parallel sphere convs serve in eval mode only; training "
                               "over a (data, model) grid (partial dx summed over model, the "
                               "power iteration on a split kernel) is not ported yet")
        if x.shape[-1] != self.in_channels:
            x = all_gather_channels(x, self.model)
        kernel = self.kernel if self.u is None else self.kernel / self.sigma()
        cdt = self.compute_dtype
        y = sphere_conv(x.to(cdt).contiguous(), kernel.to(cdt), self.bias, self.stride)
        if self.gather_output and self.split:
            y = all_gather_channels(y, self.model, self.parts)
        return y


def _sliced_batchnorm(bn: BatchNorm | None, model: RankGroup | None) -> BatchNorm | None:
    """SPADE's parameter-free BatchNorm on the rank's slice of the running
    statistics, where its channels split over ``model`` (where they do not,
    x arrives whole and the norm stays whole)."""
    if bn is None:
        return None
    mean, var = bn.running_stats()
    idx = rank_channels(mean.numel(), model)
    if idx is None:
        return bn
    out = BatchNorm(idx.numel(), eps=bn.eps, momentum=bn.momentum, dtype=bn.dtype)
    out.train(bn.training)
    idx = idx.to(mean.device)
    with torch.no_grad():
        out.mean, out.var = mean[idx].clone(), var[idx].clone()
    return out


def _shard_block(block: SPADEResnetBlock, model: RankGroup | None) -> None:
    n_norms = 3 if block.learned_shortcut else 2
    block.mlp_shared = ColumnSphereConv(block.mlp_shared, model, parts=n_norms,
                                        gather_output=True)
    for name in ("norm_0", "norm_1", "norm_s")[:n_norms]:
        spade = getattr(block, name)
        spade.mlp_gammabeta = ColumnSphereConv(spade.mlp_gammabeta, model, parts=2)
        spade.param_free_norm = _sliced_batchnorm(spade.param_free_norm, model)
    for name in ("conv_0", "conv_1", "conv_s")[:n_norms]:
        setattr(block, name, ColumnSphereConv(getattr(block, name), model))


def auto_shard_state(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place a model on the mesh, in place; returns it. A SPADEGenerator's
    blocks and head take their column-parallel convs and sliced norms over
    ``mesh.model``, and its first block the rank's channels of the
    encoder's map; a DenseNet regressor runs whole on every rank and is
    returned as it is. The generator serves in eval mode only."""
    if isinstance(model, DenseNet):
        return model
    if not isinstance(model, SPADEGenerator):
        raise TypeError(f"auto_shard_state places a SPADEGenerator or a DenseNet, got "
                        f"{type(model).__name__}")
    if getattr(model, "auto_mesh", None) is not None:
        raise ValueError("the generator is already placed on a mesh")
    for block in model.modules():
        if isinstance(block, SPADEResnetBlock):
            _shard_block(block, mesh.model)
    model.sphere_conv1 = ColumnSphereConv(model.sphere_conv1, mesh.model)
    idx = rank_channels(16 * model.ngf, mesh.model)
    if idx is not None:
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        model.head_0.register_forward_pre_hook(lambda _, args: (args[0][..., lo:hi], *args[1:]))
    model.auto_mesh = mesh
    return model


def auto_shard_batch(batch, mesh: Mesh):
    """The rank's ``data`` rows of a batch: of every leaf of a dict, or of
    one array or tensor."""
    if isinstance(batch, dict):
        return shard_batch(batch, mesh.data)
    return batch[shard_rows(len(batch), mesh.data)]


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
