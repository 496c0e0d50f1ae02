"""DenseNet anchor regressor (EMLight stage 1): model construction, training
and eval.

Port of emlight_tpu/train/regression.py: ``make_model``, ``create_state``
(Adam, optional global-norm clipping in front, ``_maybe_clipped``),
``_make_sinkhorn``, ``loss_fn``, ``train_step``, ``eval_step``,
``predict``, ``make_train_apply``, ``make_eval_apply``,
``make_baked_infer`` and ``fold_for_inference``. The loss is the
reference's 1000·Sinkhorn + 1000·L2(dist) + 0.1·L2(intensity) +
100·L2(rgb) + 1·L2(ambient) (RegressionNetwork/train.py:92-98), with the
Sinkhorn EMD SUMMED over the batch and every L2 term a mean. Every step
updates the BatchNorm running statistics.

Forwards go through the state's ``apply_fn(model, crop, train)``, as in the
JAX package. ``cfg.train_forward`` picks it: "buffer" (the default, as
there) is ``make_train_apply``, the concat-free buffer forwards of
nn/densenet_fast.py, train_apply with its block backward in training and
buffer_apply at eval; "standard" is the DenseNet module's own graph
(``standard_apply``), the one ``cfg.remat`` acts on. As in the JAX package,
``remat`` changes nothing under "buffer".

Data-parallel training (dist/parallel.py): ``create_state(..., group)``
builds the regressor with its BatchNorms synced over the ranks' group (a
dist/mesh.py RankGroup), ``train_step`` averages the gradients over the
ranks before clipping and the update, and ``loss_fn`` takes the Sinkhorn
diameter over the global batch and scales the rank's EMD sum by the rank
count, so that the averaged gradient is the global batch's sum
(emlight_tpu/train/regression.py:143). On a (data, model) grid
(dist/auto.py's ``auto_shard_state``, which sets ``state.mesh``) the
regressor runs whole on every model rank over its data rows, and its
gradients are averaged over the whole grid (dist/mesh.py::mean_grads_).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..config import RegressionConfig
from ..core.device import resolve_device
from ..dist.mesh import mean_grads_, mean_metrics
from ..losses.sinkhorn import SamplesLoss
from ..nn import densenet_fast as DF
from ..nn.densenet import DenseNet, fold_eval_variables
from .optim import clip_by_global_norm, global_norm

__all__ = ["make_model", "predict", "RegressionState", "create_state", "loss_fn",
           "train_step", "eval_step", "standard_apply", "make_train_apply", "make_eval_apply",
           "make_baked_infer", "fold_for_inference", "HEADS"]

HEADS = ("fc_dist", "fc_intensity", "fc_rgb_ratio", "fc_ambient")


def make_model(cfg: RegressionConfig, device=None, seed: int = 0,
               fold_bn: bool = False, group=None) -> DenseNet:
    """The regressor in eval mode on `device` (CUDA unless "cpu" is asked),
    computing in ``cfg.dtype`` (float32 parameters), its dense layers
    rematerialized in the standard train forward if ``cfg.remat``;
    ``fold_bn`` builds the eval-only folded layout of ``fold_for_inference``;
    ``group`` syncs its BatchNorms over the ranks in training.

    Weights are drawn on the CPU from a torch.Generator seeded with `seed`,
    so one seed gives the same model on every device.
    """
    dev = resolve_device(device)
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"regressor dtype {cfg.dtype!r}: float32 or bfloat16")
    gen = torch.Generator().manual_seed(seed)
    model = DenseNet(
        growth_rate=cfg.growth_rate,
        block_config=cfg.block_config,
        num_init_features=cfg.num_init_features,
        n_anchors=cfg.anchors.regression_anchors,
        input_hw=(cfg.crop_h, cfg.crop_w),
        generator=gen,
        dtype=getattr(torch, cfg.dtype),
        remat=cfg.remat,
        fold_bn=fold_bn,
        group=group,
    )
    return model.eval().to(dev)


def standard_apply(model: DenseNet, crop: torch.Tensor, train: bool = False):
    """The DenseNet module's own forward, in train or eval mode."""
    return model.train(train)(crop)


def make_train_apply(cfg: RegressionConfig) -> Callable:
    """The default forward of training, ``cfg.train_forward == "buffer"``:
    apply_fn(model, crop, train) runs nn/densenet_fast.py's train_apply
    (the concat-free buffer forward with its block backward) in training and
    buffer_apply at eval. ``cfg.remat`` is not read, as the JAX package's
    make_train_apply does not read it."""

    def apply_fn(model: DenseNet, crop: torch.Tensor, train: bool = False):
        model.train(train)
        if train:
            return DF.train_apply(model, crop)
        return DF.buffer_apply(model, crop)

    return apply_fn


def make_eval_apply(cfg: RegressionConfig) -> Callable:
    """The default forward of inference: apply_fn(model, crop) runs the
    concat-free buffer eval forward (nn/densenet_fast.py::buffer_apply) on
    the model's parameters and running statistics. Eval only."""

    def apply_fn(model: DenseNet, crop: torch.Tensor, train: bool = False):
        if train:
            raise ValueError("buffer_apply is an eval-only forward")
        return DF.buffer_apply(model.eval(), crop)

    return apply_fn


def make_baked_infer(cfg: RegressionConfig, model: DenseNet) -> Callable:
    """Serving inference for one checkpoint: a closure ``infer(crop) ->
    heads`` over the buffer eval forward with every BatchNorm affine and
    kernel layout computed once, here (nn/densenet_fast.py::eval_plan). Its
    outputs equal ``make_eval_apply(cfg)(model, crop)``'s bit for bit; the
    model must not change while the closure serves."""
    model.eval()
    plan = DF.eval_plan(model)

    def infer(crop: torch.Tensor) -> dict[str, torch.Tensor]:
        return DF.buffer_forward(model, plan, crop)

    return infer


def fold_for_inference(cfg: RegressionConfig, model: DenseNet) -> DenseNet:
    """The eval model with every dense layer's norm2 folded into its conv2
    kernel and a bias (nn/densenet.py::fold_eval_variables): a new
    ``fold_bn`` DenseNet in eval mode on the model's device, whose standard
    eval forward equals the model's up to float reassociation."""
    folded = make_model(cfg, device=next(model.parameters()).device, fold_bn=True)
    folded.load_state_dict(fold_eval_variables(model.state_dict()))
    return folded


def predict(model: DenseNet, crop: torch.Tensor, apply_fn: Callable | None = None
            ) -> dict[str, torch.Tensor]:
    """Inference: crop (B, H, W, 3) -> anchor parameter dict
    {distribution (B, N), intensity (B, 1), rgb_ratio (B, 3), ambient (B, 3)},
    through ``apply_fn(model, crop, train=False)`` (the model's own eval
    forward if None)."""
    with torch.inference_mode():
        return (apply_fn or standard_apply)(model, crop, train=False)


@dataclasses.dataclass
class RegressionState:
    """The model (its parameters and BatchNorm running statistics), Adam,
    the step count, the forward (``apply_fn(model, crop, train)``), the
    ranks' group (None on one device) and the (data, model) grid
    dist/auto.py placed the state on (None otherwise). ``train_step``
    updates the first three in place."""

    cfg: RegressionConfig
    model: DenseNet
    opt: torch.optim.Adam
    step: int = 0
    apply_fn: Callable = standard_apply
    group: object = None
    mesh: object = None


def create_state(cfg: RegressionConfig, device=None, seed: int = 0,
                 group=None) -> RegressionState:
    """make_model's regressor, Adam(cfg.lr, cfg.betas, eps 1e-8), the
    update optax.adam makes, and the forward ``cfg.train_forward`` names
    ("buffer": ``make_train_apply``; "standard": the module's graph).
    cfg.clip_grad_norm > 0 clips the global gradient norm before each
    update (off by default, as in the reference). ``group`` (a
    dist/mesh.py RankGroup): a rank's state of data-parallel training."""
    if cfg.train_forward not in ("buffer", "standard"):
        raise ValueError(f"train_forward {cfg.train_forward!r}: 'buffer' or 'standard'")
    model = make_model(cfg, device, seed, group=group)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=tuple(cfg.betas), eps=1e-8)
    apply_fn = make_train_apply(cfg) if cfg.train_forward == "buffer" else standard_apply
    return RegressionState(cfg=cfg, model=model, opt=opt, apply_fn=apply_fn, group=group)


def _make_sinkhorn(cfg: RegressionConfig, group=None) -> SamplesLoss:
    s = cfg.sinkhorn
    return SamplesLoss("sinkhorn", p=s.p, blur=s.blur, scaling=s.scaling, diameter=s.diameter,
                       n_iters=s.n_iters, n_anchors=cfg.anchors.regression_anchors,
                       backend=s.backend, group=group)


def _batch_on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}


def loss_fn(model: DenseNet, batch: dict, cfg: RegressionConfig, train: bool,
            apply_fn: Callable = standard_apply, group=None):
    """Forward (``apply_fn(model, crop, train)``) + composite loss. batch:
    crop (B, H, W, 3), distribution (B, N), intensity (B,), rgb_ratio
    (B, 3), ambient (B, 3). Returns (total, metrics, pred). With the
    ranks' ``group`` the batch is the rank's rows: the Sinkhorn diameter is
    the global batch's and the EMD sum is scaled by the rank count (the
    reference SUMS it over the batch, while every L2 term is a mean)."""
    b = _batch_on(batch, next(model.parameters()).device)
    pred = apply_fn(model, b["crop"], train=train)
    emd = _make_sinkhorn(cfg, group)
    emd_scale = 1 if group is None else group.size
    mse = lambda p, t: torch.mean((p - t) ** 2)  # noqa: E731
    metrics = {
        "dist_emloss": emd(pred["distribution"][..., None],
                           b["distribution"][..., None]).sum() * (cfg.w_emd * emd_scale),
        "dist_l2loss": mse(pred["distribution"], b["distribution"]) * cfg.w_dist_l2,
        "intensity_loss": mse(pred["intensity"][:, 0], b["intensity"]) * cfg.w_intensity,
        "rgb_loss": mse(pred["rgb_ratio"], b["rgb_ratio"]) * cfg.w_rgb,
        "ambient_loss": mse(pred["ambient"], b["ambient"]) * cfg.w_ambient,
    }
    total = sum(metrics.values())
    return total, {"loss": total, **metrics}, pred


def train_step(state: RegressionState, batch: dict) -> dict:
    """One Adam step on one batch. Returns the metrics ("loss" and the five
    terms; with cfg.log_grad_norms also "grad_norm" and "grad_norm_<head>" of
    the gradients before clipping) as detached 0-d tensors. The gradients
    stay in the parameters' ``.grad`` after the update. Under
    ``state.group`` the batch is the rank's rows and the gradients are
    averaged over the ranks before the norms, clipping and the update, and
    the metrics are averaged over the ranks (the global batch's)."""
    cfg, model = state.cfg, state.model
    state.opt.zero_grad(set_to_none=True)
    total, metrics, _ = loss_fn(model, batch, cfg, True, state.apply_fn, state.group)
    total.backward()
    mean_grads_(model.parameters(), state.group, state.mesh)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if cfg.log_grad_norms:
        # the reference's gradient probes (panorama.py:41-64) as metrics
        named = dict(model.named_parameters())
        metrics["grad_norm"] = global_norm([p.grad for p in named.values()])
        for head in HEADS:
            metrics[f"grad_norm_{head}"] = global_norm(
                [p.grad for n, p in named.items() if n.startswith(head + ".")])
    if cfg.clip_grad_norm and cfg.clip_grad_norm > 0:
        clip_by_global_norm(model.parameters(), cfg.clip_grad_norm)
    state.opt.step()
    state.step += 1
    return mean_metrics(metrics, state.group)


@torch.no_grad()
def eval_step(state: RegressionState, batch: dict):
    """Eval-mode forward and the same loss terms, no update: (metrics, pred)."""
    _, metrics, pred = loss_fn(state.model, batch, state.cfg, False, state.apply_fn)
    return metrics, pred
