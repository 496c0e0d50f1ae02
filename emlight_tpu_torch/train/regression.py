"""DenseNet anchor regressor (EMLight stage 1): model construction, training
and eval.

Port of emlight_tpu/train/regression.py: ``make_model``, ``create_state``
(Adam, optional global-norm clipping in front, ``_maybe_clipped``),
``_make_sinkhorn``, ``loss_fn``, ``train_step``, ``eval_step`` and
``predict``. The loss is the reference's
1000·Sinkhorn + 1000·L2(dist) + 0.1·L2(intensity) + 100·L2(rgb) +
1·L2(ambient) (RegressionNetwork/train.py:92-98), with the Sinkhorn EMD
SUMMED over the batch and every L2 term a mean. The train forward is the
DenseNet's standard graph with the fused norm2 -> conv2 (nn/densenet.py);
every step updates the BatchNorm running statistics.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import RegressionConfig
from ..core.device import resolve_device
from ..losses.sinkhorn import SamplesLoss
from ..nn.densenet import DenseNet
from .optim import clip_by_global_norm, global_norm

__all__ = ["make_model", "predict", "RegressionState", "create_state", "loss_fn",
           "train_step", "eval_step", "HEADS"]

HEADS = ("fc_dist", "fc_intensity", "fc_rgb_ratio", "fc_ambient")


def make_model(cfg: RegressionConfig, device=None, seed: int = 0) -> DenseNet:
    """The regressor in eval mode on `device` (CUDA unless "cpu" is asked).

    Weights are drawn on the CPU from a torch.Generator seeded with `seed`,
    so one seed gives the same model on every device.
    """
    dev = resolve_device(device)
    if cfg.dtype != "float32":
        raise NotImplementedError(f"regressor dtype {cfg.dtype!r}: only float32 is ported")
    gen = torch.Generator().manual_seed(seed)
    model = DenseNet(
        growth_rate=cfg.growth_rate,
        block_config=cfg.block_config,
        num_init_features=cfg.num_init_features,
        n_anchors=cfg.anchors.regression_anchors,
        input_hw=(cfg.crop_h, cfg.crop_w),
        generator=gen,
    )
    return model.eval().to(dev)


@torch.inference_mode()
def predict(model: DenseNet, crop: torch.Tensor) -> dict[str, torch.Tensor]:
    """Inference: crop (B, H, W, 3) -> anchor parameter dict
    {distribution (B, N), intensity (B, 1), rgb_ratio (B, 3), ambient (B, 3)}."""
    return model(crop)


@dataclasses.dataclass
class RegressionState:
    """The model (its parameters and BatchNorm running statistics), Adam and
    the step count. ``train_step`` updates all three in place."""

    cfg: RegressionConfig
    model: DenseNet
    opt: torch.optim.Adam
    step: int = 0


def create_state(cfg: RegressionConfig, device=None, seed: int = 0) -> RegressionState:
    """make_model's regressor and Adam(cfg.lr, cfg.betas, eps 1e-8), the
    update optax.adam makes. cfg.clip_grad_norm > 0 clips the global gradient
    norm before each update (off by default, as in the reference)."""
    model = make_model(cfg, device, seed)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=tuple(cfg.betas), eps=1e-8)
    return RegressionState(cfg=cfg, model=model, opt=opt)


def _make_sinkhorn(cfg: RegressionConfig) -> SamplesLoss:
    s = cfg.sinkhorn
    return SamplesLoss("sinkhorn", p=s.p, blur=s.blur, scaling=s.scaling, diameter=s.diameter,
                       n_iters=s.n_iters, n_anchors=cfg.anchors.regression_anchors,
                       backend=s.backend)


def _batch_on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}


def loss_fn(model: DenseNet, batch: dict, cfg: RegressionConfig):
    """Forward (in the model's current mode) + composite loss. batch: crop
    (B, H, W, 3), distribution (B, N), intensity (B,), rgb_ratio (B, 3),
    ambient (B, 3). Returns (total, metrics, pred)."""
    b = _batch_on(batch, next(model.parameters()).device)
    pred = model(b["crop"])
    emd = _make_sinkhorn(cfg)
    mse = lambda p, t: torch.mean((p - t) ** 2)  # noqa: E731
    metrics = {
        "dist_emloss": emd(pred["distribution"][..., None],
                           b["distribution"][..., None]).sum() * cfg.w_emd,
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
    stay in the parameters' ``.grad`` after the update."""
    cfg, model = state.cfg, state.model.train()
    state.opt.zero_grad(set_to_none=True)
    total, metrics, _ = loss_fn(model, batch, cfg)
    total.backward()
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
    return metrics


@torch.no_grad()
def eval_step(state: RegressionState, batch: dict):
    """Eval-mode forward and the same loss terms, no update: (metrics, pred)."""
    _, metrics, pred = loss_fn(state.model.eval(), batch, state.cfg)
    return metrics, pred
