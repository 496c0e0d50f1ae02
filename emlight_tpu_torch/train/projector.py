"""SPADE GenProjector (EMLight stage 2): models, adversarial training steps
and eval.

Port of emlight_tpu/train/projector.py: ``make_models`` (generator) and
``make_discriminator`` (its discriminator half), ``create_state``,
``_lr_schedule``, ``make_guide``, ``_run_g``, ``_run_d``, ``generator_step``,
``discriminator_step`` and ``inference``:
- TTUR Adam pair (G lr/2, D lr*2, betas (beta1, beta2));
- generator step: hinge GAN + mask-weighted feature matching + cosine x5,
  with the discriminator frozen (no dK is computed for it);
- discriminator step: hinge real/fake on a detached fake; fake and real go
  through D as ONE batch of 2B.
Every train-mode forward updates the spectral-norm u, v and G's BatchNorm
running statistics, including D's forward inside the generator step and G's
forward inside the discriminator step (torch's state dynamics).

Not ported here: the VGG perceptual term (the JAX CLI runs without it when
no VGG19 weights are present, and so does this port), ``use_vae`` training,
``fused_gan_step`` and ``scanned_fused_steps``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from ..config import ProjectorConfig
from ..core.device import resolve_device
from ..losses.gan import cosine_loss, feature_matching_loss, gan_loss
from ..nn.discriminator import MultiscaleDiscriminator
from ..nn.spade import SPADEGenerator
from ..representation.splat import render_anchor_params
from .optim import clip_by_global_norm

__all__ = ["make_models", "make_discriminator", "make_guide", "inference", "compute_dtype",
           "ProjectorState", "create_state", "generator_step", "discriminator_step"]


def compute_dtype(cfg: ProjectorConfig) -> torch.dtype:
    """cfg.dtype -> the conv compute dtype ("bfloat16": bf16 sphere convs and
    SNConvs with f32 accumulation; everything else stays f32)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def make_models(cfg: ProjectorConfig, device=None, seed: int = 0) -> SPADEGenerator:
    """The generator in eval mode on `device` (CUDA unless "cpu" is asked).

    Weights are drawn on the CPU from a torch.Generator seeded with `seed`,
    so one seed gives the same model on every device.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    g = SPADEGenerator(
        ngf=cfg.ngf,
        norm_type="syncbatch" if "syncbatch" in cfg.norm_g else "instance",
        num_upsampling_layers=cfg.num_upsampling_layers,
        crop_size=cfg.crop_size,
        aspect_ratio=2.0,
        use_vae=cfg.use_vae,
        label_nc=cfg.semantic_nc,
        compute_dtype=compute_dtype(cfg),
        generator=gen,
    )
    return g.eval().to(dev)


def make_discriminator(cfg: ProjectorConfig, device=None, seed: int = 1) -> MultiscaleDiscriminator:
    """The multiscale discriminator (train mode) on `device`; it reads the
    guide and an env map stacked on channels. Weights drawn on the CPU from
    a torch.Generator seeded with `seed`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = MultiscaleDiscriminator(cfg.semantic_nc + cfg.output_nc, ndf=cfg.ndf, num_d=cfg.num_d,
                                n_layers=cfg.n_layers_d, compute_dtype=compute_dtype(cfg),
                                generator=gen)
    return d.train().to(dev)


def _env_hw(cfg: ProjectorConfig) -> tuple[int, int]:
    return cfg.crop_size // 2, cfg.crop_size


def make_guide(batch: dict, cfg: ProjectorConfig) -> torch.Tensor:
    """Rasterize the anchor-GT environment map:
    env = (splat(dist * intensity * rgb) + ambient) * alpha."""
    env_h, env_w = _env_hw(cfg)
    env = render_anchor_params(
        batch["distribution"], batch["intensity"], batch["rgb_ratio"], batch["ambient"],
        n=batch["distribution"].shape[-1], h=env_h, w=env_w, size=cfg.anchors.splat_size,
    )
    return env * batch["alpha"][:, None, None, None]


@torch.inference_mode()
def inference(generator: SPADEGenerator, batch: dict, cfg: ProjectorConfig) -> torch.Tensor:
    """Eval-mode generation from an anchor-GT batch (with "crop")."""
    return generator(make_guide(batch, cfg), batch["crop"])


@dataclasses.dataclass
class ProjectorState:
    """The two models, their Adam optimizers and the step counts. The
    modules and optimizers are updated in place by the steps."""

    cfg: ProjectorConfig
    g: SPADEGenerator
    d: MultiscaleDiscriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    lr_g: Callable[[int], float]
    lr_d: Callable[[int], float]
    step: int = 0      # generator updates (the JAX state's step)
    d_step: int = 0    # discriminator updates


def _lr_schedule(base_lr: float, cfg: ProjectorConfig,
                 steps_per_epoch: int | None) -> Callable[[int], float]:
    """Constant for niter epochs, then linear decay to 0 over niter_decay
    epochs; constant when steps_per_epoch is None."""
    if steps_per_epoch is None:
        return lambda step: base_lr

    def schedule(step: int) -> float:
        over = max(step // steps_per_epoch - cfg.niter, 0)
        return base_lr * float(np.clip(1.0 - over / cfg.niter_decay, 0.0, 1.0))

    return schedule


def create_state(cfg: ProjectorConfig, device=None, seed: int = 0,
                 steps_per_epoch: int | None = None) -> ProjectorState:
    """G and D in train mode on `device` (CUDA unless "cpu" is asked), with
    the TTUR Adam pair: G at lr/2, D at lr*2, betas (beta1, beta2), eps 1e-8
    (optax.adam's). G's weights come from `seed`, D's from `seed + 1`."""
    if cfg.use_vae:
        raise NotImplementedError("use_vae training is not ported")
    g = make_models(cfg, device, seed).train()
    d = make_discriminator(cfg, device, seed + 1)
    betas = (cfg.beta1, cfg.beta2)
    lr_g = _lr_schedule(cfg.lr / 2, cfg, steps_per_epoch)
    lr_d = _lr_schedule(cfg.lr * 2, cfg, steps_per_epoch)
    return ProjectorState(
        cfg=cfg, g=g, d=d,
        opt_g=torch.optim.Adam(g.parameters(), lr=lr_g(0), betas=betas, eps=1e-8),
        opt_d=torch.optim.Adam(d.parameters(), lr=lr_d(0), betas=betas, eps=1e-8),
        lr_g=lr_g, lr_d=lr_d,
    )


def _batch_on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}


def _run_g(state: ProjectorState, guide: torch.Tensor, crop: torch.Tensor) -> torch.Tensor:
    return state.g(guide, crop)


def _run_d(state: ProjectorState, guide: torch.Tensor, fake: torch.Tensor, real: torch.Tensor):
    """Fake and real through D as one batch of 2B; the outputs split back."""
    x = torch.cat([torch.cat([guide, fake], -1), torch.cat([guide, real], -1)], 0)
    out = state.d(x)
    b = fake.shape[0]
    pred_fake = [[t[:b] for t in per_d] for per_d in out]
    pred_real = [[t[b:] for t in per_d] for per_d in out]
    return pred_fake, pred_real


def _update(opt: torch.optim.Adam, lr: float, params, clip: float) -> None:
    if clip and clip > 0:
        clip_by_global_norm(params, clip)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def generator_step(state: ProjectorState, batch: dict):
    """One generator update. Returns (losses, fake): losses "GAN",
    "GAN_Feat", "COS" and "loss_G" as 0-d tensors, fake (B, H, W, 3).

    D runs in train mode (its u, v update) with its parameters frozen, so
    the backward computes dx through D but no dK for it. The gradients stay
    in G's ``.grad`` after the update.
    """
    cfg = state.cfg
    g, d = state.g.train(), state.d.train()
    b = _batch_on(batch, next(g.parameters()).device)
    guide = make_guide(b, cfg)
    real, light_map = b["warped"], b["map"][..., None]
    state.opt_g.zero_grad(set_to_none=True)
    d.requires_grad_(False)
    try:
        fake = _run_g(state, guide, b["crop"])
        pred_fake, pred_real = _run_d(state, guide, fake, real)
        losses = {
            "GAN": gan_loss(pred_fake, True, for_discriminator=False, mode=cfg.gan_mode),
            "GAN_Feat": feature_matching_loss(pred_fake, pred_real, light_map,
                                              cfg.ambient_feat_weight),
            "COS": cosine_loss(fake, real) * cfg.lambda_cos,
        }
        total = sum(losses.values())
        total.backward()
    finally:
        d.requires_grad_(True)
    _update(state.opt_g, state.lr_g(state.step), g.parameters(), cfg.clip_grad_norm)
    state.step += 1
    losses = {k: v.detach() for k, v in losses.items()}
    return {**losses, "loss_G": total.detach()}, fake.detach()


def discriminator_step(state: ProjectorState, batch: dict) -> dict:
    """One discriminator update. Returns "D_Fake", "D_real" and "loss_D".

    G runs in train mode under no_grad (its BatchNorm statistics and u, v
    update; the fake is detached). The gradients stay in D's ``.grad``.
    """
    cfg = state.cfg
    g, d = state.g.train(), state.d.train()
    b = _batch_on(batch, next(g.parameters()).device)
    guide = make_guide(b, cfg)
    with torch.no_grad():
        fake = _run_g(state, guide, b["crop"])
    state.opt_d.zero_grad(set_to_none=True)
    pred_fake, pred_real = _run_d(state, guide, fake, b["warped"])
    d_fake = gan_loss(pred_fake, False, for_discriminator=True, mode=cfg.gan_mode)
    d_real = gan_loss(pred_real, True, for_discriminator=True, mode=cfg.gan_mode)
    total = d_fake + d_real
    total.backward()
    _update(state.opt_d, state.lr_d(state.d_step), d.parameters(), cfg.clip_grad_norm)
    state.d_step += 1
    return {"D_Fake": d_fake.detach(), "D_real": d_real.detach(), "loss_D": total.detach()}
