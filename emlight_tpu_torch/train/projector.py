"""SPADE GenProjector (EMLight stage 2): models, adversarial training steps
and eval.

Port of emlight_tpu/train/projector.py: ``make_models`` (generator) and
``make_discriminator`` (its discriminator half), ``create_state``,
``_lr_schedule``, ``make_guide``, ``_run_d``, ``generator_step``,
``discriminator_step``, ``fused_gan_step``, ``scanned_fused_steps`` and
``inference``:
- TTUR Adam pair (G lr/2, D lr*2, betas (beta1, beta2));
- generator step: hinge GAN + mask-weighted feature matching + cosine x5,
  + VGG x5 when VGG19 weights are given (nn/vgg.py), + the KLD term under
  use_vae; the discriminator frozen (no dK is computed for it);
- discriminator step: hinge real/fake on a detached fake; fake and real go
  through D as ONE batch of 2B;
- fused step: both updates from ONE generator forward (Jacobi updates, the
  JAX package's --fused); the scanned steps: N fused steps with no host
  synchronisation between them.
Every train-mode forward updates the spectral-norm u, v and G's BatchNorm
running statistics, including D's forward inside the generator step and G's
forward inside the discriminator step (torch's state dynamics); the fused
step keeps one update of each, as the JAX package's does.

use_vae: the latent noise cannot follow ``jax.random``'s bits. Each step
draws it on G's device from a torch.Generator seeded from the step, as the
JAX steps fold the step into their keys: (0xEA, step) in the G and fused
steps, (0xDA, step) in the D step; or takes it from the ``eps`` argument.

Data-parallel training (dist/parallel.py): ``create_state(..., group)``
syncs G's "syncbatch" norms over the ranks' group (a dist/mesh.py
RankGroup), each step averages the gradients of the nets it updates over
the ranks after its backward (clipping acts on the averages) and returns
the metrics averaged over the ranks (the global batch's), and the
use_vae noise is drawn for the global batch and sliced to the rank's rows.
G's BatchNorm statistics and both nets' u, v stay equal on every rank
without a collective: the statistics are the global batch's and the power
iteration reads the weights only.

Tensor-parallel training (dist/auto.py): ``auto_shard_state`` places a
state built with ``group=mesh.data`` on a (data, model) grid and sets
``state.mesh``. The steps then average the gradients of G's slices over
``data`` and those of the whole parameters over the grid
(dist/mesh.py::mean_grads_), and clip by the norm of the whole gradients
(train/optim.py::grads_global_norm over ``model``).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Callable

import numpy as np
import torch

from ..config import ProjectorConfig
from ..core.device import resolve_device
from ..dist.mesh import mean_grads_, mean_metrics, shard_rows
from ..losses.gan import cosine_loss, feature_matching_loss, gan_loss, kld_loss
from ..nn.discriminator import MultiscaleDiscriminator
from ..nn.spade import SPADEGenerator
from ..nn.vgg import VGG19Features, vgg_perceptual_loss
from ..representation.splat import render_anchor_params
from .optim import clip_by_global_norm

__all__ = ["make_models", "make_discriminator", "make_guide", "inference", "compute_dtype",
           "ProjectorState", "create_state", "generator_step", "discriminator_step",
           "fused_gan_step", "scanned_fused_steps", "vae_noise"]

# the use_vae noise streams' seeds: G (and fused) steps, D steps
VAE_G_SEED, VAE_D_SEED = 0xEA, 0xDA


def compute_dtype(cfg: ProjectorConfig) -> torch.dtype:
    """cfg.dtype -> the conv compute dtype ("bfloat16": bf16 sphere convs and
    SNConvs with f32 accumulation; everything else stays f32)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def make_models(cfg: ProjectorConfig, device=None, seed: int = 0,
                group=None) -> SPADEGenerator:
    """The generator in eval mode on `device` (CUDA unless "cpu" is asked),
    its "syncbatch" norms synced over `group` in training.

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
        group=group,
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
    """The two models, their Adam optimizers, the step counts, the ranks'
    group (None on one device) and the (data, model) grid dist/auto.py
    placed the state on (None otherwise). The modules and optimizers are
    updated in place by the steps."""

    cfg: ProjectorConfig
    g: SPADEGenerator
    d: MultiscaleDiscriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    lr_g: Callable[[int], float]
    lr_d: Callable[[int], float]
    step: int = 0      # generator updates (the JAX state's step)
    d_step: int = 0    # discriminator updates
    group: object = None
    mesh: object = None


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
                 steps_per_epoch: int | None = None, group=None) -> ProjectorState:
    """G and D in train mode on `device` (CUDA unless "cpu" is asked), with
    the TTUR Adam pair: G at lr/2, D at lr*2, betas (beta1, beta2), eps 1e-8
    (optax.adam's). G's weights come from `seed`, D's from `seed + 1`.
    With cfg.use_vae the encoder has the fc_mu and fc_var heads. ``group``
    (a dist/mesh.py RankGroup): a rank's state of data-parallel training."""
    g = make_models(cfg, device, seed, group).train()
    d = make_discriminator(cfg, device, seed + 1)
    betas = (cfg.beta1, cfg.beta2)
    lr_g = _lr_schedule(cfg.lr / 2, cfg, steps_per_epoch)
    lr_d = _lr_schedule(cfg.lr * 2, cfg, steps_per_epoch)
    return ProjectorState(
        cfg=cfg, g=g, d=d,
        opt_g=torch.optim.Adam(g.parameters(), lr=lr_g(0), betas=betas, eps=1e-8),
        opt_d=torch.optim.Adam(d.parameters(), lr=lr_d(0), betas=betas, eps=1e-8),
        lr_g=lr_g, lr_d=lr_d, group=group,
    )


def _batch_on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}


def vae_noise(state: ProjectorState, seed: int, b: int) -> torch.Tensor:
    """A use_vae step's latent noise: N(0, 1) of shape (b, 32 * ngf) on G's
    device, from a torch.Generator seeded from (seed, state.step) (mixed by
    numpy's SeedSequence into the 32 bits the CPU generator reads). Under
    ``state.group`` b is the rank's rows: the noise is drawn for the global
    batch and the rank's rows are kept, so R ranks draw what one device
    does."""
    dev = next(state.g.parameters()).device
    ranks = 1 if state.group is None else state.group.size
    mixed = np.random.SeedSequence([seed, state.step]).generate_state(1)[0]
    gen = torch.Generator(device=dev).manual_seed(int(mixed))
    eps = torch.randn((b * ranks, 32 * state.cfg.ngf), generator=gen, device=dev)
    return eps[shard_rows(b * ranks, state.group)]


def _run_d(state: ProjectorState, guide: torch.Tensor, fake: torch.Tensor, real: torch.Tensor):
    """Fake and real through D as one batch of 2B; the outputs split back."""
    x = torch.cat([torch.cat([guide, fake], -1), torch.cat([guide, real], -1)], 0)
    out = state.d(x)
    b = fake.shape[0]
    pred_fake = [[t[:b] for t in per_d] for per_d in out]
    pred_real = [[t[b:] for t in per_d] for per_d in out]
    return pred_fake, pred_real


def _update(state: ProjectorState, opt: torch.optim.Adam, lr: float, params) -> None:
    clip = state.cfg.clip_grad_norm
    if clip and clip > 0:
        clip_by_global_norm(params, clip, None if state.mesh is None else state.mesh.model)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def _generator_losses(state: ProjectorState, b: dict, guide: torch.Tensor,
                      vgg: VGG19Features | None, eps: torch.Tensor | None):
    """G's forward and its losses with D frozen: (fake, losses, total)."""
    cfg = state.cfg
    real, light_map = b["warped"], b["map"][..., None]
    d = state.d.requires_grad_(False)
    try:
        if cfg.use_vae:
            if eps is None:
                eps = vae_noise(state, VAE_G_SEED, real.shape[0])
            fake, (mu, logvar) = state.g(guide, b["crop"], eps=eps, want_vae=True)
        else:
            fake = state.g(guide, b["crop"])
        pred_fake, pred_real = _run_d(state, guide, fake, real)
    finally:
        d.requires_grad_(True)
    losses = {
        "GAN": gan_loss(pred_fake, True, for_discriminator=False, mode=cfg.gan_mode),
        "GAN_Feat": feature_matching_loss(pred_fake, pred_real, light_map,
                                          cfg.ambient_feat_weight),
        "COS": cosine_loss(fake, real) * cfg.lambda_cos,
    }
    if vgg is not None:
        losses["VGG"] = cfg.lambda_vgg * vgg_perceptual_loss(vgg, fake, real)
    if cfg.use_vae:
        losses["KLD"] = kld_loss(mu, logvar) * cfg.lambda_kld
    return fake, losses, sum(losses.values())


def _discriminator_losses(state: ProjectorState, guide: torch.Tensor, fake: torch.Tensor,
                          real: torch.Tensor):
    """D's hinge losses on a detached fake: (D_Fake, D_real, total)."""
    cfg = state.cfg
    pred_fake, pred_real = _run_d(state, guide, fake, real)
    d_fake = gan_loss(pred_fake, False, for_discriminator=True, mode=cfg.gan_mode)
    d_real = gan_loss(pred_real, True, for_discriminator=True, mode=cfg.gan_mode)
    return d_fake, d_real, d_fake + d_real


def _detached(metrics: dict, group) -> dict:
    """The step's metrics, detached, averaged over the ranks under a group."""
    return mean_metrics({k: v.detach() for k, v in metrics.items()}, group)


def generator_step(state: ProjectorState, batch: dict, vgg: VGG19Features | None = None,
                   eps: torch.Tensor | None = None):
    """One generator update. Returns (losses, fake): losses "GAN",
    "GAN_Feat", "COS" (+ "VGG" with `vgg`, + "KLD" under use_vae) and
    "loss_G" as 0-d tensors, fake (B, H, W, 3).

    D runs in train mode (its u, v update) with its parameters frozen, so
    the backward computes dx through D but no dK for it. VGG's weights are
    frozen and its real branch runs without a graph. eps: the use_vae
    latent noise (``vae_noise(state, VAE_G_SEED, B)`` when None). The
    gradients stay in G's ``.grad`` after the update.
    """
    cfg = state.cfg
    g = state.g.train()
    state.d.train()
    b = _batch_on(batch, next(g.parameters()).device)
    guide = make_guide(b, cfg)
    state.opt_g.zero_grad(set_to_none=True)
    fake, losses, total = _generator_losses(state, b, guide, vgg, eps)
    total.backward()
    mean_grads_(g.parameters(), state.group, state.mesh)
    _update(state, state.opt_g, state.lr_g(state.step), g.parameters())
    state.step += 1
    return _detached({**losses, "loss_G": total}, state.group), fake.detach()


def discriminator_step(state: ProjectorState, batch: dict,
                       eps: torch.Tensor | None = None) -> dict:
    """One discriminator update. Returns "D_Fake", "D_real" and "loss_D".

    G runs in train mode under no_grad (its BatchNorm statistics and u, v
    update; the fake is detached); a use_vae G re-samples its latent (eps,
    or ``vae_noise(state, VAE_D_SEED, B)`` when None). The gradients stay
    in D's ``.grad``.
    """
    cfg = state.cfg
    g, d = state.g.train(), state.d.train()
    b = _batch_on(batch, next(g.parameters()).device)
    guide = make_guide(b, cfg)
    if cfg.use_vae and eps is None:
        eps = vae_noise(state, VAE_D_SEED, guide.shape[0])
    with torch.no_grad():
        fake = g(guide, b["crop"], eps=eps) if cfg.use_vae else g(guide, b["crop"])
    state.opt_d.zero_grad(set_to_none=True)
    d_fake, d_real, total = _discriminator_losses(state, guide, fake, b["warped"])
    total.backward()
    mean_grads_(d.parameters(), state.group, state.mesh)
    _update(state, state.opt_d, state.lr_d(state.d_step), d.parameters())
    state.d_step += 1
    return _detached({"D_Fake": d_fake, "D_real": d_real, "loss_D": total}, state.group)


def fused_gan_step(state: ProjectorState, batch: dict, vgg: VGG19Features | None = None,
                   eps: torch.Tensor | None = None):
    """One G update and one D update sharing a single generator forward.
    Returns (metrics, fake): generator_step's losses and
    discriminator_step's, fake (B, H, W, 3).

    As the JAX package's fused_gan_step: G's gradients are generator_step's;
    D's are discriminator_step's at the PRE-update G, on the detached fake
    (a Jacobi update where the alternating steps take a Gauss-Seidel one);
    both Adam updates apply after both backwards. G's BatchNorm statistics
    and u, v update once, from the one G forward. The D pass inside G's
    loss runs in train mode (its power iteration gives the sigma the loss
    sees) but its u, v update is thrown away: the D loss starts again from
    D's u, v before the step and keeps its own update, so D's u, v move
    once per step. ``step`` and ``d_step`` each advance by one. The
    gradients stay in ``.grad``.
    """
    cfg = state.cfg
    g, d = state.g.train(), state.d.train()
    b = _batch_on(batch, next(g.parameters()).device)
    guide = make_guide(b, cfg)
    state.opt_g.zero_grad(set_to_none=True)
    state.opt_d.zero_grad(set_to_none=True)
    d_uv = [t.clone() for t in d.buffers()]  # D's spectral u, v before the step
    fake, g_losses, g_total = _generator_losses(state, b, guide, vgg, eps)
    g_total.backward()
    with torch.no_grad():
        for t, before in zip(d.buffers(), d_uv):
            t.copy_(before)
    fake = fake.detach()
    d_fake, d_real, d_total = _discriminator_losses(state, guide, fake, b["warped"])
    d_total.backward()
    mean_grads_(itertools.chain(g.parameters(), d.parameters()), state.group, state.mesh)
    _update(state, state.opt_g, state.lr_g(state.step), g.parameters())
    _update(state, state.opt_d, state.lr_d(state.d_step), d.parameters())
    state.step += 1
    state.d_step += 1
    return _detached({**g_losses, "loss_G": g_total, "D_Fake": d_fake, "D_real": d_real,
                      "loss_D": d_total}, state.group), fake


def scanned_fused_steps(state: ProjectorState, batches: dict,
                        vgg: VGG19Features | None = None):
    """N fused_gan_step iterations (the JAX package's lax.scan of them,
    --scan_steps N) with no host synchronisation between them.

    `batches` holds every batch leaf with a leading step axis, (N, B, ...),
    arrays or tensors; it goes onto G's device in one copy. Returns
    (metrics stacked (N,) on the device, the last fake): the caller reads
    the N steps' metrics once.
    """
    b = _batch_on(batches, next(state.g.parameters()).device)
    rows = []
    for i in range(len(b["crop"])):
        metrics, fake = fused_gan_step(state, {k: v[i] for k, v in b.items()}, vgg)
        rows.append(metrics)
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}, fake
