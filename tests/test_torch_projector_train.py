"""Port of the SPADE GAN training steps (emlight_tpu_torch.train.projector)
against the JAX package, at the TINY config of tests/test_projector_train.py
(ngf 8, ndf 8, crop 64 -> 32x64 env maps, 96 anchors, batch 2), with the
weights of the JAX package's create_state carried across by the bridge.

One generator_step and one discriminator_step run on both sides from the
same state. Compared: the losses, EVERY gradient leaf of G and of D, the
BatchNorm running statistics and the spectral-norm u, v the steps leave.
Parameters after the Adam update are not compared: with beta1 = 0 the first
step moves each parameter by about lr * sign(g), which hides the gradient.
The JAX gradients are read exactly by running the JAX step with an optax
transformation whose update is zero and whose state is the gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emlight_tpu.config import AnchorConfig, ProjectorConfig
from emlight_tpu.train import projector as P
from emlight_tpu.train.data import synthetic_projector_batch as j_batch
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train.data import synthetic_projector_batch as t_batch
from emlight_tpu_torch.train.jax_weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
)
from emlight_tpu_torch.train.optim import clip_by_global_norm
from torch_port_helpers import capture_tx, jax_projector_state, port_projector_cfg

TINY = dataclasses.replace(
    ProjectorConfig(), crop_size=64, ngf=8, ndf=8, batch_size=2,
    anchors=AnchorConfig(n_anchors=96, env_h=32, env_w=64),
)

# Tolerances. The reference runs at tests/conftest.py's XLA optimization
# level 0, where the guide's splat rounds an ulp differently from the port
# (2.4e-5 of the guide, ROADMAP.md section 3); that difference, and f32 sums
# taken in other orders, pass through 44 sphere convs, 21 batch norms and
# the losses. Values and state: rtol 1e-4. Gradients: each leaf within 2e-4
# of its own largest magnitude (measured: at most 3e-5), but never of less
# than 1e-3 of the model's largest gradient: some leaves are zero in exact
# arithmetic and hold only rounding noise (the bias of a conv followed by a
# batch norm; the logit bias of D under a balanced hinge loss).
LOSS_RTOL = 1e-4
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 2e-4
GRAD_FLOOR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run():
    """Both sides' G step and D step; returns what the tests compare."""
    batch = j_batch(2, n_anchors=96, crop_size=32, env_hw=(32, 64), seed=1)
    tx = capture_tx()
    s0 = jax_projector_state(TINY, 0)  # create_state with its inits jitted at XLA level 0
    s0 = s0.replace(tx_g=tx, tx_d=tx, g_opt=tx.init(s0.g_params), d_opt=tx.init(s0.d_params))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    s1, j_g_losses, j_fake = P.generator_step(s0, jbatch, TINY)
    s2, j_d_losses = P.discriminator_step(s1, jbatch, TINY)

    state = TP.create_state(port_projector_cfg(TINY), device="cpu")

    def load(s):
        state.g.load_state_dict(generator_state_from_jax(_np(s.g_params), _np(s.g_stats)),
                                strict=True)
        state.d.load_state_dict(discriminator_state_from_jax(_np(s.d_params), _np(s.d_stats)),
                                strict=True)

    load(s0)
    t_g_losses, t_fake = TP.generator_step(state, batch)
    g_grads = {k: p.grad.clone() for k, p in state.g.named_parameters()}
    d_grads_in_g_step = [p.grad for p in state.d.parameters()]
    g_step = dict(g_sd=state.g.state_dict(), d_sd=state.d.state_dict())
    g_step = {k: {n: t.clone() for n, t in sd.items()} for k, sd in g_step.items()}
    load(s1)  # the D step starts from the JAX state after its G step
    t_d_losses = TP.discriminator_step(state, batch)
    d_grads = {k: p.grad.clone() for k, p in state.d.named_parameters()}
    return dict(
        batch=batch, s1=s1, s2=s2, j_g_losses=j_g_losses, j_d_losses=j_d_losses,
        j_fake=np.asarray(j_fake), t_g_losses=t_g_losses, t_fake=t_fake.numpy(),
        t_d_losses=t_d_losses, g_grads=g_grads, d_grads=d_grads,
        d_grads_in_g_step=d_grads_in_g_step, g_step=g_step,
        g_sd_after_d=state.g.state_dict(), d_sd_after_d=state.d.state_dict(),
        t_step=(state.step, state.d_step),
    )


def test_port_batch_equals_jax():
    a = j_batch(2, n_anchors=96, crop_size=32, env_hw=(32, 64), seed=5)
    b = t_batch(2, n_anchors=96, crop_size=32, env_hw=(32, 64), seed=5)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _grads_close(port: dict, ref: dict, what: str):
    assert set(port) == set(ref), (sorted(set(port) ^ set(ref)))[:5]
    model_scale = max(r.abs().max().item() for r in ref.values())
    for name, r in ref.items():
        r = r.numpy()
        err = np.abs(port[name].numpy() - r).max()
        scale = max(np.abs(r).max(), GRAD_FLOOR * model_scale)
        assert err <= GRAD_REL * scale, f"{what} {name}: {err} > {GRAD_REL} * {scale}"


def test_generator_step_losses_and_fake(run):
    for k, v in run["j_g_losses"].items():
        np.testing.assert_allclose(run["t_g_losses"][k].item(), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    # (tanh+1)*25 range: atol 5e-4 is 1e-5 of it
    np.testing.assert_allclose(run["t_fake"], run["j_fake"], rtol=1e-4, atol=5e-4)


def test_generator_step_gradients_every_leaf(run):
    ref = generator_state_from_jax(_np(run["s1"].g_opt), {})
    _grads_close(run["g_grads"], ref, "G")
    # the frozen discriminator got no gradient in the G step
    assert all(g is None for g in run["d_grads_in_g_step"])


def test_generator_step_state(run):
    """G's BatchNorm statistics and u, v, and D's u, v (D's forward inside
    the G step updates them too)."""
    s1 = run["s1"]
    for what, ref in (("g_sd", generator_state_from_jax(_np(s1.g_params), _np(s1.g_stats))),
                      ("d_sd", discriminator_state_from_jax(_np(s1.d_params),
                                                            _np(s1.d_stats)))):
        n = 0
        for key, val in ref.items():
            if key.endswith((".mean", ".var", ".u", ".v")):
                np.testing.assert_allclose(run["g_step"][what][key].numpy(), val.numpy(),
                                           err_msg=key, **STATE_TOL)
                n += 1
        assert n > 0


def test_discriminator_step_losses_and_gradients(run):
    for k, v in run["j_d_losses"].items():
        np.testing.assert_allclose(run["t_d_losses"][k].item(), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    ref = discriminator_state_from_jax(_np(run["s2"].d_opt), {})
    _grads_close(run["d_grads"], ref, "D")


def test_discriminator_step_state(run):
    """G's forward inside the D step updates G's BatchNorm statistics and
    u, v; D's u, v update again."""
    s2 = run["s2"]
    for port_sd, ref in (
            (run["g_sd_after_d"], generator_state_from_jax(_np(s2.g_params), _np(s2.g_stats))),
            (run["d_sd_after_d"], discriminator_state_from_jax(_np(s2.d_params),
                                                               _np(s2.d_stats)))):
        for key, val in ref.items():
            if key.endswith((".mean", ".var", ".u", ".v")):
                np.testing.assert_allclose(port_sd[key].numpy(), val.numpy(), err_msg=key,
                                           **STATE_TOL)
    assert run["t_step"] == (1, 1)


@pytest.mark.parametrize("steps_per_epoch", [None, 10])
def test_lr_schedule_matches_jax(steps_per_epoch):
    """Constant for niter epochs, then linear decay to 0 over niter_decay."""
    port = TP._lr_schedule(1e-4, port_projector_cfg(TINY), steps_per_epoch)
    ref = P._lr_schedule(1e-4, TINY, steps_per_epoch)
    for step in (0, 7, 999, 1000, 1001, 1500, 1999, 2000, 2600):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, atol=1e-12)


def test_create_state_ttur_adam():
    cfg = port_projector_cfg(TINY)
    state = TP.create_state(cfg, device="cpu")
    (g_group,), (d_group,) = state.opt_g.param_groups, state.opt_d.param_groups
    assert g_group["lr"] == cfg.lr / 2 and d_group["lr"] == cfg.lr * 2
    assert g_group["betas"] == d_group["betas"] == (cfg.beta1, cfg.beta2)
    assert g_group["eps"] == d_group["eps"] == 1e-8
    assert state.g.training and state.d.training
    assert (state.step, state.d_step) == (0, 0)
    # use_vae: the encoder's fc_mu and fc_var heads in place of fc
    vae = {k for k, _ in TP.create_state(dataclasses.replace(cfg, use_vae=True),
                                         device="cpu").g.named_parameters()}
    assert {"netE.fc_mu.weight", "netE.fc_var.weight"} <= vae and "netE.fc.weight" not in vae


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_grad_norm_matches_optax(max_norm):
    """clip_grad_norm > 0: every gradient scaled by max_norm / global norm
    when the norm exceeds max_norm, as optax.clip_by_global_norm does."""
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    clip_by_global_norm(params, max_norm)
    tx = optax.clip_by_global_norm(max_norm)
    ref, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(grads))
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)
