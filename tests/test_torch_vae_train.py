"""use_vae training in the port (upstream SPADE's --use_vae: the
reparameterized latent and the KLD term) against the JAX package, at the
TINY config of tests/test_torch_projector_train.py with use_vae on, and its
full train state between the two packages.

Torch cannot draw ``jax.random``'s bits, so the JAX draws are recovered and
fed to the port: the JAX generator calls ``make_rng("vae")`` once at its
root scope with the step's key (fold_in(PRNGKey(0xEA), step) in the G step,
fold_in(PRNGKey(0xDA), step) in the D step), and a probe module at the root
that makes the same call with the same key draws the same array. The test
first checks that the recovered draw reproduces JAX's generated map (and
that another draw does not), then compares one G step and one D step, as
tests/test_torch_projector_train.py does: losses (KLD included), every
gradient leaf (netE's fc_mu and fc_var included) under its bars, and the
statistics the steps leave. The JAX gradients are read exactly through
torch_port_helpers.capture_tx.

The JAX state is create_state's with the tree every JAX step leaves: its
create_state keeps the (mu, logvar) the init sowed ("vae_stats") in
g_stats, and its first step reads those for the KLD term (a constant: the
zero crop's, with no gradient); every step drops them, and from then on
each step reads its own, as the port's steps always do (ROADMAP.md §3).

Train state: after its G + D steps the port saves its state (with Adam);
the JAX package restores the file into its create_state and gives back
every leaf bit for bit, and the port restores the JAX package's save of it
bit for bit."""

import dataclasses

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emlight_tpu.train import checkpoint as jckpt
from emlight_tpu.train import projector as P
from emlight_tpu.train.data import synthetic_projector_batch
from emlight_tpu_torch.train import projector as TP
from emlight_tpu_torch.train.checkpoint import (
    restore_train_state,
    save_train_state,
    train_state_tree,
)
from emlight_tpu_torch.train.jax_weights import (
    discriminator_state_from_jax,
    generator_state_from_jax,
)
from test_torch_projector_train import LOSS_RTOL, STATE_TOL, TINY, _grads_close
from test_torch_train_state import _leaves
from torch_port_helpers import (  # noqa: F401 (the fixtures: autouse)
    capture_tx,
    jax_projector_state,
    no_persistent_cache_writes,
    one_torch_thread,
    port_projector_cfg,
)

VAE = dataclasses.replace(TINY, use_vae=True)
ZDIM = 32 * VAE.ngf


class _VaeDraw(fnn.Module):
    """make_rng("vae") at the root scope, once: the JAX generator's draw."""

    @fnn.compact
    def __call__(self, shape):
        return jax.random.normal(self.make_rng("vae"), shape)


def _jax_eps(seed: int, step: int) -> np.ndarray:
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return np.asarray(_VaeDraw().apply({}, (2, ZDIM), rngs={"vae": key}))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(state, s):
    state.g.load_state_dict(generator_state_from_jax(_np(s.g_params), _np(s.g_stats)),
                            strict=True)
    state.d.load_state_dict(discriminator_state_from_jax(_np(s.d_params), _np(s.d_stats)),
                            strict=True)


def _tree(state) -> dict:
    return dict(_leaves(jax.tree.map(np.asarray, flax.serialization.to_state_dict(state))))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("vae")
    # the tree of a JAX state after a step (create_state's g_stats also hold
    # the (mu, logvar) the init sowed, which JAX's first step would read)
    s_adam = jax_projector_state(VAE)
    s_adam = s_adam.replace(
        g_stats={k: v for k, v in s_adam.g_stats.items() if k != "vae_stats"})
    tx = capture_tx()
    s0 = s_adam.replace(tx_g=tx, tx_d=tx, g_opt=tx.init(s_adam.g_params),
                        d_opt=tx.init(s_adam.d_params))
    batch = synthetic_projector_batch(2, n_anchors=96, crop_size=32, env_hw=(32, 64), seed=51)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    s1, j_g, j_fake = P.generator_step(s0, jb, VAE)
    s2, j_d = P.discriminator_step(s1, jb, VAE)
    eps_g, eps_d = _jax_eps(TP.VAE_G_SEED, 0), _jax_eps(TP.VAE_D_SEED, 1)

    state = TP.create_state(port_projector_cfg(VAE), device="cpu")
    _load(state, s0)
    t_g, t_fake = TP.generator_step(state, batch, eps=torch.tensor(eps_g))
    g_grads = {k: p.grad.clone() for k, p in state.g.named_parameters()}
    _load(state, s0)
    with torch.no_grad():  # another draw: the port's own G stream
        other_fake = state.g(TP.make_guide(TP._batch_on(batch, "cpu"), state.cfg),
                             torch.tensor(batch["crop"]),
                             eps=TP.vae_noise(state, TP.VAE_G_SEED, 2))
    _load(state, s1)
    t_d = TP.discriminator_step(state, batch, eps=torch.tensor(eps_d))
    d_grads = {k: p.grad.clone() for k, p in state.d.named_parameters()}
    return dict(s1=s1, s2=s2, j_g={k: float(v) for k, v in j_g.items()},
                j_d={k: float(v) for k, v in j_d.items()}, j_fake=np.asarray(j_fake),
                t_g={k: v.item() for k, v in t_g.items()},
                t_d={k: v.item() for k, v in t_d.items()}, t_fake=t_fake.numpy(),
                other_fake=other_fake.numpy(), g_grads=g_grads, d_grads=d_grads,
                g_sd_after_d=dict(state.g.state_dict()), d_sd_after_d=dict(state.d.state_dict()),
                port=state, port_file=save_train_state(str(d / "port"), state), template=s_adam,
                dir=d)


def test_recovered_draw_reproduces_jax_fake(run):
    # (tanh+1)*25 range: atol 5e-4 is 1e-5 of it
    np.testing.assert_allclose(run["t_fake"], run["j_fake"], rtol=1e-4, atol=5e-4)
    assert np.abs(run["other_fake"] - run["j_fake"]).max() > 1e-2


def test_generator_step_losses_and_gradients(run):
    assert set(run["t_g"]) == set(run["j_g"]) == {"GAN", "GAN_Feat", "COS", "KLD", "loss_G"}
    for k, v in run["j_g"].items():
        np.testing.assert_allclose(run["t_g"][k], v, rtol=LOSS_RTOL, err_msg=k)
    ref = generator_state_from_jax(_np(run["s1"].g_opt), {})
    assert {"netE.fc_mu.weight", "netE.fc_var.weight", "netE.fc_var.bias"} <= set(ref)
    _grads_close(run["g_grads"], ref, "G")


def test_discriminator_step_losses_gradients_and_state(run):
    """The D step's losses and gradients, and the statistics it leaves: G's
    BatchNorm statistics moved by its forward on the re-sampled latent."""
    for k, v in run["j_d"].items():
        np.testing.assert_allclose(run["t_d"][k], v, rtol=LOSS_RTOL, err_msg=k)
    _grads_close(run["d_grads"], discriminator_state_from_jax(_np(run["s2"].d_opt), {}), "D")
    s2 = run["s2"]
    for port_sd, ref in (
            (run["g_sd_after_d"], generator_state_from_jax(_np(s2.g_params), _np(s2.g_stats))),
            (run["d_sd_after_d"], discriminator_state_from_jax(_np(s2.d_params),
                                                               _np(s2.d_stats)))):
        keys = [k for k in ref if k.endswith((".mean", ".var", ".u", ".v"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(port_sd[k].numpy(), ref[k].numpy(), err_msg=k,
                                       **STATE_TOL)


def test_noise_streams_are_seeded_by_the_step():
    state = TP.create_state(port_projector_cfg(VAE), device="cpu")
    g0 = TP.vae_noise(state, TP.VAE_G_SEED, 2)
    assert g0.shape == (2, ZDIM)
    assert torch.equal(g0, TP.vae_noise(state, TP.VAE_G_SEED, 2))
    assert not torch.equal(g0, TP.vae_noise(state, TP.VAE_D_SEED, 2))
    state.step = 1
    assert not torch.equal(g0, TP.vae_noise(state, TP.VAE_G_SEED, 2))


def test_jax_restores_the_ports_vae_state_bit_for_bit(run):
    restored = jckpt.restore_checkpoint(run["port_file"], run["template"])
    got, mine = _tree(restored), dict(_leaves(train_state_tree(run["port"])))
    assert set(got) == set(mine)
    assert ("g_params", "netE", "fc_mu", "kernel") in got
    assert ("g_opt", "0", "mu", "netE", "fc_var", "bias") in got
    for k, a in got.items():
        assert a.dtype == mine[k].dtype and np.array_equal(a, mine[k]), "/".join(k)
    assert int(restored.step) == 1


def test_the_port_restores_the_jax_save_bit_for_bit(run):
    restored = jckpt.restore_checkpoint(run["port_file"], run["template"])
    path = jckpt.save_checkpoint(str(run["dir"] / "jax_again"), restored)
    state = TP.create_state(port_projector_cfg(VAE), device="cpu", seed=9)
    restore_train_state(path, state)
    assert (state.step, state.d_step) == (1, 1)
    a, b = dict(_leaves(train_state_tree(state))), dict(_leaves(train_state_tree(run["port"])))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), "/".join(k)
